"""BC7 q2 on the five block classes of the north-star content, three ways.

    python tools/bc7_classes.py

Prints, for each class of ``northstar.CLASSES`` (``content_blocks``, 256
blocks), the decoded PSNR (peak 255, as tests/test_cpu_reference.py
measures) of: the port's plain version (after the Pallas kernel), the JAX
package's ``jnp`` path, and the native CPU encoder.  The reference's BC7
bars are tests/test_native.py's content and the corpus, not these classes:
this prints a finding, it asserts nothing.  Runs on the CPU; JAX is the
reference here, as in the tests.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cuttlefish_tpu.kernels.bc7 import encode_bc7 as encode_jnp  # noqa: E402
from cuttlefish_tpu_torch import native, northstar  # noqa: E402
from cuttlefish_tpu_torch.decode.bc7 import decode_bc7  # noqa: E402
from cuttlefish_tpu_torch.kernels.bc7 import encode_bc7  # noqa: E402


def psnr(words, ref) -> float:
    """[N,4] uint32 BC7 words, decoded; PSNR at peak 255 against ``ref``."""
    raw = np.ascontiguousarray(np.asarray(words).astype("<u4")).view(np.uint8).reshape(-1)
    mse = ((decode_bc7(raw).astype(np.float64) - ref) ** 2).mean()
    return 10 * np.log10(255.0**2 / max(mse, 1e-12))


def main() -> None:
    for name in northstar.CLASSES:
        blocks = northstar.content_blocks(name)
        ref = blocks * 255.0
        words = {
            "port plain": encode_bc7(torch.from_numpy(blocks), 2).numpy(),
            "JAX jnp": np.asarray(encode_jnp(blocks, quality=2)),
            "CPU encoder": native.bc7_encode_cpu(blocks, 2, threads=1),
        }
        p = {k: psnr(w, ref) for k, w in words.items()}
        print(f"{name}: " + ", ".join(f"{k} {v:.4f} dB" for k, v in p.items())
              + f"; port - CPU {p['port plain'] - p['CPU encoder']:+.4f} dB")


if __name__ == "__main__":
    main()
