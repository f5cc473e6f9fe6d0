"""The port's BC6H encoder against the JAX package's ``jnp`` path.

The ``jnp`` path is another algorithm than the TPU kernel that the port
follows (7.8 % identical blocks at q2), so it is held only to the
reference's own bar, on the reference's own input: PSNR >= jnp - 0.1 dB
for ``random((64,16,3)) * 8``, unsigned and negated
(``tests/test_pallas.py:307-336``).  The bar is taken at q0 and q2; the
``jnp`` path's q4 compile takes minutes on a CPU (156 s measured on an
x86 host), so q4 is held to the q2 bar as a floor.  On the wide-range HDR
blocks of ``tests/test_torch_bc6h.py`` the TPU kernel itself, and so the
port, falls 0.2-0.3 dB under the ``jnp`` path at q0 and q2 unsigned;
there the port is held to the TPU kernel, block for block.
"""

import numpy as np
import pytest
import torch

from cuttlefish_tpu.decode.bc6h import decode_bc6h
from cuttlefish_tpu.packfloat import half_bits_to_f32
from cuttlefish_tpu_torch.kernels.bc6h import encode_bc6h


def _psnr(words, src, signed):
    raw = np.frombuffer(np.ascontiguousarray(np.asarray(words).astype("<u4")).tobytes(), np.uint8)
    dec = half_bits_to_f32(decode_bc6h(raw, signed=signed)).astype(np.float64)
    return 10 * np.log10(1.0 / max(((dec - src) ** 2).mean(), 1e-12))


@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
def test_psnr_vs_jnp(signed):
    from cuttlefish_tpu.kernels.bc6h import _encode_bc6h_jnp

    src = (np.random.default_rng(1).random((64, 16, 3)) * 8.0).astype(np.float32)
    s = src * (np.float32(-1.0) if signed else np.float32(1.0))
    port = {q: encode_bc6h(torch.from_numpy(s), q, signed).numpy() for q in (0, 2, 4)}
    for q in (0, 2):
        p_jnp = _psnr(np.asarray(_encode_bc6h_jnp(s, q, signed, "value")), s, signed)
        assert _psnr(port[q], s, signed) >= p_jnp - 0.1, (q, p_jnp)
    assert _psnr(port[4], s, signed) >= p_jnp - 0.1
