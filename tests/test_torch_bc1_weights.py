"""The port's plain BC1 version with channel weights, against the TPU kernel.

The reference's own case (tests/test_pallas.py:57,68): BC1 at quality 3
with the channel weights ``[0.9, 1.77, 0.33]``, through
``bc_pallas.py:encode_bc1_pallas`` in interpret mode on the CPU, on float
blocks made as tests/test_pallas.py makes them.  It sits in a file of its
own because its Pallas program compiles apart from every other case.
"""

import numpy as np
import torch

from cuttlefish_tpu import decode as jd
from cuttlefish_tpu_torch.kernels import bc

_N = 256
_W = (0.9, 1.77, 0.33)  # tests/test_pallas.py:57


def _blocks(seed=7):
    rng = np.random.default_rng(seed)
    base = rng.random((_N, 1, 4), np.float32)
    grad = rng.normal(0, 0.15, (_N, 16, 4)).astype(np.float32)
    b = np.clip(base + grad, 0, 1)
    b[::3, :, 3] = np.clip(b[::3, :, 3] * 0.6 + 0.2, 0, 1)
    return b


def _decoded_rgb(words):
    raw = np.frombuffer(np.ascontiguousarray(words.astype("<u4")).tobytes(), np.uint8)
    return jd.decode_bc1(raw)[..., :3].astype(np.float64)


def _psnr(dec, ref):
    return 10 * np.log10(255.0**2 / (((dec - ref) ** 2).mean() + 1e-20))


def test_plain_matches_tpu_kernel_with_weights_q3():
    """>= 99 % identical blocks (100 % so far) and PSNR within 0.05 dB."""
    from cuttlefish_tpu.kernels import bc_pallas as P

    b = _blocks()
    chw = tuple(float(x) for x in np.float32(_W))
    port = bc.encode_bc1(torch.from_numpy(b), 3, ch_weights=np.float32(_W))
    ref = np.asarray(P.encode_bc1_pallas(b, 3, False, True, chw))
    assert port.dtype == torch.uint32
    port = port.numpy()
    assert port.shape == ref.shape == (_N, 2)
    same = np.all(port == ref, axis=1).mean()
    assert same >= 0.99, same
    target = np.round(b[..., :3] * 255)
    assert abs(_psnr(_decoded_rgb(port), target) - _psnr(_decoded_rgb(ref), target)) <= 0.05
