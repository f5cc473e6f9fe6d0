"""The port's ASTC encoder on decimated weight grids against the TPU
kernels that it ports: 6x6 and 8x8 at quality 2 (10x5 and 12x12, where
Gauss-Seidel runs: ``tests/test_torch_astc_decimated_large.py``).

Reference and inputs as in ``tests/test_torch_astc.py``: the kernel
bodies called eagerly, 200 seeded near-gray blocks with alpha, so that
every kernel A task (CEM 8/12, dual plane, CEM 0/4) and kernel B run.
Tolerance: >= 99 % identical blocks and a decoded MSE within 0.5 % of the
reference's.  The eager bodies form the grid's pseudo-inverse product
and the partition screens with XLA's dot, whose summation order the port
does not follow at these sizes (it folds over texels, as the hand kernel
does), so a near-tie could flip a block; none does on these inputs
(100 % identical, equal MSE, on the CPU).
"""

import numpy as np
import pytest
from test_torch_astc import astc_blocks, eager_encode, flags_of, port_encode, same, to_bytes

from cuttlefish_tpu_torch.decode.astc import decode_astc


def check_decimated(bw, bh, quality=2, n=200):
    b = astc_blocks(n, bw * bh, "gray_alpha", seed=21)
    gray, alpha = flags_of(b)
    assert gray and alpha
    ref = eager_encode(b, bw, bh, quality, gray, alpha)
    port = port_encode(b, bw, bh, quality, gray, alpha)
    assert port.dtype == np.uint32 and port.shape == ref.shape == (n, 4)
    assert same(port, ref) >= 0.99, same(port, ref)
    src = np.round(b.astype(np.float64) * 255)
    mse = [((decode_astc(to_bytes(w), bw, bh).astype(np.float64) - src) ** 2).mean()
           for w in (port, ref)]
    assert mse[0] <= mse[1] * 1.005, mse


@pytest.mark.parametrize("size", [(6, 6), (8, 8)], ids=["6x6", "8x8"])
def test_plain_matches_tpu_kernel_decimated(size):
    check_decimated(*size)
