"""The port's ASTC encoder against the TPU kernels at 10x5 and 12x12,
quality 2: decimated grids, the extended block-mode rows and, at 12x12,
the Gauss-Seidel refinement of blocks above 64 texels (helpers and
tolerance: ``tests/test_torch_astc_decimated.py``).
"""

import pytest
from test_torch_astc_decimated import check_decimated


@pytest.mark.parametrize("size", [(10, 5), (12, 12)], ids=["10x5", "12x12"])
def test_plain_matches_tpu_kernel_decimated_large(size):
    check_decimated(*size)
