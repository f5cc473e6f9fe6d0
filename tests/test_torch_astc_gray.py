"""The port's ASTC encoder at 4x4 against the TPU kernel bodies (helpers
and tolerance: ``tests/test_torch_astc.py``).  Near-gray opaque blocks: the luminance CEM 0 fits of kernel A and, from
quality 3, kernel D's 4-partition CEM 0/4 sweep.
"""

import pytest
from test_torch_astc import check_4x4


@pytest.mark.parametrize("quality", [0, 1, 2, 3, 4])
def test_plain_matches_tpu_kernel_4x4_gray(quality):
    check_4x4("gray", quality)
