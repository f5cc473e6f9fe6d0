"""The port's ASTC encoder at 4x4 against the TPU kernel bodies (helpers
and tolerance: ``tests/test_torch_astc.py``).  Near-gray blocks with a varying alpha: CEM 4, CEM 12, dual plane and
kernel D.
"""

import pytest
from test_torch_astc import check_4x4


@pytest.mark.parametrize("quality", [0, 1, 2, 3, 4])
def test_plain_matches_tpu_kernel_4x4_gray_alpha(quality):
    check_4x4("gray_alpha", quality)
