"""The port's ASTC encoder at 4x4 against the TPU kernel bodies (helpers
and tolerance: ``tests/test_torch_astc.py``).  Blocks with a varying alpha: CEM 12, dual plane and, from quality 3,
the (12, 2) layout of kernel B.
"""

import pytest
from test_torch_astc import check_4x4


@pytest.mark.parametrize("quality", [0, 1, 2, 3, 4])
def test_plain_matches_tpu_kernel_4x4_alpha(quality):
    check_4x4("alpha", quality)
