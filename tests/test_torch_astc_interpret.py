"""The shortcut of the ASTC tests is honest: the TPU kernel bodies called
eagerly and merged as the wrapper merges them (``eager_encode`` in
``tests/test_torch_astc.py``) equal the reference's own entry point in
interpret mode (``encode_astc_pallas(..., interpret=True)``), and so does
the port: 64 near-gray blocks with alpha at 4x4, quality 2, which run
kernel A's CEM 8/12, dual-plane and CEM 0/4 fits and kernel B.
"""

import numpy as np
from test_torch_astc import astc_blocks, eager_encode, flags_of, port_encode

from cuttlefish_tpu.kernels.astc_pallas import encode_astc_pallas


def test_eager_bodies_are_the_interpret_kernel():
    b = astc_blocks(64, 16, "gray_alpha", seed=3)
    gray, alpha = flags_of(b)
    assert gray and alpha
    ref = np.asarray(encode_astc_pallas(b, 4, 4, 2, interpret=True, gray=gray, alpha=alpha))
    assert ref.shape == (64, 4)
    assert np.array_equal(eager_encode(b, 4, 4, 2, gray, alpha), ref)
    assert np.array_equal(port_encode(b, 4, 4, 2, gray, alpha), ref)
