"""The shortcut of the ETC/EAC tests is honest: the TPU kernel bodies
called eagerly (``jax.disable_jit``, numpy refs; ``tests/test_torch_etc.py``)
equal the reference's own entry points in interpret mode
(``encode_*_pallas(..., interpret=True)``), and so does the port: ETC2 RGB
at quality 1 and EAC at quality 2, on 64 blocks each.  (Where the two
differ, on a rounding tie of EAC's multiplier seed, interpret mode is the
truth: ``tests/test_torch_etc_eac.py``.)"""

import numpy as np
import torch
from test_torch_etc import eager_eac, eager_rgb, etc_blocks
from test_torch_etc_eac import _eager, _port, _values

from cuttlefish_tpu.kernels import etc_pallas
from cuttlefish_tpu_torch.kernels import etc


def test_eager_body_is_the_interpret_kernel_rgb():
    """ETC2 RGB at quality 1: the eager body equals encode_etc_rgb_pallas
    in interpret mode, and so does the port (64 blocks)."""
    b = etc_blocks(64, seed=5)
    ref = np.asarray(etc_pallas.encode_etc_rgb_pallas(b, 1, True, interpret=True))
    assert np.array_equal(eager_rgb(b, 1, True), ref)
    assert np.array_equal(etc.encode_etc_rgb(torch.from_numpy(b), 1, True).numpy(), ref)


def test_eager_body_is_the_interpret_kernel_eac():
    """EAC at quality 2: the eager bodies equal encode_eac_alpha_pallas and
    encode_eac_rg11_pallas (signed) in interpret mode, and so does the port
    (64 blocks)."""
    a = _values("alpha")[:64]
    ref = np.asarray(etc_pallas.encode_eac_alpha_pallas(a, 2, interpret=True))
    assert np.array_equal(eager_eac(a, 2, "alpha"), ref)
    assert np.array_equal(_port("alpha", a, 2), ref)
    v = _values("rg11s")[:64]
    ref = np.asarray(etc_pallas.encode_eac_rg11_pallas(v, 2, True, interpret=True))
    assert np.array_equal(_eager("rg11s", v, 2), ref)
    assert np.array_equal(_port("rg11s", v, 2), ref)
