"""The fused mip pyramid's kernel (``csrc/pyramid.cu``) against the torch
ops of ``convert/device.py:pyramid_blocks_plain`` on the CPU.

The kernel's device code is plain C++ (the kernel and its launcher sit
under ``__CUDACC__``), so g++ builds it with ``-ffp-contract=off`` against
the shim of ``chip_smoke.py:COUNT_PRELUDE`` with plain floats.  Its CPU
entry ``pyramid_level_cpu`` runs one level's threads one after another,
and ``pyramid_blocks_levels`` calls it once a level, with the same
arguments (``kernels/pyramid_cuda.py:level_args``) and the same buffers as
it calls the card's launch.  Every block must equal the plain version's bit
for bit where ``srgb`` is false, and lie within 1e-5 of it where it is set
(the host's ``powf`` is neither torch's vectorised CPU ``pow`` nor the
card's); a NaN must stand where the plain version has one (x86 keeps the
payload of whichever operand the compiler puts first).

Cases: the inputs of ``tests/test_torch_fused.py:_PYRAMIDS`` (normal maps
included, their level 0 made by the same torch ops), an odd 37x23 surface,
1xN and Nx1 strips, a six-face HDR cube with a sun of 5,000, a surface
holding -0.0 and infs, every filter of ``image/resample.py`` in linear
light and through sRGB, and block sizes 4x4, 5x4, 8x8 and 12x12.
"""

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cuttlefish_tpu_torch.convert.device import pyramid_blocks_levels, pyramid_blocks_plain
from cuttlefish_tpu_torch.kernels import _build, pyramid_cuda
from test_torch_fused import _PYRAMIDS

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

_TOL = 1e-5
_FILTERS = ("box", "linear", "cubic", "catmullrom", "bspline")


@pytest.fixture(scope="module")
def level_cpu(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    tmp = tmp_path_factory.mktemp("pyramid")
    src, lib = tmp / "pyramid_device.cpp", tmp / "libpyramid_device.so"
    src.write_text(chip_smoke.COUNT_PRELUDE + '#include "pyramid.cu"\n')
    subprocess.run(["g++", "-O1", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC", "-I",
                    str(_build.CSRC), "-o", str(lib), str(src)], check=True, capture_output=True,
                   timeout=300)
    dll = ctypes.CDLL(str(lib))
    dll.pyramid_level_cpu.argtypes = pyramid_cuda.ARGTYPES
    dll.pyramid_level_cpu.restype = ctypes.c_int

    def build_level(*args):
        assert dll.pyramid_level_cpu(*pyramid_cuda.level_args(*args)) == 0

    return build_level


def _hdr_cube(size, seed=3):
    """Six linear faces: a sky gradient with noise, a sun of 5,000 on face 0."""
    rng = np.random.default_rng(seed)
    y = np.linspace(0.0, 1.0, size, dtype=np.float32)[None, :, None, None]
    faces = (0.2 + 1.5 * y) * (1.0 + 0.01 * rng.standard_normal((6, size, size, 4)))
    faces = faces.astype(np.float32)
    faces[0, size // 3 : size // 3 + 2, size // 2 : size // 2 + 2, :3] = 5000.0
    faces[..., 3] = 1.0
    return faces


def _specials():
    """A linear surface with -0.0 and infs: the padding taps' products
    (0 * inf) and the signs of zero must meet the same sums."""
    x = np.random.default_rng(5).random((1, 16, 16, 4), dtype=np.float32)
    x[0, :4, :4] = -0.0
    x[0, 9, 13, 1] = np.inf
    x[0, 0, 10, 2] = np.inf  # in row 0, which the padding taps read
    return x


def _cases():
    rng = np.random.default_rng(11)
    odd = rng.random((1, 23, 37, 4), dtype=np.float32)
    strip = rng.random((1, 1, 40, 4), dtype=np.float32)
    small = rng.random((1, 20, 30, 4), dtype=np.float32)
    cases = {
        name: (x, levels, "catmullrom", srgb, 4, 4, nopts)
        for name, (x, levels, srgb, nopts) in _PYRAMIDS.items()
    }
    cases.update({
        "odd_37x23_srgb_5x4": (odd, 6, "catmullrom", True, 5, 4, None),
        "odd_37x23_signed_12x12": (odd * 3.0 - 1.0, 6, "cubic", False, 12, 12, None),
        "strip_1x40_srgb": (strip, 6, "linear", True, 4, 4, None),
        "strip_40x1_8x8": (np.ascontiguousarray(strip.transpose(0, 2, 1, 3)), 6, "bspline",
                           False, 8, 8, None),
        "cube_hdr_sun": (_hdr_cube(24), 5, "catmullrom", False, 4, 4, None),
        "specials_box_8x8": (_specials(), 5, "box", False, 8, 8, None),
        "specials_catmullrom": (_specials(), 5, "catmullrom", False, 4, 4, None),
    })
    for f in _FILTERS:
        for srgb in (False, True):
            cases[f"{f}_{'srgb' if srgb else 'linear'}"] = (small, 5, f, srgb, 4, 4, None)
    return cases


_CASES = _cases()


@pytest.mark.parametrize("name", list(_CASES))
def test_kernel_body_equals_plain_version(level_cpu, name):
    x, levels, filt, srgb, bw, bh, nopts = _CASES[name]
    xt = torch.from_numpy(x)
    want = pyramid_blocks_plain(xt, levels, filt, srgb, bw, bh, nopts)
    got = pyramid_blocks_levels(xt, levels, filt, srgb, bw, bh, nopts, level_cpu)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got.isnan(), want.isnan())
    both = ~want.isnan()
    if srgb:
        assert float((got[both] - want[both]).abs().max()) <= _TOL
    else:
        assert torch.equal(got[both].view(torch.int32), want[both].view(torch.int32))
    if name.startswith("specials"):
        assert want.isinf().any() and (want.view(torch.int32) == -(2**31)).any()


def test_build_level_refuses_a_cpu_tensor():
    x = torch.zeros((1, 4, 4, 4))
    blocks = torch.empty((1, 16, 4))
    with pytest.raises(ValueError, match="CUDA"):
        pyramid_cuda.build_level(x, None, blocks, 0, (4, 4), None, 4, 4, False)


def test_level_args_checks_shapes():
    x = torch.zeros((1, 4, 4, 4))
    with pytest.raises(ValueError, match="exceed"):
        pyramid_cuda.level_args(x, None, torch.empty((0, 16, 4)), 0, (4, 4), None, 4, 4, False)
    with pytest.raises(ValueError, match="level 0"):
        pyramid_cuda.level_args(x, None, torch.empty((1, 16, 4)), 0, (2, 2), None, 4, 4, False)
    with pytest.raises(ValueError, match="float32"):
        pyramid_cuda.level_args(x.double(), None, torch.empty((1, 16, 4)), 0, (4, 4), None,
                                4, 4, False)
