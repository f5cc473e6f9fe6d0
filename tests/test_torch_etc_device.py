"""The ETC RGB and RGBA8 kernels' device code against the plain version on
the CPU.

``csrc/etc_encode.cu`` keeps its device functions plain C++ (the kernels
and launchers sit under ``__CUDACC__``), so g++ builds it against the shim
of ``chip_smoke.py:COUNT_PRELUDE`` with plain floats.  Its CPU entries
``etc_rgb_cpu`` and ``etc2_rgba_cpu`` run what the card runs: each CTA of
128 blocks staged into the shared-memory layout, then the CTA's threads one
after another.  Their words must equal ``encode_etc_rgb_plain`` and
``encode_etc2_rgba_plain`` bit for bit at every quality the smoke run
checks, on blocks chosen to reach every mode and rule: flat blocks, blocks
clamped at 0 and 255 (whose offset estimates tie), two-colour blocks (T and
H win), gradients (planar wins) and noisy ones, 200 of them (a short last
CTA).  A second build with the counting float of ``COUNT_PRELUDE`` holds
the float operations that bound PERF rows 11-12 (``chip_smoke.py:
etc_rgb_ops``, ``eac_ops``) to what the device code does.
"""

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cuttlefish_tpu_torch.kernels import _build, etc

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

ONE = (1.0, 1.0, 1.0)
# Rec.709 x 3, the weights every sRGB texture takes (convert/etc.py).
SRGB = tuple(float(w) for w in np.array([0.2126, 0.7152, 0.0722], np.float32) * np.float32(3.0))

_GLUE = r"""
#include "etc_encode.cu"
extern "C" void etc_rgb(const float* b, uint32_t* out, int n, int nch, int q, int etc2,
                        const float* w) {
  etcx::etc_rgb_cpu(b, out, n, nch, q, etc2, etcx::Chw{{w[0], w[1], w[2]}});
}
extern "C" void etc2_rgba(const float* b, uint32_t* out, int n, int q, const float* w) {
  etcx::etc2_rgba_cpu(b, out, n, q, etcx::Chw{{w[0], w[1], w[2]}});
}
"""


# The same entries on the counting float: each returns the float
# operations it did.
_COUNT_GLUE = r"""
#define float CF
#include "etc_encode.cu"
#undef float
extern "C" unsigned long long etc_rgb(const float* b, uint32_t* out, int n, int nch, int q,
                                      int etc2, const float* w) {
  g_ops = 0;
  etcx::etc_rgb_cpu((const CF*)b, out, n, nch, q, etc2, etcx::Chw{{w[0], w[1], w[2]}});
  return g_ops;
}
extern "C" unsigned long long etc2_rgba(const float* b, uint32_t* out, int n, int q,
                                        const float* w) {
  g_ops = 0;
  etcx::etc2_rgba_cpu((const CF*)b, out, n, q, etcx::Chw{{w[0], w[1], w[2]}});
  return g_ops;
}
"""


def _build_glue(tmp, glue):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    src, lib = tmp / "etc_device.cpp", tmp / "libetc_device.so"
    src.write_text(chip_smoke.COUNT_PRELUDE + glue)
    subprocess.run(["g++", "-O1", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC", "-I",
                    str(_build.CSRC), "-o", str(lib), str(src)], check=True, capture_output=True,
                   timeout=300)
    dll = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.etc_rgb.argtypes = [p, p, i, i, i, i, p]
    dll.etc2_rgba.argtypes = [p, p, i, i, p]
    dll.etc_rgb.restype = dll.etc2_rgba.restype = ctypes.c_ulonglong
    return dll


@pytest.fixture(scope="module")
def device_code(tmp_path_factory):
    return _build_glue(tmp_path_factory.mktemp("etc"), _GLUE)


@pytest.fixture(scope="module")
def counting_code(tmp_path_factory):
    return _build_glue(tmp_path_factory.mktemp("etc_count"), _COUNT_GLUE)


def run_device(dll, blocks, quality, kind, chw=ONE):
    """([N,2] (etc1, etc2) or [N,4] (rgba) words of the CPU build, what its
    entry returns)."""
    b = np.ascontiguousarray(blocks, np.float32)
    w = np.asarray(chw, np.float32)
    out = np.zeros((b.shape[0], 4 if kind == "rgba" else 2), np.uint32)
    if kind == "rgba":
        ret = dll.etc2_rgba(b.ctypes.data, out.ctypes.data, b.shape[0], quality, w.ctypes.data)
    else:
        ret = dll.etc_rgb(b.ctypes.data, out.ctypes.data, b.shape[0], b.shape[2], quality,
                          int(kind == "etc2"), w.ctypes.data)
    return out, ret


def device_words(dll, blocks, quality, kind, chw=ONE):
    return run_device(dll, blocks, quality, kind, chw)[0]


# Two-colour blocks (u8 colours a, b; texel t takes b where bit t of the
# mask is set) on which two tables tie for the runner-up of a centre fit,
# so that the restricted set of the estimates, and the words, depend on
# its first-minimum rule.
_RUNNER_UP_TIES = [
    ((63, 200, 43, 76), (174, 3, 179, 250), 0b1000000110111101),
    ((171, 196, 217, 38), (214, 223, 229, 91), 0b0101010011001100),
    ((76, 106, 92, 186), (166, 88, 83, 53), 0b0011110011011110),
    ((43, 219, 227, 130), (143, 129, 91, 87), 0b1011011111001010),
]


def device_blocks(n=200, seed=21):
    """[n,16,4] float blocks (values outside [0, 1] too) in six kinds, the
    last four _RUNNER_UP_TIES."""
    rng = np.random.default_rng(seed)
    k = n // 6
    b = np.clip(rng.random((n, 1, 4)) + rng.normal(0, 0.12, (n, 16, 4)), 0, 1)
    b[:k] = b[:k, :1]  # flat
    b[: k // 3] = rng.choice([0.0, 1.0], size=(k // 3, 1, 4))  # flat at 0 / 255
    pairs = rng.random((k, 2, 4))  # two colours, scattered: T and H
    pick = rng.random((k, 16)) > 0.5
    b[k : 2 * k] = np.where(pick[..., None], pairs[:, :1], pairs[:, 1:])
    y, x = np.mgrid[0:4, 0:4].reshape(2, 16) / 3.0
    g = rng.random((k, 3, 4))
    b[2 * k : 3 * k] = (  # gradients: planar
        g[:, 0, None] + (g[:, 1, None] - 0.5) * x[None, :, None]
        + (g[:, 2, None] - 0.5) * y[None, :, None]
    )
    b[3 * k : 4 * k] = rng.choice([-0.3, 0.0, 1.0, 1.4], size=(k, 16, 4))  # clamped at 0 / 255
    b[4 * k : 5 * k] = 0.97 + rng.normal(0, 0.05, (k, 16, 4))  # near 255, partly clamped
    for i, (ca, cb, mask) in enumerate(_RUNNER_UP_TIES):
        bits = (mask >> np.arange(16)) & 1
        b[n - len(_RUNNER_UP_TIES) + i] = np.where(bits[:, None], cb, ca) / 255.0
    return b.astype(np.float32)


def etc2_mode(words):
    """ETC2 mode of each RGB block ([N,2] words as stored): individual,
    differential, T, H or planar."""
    hi = words[:, 0].byteswap().astype(np.int64)
    diff = (hi >> 1) & 1

    def overflow(shift):
        base = (hi >> (shift + 3)) & 31
        d = (hi >> shift) & 7
        s = base + np.where(d >= 4, d - 8, d)
        return (s < 0) | (s > 31)

    t, h, p = overflow(24), overflow(16), overflow(8)
    mode = np.where(diff == 0, "individual", "differential").astype(object)
    mode = np.where((diff == 1) & p, "planar", mode)
    mode = np.where((diff == 1) & h, "H", mode)
    return np.where((diff == 1) & t, "T", mode)


# (format, quality, weights, channels)
_CASES = {
    "etc1_q0": ("etc1", 0, ONE, 4), "etc1_q1": ("etc1", 1, ONE, 3),
    "etc1_q2": ("etc1", 2, ONE, 4), "etc1_q4": ("etc1", 4, ONE, 4),
    "etc2_q2": ("etc2", 2, ONE, 4), "etc2_q4": ("etc2", 4, ONE, 3),
    "etc2_q2_srgb": ("etc2", 2, SRGB, 4), "etc2_q4_srgb": ("etc2", 4, SRGB, 4),
    "rgba_q2": ("rgba", 2, ONE, 4), "rgba_q4": ("rgba", 4, SRGB, 4),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_device_code_equals_plain_version(device_code, case):
    kind, q, chw, nch = _CASES[case]
    b = device_blocks()[..., :nch]
    got = device_words(device_code, b, q, kind, chw)
    x = torch.from_numpy(np.ascontiguousarray(b))
    if kind == "rgba":
        want = etc.encode_etc2_rgba_plain(x, q, chw).numpy()
    else:
        want = etc.encode_etc_rgb_plain(x, q, kind == "etc2", chw).numpy()
    assert got.dtype == want.dtype == np.uint32 and got.shape == want.shape
    assert np.array_equal(got, want), np.where(~np.all(got == want, axis=1))[0][:10]


def test_blocks_reach_every_etc2_mode(device_code):
    """The blocks above make every ETC2 mode win somewhere at q4 and q2,
    so the equality covers planar, T and H as well as ETC1's two modes."""
    b = device_blocks()
    for q in (2, 4):
        modes = set(etc2_mode(device_words(device_code, b, q, "etc2")))
        assert modes == {"individual", "differential", "T", "H", "planar"}, (q, modes)


@pytest.mark.parametrize("case", list(_CASES))
def test_bound_counts_the_device_codes_operations(counting_code, device_code, case):
    """The needed float operations that bound PERF rows 11-12 are within 2 %
    of what the device code does on noisy blocks (where no difference is 0,
    which the counting float would not count), products by the channel
    weights counted only where a weight is not 1.  The counting build's
    words are the plain-float build's."""
    kind, q, chw, nch = _CASES[case]
    b = np.random.default_rng(5).random((130, 16, 4)).astype(np.float32)[..., :nch]
    words, ops = run_device(counting_code, b, q, kind, chw)
    assert np.array_equal(words, device_words(device_code, b, q, kind, chw))
    weighted = chw != ONE
    rgb = chip_smoke.etc_rgb_ops(q, kind != "etc1", weighted)
    need = 3 * 64 + chip_smoke.eac_ops(q, False) + rgb if kind == "rgba" else 3 * 48 + rgb
    assert abs(ops / b.shape[0] / need - 1) <= 0.02, (ops / b.shape[0], need)
