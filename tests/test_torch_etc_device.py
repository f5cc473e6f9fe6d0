"""The ETC RGB, RGBA8 and EAC kernels' device code against the plain
version on the CPU.

``csrc/etc_encode.cu`` keeps its device functions plain C++ (the kernels
and launchers sit under ``__CUDACC__``), so g++ builds it against the shim
of ``chip_smoke.py:COUNT_PRELUDE`` with plain floats.  Its CPU entries
``etc_rgb_cpu``, ``etc2_rgba_cpu``, ``eac_r11_cpu``, ``eac_rg11_cpu`` and
``eac_alpha_cpu`` run what the card runs: each CTA of 128 blocks staged
into the shared-memory layout, then the CTA's threads one after another
(RG11: a thread per block and channel).  Their words must equal
``encode_etc_rgb_plain``, ``encode_etc2_rgba_plain`` and the
``encode_eac_*_plain`` functions bit for bit at every quality the smoke run
checks, on blocks chosen to reach every mode and rule: flat blocks, blocks
clamped at 0 and 255 (whose offset estimates tie), two-colour blocks (T and
H win), gradients (planar wins) and noisy ones, 200 of them (a short last
CTA); for EAC flat blocks (repeated multipliers), spans that clamp the
multiplier at 15, values past both ends of the clip range and texels
exactly between two palette entries.  A second build with the counting
float of ``COUNT_PRELUDE`` holds the float operations that bound PERF rows
11-12 (``chip_smoke.py:etc_rgb_ops``, ``eac_ops``) to what the device code
does, and those the EAC entries need (rows 9, 10 and 13) below every
candidate in full.
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
extern "C" void eac_r11(const float* v, uint32_t* out, int n, int q, int sgn) {
  etcx::eac_r11_cpu(v, out, n, q, sgn);
}
extern "C" void eac_rg11(const float* b, uint32_t* out, int n, int nch, int q, int sgn) {
  etcx::eac_rg11_cpu(b, out, n, nch, q, sgn);
}
extern "C" void eac_alpha(const float* v, uint32_t* out, int n, int q) {
  etcx::eac_alpha_cpu(v, out, n, q);
}
"""


# The same entries on the counting float: each returns the float
# operations it did, the EAC search's side of the base counted once a texel
# (chip_smoke.py:EAC_SIDE_COUNT), as the function needs it.
_COUNT_GLUE = chip_smoke.EAC_SIDE_COUNT + r"""
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
  g_needed = true;
  etcx::etc2_rgba_cpu((const CF*)b, out, n, q, etcx::Chw{{w[0], w[1], w[2]}});
  return g_ops + 16ull * n;
}
extern "C" unsigned long long eac_r11(const float* v, uint32_t* out, int n, int q, int sgn) {
  g_ops = 0;
  g_needed = true;
  etcx::eac_r11_cpu((const CF*)v, out, n, q, sgn);
  return g_ops + 16ull * n;
}
extern "C" unsigned long long eac_rg11(const float* b, uint32_t* out, int n, int nch, int q,
                                       int sgn) {
  g_ops = 0;
  g_needed = true;
  etcx::eac_rg11_cpu((const CF*)b, out, n, nch, q, sgn);
  return g_ops + 32ull * n;
}
extern "C" unsigned long long eac_alpha(const float* v, uint32_t* out, int n, int q) {
  g_ops = 0;
  g_needed = true;
  etcx::eac_alpha_cpu((const CF*)v, out, n, q);
  return g_ops + 16ull * n;
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
    dll.eac_r11.argtypes = [p, p, i, i, i]
    dll.eac_rg11.argtypes = [p, p, i, i, i, i]
    dll.eac_alpha.argtypes = [p, p, i, i]
    for f in (dll.etc_rgb, dll.etc2_rgba, dll.eac_r11, dll.eac_rg11, dll.eac_alpha):
        f.restype = ctypes.c_ulonglong
    return dll


@pytest.fixture(scope="module")
def device_code(tmp_path_factory):
    return _build_glue(tmp_path_factory.mktemp("etc"), _GLUE)


@pytest.fixture(scope="module")
def counting_code(tmp_path_factory):
    return _build_glue(tmp_path_factory.mktemp("etc_count"), _COUNT_GLUE)


def run_device(dll, blocks, quality, kind, chw=ONE):
    """([N,2] (etc1, etc2, r11[s], a8) or [N,4] (rgba, rg11[s]) words of the
    CPU build, what its entry returns).  EAC kinds take their input as
    eac_input gives it."""
    b = np.ascontiguousarray(blocks, np.float32)
    w = np.asarray(chw, np.float32)
    out = np.zeros((b.shape[0], 4 if kind in ("rgba", "rg11", "rg11s") else 2), np.uint32)
    n, sgn = b.shape[0], int(kind.endswith("s"))
    if kind == "rgba":
        ret = dll.etc2_rgba(b.ctypes.data, out.ctypes.data, b.shape[0], quality, w.ctypes.data)
    elif kind in ("r11", "r11s"):
        ret = dll.eac_r11(b.ctypes.data, out.ctypes.data, n, quality, sgn)
    elif kind in ("rg11", "rg11s"):
        ret = dll.eac_rg11(b.ctypes.data, out.ctypes.data, n, b.shape[2], quality, sgn)
    elif kind == "a8":
        ret = dll.eac_alpha(b.ctypes.data, out.ctypes.data, n, quality)
    else:
        ret = dll.etc_rgb(b.ctypes.data, out.ctypes.data, b.shape[0], b.shape[2], quality,
                          int(kind == "etc2"), w.ctypes.data)
    return out, ret


def device_words(dll, blocks, quality, kind, chw=ONE):
    return run_device(dll, blocks, quality, kind, chw)[0]


def plain_words(blocks, quality, kind, chw=ONE):
    """The plain version's words of the same input."""
    x = torch.from_numpy(np.ascontiguousarray(blocks, np.float32))
    if kind == "rgba":
        return etc.encode_etc2_rgba_plain(x, quality, chw).numpy()
    if kind in ("r11", "r11s"):
        return etc.encode_eac_r11_plain(x, quality, kind == "r11s").numpy()
    if kind in ("rg11", "rg11s"):
        return etc.encode_eac_rg11_plain(x, quality, kind == "rg11s").numpy()
    if kind == "a8":
        return etc.encode_eac_alpha_plain(x, quality).numpy()
    return etc.encode_etc_rgb_plain(x, quality, kind == "etc2", chw).numpy()


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


# R11 values (clamp(x) * scale: 0..2047, or -1023..1023 signed) of blocks
# in which texels 5 and 10 lie exactly between two entries of the palette
# that wins at q2: their indices must take the first of two equal squares.
_R11_TIES = {
    False: [
        [949, 1109, 1151, 956, 979, 1092, 1151, 1002, 1015, 1134, 1092, 1007, 1125, 1003, 1036, 1161],
        [1103, 1104, 1145, 1139, 1144, 1112, 1143, 1119, 1125, 1141, 1112, 1117, 1109, 1125, 1150, 1151],
        [769, 923, 803, 854, 813, 788, 897, 779, 816, 854, 788, 788, 936, 897, 933, 939],
    ],
    True: [
        [79, 80, 121, 115, 120, 84, 119, 95, 101, 117, 84, 93, 85, 101, 126, 127],
        [-255, -101, -221, -170, -211, -240, -127, -245, -208, -170, -240, -236, -88, -127, -91, -85],
        [430, 499, 549, 465, 523, 512, 471, 555, 484, 496, 512, 444, 484, 510, 488, 558],
    ],
}


def r11_input(value, signed):
    """The float32 input whose R11 value clamp(x) * scale is exactly value."""
    scale = np.float32(1023.0 if signed else 2047.0)
    x = np.float32(value / float(scale))
    for _ in range(8):
        v = np.float32(x * scale)
        if v == value:
            return x
        x = np.nextafter(x, np.float32(np.inf if v < value else -np.inf), dtype=np.float32)
    raise ValueError(value)


def eac_blocks(signed=False, n=200, seed=7):
    """[n,16,4] float blocks for the EAC entries (red and green for R11 and
    RG11, alpha for A8 on the 8-bit grid, whose integer palettes tie
    often): flat blocks (multiplier seed 1, so repeated multipliers), near
    flat ones, values past both ends of the clip range (seed clamped at 15),
    noisy ones, and last _R11_TIES in red and, reversed, in green.  signed:
    red and green 2x - 1 of the same."""
    rng = np.random.default_rng(seed)
    k = n // 6
    b = np.clip(rng.random((n, 1, 4)) + rng.normal(0, 0.15, (n, 16, 4)), 0, 1)
    b[:k] = b[:k, :1]  # flat
    b[: k // 3] = rng.choice([0.0, 1.0], size=(k // 3, 1, 4))  # flat at the ends
    b[k : 2 * k] = b[k : 2 * k, :1] + rng.normal(0, 0.004, (k, 16, 4))  # near flat
    b[2 * k : 3 * k] = rng.choice([-0.3, 0.0, 1.0, 1.4], size=(k, 16, 4))  # past the ends
    b[3 * k : 4 * k] = rng.random((k, 16, 4))  # noisy, wide
    b[..., 3] = np.clip(np.round(b[..., 3] * 255), 0, 255) / 255
    if signed:
        b[..., :3] = b[..., :3] * 2 - 1
    ties = _R11_TIES[signed]
    for i, row in enumerate(ties):
        x = np.array([r11_input(v, signed) for v in row], np.float32)
        b[n - len(ties) + i, :, 0] = x
        b[n - len(ties) + i, :, 1] = x[::-1]
    return b.astype(np.float32)


def eac_input(kind, blocks, nch):
    """An EAC entry's input from [n,16,4] blocks: red (R11), alpha (A8) or
    the first nch channels (RG11)."""
    if kind.startswith("rg11"):
        return blocks[..., :nch]
    return blocks[..., 3] if kind == "a8" else blocks[..., 0]


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


# (format, quality, weights, channels; RG11's input channels)
_CASES = {
    "etc1_q0": ("etc1", 0, ONE, 4), "etc1_q1": ("etc1", 1, ONE, 3),
    "etc1_q2": ("etc1", 2, ONE, 4), "etc1_q4": ("etc1", 4, ONE, 4),
    "etc2_q2": ("etc2", 2, ONE, 4), "etc2_q4": ("etc2", 4, ONE, 3),
    "etc2_q2_srgb": ("etc2", 2, SRGB, 4), "etc2_q4_srgb": ("etc2", 4, SRGB, 4),
    "rgba_q2": ("rgba", 2, ONE, 4), "rgba_q4": ("rgba", 4, SRGB, 4),
}
_EAC = ("r11", "r11s", "rg11", "rg11s", "a8")
for _q in (0, 2, 4):
    for _kind in ("r11", "r11s", "rg11", "rg11s"):
        _CASES[f"{_kind}_q{_q}"] = (_kind, _q, ONE, 4)
_CASES.update({"a8_q2": ("a8", 2, ONE, 4), "a8_q4": ("a8", 4, ONE, 4),
               "rg11_q2_3ch": ("rg11", 2, ONE, 3)})  # RG11 staged a float at a time


def case_input(kind, nch):
    if kind in _EAC:
        return eac_input(kind, eac_blocks(kind.endswith("s")), nch)
    return device_blocks()[..., :nch]


@pytest.mark.parametrize("case", list(_CASES))
def test_device_code_equals_plain_version(device_code, case):
    kind, q, chw, nch = _CASES[case]
    b = case_input(kind, nch)
    got = device_words(device_code, b, q, kind, chw)
    want = plain_words(b, q, kind, chw)
    assert got.dtype == want.dtype == np.uint32 and got.shape == want.shape
    assert np.array_equal(got, want), np.where(~np.all(got == want, axis=1))[0][:10]


def test_blocks_reach_every_etc2_mode(device_code):
    """The blocks above make every ETC2 mode win somewhere at q4 and q2,
    so the equality covers planar, T and H as well as ETC1's two modes."""
    b = device_blocks()
    for q in (2, 4):
        modes = set(etc2_mode(device_words(device_code, b, q, "etc2")))
        assert modes == {"individual", "differential", "T", "H", "planar"}, (q, modes)


def eac_ties_and_seeds(blocks, quality, kind, words):
    """(texels whose least square against the chosen palette is reached by
    two entries, the multiplier seeds of every block and table) of R11 (red)
    or A8 blocks and their words."""
    mods = np.asarray(etc._EAC_MODS_NP, np.float32)
    hi = words[:, 0].byteswap().astype(np.int64)
    base, mult, table = hi >> 24, ((hi >> 20) & 15).astype(np.float32), (hi >> 16) & 15
    if kind == "a8":
        v = np.clip(blocks, 0, 1).astype(np.float32) * np.float32(255)
        pal = np.clip(base[:, None].astype(np.float32) + mods[table] * mult[:, None], 0, 255)
    else:
        signed = kind == "r11s"
        lo, scale = (-1.0, 1023.0) if signed else (0.0, 2047.0)
        v = (np.clip(blocks, lo, 1).astype(np.float32) * np.float32(scale)) * np.float32(0.125)
        base = np.where(base > 127, base - 256, base) if signed else base
        base_v = base.astype(np.float32) * 8 + (0 if signed else 4)
        pal = np.clip(base_v[:, None] + mods[table] * (mult[:, None] * 8), lo * 1023 if signed
                      else 0, 1023 if signed else 2047).astype(np.float32) * np.float32(0.125)
    sq = np.square((v[:, :, None] - pal[:, None, :]).astype(np.float32))
    ties = int(((sq == sq.min(axis=2, keepdims=True)).sum(axis=2) >= 2).sum())
    span = (v.max(axis=1) - v.min(axis=1)) * np.float32(0.5)
    inv = np.float32(1) / mods[:, 7]
    return ties, np.clip(np.rint(span[:, None] * inv[None, :]), 1, 15)


@pytest.mark.parametrize("kind", ["r11", "r11s", "a8"])
def test_eac_blocks_reach_ties_and_repeats(device_code, kind):
    """The EAC blocks above hold texels exactly between two entries of the
    winning palette, and multiplier seeds of 1 and 15, where q2's three
    candidates repeat a multiplier; so the equality covers the indices'
    first-minimum rule and the skipped repeats."""
    b = eac_input(kind, eac_blocks(kind == "r11s"), 4)
    ties, seeds = eac_ties_and_seeds(b, 2, kind, device_words(device_code, b, 2, kind))
    assert ties >= 2, ties
    assert (seeds == 1).any() and (seeds == 15).any()


_COUNTED = [c for c, v in _CASES.items() if v[0] not in _EAC] + ["r11_q2", "rg11_q2", "a8_q2"]
# Float operations a block of the EAC entries at q2 when every candidate is
# evaluated in full (A8: its clamp and scale, 3 a value, and eac_ops(2);
# R11 adds its / 8 of each candidate's eight palette entries and the
# winner's, and 18 in its seed and base; RG11 twice R11's): what the
# entries need, their exits taken, stays below.
_EAC_MOST = {"r11_q2": 11006, "rg11_q2": 22012, "a8_q2": 10596}


@pytest.mark.parametrize("case", _COUNTED)
def test_bound_counts_the_device_codes_operations(counting_code, device_code, case):
    """The needed float operations that bound PERF rows 11-12 are within 2 %
    of what the device code does on noisy blocks (where no difference is 0,
    which the counting float would not count), products by the channel
    weights counted only where a weight is not 1, and the EAC search's side
    of the base once a texel.  EAC (rows 9, 10, 13): what the entries need
    on those blocks (their exits taken) stays below every candidate in
    full.  The counting build's words are the plain-float build's."""
    kind, q, chw, nch = _CASES[case]
    rng = np.random.default_rng(5)
    if kind in _EAC:
        b = eac_input(kind, (0.3 + 0.4 * rng.random((130, 16, 4))).astype(np.float32), nch)
    else:
        b = rng.random((130, 16, 4)).astype(np.float32)[..., :nch]
    words, ops = run_device(counting_code, b, q, kind, chw)
    assert np.array_equal(words, device_words(device_code, b, q, kind, chw))
    if kind in _EAC:
        assert ops / b.shape[0] < _EAC_MOST[case], ops / b.shape[0]
        return
    rgb = chip_smoke.etc_rgb_ops(q, kind != "etc1", chw != ONE)
    need = 3 * 64 + chip_smoke.eac_ops(q) + rgb if kind == "rgba" else 3 * 48 + rgb
    assert abs(ops / b.shape[0] / need - 1) <= 0.02, (ops / b.shape[0], need)
