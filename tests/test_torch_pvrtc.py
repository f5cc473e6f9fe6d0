"""PVRTC1/PVRTC2 of the port against the JAX package, which encodes them
with one jitted XLA program per surface and no TPU kernel
(``cuttlefish_tpu/kernels/pvrtc.py:_encode_pvrtc``).

- Words bit for bit at quality 0 (no refinement), PVRTC1 and PVRTC2 at
  4bpp and 2bpp, on a square and a non-square power-of-two surface whose
  thirds are opaque, translucent and hard-alpha content, and (PVRTC2) a
  block-scale checkerboard with holes (hard-transition and punch-through
  flags).
- Quality 1-4 on the square surface (every variant at 2, two at 1, 3 and
  4): the decoded PSNR against the source within 0.05 dB of the JAX
  package's (the words are identical there as well; the share is asserted
  >= 99 % and printed).
- The port's decoder against ``decode_pvrtc1``/``decode_pvrtc2`` on the
  JAX package's own words: max |delta| <= 1e-6.
- Every case of ``tests/test_pvrtc.py`` on the port, with its bars.

The reference runs in a child interpreter under the XLA flags of
``tests/test_torch_etc_slice.py`` (XLA's algebraic simplifier and FMA
contraction off), jitted as a user runs it: 1-8 s a compile, about 40 s
for its 22 programs on an idle CPU.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cuttlefish_tpu.decode.pvrtc import decode_pvrtc1 as ref_decode_pvrtc1
from cuttlefish_tpu.decode.pvrtc import decode_pvrtc2 as ref_decode_pvrtc2
from cuttlefish_tpu_torch.convert import EncodeParams, create_converter
from cuttlefish_tpu_torch.decode.pvrtc import decode_pvrtc1, decode_pvrtc2
from cuttlefish_tpu_torch.formats import Quality, TextureFormat, TextureType
from cuttlefish_tpu_torch.kernels.pvrtc import encode_pvrtc1, encode_pvrtc2
from cuttlefish_tpu_torch.kernels.pvrtc_tables import morton_order

_F = TextureFormat
_T = TextureType
_ROOT = Path(__file__).resolve().parent.parent
_REF_XLA_FLAGS = "--xla_disable_hlo_passes=algsimp --xla_cpu_max_isa=AVX"
_VARIANTS = [("1", False), ("1", True), ("2", False), ("2", True)]

_REFERENCE = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from cuttlefish_tpu.kernels import pvrtc

inp = np.load(sys.argv[1])
out = {}
for task in sys.argv[3:]:
    name, ver, bpp2, q = task.split(":")
    enc = pvrtc.encode_pvrtc1 if ver == "1" else pvrtc.encode_pvrtc2
    out[task] = np.asarray(enc(inp[name], bpp2=bpp2 == "1", quality=int(q)))
np.savez(sys.argv[2], **out)
"""


def _psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(1.0 / mse)


def _smooth_surface(h, w, rng):
    arr = rng.random((h, w, 4)).astype(np.float32)
    for _ in range(4):
        arr = (
            arr
            + np.roll(arr, 1, 0)
            + np.roll(arr, -1, 0)
            + np.roll(arr, 1, 1)
            + np.roll(arr, -1, 1)
        ) / 5
    arr[..., 3] = 1.0
    return arr.astype(np.float32)


def _mixed(h, w, seed):
    """Thirds along x: opaque, translucent (an alpha ramp), hard alpha."""
    rng = np.random.default_rng(seed)
    arr = _smooth_surface(h, w, rng)
    third = w // 3
    arr[:, third : 2 * third, 3] = np.linspace(0.15, 0.9, h, dtype=np.float32)[:, None]
    hole = rng.random((h, w - 2 * third)) < 0.3
    arr[:, 2 * third :, 3] = np.where(hole, 0.0, 1.0)
    return arr


def _checker(n=64):
    """Block-scale two-colour checkerboard with two transparent holes."""
    y, x = np.mgrid[0:n, 0:n]
    pick = ((y // 4) + (x // 4)) % 2
    c0 = np.asarray([0.95, 0.1, 0.1, 1.0], np.float32)
    c1 = np.asarray([0.05, 0.2, 0.9, 1.0], np.float32)
    arr = np.where(pick[..., None] == 0, c0, c1).astype(np.float32)
    arr[8:12, 8:12, 3] = 0.0
    arr[40:44, 16:20, 3] = 0.0
    return arr


def _surfaces():
    return {"square": _mixed(32, 32, 5), "wide": _mixed(16, 64, 6), "checker": _checker()}


def _encode(ver, surface, bpp2, quality):
    enc = encode_pvrtc1 if ver == "1" else encode_pvrtc2
    return enc(torch.from_numpy(surface), bpp2=bpp2, quality=quality).numpy().astype(np.uint32)


def _raw(words):
    return np.ascontiguousarray(np.asarray(words).astype("<u4")).view(np.uint8)


# (quality, variants) held to the decoded-PSNR bar on the square surface:
# every variant at Normal, two at each other refining quality, so that each
# variant runs at two of q1, q3 and q4 (a compile takes 1-8 s, q4 the
# longest).
_REFINED = [
    (1, [("1", False), ("2", True)]),
    (2, _VARIANTS),
    (3, [("1", True), ("2", False)]),
    (4, [("1", False), ("2", True)]),
]
# PVRTC2's hard flags come with the checkerboard.
_Q0 = [("square", v) for v in _VARIANTS] + [("wide", v) for v in _VARIANTS] + [
    ("checker", ("2", False)), ("checker", ("2", True))]


def _tasks():
    pairs = [(name, ver, bpp2, 0) for name, (ver, bpp2) in _Q0]
    pairs += [("square", ver, bpp2, q) for q, variants in _REFINED for ver, bpp2 in variants]
    return [f"{name}:{ver}:{int(bpp2)}:{q}" for name, ver, bpp2, q in pairs]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pvrtc_ref")
    np.savez(tmp / "in.npz", **_surfaces())
    env = dict(os.environ)
    env.update(XLA_FLAGS=_REF_XLA_FLAGS, JAX_PLATFORMS="cpu")
    env.pop("CUTTLEFISH_PALLAS", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    )
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(tmp / "in.npz"), str(tmp / "out.npz"), *_tasks()],
        cwd=_ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("name,variant", _Q0)
def test_words_at_q0_equal_the_jax_package(reference, name, variant):
    ver, bpp2 = variant
    want = reference[f"{name}:{ver}:{int(bpp2)}:0"]
    got = _encode(ver, _surfaces()[name], bpp2, 0)
    assert got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("quality,variants", _REFINED)
def test_psnr_at_q1_to_q4_within_005_db(reference, quality, variants):
    name = "square"
    surface = _surfaces()[name]
    h, w = surface.shape[:2]
    for ver, bpp2 in variants:
        want = reference[f"{name}:{ver}:{int(bpp2)}:{quality}"]
        got = _encode(ver, surface, bpp2, quality)
        dec = decode_pvrtc1 if ver == "1" else decode_pvrtc2
        p_ref = _psnr(dec(_raw(want), w, h, bpp2=bpp2), surface)
        p_port = _psnr(dec(_raw(got), w, h, bpp2=bpp2), surface)
        same = np.all(got == want, axis=1).mean()
        print(f"{name} PVRTC{ver} bpp2={bpp2} q{quality}: identical {same:.4f}, "
              f"PSNR {p_port:.4f} vs {p_ref:.4f}")
        assert abs(p_port - p_ref) <= 0.05, (ver, bpp2, p_port, p_ref)
        assert same >= 0.99


@pytest.mark.parametrize("name,variant", _Q0)
def test_decoder_equals_the_jax_decoder(reference, name, variant):
    ver, bpp2 = variant
    surface = _surfaces()[name]
    h, w = surface.shape[:2]
    words = reference[f"{name}:{ver}:{int(bpp2)}:0"]
    if name == "checker" and ver == "2" and not bpp2:
        assert ((words[:, 1] >> 15) & 1).any()  # hard flags in the words
    raw = _raw(words)
    ours = (decode_pvrtc1 if ver == "1" else decode_pvrtc2)(raw, w, h, bpp2=bpp2)
    theirs = (ref_decode_pvrtc1 if ver == "1" else ref_decode_pvrtc2)(raw, w, h, bpp2=bpp2)
    assert ours.dtype == np.float32 and ours.shape == theirs.shape == (h, w, 4)
    assert np.abs(ours - theirs).max() <= 1e-6


# ---------------------------------------------------------------------------
# tests/test_pvrtc.py on the port
# ---------------------------------------------------------------------------


class TestMorton:
    def test_square_pow2(self):
        perm = morton_order(4, 4)
        assert sorted(perm) == list(range(16))
        assert perm[0] == 0
        assert perm[1] in (1, 4)

    def test_nonsquare(self):
        perm = morton_order(8, 2)
        assert sorted(perm) == list(range(16))


class TestPvrtc1:
    def test_solid(self):
        surf = np.tile(np.array([0.3, 0.5, 0.8, 1.0], np.float32), (16, 16, 1))
        dec = decode_pvrtc1(_raw(_encode("1", surf, False, 2)), 16, 16)
        assert np.abs(dec[..., :3] - surf[..., :3]).max() < 0.03

    def test_smooth_quality(self):
        surf = _smooth_surface(32, 32, np.random.default_rng(1))
        dec = decode_pvrtc1(_raw(_encode("1", surf, False, 2)), 32, 32)
        assert _psnr(dec[..., :3], surf[..., :3]) > 30

    def test_2bpp(self):
        surf = _smooth_surface(32, 32, np.random.default_rng(2))
        words = _encode("1", surf, True, 2)
        assert words.shape == (4 * 8, 2)
        dec = decode_pvrtc1(_raw(words), 32, 32, bpp2=True)
        assert _psnr(dec[..., :3], surf[..., :3]) > 24

    def test_refinement_helps(self):
        surf = _smooth_surface(32, 32, np.random.default_rng(3))
        errs = []
        for q in (0, 2, 4):
            dec = decode_pvrtc1(_raw(_encode("1", surf, False, q)), 32, 32)
            errs.append(np.mean((dec[..., :3] - surf[..., :3]) ** 2))
        assert errs[1] <= errs[0] + 1e-9
        assert errs[2] <= errs[1] + 1e-9
        assert errs[2] < 0.64 * errs[0]


class TestPipeline:
    @pytest.mark.parametrize(
        "fmt,bpp2",
        [
            (_F.PVRTC1_RGB_4BPP, False),
            (_F.PVRTC1_RGBA_4BPP, False),
            (_F.PVRTC1_RGB_2BPP, True),
            (_F.PVRTC1_RGBA_2BPP, True),
        ],
    )
    def test_converter(self, fmt, bpp2):
        conv = create_converter(fmt, _T.UNorm, "cpu")
        surface = _smooth_surface(32, 32, np.random.default_rng(4))
        data = conv.encode(surface, EncodeParams(quality=Quality.Low))
        assert len(data) == (32 * 32 * (2 if bpp2 else 4)) // 8

    def test_npot_rejected(self):
        conv = create_converter(_F.PVRTC1_RGB_4BPP, _T.UNorm, "cpu")
        with pytest.raises(ValueError):
            conv.encode(np.zeros((20, 24, 4), np.float32), EncodeParams())

    @pytest.mark.parametrize("fmt,bpp2", [(_F.PVRTC2_RGBA_4BPP, False), (_F.PVRTC2_RGBA_2BPP, True)])
    def test_pvrtc2_converter(self, fmt, bpp2):
        conv = create_converter(fmt, _T.UNorm, "cpu")
        surface = _smooth_surface(32, 32, np.random.default_rng(7))
        data = conv.encode(surface, EncodeParams(quality=Quality.Normal))
        assert len(data) == (32 * 32 * (2 if bpp2 else 4)) // 8
        words = np.frombuffer(bytes(data), np.uint8).reshape(-1, 8)
        inv = np.argsort(morton_order(32 // (8 if bpp2 else 4), 32 // 4))
        dec = decode_pvrtc2(words[inv].reshape(-1), 32, 32, bpp2=bpp2)
        assert _psnr(dec[..., :3], surface[..., :3]) > (24 if bpp2 else 28)

    def test_pvrtc2_flag_bits(self):
        opaque = _smooth_surface(32, 32, np.random.default_rng(3))
        opaque[..., 3] = 1.0
        cw = _encode("2", opaque, False, 2)[:, 1].astype(np.uint64)
        assert np.all((cw >> 31) & 1 == 1)
        trans = opaque.copy()
        trans[..., 3] = 0.5
        cw = _encode("2", trans, False, 2)[:, 1].astype(np.uint64)
        assert np.all((cw >> 31) & 1 == 0)

    def test_pvrtc2_translucent_roundtrip(self):
        surf = _smooth_surface(32, 32, np.random.default_rng(9))
        surf[..., 3] = np.linspace(0.2, 1.0, 32)[None, :]
        dec = decode_pvrtc2(_raw(_encode("2", surf, False, 2)), 32, 32)
        assert _psnr(dec, surf) > 24

    def test_pvrtc2_border_no_wrap(self):
        surf = np.zeros((32, 32, 4), np.float32)
        surf[..., 3] = 1.0
        surf[:, :4, :3] = 1.0
        dec = decode_pvrtc2(_raw(_encode("2", surf, False, 2)), 32, 32)
        assert dec[:, -2:, :3].max() < 0.25
        dec1 = decode_pvrtc1(_raw(_encode("1", surf, False, 2)), 32, 32)
        assert dec1[:, -2:, :3].max() > dec[:, -2:, :3].max()


class TestPunchThrough:
    def test_punch_alpha_mask(self):
        rng = np.random.default_rng(8)
        surf = _smooth_surface(32, 32, rng)
        hole = rng.random((32, 32)) < 0.3
        surf[hole, 3] = 0.0
        words = _encode("1", surf, False, 2)
        assert (words[:, 1] & 1).any()
        dec = decode_pvrtc1(_raw(words), 32, 32)
        assert dec[..., 3][hole].max() < 0.25
        assert np.median(dec[..., 3][hole]) == 0.0
        assert dec[..., 3][~hole].min() > 0.4

    def test_opaque_content_never_punched(self):
        surf = _smooth_surface(32, 32, np.random.default_rng(9))
        dec = decode_pvrtc1(_raw(_encode("1", surf, False, 2)), 32, 32)
        assert np.abs(dec[..., 3] - 1.0).max() < 1e-6


class TestAlpha:
    def test_translucent_endpoints(self):
        surf = _smooth_surface(32, 32, np.random.default_rng(5))
        surf[..., 3] = np.linspace(0.1, 0.9, 32, dtype=np.float32)[None, :]
        dec = decode_pvrtc1(_raw(_encode("1", surf, False, 2)), 32, 32)
        assert _psnr(dec[..., 3], surf[..., 3]) > 18
        assert _psnr(dec[..., :3], surf[..., :3]) > 26

    def test_opaque_stays_exact_alpha(self):
        surf = _smooth_surface(16, 16, np.random.default_rng(6))
        dec = decode_pvrtc1(_raw(_encode("1", surf, False, 1)), 16, 16)
        assert np.abs(dec[..., 3] - 1.0).max() < 1e-6


class TestPvrtc2Hard:
    @staticmethod
    def _checker(n=64):
        y, x = np.mgrid[0:n, 0:n]
        pick = ((y // 4) + (x // 4)) % 2
        c0 = np.asarray([0.95, 0.1, 0.1, 1.0], np.float32)
        c1 = np.asarray([0.05, 0.2, 0.9, 1.0], np.float32)
        return np.where(pick[..., None] == 0, c0, c1).astype(np.float32)

    def test_hard_flags_emitted_and_win(self):
        surf = self._checker()
        words = _encode("2", surf, False, 2)
        assert ((words[:, 1] >> 15) & 1).any()
        p_hard = _psnr(decode_pvrtc2(_raw(words), 64, 64), surf)
        soft = words.copy()
        soft[:, 1] &= ~np.uint32(1 << 15)
        p_soft = _psnr(decode_pvrtc2(_raw(soft), 64, 64), surf)
        assert p_hard > p_soft + 3.0, (p_hard, p_soft)

    def test_hard_never_with_punch(self):
        surf = self._checker()
        surf[8:12, 8:12, 3] = 0.0
        surf[40:44, 16:20, 3] = 0.0
        cw = _encode("2", surf, False, 2)[:, 1].reshape(16, 16)
        hard = ((cw >> 15) & 1).astype(bool)
        punch = (cw & 1).astype(bool)
        pr = np.pad(punch, ((1, 0), (1, 0)), mode="edge")
        cover = pr[:-1, :-1] | pr[:-1, 1:] | pr[1:, :-1] | pr[1:, 1:]
        assert not (hard & cover).any()

    def test_ladder_monotone_on_checker(self):
        surf = self._checker()
        ps = [_psnr(decode_pvrtc2(_raw(_encode("2", surf, False, q)), 64, 64), surf)
              for q in (0, 2, 4)]
        assert ps[0] <= ps[1] + 1e-6 and ps[1] <= ps[2] + 1e-6, ps


class TestHandDecodedFixtures:
    @staticmethod
    def _surface(cw: int, mod: int, n: int = 4):
        words = np.zeros((n, 2), np.uint32)
        words[:, 0] = mod
        words[:, 1] = cw
        return np.ascontiguousarray(words).view(np.uint8).reshape(-1)

    def test_opaque_block_modulation_ladder(self):
        field_a = (1 << 15) | (10 << 10) | (20 << 5) | (5 << 1)
        field_b = (1 << 15) | (31 << 10) | (0 << 5) | 16
        cw = (field_b << 16) | field_a
        dec = decode_pvrtc1(self._surface(cw, 0xE4E4E4E4), 8, 8)
        a = np.array([82, 165, 82, 255], np.float64)
        b = np.array([255, 0, 132, 255], np.float64)
        for k, w in enumerate((0, 3, 5, 8)):
            want = ((a * (8 - w) + b * w) / 8.0 / 255.0).astype(np.float32)
            assert np.allclose(dec[0, k], want, atol=1e-6), (k, dec[0, k], want)

    def test_translucent_color_a_expansion(self):
        field_a = (2 << 12) | (15 << 8) | (0 << 4) | (4 << 1)
        field_b = (1 << 15) | (31 << 10) | (0 << 5) | 16
        cw = (field_b << 16) | field_a
        dec = decode_pvrtc1(self._surface(cw, 0), 8, 8)
        want = np.array([255, 0, 153, 68], np.float64) / 255.0
        assert np.allclose(dec[0, 0], want, atol=1e-6), dec[0, 0]

    def test_punch_through_modulation(self):
        field_a = (1 << 15) | (10 << 10) | (20 << 5) | (5 << 1) | 1
        field_b = (1 << 15) | (31 << 10) | (0 << 5) | 16
        cw = (field_b << 16) | field_a
        dec = decode_pvrtc1(self._surface(cw, 0xE4E4E4E4), 8, 8)
        a = np.array([82, 165, 82, 255], np.float64)
        b = np.array([255, 0, 132, 255], np.float64)
        half = (a + b) / 2.0 / 255.0
        assert np.allclose(dec[0, 1], half, atol=1e-6), dec[0, 1]
        want2 = half.copy()
        want2[3] = 0.0
        assert np.allclose(dec[0, 2], want2, atol=1e-6), dec[0, 2]
