"""The ASTC HDR profile of the port (``kernels/astc_hdr.py``) against the
JAX package, which encodes it on its ``jnp`` path only
(``cuttlefish_tpu/kernels/astc.py:encode_astc_hdr``; no TPU kernel).

- Words bit for bit, the ASTC family's bar (``tests/test_pallas.py:
  102-129``), at 4x4, 6x6 and 8x8 and quality 0, 2 and 4, on HDR blocks
  (values from 2^-16 to 2^9, a sixth of them half denormals), solid blocks
  (the HDR void extent) and blocks with LDR alpha below 1 (CEM 14).
- An ASTC_6x6 UFloat + mips KTX file from the port's ``Texture`` equal to
  the JAX package's byte for byte, read back through ``load_texture`` and
  decoded; the same through the fused mip pipeline (``convert_with_mips``).
- The reference's own HDR cases on the port, with their bars:
  ``tests/test_astc.py:316-375`` and ``tests/test_cpu_reference.py:
  384-389`` (against the JAX package's native astcenc-class HDR encoder).

The reference runs in a child interpreter under the XLA flags of
``tests/test_torch_etc_slice.py`` (XLA's algebraic simplifier and FMA
contraction off), jitted as a user runs it: 2-5 s a compile on a CPU.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import cuttlefish_tpu_torch as cp
from cuttlefish_tpu import native
from cuttlefish_tpu_torch.convert import create_converter
from cuttlefish_tpu_torch.decode.astc import decode_astc_hdr
from cuttlefish_tpu_torch.kernels.astc_hdr import encode_astc_hdr

_ROOT = Path(__file__).resolve().parent.parent
_REF_XLA_FLAGS = "--xla_disable_hlo_passes=algsimp --xla_cpu_max_isa=AVX"
_SIZES = [(4, 4), (6, 6), (8, 8)]
_QUALITIES = [0, 2, 4]
_H, _W = 24, 40
TIE_DB = 0.05  # tests/test_cpu_reference.py's tie tolerance

_REFERENCE = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import cuttlefish_tpu as ct
from cuttlefish_tpu.kernels import astc

inp = np.load(sys.argv[1])
out = {}
for task in sys.argv[3:]:
    if task == "ktx":
        src = inp["image"]
        tex = ct.Texture(ct.Dimension.Dim2D, src.shape[1], src.shape[0], mip_levels=99)
        assert tex.set_image(ct.Image.from_array(src, ct.ImageFormat.RGBAF))
        assert tex.generate_mipmaps()
        assert tex.convert(ct.TextureFormat.ASTC_6x6, ct.TextureType.UFloat, ct.Quality.Normal)
        res, data = tex.save_to_bytes(ct.FileType.KTX)
        assert res is ct.SaveResult.Success
        out[task] = np.frombuffer(data, np.uint8)
        continue
    if task == "fused":
        src = inp["image"]
        tex = ct.Texture(ct.Dimension.Dim2D, src.shape[1], src.shape[0])
        assert tex.set_image(ct.Image.from_array(src, ct.ImageFormat.RGBAF))
        assert tex.convert_with_mips(ct.TextureFormat.ASTC_6x6, ct.TextureType.UFloat)
        res, data = tex.save_to_bytes(ct.FileType.KTX)
        assert res is ct.SaveResult.Success
        out[task] = np.frombuffer(data, np.uint8)
        continue
    bw, bh, q = (int(v) for v in task.split(":"))
    out[task] = np.asarray(astc.encode_astc_hdr(inp[f"b{bw}x{bh}"], bw, bh, quality=q))
np.savez(sys.argv[2], **out)
"""


def _bytes(words):
    return np.ascontiguousarray(np.asarray(words).astype("<u4")).view(np.uint8)


def _half_values(halfs):
    return np.asarray(halfs).astype(np.uint16).view(np.float16).astype(np.float64)


def block_set(bw, bh, n=48, seed=3):
    """[3n, T, 4] float32 blocks on the f16 wire: HDR (a sixth of them half
    denormals), solid (void extent) and LDR alpha below 1 (CEM 14)."""
    rng = np.random.default_rng(seed)
    t = bw * bh
    rgb = (rng.random((n, t, 3)).astype(np.float32) + 0.05) * (
        2.0 ** rng.integers(-16, 9, (n, 1, 1))
    ).astype(np.float32)
    rgb = (rgb + np.roll(rgb, 1, 1)) / 2
    rgb[: n // 6] *= np.float32(2.0**-14)
    hdr = np.concatenate([rgb, np.ones((n, t, 1), np.float32)], -1)
    solid = np.repeat(hdr[:, :1], t, 1)
    solid[n // 2 :, :, :3] = rng.random((n - n // 2, 1, 3)).astype(np.float32) * 7
    alpha = hdr.copy()
    alpha[..., 3] = rng.random((n, t)).astype(np.float32)
    out = np.concatenate([hdr, solid, alpha]).astype(np.float32)
    return out.astype(np.float16).astype(np.float32)


def image():
    """A 40x24 HDR source (values up to 48) with LDR alpha."""
    rng = np.random.default_rng(21)
    y, x = np.mgrid[0:_H, 0:_W].astype(np.float32)
    rgb = np.stack([np.sin(x / 6.0), np.cos(y / 4.0), np.sin((x + y) / 8.0)], -1) * 0.5 + 0.6
    rgb = rgb * (2.0 ** (x / 8.0))[..., None] + rng.random((_H, _W, 3)) * 0.05
    a = np.clip(0.5 + 0.4 * np.sin(y / 3.0) + rng.normal(0, 0.05, (_H, _W)), 0, 1)
    return np.concatenate([rgb, a[..., None]], -1).astype(np.float32)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("astc_hdr_ref")
    np.savez(
        tmp / "in.npz",
        image=image(),
        **{f"b{bw}x{bh}": block_set(bw, bh) for bw, bh in _SIZES},
    )
    tasks = [f"{bw}:{bh}:{q}" for bw, bh in _SIZES for q in _QUALITIES] + ["ktx", "fused"]
    env = dict(os.environ)
    env.update(XLA_FLAGS=_REF_XLA_FLAGS, JAX_PLATFORMS="cpu")
    env.pop("CUTTLEFISH_PALLAS", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    )
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(tmp / "in.npz"), str(tmp / "out.npz"), *tasks],
        cwd=_ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("quality", _QUALITIES)
@pytest.mark.parametrize("bw,bh", _SIZES)
def test_words_equal_the_jax_package(reference, bw, bh, quality):
    blocks = block_set(bw, bh)
    got = encode_astc_hdr(torch.from_numpy(blocks), bw, bh, quality=quality)
    assert got.dtype == torch.uint32
    got = got.numpy().astype(np.uint32)
    want = reference[f"{bw}:{bh}:{quality}"]
    assert got.shape == want.shape == (blocks.shape[0], 4)
    assert np.array_equal(got, want)
    # All three candidates won somewhere: the void extent, CEM 11, CEM 14.
    mode = got[:, 0] & 0x1FF
    cem = (got[:, 0] >> 13) & 0xF
    assert (mode == 0x1FC).any() and (cem == 11).any() and (cem == 14).any()


def test_ktx_file_equals_the_jax_package(reference, tmp_path):
    src = image()
    tex = cp.Texture(cp.Dimension.Dim2D, _W, _H, mip_levels=99, device="cpu")
    assert tex.set_image(cp.Image.from_array(src, cp.ImageFormat.RGBAF))
    assert tex.generate_mipmaps()
    assert tex.convert(cp.TextureFormat.ASTC_6x6, cp.TextureType.UFloat, cp.Quality.Normal)
    assert tex.last_convert_stats["launches"] == {}
    res, data = tex.save_to_bytes(cp.FileType.KTX)
    assert res is cp.SaveResult.Success
    assert data == reference["ktx"].tobytes()
    path = tmp_path / "hdr.ktx"
    path.write_bytes(data)
    back = cp.load_texture(str(path))
    # KTX1 names ASTC blocks alike for both profiles: the loader reads UNorm,
    # as the JAX package's does, so the texture in memory decodes the HDR.
    assert back.format is cp.TextureFormat.ASTC_6x6
    assert all(back.data(mip_level=m) == tex.data(mip_level=m) for m in range(tex.mip_levels))
    dec = tex.decode_image().rgbaf()
    assert dec.shape == src.shape
    logerr = np.abs(np.log2(np.maximum(dec[..., :3], 1e-6)) - np.log2(src[..., :3]))
    assert np.median(logerr) < 0.3


def test_fused_mips_equal_the_jax_package(reference, monkeypatch):
    """``convert_with_mips(ASTC_6x6, UFloat)``: the fused pyramid into the
    HDR encoder with no host scan of level 0, against the JAX package's
    fused KTX file."""
    import cuttlefish_tpu_torch.convert.device as device

    def no_host_tiling(*args, **kwargs):
        raise AssertionError("the HDR profile has no content scan to tile level 0 for")

    monkeypatch.setattr(device, "extract_blocks", no_host_tiling)
    src = image()
    tex = cp.Texture(cp.Dimension.Dim2D, _W, _H, device="cpu")
    assert tex.set_image(cp.Image.from_array(src, cp.ImageFormat.RGBAF))
    assert tex.convert_with_mips(cp.TextureFormat.ASTC_6x6, cp.TextureType.UFloat)
    stats = tex.last_convert_stats
    assert stats["launches"] == {}
    ref = cp.load_texture(reference["fused"].tobytes())
    assert ref.format is cp.TextureFormat.ASTC_6x6 and ref.mip_levels == tex.mip_levels == 6
    for m in range(tex.mip_levels):
        a = np.frombuffer(tex.data(mip_level=m), np.uint8).reshape(-1, 16)
        b = np.frombuffer(ref.data(mip_level=m), np.uint8).reshape(-1, 16)
        assert a.shape == b.shape, m
    res, data = tex.save_to_bytes(cp.FileType.KTX)
    assert res is cp.SaveResult.Success
    assert data == reference["fused"].tobytes()


# ---------------------------------------------------------------------------
# tests/test_astc.py:316-375 on the port
# ---------------------------------------------------------------------------


def test_hdr_converter_exists():
    assert create_converter(cp.TextureFormat.ASTC_4x4, cp.TextureType.UFloat, "cpu") is not None


def test_hdr_roundtrip_and_quality():
    rng = np.random.default_rng(11)
    n = 32
    rgb = (rng.random((n, 16, 3)).astype(np.float32) + 0.1) * (
        2.0 ** rng.integers(-3, 6, (n, 1, 1))
    )
    blocks = np.concatenate([rgb, np.ones((n, 16, 1), np.float32)], -1)
    blocks = ((blocks + np.roll(blocks, 1, 1)) / 2).astype(np.float32)
    words = encode_astc_hdr(torch.from_numpy(blocks), 4, 4, quality=2)
    vals = _half_values(decode_astc_hdr(_bytes(words.numpy()), 4, 4))
    assert np.all(vals[..., 3] == 1.0)
    logerr = np.abs(
        np.log2(np.maximum(vals[..., :3], 1e-6)) - np.log2(np.maximum(blocks[..., :3], 1e-6))
    )
    assert np.median(logerr) < 0.3


def test_hdr_solid_block_void_extent():
    blocks = np.full((4, 16, 4), 5.25, np.float32)
    blocks[..., 3] = 1.0
    words = encode_astc_hdr(torch.from_numpy(blocks), 4, 4, quality=2)
    vals = _half_values(decode_astc_hdr(_bytes(words.numpy()), 4, 4))
    assert np.all(vals[..., :3] == 5.25)


def test_hdr_alpha_cem14():
    rng = np.random.default_rng(12)
    n = 32
    blocks = np.concatenate(
        [rng.random((n, 16, 3)).astype(np.float32) * 4.0, rng.random((n, 16, 1)).astype(np.float32)],
        -1,
    ).astype(np.float32)
    words = encode_astc_hdr(torch.from_numpy(blocks), 4, 4, quality=2)
    vals = _half_values(decode_astc_hdr(_bytes(words.numpy()), 4, 4))
    amse = ((vals[..., 3] - blocks[..., 3]) ** 2).mean()
    assert 10 * np.log10(1.0 / amse) > 20.0


# ---------------------------------------------------------------------------
# tests/test_cpu_reference.py:TestAstcHdrVsCpuReference on the port
# ---------------------------------------------------------------------------


def _content(name, n=256):
    rng = np.random.default_rng(13)
    if name == "lerp":
        c0 = rng.random((n, 1, 3), np.float32) * 8
        c1 = rng.random((n, 1, 3), np.float32) * 8
        t = rng.random((n, 16, 1), np.float32)
        rgb = (c0 + (c1 - c0) * t).astype(np.float32)
    else:
        rgb = (rng.random((n, 16, 3)) * 8).astype(np.float32)
    a = np.ones((n, 16, 1), np.float32)
    if name == "alpha":
        a = (0.2 + 0.7 * rng.random((n, 16, 1))).astype(np.float32)
    return np.concatenate([rgb, a], -1)


def _log_psnr(dec16, rgb):
    dec = (
        np.frombuffer(np.ascontiguousarray(dec16[..., :3]).astype("<u2").tobytes(), np.float16)
        .reshape(rgb.shape)
        .astype(np.float64)
    )
    a = np.log2(np.maximum(dec, 1e-6))
    r = np.log2(np.maximum(rgb, 1e-6))
    mse = ((a - r) ** 2).mean()
    span = r.max() - r.min()
    return 10 * np.log10(span * span / max(mse, 1e-12))


@pytest.mark.skipif(not native.available(), reason="native toolchain unavailable")
@pytest.mark.parametrize("content", ["lerp", "noise", "alpha"])
@pytest.mark.parametrize("quality", [2, 4])
def test_astc_hdr_psnr_not_below_cpu_reference(content, quality):
    b = _content(content)
    rgb = b[..., :3]
    wt = encode_astc_hdr(torch.from_numpy(b), 4, 4, quality=quality).numpy()
    p_port = _log_psnr(decode_astc_hdr(_bytes(wt), 4, 4), rgb)
    wc = native.astc_hdr_encode_cpu(b, quality=quality)
    p_cpu = _log_psnr(decode_astc_hdr(wc.reshape(-1), 4, 4), rgb)
    assert p_port >= p_cpu - TIE_DB, (content, quality, p_port, p_cpu)
