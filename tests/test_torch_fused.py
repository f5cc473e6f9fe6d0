"""The fused device mip pipeline of the port (``Texture.convert_with_mips``,
``BlockConverter.encode_pyramid``) on the CPU against the JAX package's
(``cuttlefish_tpu/convert/device.py:_FusedPyramid``, ``_encode_pyramid``,
``texture.py:convert_with_mips``).

Three kinds of case:

- the block batch itself: the port's ``pyramid_blocks`` against
  ``_FusedPyramid(...).fn`` built with a converter whose ``encode_blocks``
  returns its input (no Pallas), within max |d| <= 1e-5;
- the reference's own cases (``tests/test_fused.py``) on the port, with
  the same bars, but ``test_mesh_shard_equivalence`` (multi-device is
  ROADMAP queue 1, item 15) and the fresh-process tracer regression
  (JAX's alone);
- the whole convert: BC3 Low 96x64 -> KTX against the JAX package's, run
  in a child interpreter with ``CUTTLEFISH_PALLAS=1`` and XLA's algebraic
  simplifier and FMA contraction off (``tests/test_torch_astc_slice.py``),
  >= 99 % identical blocks on every level.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import cuttlefish_tpu_torch as cp
from cuttlefish_tpu.convert.device import _FusedPyramid
from cuttlefish_tpu_torch.convert.device import pyramid_blocks
from cuttlefish_tpu_torch.decode import decode_bc3, decode_bc6h, decode_bc7
from cuttlefish_tpu_torch.formats import block_size
from cuttlefish_tpu_torch.packfloat import half_bits_to_f32

F, T, Q = cp.TextureFormat, cp.TextureType, cp.Quality
_ROOT = Path(__file__).resolve().parent.parent
_REF_XLA_FLAGS = "--xla_disable_hlo_passes=algsimp --xla_cpu_max_isa=AVX"
_TOL = 1e-5


def _arr(w, h, seed=0):
    """tests/test_fused.py:_img's array: a random blend of two colours."""
    rng = np.random.default_rng(seed)
    c0 = rng.random((1, 1, 4)).astype(np.float32)
    c1 = rng.random((1, 1, 4)).astype(np.float32)
    t = rng.random((h, w, 1)).astype(np.float32)
    arr = c0 * t + c1 * (1 - t)
    arr[..., 3] = 1.0
    return arr.astype(np.float32)


def _img(w, h, seed=0):
    return cp.Image.from_array(_arr(w, h, seed), cp.ImageFormat.RGBAF)


class _Identity:
    """A converter whose encode is the block batch itself."""

    block_w = 4
    block_h = 4

    def encode_blocks(self, blocks, params):
        return blocks


def _heightfield(w, h, faces):
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for f in range(faces):
        hf = 0.5 + 0.4 * np.sin((x + 3 * f) / 3.0) * np.cos((y - f) / 2.5)
        out.append(np.stack([hf, hf * 0.5, hf, np.ones_like(hf)], -1))
    return np.stack(out).astype(np.float32)


# name -> (level 0 [S,H,W,4], levels, sRGB, normal options)
_PYRAMIDS = {
    "96x64_linear": (_arr(96, 64)[None], 7, False, None),
    "96x64_srgb": (_arr(96, 64)[None], 7, True, None),
    "cube_nm_default_linear": (_heightfield(16, 16, 6), 5, False, (0, 2.0)),
    "cube_nm_default_srgb": (_heightfield(16, 16, 6), 5, True, (0, 2.0)),
    "cube_nm_wrap_linear": (_heightfield(16, 16, 6), 5, False, (2 | 4, 2.0)),
    "cube_nm_wrap_srgb": (_heightfield(16, 16, 6), 5, True, (2 | 4, 2.0)),
    "signed": (_arr(96, 64, seed=7)[None] * 2.0 - 1.0, 7, False, None),
}


@pytest.mark.parametrize("name", list(_PYRAMIDS))
def test_pyramid_matches_reference(name):
    x, levels, srgb, nopts = _PYRAMIDS[name]
    s, h, w, _ = x.shape
    ref = _FusedPyramid(_Identity(), h, w, s, levels, "catmullrom", srgb, None, nopts)
    want = np.asarray(ref.fn(x))[: ref.ntot]
    got = pyramid_blocks(torch.from_numpy(x), levels, "catmullrom", srgb, 4, 4, nopts).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (ref.ntot, 16, 4)
    assert float(np.abs(got - want).max()) <= _TOL
    if name == "signed":
        assert (got < -0.5).any()  # no clamp


def test_matches_host_path_structure_and_quality():
    img = _img(96, 64)
    host = cp.Texture(cp.Dimension.Dim2D, 96, 64, device="cpu")
    host.set_image(img)
    host.generate_mipmaps()
    assert host.convert(F.BC3, T.UNorm, quality=Q.Low)

    fused = cp.Texture(cp.Dimension.Dim2D, 96, 64, device="cpu")
    fused.set_image(img)
    assert fused.convert_with_mips(F.BC3, T.UNorm, quality=Q.Low)
    stats = fused.last_convert_stats
    assert stats["launches"] == {} and stats["bc7_launches"] == 0
    assert set(stats["phases"]) == {
        "upload", "pyramid", "kernel", "fetch", "interleave", "scan", "fused"}
    assert stats["texels"] == sum(max(96 >> k, 1) * max(64 >> k, 1) for k in range(7))

    assert fused.mip_levels == host.mip_levels == 7
    for lvl in range(host.mip_levels):
        a = host.data(mip_level=lvl)
        b = fused.data(mip_level=lvl)
        assert len(a) == len(b)
        da = decode_bc3(np.frombuffer(a, np.uint8))
        db = decode_bc3(np.frombuffer(b, np.uint8))
        assert np.abs(da.astype(int) - db.astype(int)).mean() < 2.0


def test_deterministic():
    img = _img(32, 32, seed=3)
    outs = []
    for _ in range(2):
        t = cp.Texture(cp.Dimension.Dim2D, 32, 32, device="cpu")
        t.set_image(img)
        assert t.convert_with_mips(F.BC1_RGB, T.UNorm, quality=Q.Lowest)
        outs.append(t.save_to_bytes(cp.FileType.DDS)[1])
    assert outs[0] == outs[1]


def test_srgb_cube_astc():
    img = _img(16, 16, seed=5)
    tex = cp.Texture(cp.Dimension.Cube, 16, 16, color_space=cp.ColorSpace.sRGB, device="cpu")
    for face in cp.CubeFace:
        tex.set_image(img, face=face)
    assert tex.convert_with_mips(F.ASTC_4x4, T.UNorm, quality=Q.Lowest)
    assert tex.mip_levels == 5
    for lvl in range(5):
        side = max(16 >> lvl, 1)
        blocks = (-(-side // 4)) ** 2
        for face in cp.CubeFace:
            assert len(tex.data(face, lvl)) == blocks * 16
    res, _ = tex.save_to_bytes(cp.FileType.KTX)
    assert res is cp.SaveResult.Success


def test_array():
    tex = cp.Texture(cp.Dimension.Dim2D, 16, 16, depth=3, device="cpu")
    for d in range(3):
        tex.set_image(_img(16, 16, seed=d), depth=d)
    assert tex.convert_with_mips(F.ETC2_R8G8B8, T.UNorm, quality=Q.Lowest)
    per = 16 * block_size(F.ETC2_R8G8B8)
    assert len(tex.data(depth=2)) == per
    assert tex.data(depth=0) != tex.data(depth=1)


def test_rejections():
    t3 = cp.Texture(cp.Dimension.Dim3D, 8, 8, depth=2, device="cpu")
    for z in range(2):
        t3.set_image(_img(8, 8), depth=z)
    assert not t3.convert_with_mips(F.BC1_RGB, T.UNorm)
    t2 = cp.Texture(cp.Dimension.Dim2D, 8, 8, device="cpu")
    t2.set_image(_img(8, 8))
    assert not t2.convert_with_mips(F.R8G8B8A8, T.UNorm)
    assert not t2.convert_with_mips(F.BC1_RGB, T.SNorm)
    # sRGB without a native sRGB format
    ts = cp.Texture(cp.Dimension.Dim2D, 8, 8, color_space=cp.ColorSpace.sRGB, device="cpu")
    ts.set_image(_img(8, 8))
    assert not ts.convert_with_mips(F.BC4, T.UNorm)
    # missing level-0 image
    t4 = cp.Texture(cp.Dimension.Cube, 8, 8, device="cpu")
    t4.set_image(_img(8, 8), face=cp.CubeFace.PosX)
    assert not t4.convert_with_mips(F.BC1_RGB, T.UNorm)
    # nothing committed by a rejection
    assert t2.format is cp.TextureFormat.Unknown and t2.mip_levels == 1


@pytest.mark.parametrize("srgb", [False, True])
def test_device_normal_map(srgb):
    """convert_with_mips(normal_map=...) equals the host create_normal_map
    + set_image + generate_mipmaps + convert flow (within u8 wire
    quantisation)."""
    y, x = np.mgrid[0:32, 0:48].astype(np.float32)
    hf = (0.5 + 0.4 * np.sin(x / 5) * np.cos(y / 7)).astype(np.float32)
    arr = np.stack([hf, hf, hf, np.ones_like(hf)], -1)
    cs = cp.ColorSpace.sRGB if srgb else cp.ColorSpace.Linear
    opts = cp.NormalOptions.WrapX

    host = cp.Texture(cp.Dimension.Dim2D, 48, 32, color_space=cs, device="cpu")
    img = cp.Image.from_array(arr, cp.ImageFormat.RGBAF)
    host.set_image(img.create_normal_map(opts, height=2.0))
    host.generate_mipmaps()
    assert host.convert(F.BC7, T.UNorm, quality=Q.Low)

    fused = cp.Texture(cp.Dimension.Dim2D, 48, 32, color_space=cs, device="cpu")
    fused.set_image(cp.Image.from_array(arr, cp.ImageFormat.RGBAF))
    assert fused.convert_with_mips(
        F.BC7, T.UNorm, quality=Q.Low, normal_map=opts, normal_height=2.0,
    )
    assert fused.mip_levels == host.mip_levels
    for lvl in range(host.mip_levels):
        a = decode_bc7(np.frombuffer(host.data(mip_level=lvl), np.uint8))
        b = decode_bc7(np.frombuffer(fused.data(mip_level=lvl), np.uint8))
        assert np.abs(a.astype(int) - b.astype(int)).mean() < 2.0


def test_signed_bc6h_negatives_survive_mips():
    """The device mip chain does not clamp: signed BC6H content keeps
    negative values through resampling."""
    rng = np.random.default_rng(9)
    arr = (rng.random((16, 16, 4)).astype(np.float32) - 0.5) * 2.0
    arr[..., 3] = 1.0
    img = cp.Image.from_array(arr, cp.ImageFormat.RGBAF)

    fused = cp.Texture(cp.Dimension.Dim2D, 16, 16, device="cpu")
    fused.set_image(img)
    assert fused.convert_with_mips(F.BC6H, T.Float, quality=Q.Lowest)
    host = cp.Texture(cp.Dimension.Dim2D, 16, 16, device="cpu")
    host.set_image(img)
    host.generate_mipmaps()
    assert host.convert(F.BC6H, T.Float, quality=Q.Lowest)
    for lvl in (1, 2):
        df, dh = (
            half_bits_to_f32(
                decode_bc6h(np.frombuffer(t.data(mip_level=lvl), np.uint8), signed=True)
                .astype(np.uint16)
            )
            for t in (fused, host)
        )
        assert (df < -0.05).any()
        assert np.abs(df - dh).mean() < 0.05


def test_mip_level_cap():
    t = cp.Texture(cp.Dimension.Dim2D, 32, 32, device="cpu")
    t.set_image(_img(32, 32))
    assert t.convert_with_mips(F.BC1_RGB, T.UNorm, mip_levels=3)
    assert t.mip_levels == 3
    res, _ = t.save_to_bytes(cp.FileType.KTX)
    assert res is cp.SaveResult.Success


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    t = cp.Texture(cp.Dimension.Dim2D, 8, 8)
    t.set_image(_img(8, 8))
    with pytest.raises((RuntimeError, AssertionError)):
        t.convert_with_mips(F.BC1_RGB, T.UNorm)
    assert t.format is cp.TextureFormat.Unknown and t.mip_levels == 1


_REFERENCE = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import cuttlefish_tpu as ct

arr = np.load(sys.argv[1])
tex = ct.Texture(ct.Dimension.Dim2D, arr.shape[1], arr.shape[0])
assert tex.set_image(ct.Image.from_array(arr, ct.ImageFormat.RGBAF))
assert tex.convert_with_mips(ct.TextureFormat.BC3, ct.TextureType.UNorm, quality=ct.Quality.Low)
res, data = tex.save_to_bytes(ct.FileType.KTX)
assert res is ct.SaveResult.Success
open(sys.argv[2], "wb").write(data)
"""


def test_whole_convert_matches_jax_package(tmp_path):
    """BC3 Low 96x64 through the fused pipeline -> KTX: the same level
    sizes as the JAX package's file, >= 99 % identical blocks on each."""
    arr = _arr(96, 64)
    np.save(tmp_path / "in.npy", arr)
    env = dict(os.environ)
    env.update(XLA_FLAGS=_REF_XLA_FLAGS, JAX_PLATFORMS="cpu", CUTTLEFISH_PALLAS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    )
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(tmp_path / "in.npy"), str(tmp_path / "out.ktx")],
        cwd=_ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    ref = cp.load_texture((tmp_path / "out.ktx").read_bytes())

    tex = cp.Texture(cp.Dimension.Dim2D, 96, 64, device="cpu")
    assert tex.set_image(cp.Image.from_array(arr, cp.ImageFormat.RGBAF))
    assert tex.convert_with_mips(F.BC3, T.UNorm, quality=Q.Low)
    assert ref.format is F.BC3 and ref.mip_levels == tex.mip_levels == 7
    for m in range(7):
        a = np.frombuffer(tex.data(mip_level=m), np.uint8).reshape(-1, 16)
        b = np.frombuffer(ref.data(mip_level=m), np.uint8).reshape(-1, 16)
        assert a.shape == b.shape, m
        assert np.all(a == b, axis=1).mean() >= 0.99, m
