"""The port's ETC2 RGBA8 encoder (EAC alpha + ETC2 RGB) against the TPU
kernel body ``etc_pallas.py:_kernel_rgba`` called eagerly (helpers and
tolerances: ``tests/test_torch_etc.py``), and the slice it serves: an RGBA
texture + mips -> ETC2_R8G8B8A8 Highest -> KTX, written by the port and
read by the JAX package.  No JAX encoder runs for the slice test: the
quality 4 eager call takes the test blocks and the slice's together."""

import numpy as np
import pytest
import torch
from test_torch_etc import eager_rgba, etc_blocks, psnr, same, to_bytes

import cuttlefish_tpu as ct
import cuttlefish_tpu_torch as cp
from cuttlefish_tpu.decode import etc as jdec
from cuttlefish_tpu_torch.convert.blocks import extract_blocks
from cuttlefish_tpu_torch.convert.device import wire_u8
from cuttlefish_tpu_torch.decode import etc as pdec
from cuttlefish_tpu_torch.kernels import etc

_H, _W = 24, 40


def _rgba_image():
    """40x24 RGBA: smooth colour and alpha with noise."""
    rng = np.random.default_rng(17)
    y, x = np.mgrid[0:_H, 0:_W].astype(np.float32)
    arr = np.stack(
        [np.sin(x / 7.0), np.cos(y / 5.0), np.sin((x + y) / 9.0), np.cos(x / 6.0 + y / 4.0)],
        axis=-1,
    ) * 0.45 + 0.5
    return np.clip(arr + rng.normal(0, 0.04, arr.shape), 0, 1).astype(np.float32)


@pytest.fixture(scope="module")
def slice_texture():
    """The port's texture on the CPU, converted, and each mip's blocks
    through the u8 wire."""
    tex = cp.Texture(cp.Dimension.Dim2D, _W, _H, mip_levels=99, device="cpu")
    assert tex.set_image(cp.Image.from_array(_rgba_image(), cp.ImageFormat.RGBAF))
    assert tex.generate_mipmaps()
    mips = [
        wire_u8(extract_blocks(tex.get_image(mip_level=m).rgbaf(), 4, 4)[0]).astype(np.float32)
        * np.float32(1 / 255)
        for m in range(tex.mip_levels)
    ]
    assert tex.convert(cp.TextureFormat.ETC2_R8G8B8A8, cp.TextureType.UNorm, cp.Quality.Highest)
    return tex, mips


@pytest.fixture(scope="module")
def encoded(slice_texture):
    """quality -> (blocks, port words, eager words); ("slice") -> the
    eager quality 4 words of the slice's mips."""
    b = etc_blocks()
    out = {}
    slice_blocks = np.concatenate(slice_texture[1])
    for q in (2, 4):
        port = etc.encode_etc2_rgba(torch.from_numpy(b), q).numpy()
        ref = eager_rgba(np.concatenate([b, slice_blocks]) if q == 4 else b, q)
        out[q] = (b, port, ref[: b.shape[0]])
        if q == 4:
            out["slice"] = ref[b.shape[0] :]
    return out


def _rgba_psnr(words, b):
    dec = jdec.decode_etc2_rgba(to_bytes(words))
    return psnr(dec, np.round(b * 255), 255.0)


@pytest.mark.parametrize("quality", [2, 4])
def test_plain_matches_tpu_kernel(quality, encoded):
    """>= 99 % identical blocks (100 % expected), RGBA PSNR within 0.05 dB;
    alpha words come first."""
    b, port, ref = encoded[quality]
    assert port.dtype == np.uint32 and port.shape == ref.shape == (256, 4)
    assert same(port, ref) >= 0.99, same(port, ref)
    assert abs(_rgba_psnr(port, b) - _rgba_psnr(ref, b)) <= 0.05
    alpha = etc.encode_eac_alpha(torch.from_numpy(np.ascontiguousarray(b[..., 3])), quality)
    assert np.array_equal(port[:, :2], alpha.numpy())
    rgb = etc.encode_etc_rgb(torch.from_numpy(b), quality, True).numpy()
    assert np.array_equal(port[:, 2:], rgb)


def test_slice_reads_back_in_the_jax_package(slice_texture, encoded, tmp_path):
    """ETC2_R8G8B8A8 Highest, 40x24 + mips, KTX written by the port and read
    by the JAX package's load_texture: same format, type, size and mips;
    each mip's payload is the eager TPU kernel's words for its blocks."""
    tex, mips = slice_texture
    path = tmp_path / "slice.ktx"
    assert tex.save(str(path)) is cp.SaveResult.Success
    loaded = ct.load_texture(str(path))
    assert loaded.format is ct.TextureFormat.ETC2_R8G8B8A8 and loaded.type is ct.TextureType.UNorm
    assert (loaded.width(), loaded.height(), loaded.mip_levels) == (_W, _H, tex.mip_levels)
    ref = encoded["slice"]
    start = 0
    for m, blocks in enumerate(mips):
        want = to_bytes(ref[start : start + blocks.shape[0]]).tobytes()
        start += blocks.shape[0]
        assert loaded.data(mip_level=m) == tex.data(mip_level=m) == want, m
    assert start == ref.shape[0]


def test_slice_decodes_alike(slice_texture, tmp_path):
    """Both packages' decoders give the same texels for the port's file, and
    the port reads it back and decodes it without JAX's help."""
    tex, _ = slice_texture
    path = tmp_path / "slice.ktx"
    assert tex.save(str(path)) is cp.SaveResult.Success
    back = cp.load_texture(str(path))
    assert back.format is cp.TextureFormat.ETC2_R8G8B8A8
    for m in range(tex.mip_levels):
        raw = np.frombuffer(back.data(mip_level=m), np.uint8)
        assert np.array_equal(pdec.decode_etc2_rgba(raw), jdec.decode_etc2_rgba(raw))
    dec = back.decode_image().rgbaf()
    src = tex.get_image(mip_level=0).rgbaf()
    assert dec.shape == (_H, _W, 4) and np.isfinite(dec).all()
    assert psnr(dec, src, 1.0) > 30.0
