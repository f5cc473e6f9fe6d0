"""The port's main path as a whole: Image -> mips -> BC7 q2 -> DDS.

The same source goes through cuttlefish_tpu.Texture with the TPU kernel
run in interpret mode (CUTTLEFISH_PALLAS=1) and through the port's
Texture on the CPU (its plain PyTorch version).
"""

import numpy as np
import pytest
import torch

import cuttlefish_tpu as ct
import cuttlefish_tpu_torch as cp
from cuttlefish_tpu.decode import decode_bc7
from cuttlefish_tpu_torch.convert.device import dequant_u8, wire_u8

_DDS_HEADER = 148
# (height, width, color space): a multiple-of-4 size, and a sRGB one (the
# perceptual weights) that is not a multiple of 4.
_CASES = [(64, 96, ct.ColorSpace.Linear), (22, 30, ct.ColorSpace.sRGB)]


def _psnr(dec, ref):
    mse = ((dec.astype(np.float64) - ref) ** 2).mean()
    return 10 * np.log10(255**2 / (mse + 1e-12))


def _texture(mod, arr, cs, **kw):
    """A mipmapped texture of package ``mod``, built from its own enums."""
    h, w = arr.shape[:2]
    cs = mod.ColorSpace[cs.name]
    tex = mod.Texture(mod.Dimension.Dim2D, w, h, mip_levels=99, color_space=cs, **kw)
    assert tex.set_image(mod.Image.from_array(arr, mod.ImageFormat.RGBAF, cs))
    assert tex.generate_mipmaps()
    return tex


@pytest.fixture(scope="module")
def converted():
    """case -> (port texture, reference texture)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("CUTTLEFISH_PALLAS", "1")
    out = {}
    try:
        rng = np.random.default_rng(11)
        for h, w, cs in _CASES:
            y, x = np.mgrid[0:h, 0:w].astype(np.float32)
            arr = np.stack(
                [np.sin(x / 7.0), np.cos(y / 5.0), np.sin((x + y) / 9.0), np.cos(x / 11.0)],
                axis=-1,
            ) * 0.4 + 0.5
            arr = np.clip(arr + rng.normal(0, 0.05, arr.shape), 0, 1).astype(np.float32)
            port = _texture(cp, arr, cs, device="cpu")
            ref = _texture(ct, arr, cs)
            for mod, tex in ((cp, port), (ct, ref)):
                assert tex.convert(mod.TextureFormat.BC7, mod.TextureType.UNorm, mod.Quality.Normal)
            out[(h, w, cs)] = (port, ref)
    finally:
        mp.undo()
    return out


def _ids(c):
    return f"{c[1]}x{c[0]}-{c[2].name}"


@pytest.mark.parametrize("case", _CASES, ids=_ids)
def test_dds_header_and_size(case, converted):
    port, ref = converted[case]
    rp, dp = port.save_to_bytes(cp.FileType.DDS)
    rr, dr = ref.save_to_bytes(ct.FileType.DDS)
    assert rp is cp.SaveResult.Success and rr is ct.SaveResult.Success
    assert dp[:_DDS_HEADER] == dr[:_DDS_HEADER]
    sizes = [port.data_size(mip_level=m) for m in range(port.mip_levels)]
    assert port.mip_levels == ref.mip_levels > 1
    assert len(dp) == len(dr) == _DDS_HEADER + sum(sizes)
    h, w = case[:2]
    assert sizes[0] == 16 * (-(-h // 4)) * (-(-w // 4))


@pytest.mark.parametrize("case", _CASES, ids=_ids)
def test_blocks_and_psnr_match_reference(case, converted):
    """>= 99 % identical blocks over all mips; PSNR within 0.05 dB."""
    port, ref = converted[case]
    same = total = 0
    for m in range(port.mip_levels):
        a = np.frombuffer(port.data(mip_level=m), np.uint8).reshape(-1, 16)
        b = np.frombuffer(ref.data(mip_level=m), np.uint8).reshape(-1, 16)
        same += int(np.all(a == b, axis=1).sum())
        total += a.shape[0]
    assert same / total >= 0.99, (same, total)
    # PSNR of level 0 against its source texels (edge-padded blocks).
    from cuttlefish_tpu_torch.convert.blocks import extract_blocks

    src, _, _ = extract_blocks(port.get_image(mip_level=0).rgbaf(), 4, 4)
    target = np.clip(np.round(src * 255), 0, 255)
    p_port = _psnr(decode_bc7(np.frombuffer(port.data(), np.uint8)), target)
    p_ref = _psnr(decode_bc7(np.frombuffer(ref.data(), np.uint8)), target)
    assert abs(p_port - p_ref) <= 0.05, (p_port, p_ref)
    assert p_port > 25.0


@pytest.mark.parametrize("case", _CASES, ids=_ids)
def test_load_texture_round_trip(case, converted, tmp_path):
    port, _ = converted[case]
    path = tmp_path / "out.dds"
    assert port.save(str(path)) is cp.SaveResult.Success
    loaded = cp.load_texture(str(path))
    assert isinstance(loaded, cp.Texture)
    assert loaded.format is cp.TextureFormat.BC7
    assert loaded.mip_levels == port.mip_levels
    assert loaded.color_space is cp.ColorSpace[case[2].name]
    for m in range(port.mip_levels):
        assert loaded.data(mip_level=m) == port.data(mip_level=m)


def test_convert_stats(converted):
    port, _ = converted[_CASES[0]]
    stats = port.last_convert_stats
    assert stats["bc7_launches"] == 0  # the CPU runs the plain version
    assert stats["launches"] == {}
    assert stats["texels"] == sum(
        port.width(m) * port.height(m) for m in range(port.mip_levels)
    )
    assert set(stats["phases"]) == {
        "prepare", "encode", "serialize",
        "tile", "upload", "kernel", "fetch", "interleave",
    }
    inner = sum(stats["phases"][k] for k in ("tile", "upload", "kernel", "fetch", "interleave"))
    assert inner <= stats["phases"]["encode"]


def test_wire_dequantisation_is_the_reference_f32():
    """u8 -> f32 on the device is u8 * float32(1/255), bit for bit."""
    u8 = np.arange(256, dtype=np.uint8)
    got = dequant_u8(torch.from_numpy(u8)).numpy()
    want = np.float32(u8) * np.float32(1 / 255)
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    x = np.array([-0.5, 0.0, 0.5 / 255, 0.2, 1.0, 1.5], np.float32)
    assert list(wire_u8(x)) == [0, 0, 1, 51, 255, 255]


def test_pvrtc_and_astc_hdr_convert_and_invalid_combos_fail():
    tex = cp.Texture(cp.Dimension.Dim2D, 8, 8, device="cpu")
    tex.set_image(cp.Image.from_array(np.full((8, 8, 4), 0.5, np.float32), cp.ImageFormat.RGBAF))
    # PVRTC1 and the ASTC HDR profile convert and decode (torch ops).
    assert tex.convert(cp.TextureFormat.PVRTC1_RGBA_4BPP, cp.TextureType.UNorm)
    assert tex.format is cp.TextureFormat.PVRTC1_RGBA_4BPP and tex.data_size() == 4 * 8
    assert tex.last_convert_stats["launches"] == {}
    dec = tex.decode_image().rgbaf()
    assert np.abs(dec - 0.5).max() < 0.04  # 3-bit translucent alpha: 1/30
    assert tex.convert(cp.TextureFormat.ASTC_4x4, cp.TextureType.UFloat)
    assert tex.format is cp.TextureFormat.ASTC_4x4 and tex.data_size() == 4 * 16
    assert np.abs(tex.decode_image().rgbaf() - 0.5).max() < 1e-3
    assert tex.convert(cp.TextureFormat.BC7, cp.TextureType.SNorm) is False
    assert tex.convert(cp.TextureFormat.BC6H, cp.TextureType.UNorm) is False
    # BC1 and BC6H are ported now.
    assert tex.convert(cp.TextureFormat.BC6H, cp.TextureType.Float)
    assert tex.format is cp.TextureFormat.BC6H and tex.data_size() == 16 * 4
    assert tex.convert(cp.TextureFormat.BC1_RGB)
    assert tex.format is cp.TextureFormat.BC1_RGB and tex.data_size() == 4 * 8
    # Uncompressed formats use the port's copy of the host converters.
    assert tex.convert(cp.TextureFormat.R8G8B8A8)
    assert tex.data() == bytes([128] * 4 * 64)
    # The fused device mip pipeline converts too (4 levels of 8x8 BC7).
    assert tex.convert_with_mips(cp.TextureFormat.BC7)
    assert tex.format is cp.TextureFormat.BC7 and tex.mip_levels == 4
    assert [tex.data_size(mip_level=m) for m in range(4)] == [64, 16, 16, 16]


def test_etc_formats_convert_punch_through_included():
    """ETC2_R8G8B8A1 (punch-through), ETC1, ETC2 and EAC convert."""
    tex = cp.Texture(cp.Dimension.Dim2D, 8, 8, device="cpu")
    tex.set_image(cp.Image.from_array(np.full((8, 8, 4), 0.5, np.float32), cp.ImageFormat.RGBAF))
    for fmt, size in ((cp.TextureFormat.ETC2_R8G8B8A1, 8),
                      (cp.TextureFormat.ETC1, 8), (cp.TextureFormat.ETC2_R8G8B8A8, 16),
                      (cp.TextureFormat.EAC_R11, 8), (cp.TextureFormat.EAC_R11G11, 16)):
        assert tex.convert(fmt, cp.TextureType.UNorm)
        assert tex.format is fmt and tex.data_size() == 4 * size


def test_texture_device_argument():
    tex = cp.Texture(cp.Dimension.Dim2D, 4, 4, device=torch.device("cpu"))
    assert tex.device == torch.device("cpu")
    # The port's Texture is a class of its own, not the JAX package's.
    from cuttlefish_tpu.texture import Texture as JaxTexture

    assert not issubclass(cp.Texture, JaxTexture)
    assert not isinstance(tex, ct.Texture)


def test_texture_defaults_to_the_card_and_never_falls_back():
    """Texture(), create_converter() and BlockConverter() default to the
    CUDA device; without a card, a block-format convert raises."""
    from cuttlefish_tpu_torch.convert import create_converter
    from cuttlefish_tpu_torch.convert.device import BlockConverter

    tex = cp.Texture(cp.Dimension.Dim2D, 8, 8)
    assert tex.device == torch.device("cuda")
    conv = create_converter(cp.TextureFormat.BC1_RGB, cp.TextureType.UNorm)
    assert isinstance(conv, BlockConverter) and conv.device == torch.device("cuda")
    assert BlockConverter().device == torch.device("cuda")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works here")
    tex.set_image(cp.Image.from_array(np.full((8, 8, 4), 0.5, np.float32), cp.ImageFormat.RGBAF))
    with pytest.raises((RuntimeError, AssertionError)):
        tex.convert(cp.TextureFormat.BC1_RGB)
    assert tex.format is cp.TextureFormat.Unknown and not tex.converted
