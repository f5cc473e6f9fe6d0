"""The port's ASTC converter on the CPU: the content scans reach the encoder
through ``BlockConverter.refine_params``, every block size converts, saves
and reads back, and the HDR profile (UFloat) converts and decodes.
"""

import numpy as np
import pytest
import torch

import cuttlefish_tpu_torch as cp
from cuttlefish_tpu_torch.convert import EncodeParams, create_converter
from cuttlefish_tpu_torch.convert.astc import AstcConverter, AstcHdrConverter
from cuttlefish_tpu_torch.convert.blocks import extract_blocks
from cuttlefish_tpu_torch.convert.device import BlockConverter, wire_u8
from cuttlefish_tpu_torch.decode import decode_astc
from cuttlefish_tpu_torch.kernels import astc

_SIZES = [f.name for f in cp.TextureFormat if f.name.startswith("ASTC_")]


def _surface(h, w, kind, seed=2):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    arr = np.stack([np.sin(x / 5.0), np.cos(y / 4.0), np.sin((x + y) / 6.0), np.cos(x / 7.0)], -1)
    arr = np.clip(arr * 0.4 + 0.5 + rng.normal(0, 0.03, arr.shape), 0, 1).astype(np.float32)
    if kind == "gray_alpha":
        arr[..., 1] = arr[..., 0]
        arr[..., 2] = arr[..., 0]
    else:
        arr[..., 3] = 1.0
    return arr


def _texture(arr, mips=1):
    tex = cp.Texture(cp.Dimension.Dim2D, arr.shape[1], arr.shape[0], mip_levels=mips, device="cpu")
    assert tex.set_image(cp.Image.from_array(arr, cp.ImageFormat.RGBAF))
    if mips > 1:
        assert tex.generate_mipmaps()
    return tex


def test_base_hook_keeps_params():
    params = EncodeParams()
    assert BlockConverter.refine_params(None, np.zeros((1, 16, 4), np.float32), params) is params


@pytest.mark.parametrize("kind,flags", [("color", (False, False)), ("gray_alpha", (True, True))])
def test_content_scans_reach_the_encoder(monkeypatch, kind, flags):
    """refine_params sees the float host blocks of the whole batch (every
    mip) before the wire, and its flags are the ones encode_astc gets; the
    words are the plain version's under those flags."""
    seen = {}
    refine, encode = AstcConverter.refine_params, astc.encode_astc

    def spy_refine(self, host_blocks, params):
        seen["host"] = host_blocks
        return refine(self, host_blocks, params)

    def spy_encode(blocks, **kw):
        seen["flags"] = (kw["gray"], kw["alpha"])
        seen["blocks"] = blocks
        return encode(blocks, **kw)

    monkeypatch.setattr(AstcConverter, "refine_params", spy_refine)
    monkeypatch.setattr(astc, "encode_astc", spy_encode)
    arr = _surface(16, 16, kind)
    tex = _texture(arr, mips=3)
    assert tex.convert(cp.TextureFormat.ASTC_4x4, cp.TextureType.UNorm, cp.Quality.Low)
    host = seen["host"]
    nblocks = sum(((max(16 >> m, 1) + 3) // 4) ** 2 for m in range(tex.mip_levels))
    assert tex.mip_levels > 1 and host.dtype == np.float32 and host.shape == (nblocks, 16, 4)
    assert np.array_equal(host[:16], extract_blocks(arr, 4, 4)[0])
    assert seen["flags"] == flags
    assert seen["blocks"].dtype == torch.float32
    want = astc.encode_astc_plain(
        torch.from_numpy(wire_u8(host).astype(np.float32) * np.float32(1 / 255)), 4, 4, 1, *flags
    ).numpy()
    got = np.frombuffer(tex.data(), np.uint8).reshape(-1, 4 * 4).view("<u4")
    assert np.array_equal(got, want[:16])


@pytest.mark.parametrize("name", _SIZES)
def test_every_block_size_converts_and_reads_back(name):
    """Each of the 14 LDR block sizes at quality 1 (void extent, the CEM 8
    layouts, one 2-partition seed): a KTX file that reads back equal and
    decodes near its source."""
    fmt = getattr(cp.TextureFormat, name)
    bw, bh = (int(v) for v in name[5:].split("x"))
    arr = _surface(2 * bh + 3, 2 * bw + 1, "color")
    tex = _texture(arr)
    assert tex.convert(fmt, cp.TextureType.UNorm, cp.Quality.Low)
    assert tex.last_convert_stats["launches"] == {}
    assert tex.data_size() == 3 * 3 * 16
    res, data = tex.save_to_bytes(cp.FileType.KTX)
    assert res is cp.SaveResult.Success
    back = cp.load_texture(data)
    assert back.format is fmt and back.data() == tex.data()
    dec = decode_astc(np.frombuffer(tex.data(), np.uint8), bw, bh)
    assert dec.shape == (9, bw * bh, 4)
    img = back.decode_image().rgbaf()
    assert img.shape == arr.shape
    mse = ((img.astype(np.float64) - arr) ** 2).mean()
    # 0.89-8 bits a texel on a detailed, noisy source: 19-30 dB.
    assert 10 * np.log10(1.0 / mse) > 17.0


def test_hdr_profile_converts_and_decodes():
    """ASTC_6x6 UFloat: the HDR profile on the f16 wire with no content
    gates, decoded back through the port's ``decode_astc_hdr``."""
    arr = _surface(8, 8, "color")
    arr[..., :3] *= np.float32(6.0)
    tex = _texture(arr)
    assert tex.convert(cp.TextureFormat.ASTC_6x6, cp.TextureType.UFloat)
    assert tex.last_convert_stats["launches"] == {}
    conv = create_converter(cp.TextureFormat.ASTC_6x6, cp.TextureType.UFloat, "cpu")
    assert isinstance(conv, AstcHdrConverter) and conv.transfer_dtype == "f16"
    # No content gates: the base hook, so the fused pipeline skips its scan.
    assert type(conv).refine_params is BlockConverter.refine_params
    params = EncodeParams()
    assert conv.refine_params(np.zeros((1, 36, 4), np.float32), params) is params
    assert tex.data_size() == 2 * 2 * 16
    img = tex.decode_image().rgbaf()
    assert img.shape == arr.shape
    logerr = np.abs(np.log2(np.maximum(img[..., :3], 1e-6)) - np.log2(np.maximum(arr[..., :3], 1e-6)))
    assert np.median(logerr) < 0.3
