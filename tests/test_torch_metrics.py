"""``tests/test_metrics.py`` on the port: ``cuttlefish_tpu_torch.metrics``
(a copy of ``cuttlefish_tpu/metrics.py``, held to it by
``tests/test_torch_host_copies.py``) scores textures converted by the
port's ``Texture`` on the CPU, with the original's floors; its PVRTC
branch runs on the port's Morton order and decoder."""

import numpy as np
import pytest

import cuttlefish_tpu_torch as cp
from cuttlefish_tpu_torch import metrics
from cuttlefish_tpu_torch.formats import Quality, TextureFormat, TextureType

_F = TextureFormat
_T = TextureType


def _texture(fmt, type_, size=16, seed=0, quality=Quality.Low):
    rng = np.random.default_rng(seed)
    arr = rng.random((size, size, 4)).astype(np.float32)
    for _ in range(3):
        arr = (
            arr + np.roll(arr, 1, 0) + np.roll(arr, -1, 0)
            + np.roll(arr, 1, 1) + np.roll(arr, -1, 1)
        ) / 5
    arr = arr.astype(np.float32)
    arr[..., 3] = 1.0
    tex = cp.Texture(cp.Dimension.Dim2D, size, size, device="cpu")
    tex.set_image(cp.Image.from_array(arr, cp.ImageFormat.RGBAF))
    assert tex.convert(fmt, type_, quality=quality)
    return tex, arr


@pytest.mark.parametrize(
    "fmt,type_,floor",
    [
        (_F.BC1_RGB, _T.UNorm, 30),
        (_F.BC3, _T.UNorm, 30),
        (_F.BC7, _T.UNorm, 33),
        (_F.ETC2_R8G8B8, _T.UNorm, 25),
        (_F.ASTC_4x4, _T.UNorm, 28),
    ],
)
def test_score_texture(fmt, type_, floor):
    tex, src = _texture(fmt, type_)
    result = metrics.score_texture(tex, [src])
    assert result["psnr"] is not None and result["psnr"] > floor


def test_pvrtc_decode_surface():
    from cuttlefish_tpu_torch import formats

    if not formats.HAS_PVRTC:
        pytest.skip("PVRTC gated off (CUTTLEFISH_TPU_NO_PVRTC)")
    tex, src = _texture(_F.PVRTC1_RGB_4BPP, _T.UNorm, size=32)
    dec = metrics.decode_surface(tex.data(mip_level=0), _F.PVRTC1_RGB_4BPP, _T.UNorm, 32, 32)
    assert dec is not None
    assert metrics.psnr(dec[..., :3], src[..., :3]) > 25


def test_convert_stats_counter():
    tex, _ = _texture(_F.BC1_RGB, _T.UNorm)
    stats = tex.last_convert_stats
    assert stats["texels"] == 16 * 16
    assert stats["mtexels_per_sec"] > 0


def test_psnr_ssim_basics():
    a = np.zeros((8, 8))
    assert metrics.psnr(a, a) == float("inf")
    assert metrics.ssim(a, a) == pytest.approx(1.0)
    b = a + 0.1
    assert metrics.psnr(a, b) == pytest.approx(20.0, abs=0.01)
