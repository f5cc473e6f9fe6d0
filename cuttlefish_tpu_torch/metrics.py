"""Quality and throughput metrics (first-class per SURVEY.md §5).

The reference has no metrics subsystem; for the TPU build PSNR-vs-source
and Mtexels/sec are the north-star numbers (BASELINE.md), so they ship as
library API: decode any converted texture surface back to texels and score
it against the source image.

Copied from ``cuttlefish_tpu/metrics.py`` with its imports pointed at the
port.
"""

from __future__ import annotations

import numpy as np

from cuttlefish_tpu_torch.formats import (
    TextureFormat,
    TextureType,
    block_height,
    block_width,
)

_F = TextureFormat


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    """Peak signal-to-noise ratio in dB; inf for identical inputs."""
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(peak * peak / mse)


def ssim(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    """Global (single-window) structural similarity."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    c1 = (0.01 * peak) ** 2
    c2 = (0.03 * peak) ** 2
    mu_a, mu_b = a.mean(), b.mean()
    va, vb = a.var(), b.var()
    cov = ((a - mu_a) * (b - mu_b)).mean()
    return float(
        ((2 * mu_a * mu_b + c1) * (2 * cov + c2))
        / ((mu_a**2 + mu_b**2 + c1) * (va + vb + c2))
    )


def decode_surface(
    data: bytes | np.ndarray,
    fmt: TextureFormat,
    type_: TextureType,
    width: int,
    height: int,
) -> np.ndarray | None:
    """Decode one converted surface back to (H, W, C) float texels.

    Returns None for formats without a reference decoder yet.
    """
    raw = np.frombuffer(bytes(data), np.uint8)
    bw, bh = block_width(fmt), block_height(fmt)
    nbx = -(-width // bw)
    nby = -(-height // bh)

    def detile(blocks: np.ndarray) -> np.ndarray:
        c = blocks.shape[-1]
        full = (
            blocks.reshape(nby, nbx, bh, bw, c)
            .transpose(0, 2, 1, 3, 4)
            .reshape(nby * bh, nbx * bw, c)
        )
        return full[:height, :width]

    T = TextureType
    if fmt in (_F.BC1_RGB, _F.BC1_RGBA):
        from cuttlefish_tpu_torch.decode import decode_bc1

        return detile(decode_bc1(raw, opaque=fmt is _F.BC1_RGB) / 255.0)
    if fmt is _F.BC2:
        from cuttlefish_tpu_torch.decode import decode_bc2

        return detile(decode_bc2(raw) / 255.0)
    if fmt is _F.BC3:
        from cuttlefish_tpu_torch.decode import decode_bc3

        return detile(decode_bc3(raw) / 255.0)
    if fmt is _F.BC4:
        from cuttlefish_tpu_torch.decode import decode_bc4

        return detile(decode_bc4(raw, signed=type_ is T.SNorm)[..., None])
    if fmt is _F.BC5:
        from cuttlefish_tpu_torch.decode import decode_bc5

        return detile(decode_bc5(raw, signed=type_ is T.SNorm))
    if fmt is _F.BC6H:
        from cuttlefish_tpu_torch.decode.bc6h import decode_bc6h_f32

        return detile(decode_bc6h_f32(raw, signed=type_ is T.Float))
    if fmt is _F.BC7:
        from cuttlefish_tpu_torch.decode.bc7 import decode_bc7

        return detile(decode_bc7(raw) / 255.0)
    if fmt is _F.ETC1:
        from cuttlefish_tpu_torch.decode.etc import decode_etc_rgb

        return detile(decode_etc_rgb(raw, etc2=False) / 255.0)
    if fmt is _F.ETC2_R8G8B8:
        from cuttlefish_tpu_torch.decode.etc import decode_etc_rgb

        return detile(decode_etc_rgb(raw, etc2=True) / 255.0)
    if fmt is _F.ETC2_R8G8B8A1:
        from cuttlefish_tpu_torch.decode.etc import decode_etc2_a1

        return detile(decode_etc2_a1(raw) / 255.0)
    if fmt is _F.ETC2_R8G8B8A8:
        from cuttlefish_tpu_torch.decode.etc import decode_etc2_rgba

        return detile(decode_etc2_rgba(raw) / 255.0)
    if fmt is _F.EAC_R11:
        from cuttlefish_tpu_torch.decode.etc import decode_eac_r11

        return detile(decode_eac_r11(raw, signed=type_ is T.SNorm)[..., None])
    if fmt is _F.EAC_R11G11:
        from cuttlefish_tpu_torch.decode.etc import decode_eac_rg11

        return detile(decode_eac_rg11(raw, signed=type_ is T.SNorm))
    if fmt.name.startswith("ASTC_"):
        if type_ is T.UFloat:
            from cuttlefish_tpu_torch.decode.astc import decode_astc_hdr

            halfs = decode_astc_hdr(raw, bw, bh)
            vals = halfs.astype(np.uint16).view(np.float16).astype(np.float64)
            return detile(vals)
        from cuttlefish_tpu_torch.decode.astc import decode_astc

        return detile(decode_astc(raw, bw, bh) / 255.0)
    if fmt in (_F.PVRTC1_RGB_4BPP, _F.PVRTC1_RGBA_4BPP,
               _F.PVRTC1_RGB_2BPP, _F.PVRTC1_RGBA_2BPP):
        from cuttlefish_tpu_torch.decode.pvrtc import decode_pvrtc1
        from cuttlefish_tpu_torch.kernels.pvrtc_tables import morton_order

        bpp2 = fmt in (_F.PVRTC1_RGB_2BPP, _F.PVRTC1_RGBA_2BPP)
        pw = max(width, 16 if bpp2 else 8)
        ph = max(height, 8)
        nx, ny = pw // bw, ph // bh
        words = raw.reshape(-1, 8)
        perm = morton_order(nx, ny)
        inv = np.argsort(perm)
        return decode_pvrtc1(words[inv].reshape(-1), pw, ph, bpp2=bpp2)[
            :height, :width
        ]
    return None


def score_texture(texture, source_images) -> dict:
    """PSNR of every mip-0 surface of a converted texture vs its sources.

    source_images: array-likes in the same (face/depth) order as the
    texture's surfaces, float RGBA.
    """
    scores = []
    for i, src in enumerate(source_images):
        src = np.asarray(src, np.float64)
        if texture.faces == 6:
            data = texture.data(face=i, mip_level=0)
        else:
            data = texture.data(mip_level=0, depth=i)
        dec = decode_surface(
            data, texture.format, texture.type, texture.width(), texture.height()
        )
        if dec is None:
            return {"psnr": None}
        c = min(dec.shape[-1], src.shape[-1])
        scores.append(psnr(dec[..., :c], src[..., :c]))
    return {"psnr": float(np.mean(scores)), "per_surface": scores}
