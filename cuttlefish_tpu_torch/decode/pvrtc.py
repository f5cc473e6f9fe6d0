"""PVRTC1 decoder (numpy, matching the encoder's word layout).

Decodes 4bpp and 2bpp PVRTC1 surfaces: unpacks per-block A/B colors,
bilinearly upscales with wraparound, applies modulation.  Input blocks in
raster order (de-Morton first via kernels.pvrtc_tables.morton_order).

Copied from ``cuttlefish_tpu/decode/pvrtc.py`` with its imports pointed at
the port; its bilinear upscale is the port's ``kernels/pvrtc.py:
upscale_bilinear`` on CPU tensors in place of the JAX package's.
"""

from __future__ import annotations

import numpy as np

from cuttlefish_tpu_torch.kernels.pvrtc import upscale_bilinear
from cuttlefish_tpu_torch.kernels.pvrtc_tables import _MOD_W_4BPP


def _expand5(v):
    return (v << 3) | (v >> 2)


def _expand4(v):
    return v * 17


def _unpack_a(cw: np.ndarray, pvrtc2: bool = False) -> np.ndarray:
    """Color A (the mod-0 endpoint): bits 0..15 (bit 0 = mode flag)
    -> [N,4] float 0..1, matching PVRTDecompress' getColourA.

    Opaque: 5.5.4; translucent: A3 R4 G4 B3.  PVRTC1 keeps color A's
    opaque flag at bit 15; PVRTC2 re-purposes bit 15 as the
    hard-transition flag and reads the block-global opacity flag at
    bit 31 instead.
    """
    field = cw & 0xFFFF
    opaque = (
        ((cw >> 31) & 1) if pvrtc2 else ((field >> 15) & 1)
    ).astype(bool)
    ro = _expand5((field >> 10) & 0x1F)
    go = _expand5((field >> 5) & 0x1F)
    b4o = (field >> 1) & 0xF
    bo = _expand5((b4o << 1) | (b4o >> 3))
    rt = _expand4((field >> 8) & 0xF)
    gt = _expand4((field >> 4) & 0xF)
    b3 = (field >> 1) & 0x7
    bt = _expand4((b3 << 1) | (b3 >> 2))
    at = _expand4(((field >> 12) & 0x7) << 1)
    r = np.where(opaque, ro, rt)
    g = np.where(opaque, go, gt)
    b = np.where(opaque, bo, bt)
    a = np.where(opaque, 255, at)
    return np.stack([r, g, b, a], -1).astype(np.float32) / 255.0


def _unpack_b(cw: np.ndarray) -> np.ndarray:
    """Color B (the mod-8 endpoint): bits 16..31 -> [N,4] float 0..1,
    matching PVRTDecompress' getColourB.

    Opaque (bit 31): 5.5.5; translucent: A3 R4 G4 B4 with alpha decoded as
    (a3 << 1) expanded to 8 bits.
    """
    field = (cw >> 16) & 0xFFFF
    opaque = ((field >> 15) & 1).astype(bool)
    ro = _expand5((field >> 10) & 0x1F)
    go = _expand5((field >> 5) & 0x1F)
    bo = _expand5(field & 0x1F)
    rt = _expand4((field >> 8) & 0xF)
    gt = _expand4((field >> 4) & 0xF)
    bt = _expand4(field & 0xF)
    at = _expand4(((field >> 12) & 0x7) << 1)
    r = np.where(opaque, ro, rt)
    g = np.where(opaque, go, gt)
    b = np.where(opaque, bo, bt)
    a = np.where(opaque, 255, at)
    return np.stack([r, g, b, a], -1).astype(np.float32) / 255.0


def _decode_pvrtc(
    data: np.ndarray, width: int, height: int, bpp2: bool, wrap: bool,
    pvrtc2: bool = False,
) -> np.ndarray:
    """Raster-order block words -> (H, W, 4) float32 decoded surface."""
    import torch

    bw, bh = (8, 4) if bpp2 else (4, 4)
    nbx, nby = width // bw, height // bh
    words = np.asarray(data, np.uint8).reshape(-1, 8).view("<u4")
    mod = words[:, 0].astype(np.uint64)
    cw = words[:, 1].astype(np.uint32)
    a = _unpack_a(cw, pvrtc2=pvrtc2).reshape(nby, nbx, 4)
    b = _unpack_b(cw).reshape(nby, nbx, 4)
    a_img = upscale_bilinear(torch.from_numpy(a), bw, bh, wrap=wrap).numpy()
    b_img = upscale_bilinear(torch.from_numpy(b), bw, bh, wrap=wrap).numpy()

    if pvrtc2:
        # Hard-transition flag (bit 15, PVRTC1's color-A opaque bit): the
        # decode region owned by block P — the half-block-offset window
        # between the centers of P and its right/down neighbors — switches
        # from bilinear interpolation to NON-interpolated reconstruction:
        # every texel takes its own container block's A/B directly
        # (within a hard region the nearest block center is always the
        # container's).  Modulation stays per-texel with the standard
        # weight table; the encoder never combines hard with the
        # punch-through flag (H=1,M=1 signals the unimplemented local
        # palette mode).  See kernels/pvrtc.py encode_pvrtc2 for layout
        # provenance.
        hard = ((cw >> 15) & 1).astype(bool).reshape(nby, nbx)
        if hard.any():
            ow_y = np.clip(
                (np.arange(height) - bh // 2) // bh, 0, nby - 1
            )
            ow_x = np.clip((np.arange(width) - bw // 2) // bw, 0, nbx - 1)
            hard_tex = hard[ow_y][:, ow_x]
            a_hard = np.repeat(np.repeat(a, bh, 0), bw, 1)
            b_hard = np.repeat(np.repeat(b, bh, 0), bw, 1)
            a_img = np.where(hard_tex[..., None], a_hard, a_img)
            b_img = np.where(hard_tex[..., None], b_hard, b_img)

    bits = 1 if bpp2 else 2
    weights = _MOD_W_4BPP if not bpp2 else np.array([0, 8], np.float32)
    # Punch-through modulation mode (color word bit 0, 4bpp): weights
    # 0/4/4/8 and index 2 zeroes alpha (PVRTDecompress getModulationValues).
    punch_weights = np.array([0, 4, 4, 8], np.float32)

    # Vectorized: unpack per-texel modulation indices for all blocks at
    # once, pick the weight table per block by the punch flag, blend.
    texel = np.arange(bh * bw, dtype=np.uint64)  # raster within block
    idx = (
        (mod[:, None] >> (bits * texel[None, :]))
        & np.uint64((1 << bits) - 1)
    ).astype(np.int64)  # [nblocks, bh*bw]
    punch = (
        np.zeros(len(cw), bool) if bpp2 else (cw & 1).astype(bool)
    )  # [nblocks]
    w8 = np.where(
        punch[:, None], punch_weights[idx], weights[idx]
    )  # [nblocks, bh*bw]
    punched = punch[:, None] & (idx == 2)
    # Scatter block-texel grids back to the surface raster.
    w8_img = (
        w8.reshape(nby, nbx, bh, bw).transpose(0, 2, 1, 3)
        .reshape(height, width)
    )
    punched_img = (
        punched.reshape(nby, nbx, bh, bw).transpose(0, 2, 1, 3)
        .reshape(height, width)
    )
    out = (a_img * (8.0 - w8_img[..., None]) + b_img * w8_img[..., None]) / 8.0
    out[..., 3] = np.where(punched_img, 0.0, out[..., 3])
    return out.astype(np.float32)


def decode_pvrtc1(
    data: np.ndarray, width: int, height: int, bpp2: bool = False
) -> np.ndarray:
    return _decode_pvrtc(data, width, height, bpp2, wrap=True)


def decode_pvrtc2(
    data: np.ndarray, width: int, height: int, bpp2: bool = False
) -> np.ndarray:
    """PVRTC2 interpolated subset: clamped borders, block-global
    opacity flag at bit 31 (bit 15 is the hard-transition flag — only
    interpolated blocks are emitted; see kernels/pvrtc.py
    encode_pvrtc2)."""
    return _decode_pvrtc(data, width, height, bpp2, wrap=False, pvrtc2=True)
