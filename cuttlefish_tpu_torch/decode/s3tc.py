"""BC1-BC5 block decoders (numpy, per the S3TC / RGTC specs).

Decoded values follow the D3D11.3 functional spec interpolation
(round-to-nearest thirds/sevenths on 8-bit expanded endpoints), which is what
desktop GPUs implement; our encoders model the same palette in float.

Copied from ``cuttlefish_tpu/decode/s3tc.py`` with its imports pointed at
the port; its logic is unchanged.
"""

from __future__ import annotations

import numpy as np


def _u64(data: np.ndarray) -> np.ndarray:
    """[N, 8] uint8 (little-endian block) -> [N] uint64."""
    return data.reshape(-1, 8).view(np.dtype("<u8")).reshape(-1)


def _expand565(c16: np.ndarray) -> np.ndarray:
    """[N] uint16 -> [N,3] uint8 with bit replication."""
    r = (c16 >> 11) & 0x1F
    g = (c16 >> 5) & 0x3F
    b = c16 & 0x1F
    return np.stack(
        [(r << 3) | (r >> 2), (g << 2) | (g >> 4), (b << 3) | (b >> 2)], axis=-1
    ).astype(np.uint8)


def decode_bc1(data: np.ndarray, opaque: bool = False) -> np.ndarray:
    """[N*8] or [N,8] uint8 -> [N,16,4] uint8 RGBA.

    opaque=True forces alpha 255 in 3-color mode (BC1 sampled as RGB).
    """
    data = np.asarray(data, np.uint8).reshape(-1, 8)
    c0 = data[:, 0:2].copy().view(np.dtype("<u2")).reshape(-1).astype(np.int32)
    c1 = data[:, 2:4].copy().view(np.dtype("<u2")).reshape(-1).astype(np.int32)
    bits = data[:, 4:8].copy().view(np.dtype("<u4")).reshape(-1)
    e0 = _expand565(c0).astype(np.int32)
    e1 = _expand565(c1).astype(np.int32)

    four = c0 > c1
    pal = np.zeros((data.shape[0], 4, 4), np.int32)
    pal[:, 0, :3] = e0
    pal[:, 1, :3] = e1
    pal[:, :, 3] = 255
    # 4-color: thirds; 3-color: midpoint + transparent black.
    p2_4 = (2 * e0 + e1 + 1) // 3
    p3_4 = (e0 + 2 * e1 + 1) // 3
    p2_3 = (e0 + e1) // 2
    pal[:, 2, :3] = np.where(four[:, None], p2_4, p2_3)
    pal[:, 3, :3] = np.where(four[:, None], p3_4, 0)
    pal[:, 3, 3] = np.where(four, 255, 255 if opaque else 0)

    idx = (bits[:, None] >> (2 * np.arange(16, dtype=np.uint32))[None, :]) & 3
    out = np.take_along_axis(pal, idx[:, :, None].astype(np.int64), axis=1)
    return out.astype(np.uint8)


def _bc4_palette(e0: np.ndarray, e1: np.ndarray, signed: bool) -> np.ndarray:
    """[N] stored bytes -> [N,8] float palette in [0,1] or [-1,1]."""
    if signed:
        s0 = np.maximum(e0.astype(np.int8).astype(np.int32), -127)
        s1 = np.maximum(e1.astype(np.int8).astype(np.int32), -127)
        f0 = s0 / 127.0
        f1 = s1 / 127.0
        lo_ext, hi_ext = -1.0, 1.0
        eight = s0 > s1
    else:
        f0 = e0 / 255.0
        f1 = e1 / 255.0
        lo_ext, hi_ext = 0.0, 1.0
        eight = e0 > e1
    n = e0.shape[0]
    pal = np.zeros((n, 8), np.float64)
    pal[:, 0] = f0
    pal[:, 1] = f1
    for i in range(2, 8):
        w8 = (8 - i) / 7.0
        pal[:, i] = np.where(eight, w8 * f0 + (1 - w8) * f1, 0.0)
    for i in range(2, 6):
        w6 = (6 - i) / 5.0
        pal[:, i] = np.where(eight, pal[:, i], w6 * f0 + (1 - w6) * f1)
    pal[:, 6] = np.where(eight, pal[:, 6], lo_ext)
    pal[:, 7] = np.where(eight, pal[:, 7], hi_ext)
    return pal


def decode_bc4(data: np.ndarray, signed: bool = False) -> np.ndarray:
    """[N*8] or [N,8] uint8 -> [N,16] float64 in [0,1] (or [-1,1] signed)."""
    data = np.asarray(data, np.uint8).reshape(-1, 8)
    block = _u64(data)
    e0 = (block & 0xFF).astype(np.int64)
    e1 = ((block >> 8) & 0xFF).astype(np.int64)
    pal = _bc4_palette(e0, e1, signed)
    idx = (block[:, None] >> (16 + 3 * np.arange(16, dtype=np.uint64))[None, :]) & 7
    return np.take_along_axis(pal, idx.astype(np.int64), axis=1)


def decode_bc2(data: np.ndarray) -> np.ndarray:
    """[N*16] uint8 -> [N,16,4] uint8 (explicit 4-bit alpha + BC1 colors)."""
    data = np.asarray(data, np.uint8).reshape(-1, 16)
    abits = _u64(data[:, :8])
    color = decode_bc1(data[:, 8:], opaque=True)
    a4 = (abits[:, None] >> (4 * np.arange(16, dtype=np.uint64))[None, :]) & 0xF
    color[:, :, 3] = (a4 * 17).astype(np.uint8)  # 4-bit expand x17
    return color


def decode_bc3(data: np.ndarray) -> np.ndarray:
    """[N*16] uint8 -> [N,16,4] uint8 (BC4 alpha + BC1 colors)."""
    data = np.asarray(data, np.uint8).reshape(-1, 16)
    alpha = decode_bc4(data[:, :8], signed=False)
    color = decode_bc1(data[:, 8:], opaque=True)
    color[:, :, 3] = np.clip(np.round(alpha * 255.0), 0, 255).astype(np.uint8)
    return color


def decode_bc5(data: np.ndarray, signed: bool = False) -> np.ndarray:
    """[N*16] uint8 -> [N,16,2] float (two BC4 channels)."""
    data = np.asarray(data, np.uint8).reshape(-1, 16)
    r = decode_bc4(data[:, :8], signed=signed)
    g = decode_bc4(data[:, 8:], signed=signed)
    return np.stack([r, g], axis=-1)
