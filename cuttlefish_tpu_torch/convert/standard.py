"""Uncompressed/packed format converters.

Vectorized bit-packing matching the reference StandardConverter family
(`lib/src/StandardConverter.{h,cpp}`): UNorm
round(clamp(v,0,1)*max), SNorm round(clamp(v,-1,1)*max), Int
round(clamp(v,min,max)), Float/Half passthrough/conversion, and the packed
layouts (4444/565/5551/1010102/UF11/RGB9E5...) with the exact bit orders of
StandardConverter.cpp.  These are memory-bound transforms; they run
host-side in numpy (the compressed formats are the device-compute path).

Copied from ``cuttlefish_tpu/convert/standard.py`` with its imports pointed at
the port; its logic is unchanged.
"""

from __future__ import annotations

import numpy as np

from cuttlefish_tpu_torch.convert import Converter, EncodeParams
from cuttlefish_tpu_torch.formats import TextureFormat, TextureType
from cuttlefish_tpu_torch.packfloat import f32_to_half_bits, pack_b10g11r11, pack_rgb9e5

_F = TextureFormat
_T = TextureType


def _round(x):
    """std::round: half away from zero (inputs may be negative for SNorm/Int)."""
    return np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5))


def _unorm(x, maxval):
    return _round(np.clip(x, 0.0, 1.0) * maxval).astype(np.int64)


def _snorm(x, maxval):
    return _round(np.clip(x, -1.0, 1.0) * maxval).astype(np.int64)


class _FnConverter(Converter):
    def __init__(self, fn):
        self._fn = fn

    def encode(self, surface: np.ndarray, params: EncodeParams) -> np.ndarray:
        pixels = np.asarray(surface, np.float32).reshape(-1, 4)
        return self._fn(pixels).reshape(-1).view(np.uint8).copy()


def _le(dtype):
    return np.dtype(dtype).newbyteorder("<")


def _direct(channels: int, dtype, transform):
    """Per-channel converter taking the first `channels` RGBA channels."""

    def fn(pixels):
        vals = transform(pixels[:, :channels])
        return np.ascontiguousarray(vals.astype(_le(dtype)))

    return _FnConverter(fn)


def _packed16(layout):
    """layout: list of (channel_index, bits, shift) or ('const', value, shift)."""

    def fn(pixels):
        out = np.zeros(pixels.shape[0], np.int64)
        for ch, bits, shift in layout:
            maxval = (1 << bits) - 1
            q = _unorm(pixels[:, ch], maxval) & maxval
            out |= q << shift
        return out.astype(_le(np.uint16))

    return _FnConverter(fn)


def _packed32(layout, unorm=True):
    def fn(pixels):
        out = np.zeros(pixels.shape[0], np.int64)
        for ch, bits, shift in layout:
            maxval = (1 << bits) - 1
            if unorm:
                q = _unorm(pixels[:, ch], maxval) & maxval
            else:
                q = _round(np.clip(pixels[:, ch], 0, maxval)).astype(np.int64) & maxval
            out |= q << shift
        return out.astype(_le(np.uint32))

    return _FnConverter(fn)


_R, _G, _B, _A = 0, 1, 2, 3

# Byte-order converters (channel sequence in memory).
_BYTE_ORDERS = {
    _F.B8G8R8: (_B, _G, _R),
    _F.B8G8R8A8: (_B, _G, _R, _A),
    _F.A8B8G8R8: (_A, _B, _G, _R),
}


def _reorder8(order):
    def fn(pixels):
        vals = _unorm(pixels[:, list(order)], 255.0)
        return np.ascontiguousarray(vals.astype(np.uint8))

    return _FnConverter(fn)


def create_standard_converter(fmt: TextureFormat, type_: TextureType) -> Converter | None:
    """Uncompressed converter factory (Converter.cpp:32-506 standard rows)."""
    # R4G4: one byte, g low nibble, r high (StandardConverter.cpp:~15).
    if fmt is _F.R4G4:
        return _FnConverter(
            lambda p: (
                (_unorm(p[:, _G], 15) | (_unorm(p[:, _R], 15) << 4)).astype(np.uint8)
            )
        )
    if fmt is _F.R4G4B4A4:
        return _packed16([(_A, 4, 0), (_B, 4, 4), (_G, 4, 8), (_R, 4, 12)])
    if fmt is _F.B4G4R4A4:
        return _packed16([(_A, 4, 0), (_R, 4, 4), (_G, 4, 8), (_B, 4, 12)])
    if fmt is _F.A4R4G4B4:
        return _packed16([(_B, 4, 0), (_G, 4, 4), (_R, 4, 8), (_A, 4, 12)])
    if fmt is _F.R5G6B5:
        return _packed16([(_B, 5, 0), (_G, 6, 5), (_R, 5, 11)])
    if fmt is _F.B5G6R5:
        return _packed16([(_R, 5, 0), (_G, 6, 5), (_B, 5, 11)])
    if fmt is _F.R5G5B5A1:
        return _packed16([(_A, 1, 0), (_B, 5, 1), (_G, 5, 6), (_R, 5, 11)])
    if fmt is _F.B5G5R5A1:
        return _packed16([(_A, 1, 0), (_R, 5, 1), (_G, 5, 6), (_B, 5, 11)])
    if fmt is _F.A1R5G5B5:
        return _packed16([(_B, 5, 0), (_G, 5, 5), (_R, 5, 10), (_A, 1, 15)])

    if fmt in _BYTE_ORDERS:
        return _reorder8(_BYTE_ORDERS[fmt])

    if fmt in (_F.A2R10G10B10, _F.A2B10G10R10):
        # A2R10G10B10: b | g<<10 | r<<20 | a<<30; A2B10G10R10 swaps r/b
        # (StandardConverter.cpp:301-397).
        first = _B if fmt is _F.A2R10G10B10 else _R
        last = _R if fmt is _F.A2R10G10B10 else _B
        layout = [(first, 10, 0), (_G, 10, 10), (last, 10, 20), (_A, 2, 30)]
        return _packed32(layout, unorm=type_ is _T.UNorm)

    if fmt is _F.B10G11R11_UFloat:
        return _FnConverter(
            lambda p: pack_b10g11r11(p[:, :3]).astype(_le(np.uint32))
        )
    if fmt is _F.E5B9G9R9_UFloat:
        return _FnConverter(lambda p: pack_rgb9e5(p[:, :3]).astype(_le(np.uint32)))

    # Plain N-channel formats.
    plain = {
        _F.R8: (1, np.uint8, np.int8),
        _F.R8G8: (2, np.uint8, np.int8),
        _F.R8G8B8: (3, np.uint8, np.int8),
        _F.R8G8B8A8: (4, np.uint8, np.int8),
        _F.R16: (1, np.uint16, np.int16),
        _F.R16G16: (2, np.uint16, np.int16),
        _F.R16G16B16: (3, np.uint16, np.int16),
        _F.R16G16B16A16: (4, np.uint16, np.int16),
        _F.R32: (1, np.uint32, np.int32),
        _F.R32G32: (2, np.uint32, np.int32),
        _F.R32G32B32: (3, np.uint32, np.int32),
        _F.R32G32B32A32: (4, np.uint32, np.int32),
    }
    if fmt in plain:
        channels, udtype, sdtype = plain[fmt]
        if type_ is _T.UNorm:
            maxval = np.iinfo(udtype).max
            return _direct(channels, udtype, lambda x, m=maxval: _unorm(x, m))
        if type_ is _T.SNorm:
            maxval = np.iinfo(sdtype).max
            return _direct(channels, sdtype, lambda x, m=maxval: _snorm(x, m))
        if type_ is _T.UInt:
            info = np.iinfo(udtype)
            return _direct(
                channels,
                udtype,
                lambda x, lo=info.min, hi=info.max: _round(np.clip(x, lo, hi)).astype(
                    np.int64
                ),
            )
        if type_ is _T.Int:
            info = np.iinfo(sdtype)
            return _direct(
                channels,
                sdtype,
                lambda x, lo=info.min, hi=info.max: _round(np.clip(x, lo, hi)).astype(
                    np.int64
                ),
            )
        if type_ is _T.Float:
            if udtype is np.uint16:
                return _direct(channels, np.uint16, lambda x: f32_to_half_bits(x))
            return _direct(channels, np.float32, lambda x: x)
    return None
