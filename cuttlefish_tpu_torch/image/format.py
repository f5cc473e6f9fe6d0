"""Pixel formats and vectorized RGBA-double conversion.

Mirrors the reference's 18 pixel formats and their get/set semantics
(`lib/include/cuttlefish/Image.h:54-74`,
`lib/src/Image.cpp:293-706`): UNorm formats normalize to [0,1] doubles,
integer formats pass raw values, float formats pass through, grayscale
replicates, absent alpha reads 1.  Writes round-half-away-from-zero and clamp
for normalized targets, matching `fromDoubleNorm`.

Copied from ``cuttlefish_tpu/image/format.py`` with its imports pointed at
the port; its logic is unchanged.
"""

from __future__ import annotations

import enum

import numpy as np

from cuttlefish_tpu_torch.color import to_grayscale


class ImageFormat(enum.Enum):
    """Pixel formats (Image.h:54-74)."""

    Invalid = 0
    Gray8 = enum.auto()
    Gray16 = enum.auto()
    RGB5 = enum.auto()
    RGB565 = enum.auto()
    RGB8 = enum.auto()
    RGB16 = enum.auto()
    RGBF = enum.auto()
    RGBA8 = enum.auto()
    RGBA16 = enum.auto()
    RGBAF = enum.auto()
    Int16 = enum.auto()
    UInt16 = enum.auto()
    Int32 = enum.auto()
    UInt32 = enum.auto()
    Float = enum.auto()
    Double = enum.auto()
    Complex = enum.auto()


class Channel(enum.IntEnum):
    """Color channels for swizzling (Image.h:104-114)."""

    Red = 0
    Green = 1
    Blue = 2
    Alpha = 3
    Null = 4  # "None" in the reference; renamed (Python keyword).


Channel.NONE = Channel.Null

_IF = ImageFormat

# format -> (numpy dtype, channel count); channels==0 means scalar (H, W) array.
_STORAGE: dict[ImageFormat, tuple[np.dtype, int]] = {
    _IF.Gray8: (np.dtype(np.uint8), 0),
    _IF.Gray16: (np.dtype(np.uint16), 0),
    _IF.RGB5: (np.dtype(np.uint8), 3),  # 5-bit values 0..31 per channel
    _IF.RGB565: (np.dtype(np.uint8), 3),  # 5/6/5-bit values per channel
    _IF.RGB8: (np.dtype(np.uint8), 3),
    _IF.RGB16: (np.dtype(np.uint16), 3),
    _IF.RGBF: (np.dtype(np.float32), 3),
    _IF.RGBA8: (np.dtype(np.uint8), 4),
    _IF.RGBA16: (np.dtype(np.uint16), 4),
    _IF.RGBAF: (np.dtype(np.float32), 4),
    _IF.Int16: (np.dtype(np.int16), 0),
    _IF.UInt16: (np.dtype(np.uint16), 0),
    _IF.Int32: (np.dtype(np.int32), 0),
    _IF.UInt32: (np.dtype(np.uint32), 0),
    _IF.Float: (np.dtype(np.float32), 0),
    _IF.Double: (np.dtype(np.float64), 0),
    _IF.Complex: (np.dtype(np.float64), 2),  # (real, imaginary)
}

# UNorm maxima per channel for the normalized formats.
_NORM_MAX: dict[ImageFormat, tuple[float, ...]] = {
    _IF.Gray8: (255.0,),
    _IF.Gray16: (65535.0,),
    _IF.RGB5: (31.0, 31.0, 31.0),
    _IF.RGB565: (31.0, 63.0, 31.0),
    _IF.RGB8: (255.0, 255.0, 255.0),
    _IF.RGB16: (65535.0, 65535.0, 65535.0),
    _IF.RGBA8: (255.0, 255.0, 255.0, 255.0),
    _IF.RGBA16: (65535.0,) * 4,
}

GRAYSCALE_FORMATS = frozenset({_IF.Gray8, _IF.Gray16, _IF.Float, _IF.Double})

INT_FORMATS = frozenset({_IF.Int16, _IF.UInt16, _IF.Int32, _IF.UInt32})


def storage_dtype(fmt: ImageFormat) -> np.dtype:
    return _STORAGE[fmt][0]


def storage_channels(fmt: ImageFormat) -> int:
    return _STORAGE[fmt][1]


def storage_shape(fmt: ImageFormat, width: int, height: int) -> tuple[int, ...]:
    ch = storage_channels(fmt)
    return (height, width) if ch == 0 else (height, width, ch)


def empty_storage(fmt: ImageFormat, width: int, height: int) -> np.ndarray:
    return np.zeros(storage_shape(fmt, width, height), storage_dtype(fmt))


def to_rgbad(data: np.ndarray, fmt: ImageFormat) -> np.ndarray:
    """Whole-image getPixel: storage array -> (H, W, 4) float64 RGBA.

    Semantics per getPixelImpl (Image.cpp:345-474).
    """
    h, w = data.shape[:2]
    out = np.empty((h, w, 4), np.float64)
    out[..., 3] = 1.0
    if fmt in (_IF.Gray8, _IF.Gray16):
        maxv = _NORM_MAX[fmt][0]
        out[..., 0] = out[..., 1] = out[..., 2] = data / maxv
    elif fmt in (_IF.RGB5, _IF.RGB565, _IF.RGB8, _IF.RGB16):
        maxv = np.asarray(_NORM_MAX[fmt], np.float64)
        out[..., :3] = data / maxv
    elif fmt is _IF.RGBF:
        out[..., :3] = data
    elif fmt in (_IF.RGBA8, _IF.RGBA16):
        maxv = np.asarray(_NORM_MAX[fmt], np.float64)
        out[...] = data / maxv
    elif fmt is _IF.RGBAF:
        out[...] = data
    elif fmt in INT_FORMATS or fmt in (_IF.Float, _IF.Double):
        out[..., 0] = out[..., 1] = out[..., 2] = data
    elif fmt is _IF.Complex:
        out[..., 0] = data[..., 0]
        out[..., 1] = data[..., 1]
        out[..., 2] = 0.0
    else:
        raise ValueError(f"cannot read pixels of {fmt}")
    return out


def _round_norm(values: np.ndarray, maxima) -> np.ndarray:
    """clamp [0,1], scale, round half away from zero (fromDoubleNorm)."""
    maxima = np.asarray(maxima, np.float64)
    scaled = np.clip(values, 0.0, 1.0) * maxima
    # np.round is half-to-even; the reference uses std::round (half away from
    # zero). Values here are non-negative so floor(x + 0.5) matches.
    return np.floor(scaled + 0.5)


def from_rgbad(
    rgba: np.ndarray, fmt: ImageFormat, grayscale_convert: bool = False
) -> np.ndarray:
    """Whole-image setPixel: (H, W, 4) float64 RGBA -> storage array.

    ``grayscale_convert`` selects setPixelImpl (grayscale targets apply
    Rec.709 on write) vs setPixelNoGrayscaleImpl (take the red channel).
    Per Image.cpp:476-706.
    """
    dtype = storage_dtype(fmt)
    if fmt in GRAYSCALE_FORMATS:
        if grayscale_convert:
            gray = to_grayscale(rgba[..., 0], rgba[..., 1], rgba[..., 2])
        else:
            gray = rgba[..., 0]
        if fmt in (_IF.Gray8, _IF.Gray16):
            return _round_norm(gray, _NORM_MAX[fmt][0]).astype(dtype)
        return gray.astype(dtype)
    if fmt in (_IF.RGB5, _IF.RGB565, _IF.RGB8, _IF.RGB16):
        return _round_norm(rgba[..., :3], _NORM_MAX[fmt]).astype(dtype)
    if fmt is _IF.RGBF:
        return rgba[..., :3].astype(dtype)
    if fmt in (_IF.RGBA8, _IF.RGBA16):
        return _round_norm(rgba, _NORM_MAX[fmt]).astype(dtype)
    if fmt is _IF.RGBAF:
        return rgba.astype(dtype)
    if fmt in INT_FORMATS:
        info = np.iinfo(dtype)
        return np.clip(np.trunc(rgba[..., 0]), info.min, info.max).astype(dtype)
    if fmt is _IF.Complex:
        return np.stack([rgba[..., 0], rgba[..., 1]], axis=-1).astype(dtype)
    raise ValueError(f"cannot write pixels of {fmt}")


# Pixel-layout introspection (reference Image.h:282-342, values matching
# FreeImage on little-endian: FI_RGBA_* for 24/32-bit bitmaps, FI16_555 /
# FI16_565 for the packed 16-bit formats, zero for non-bitmap types).
# Note the reference's Impl constructor assigns the green mask to blueMask
# (Image.cpp:746, an upstream copy-paste slip); we implement the intended
# per-channel values.
_BPP: dict[ImageFormat, int] = {
    _IF.Invalid: 0, _IF.Gray8: 8, _IF.Gray16: 16, _IF.RGB5: 16,
    _IF.RGB565: 16, _IF.RGB8: 24, _IF.RGB16: 48, _IF.RGBF: 96,
    _IF.RGBA8: 32, _IF.RGBA16: 64, _IF.RGBAF: 128, _IF.Int16: 16,
    _IF.UInt16: 16, _IF.Int32: 32, _IF.UInt32: 32, _IF.Float: 32,
    _IF.Double: 64, _IF.Complex: 128,
}

# fmt -> (red, green, blue, alpha) (mask, shift) pairs.
_MASKS: dict[ImageFormat, tuple] = {
    _IF.RGB5: ((0x7C00, 10), (0x03E0, 5), (0x001F, 0), (0, 0)),
    _IF.RGB565: ((0xF800, 11), (0x07E0, 5), (0x001F, 0), (0, 0)),
    _IF.RGB8: ((0x00FF0000, 16), (0x0000FF00, 8), (0x000000FF, 0), (0, 0)),
    _IF.RGBA8: (
        (0x00FF0000, 16), (0x0000FF00, 8), (0x000000FF, 0),
        (0xFF000000, 24),
    ),
}


def bits_per_pixel(fmt: ImageFormat) -> int:
    """Storage bits per pixel (Image.h:282, FreeImage_GetBPP values)."""
    return _BPP[fmt]


def channel_mask_shift(fmt: ImageFormat, channel: int) -> tuple[int, int]:
    """(mask, shift) of a packed channel, 0..3 = RGBA; zeros when the
    format has no packed integer channel layout (Image.h:300-342)."""
    entry = _MASKS.get(fmt)
    if entry is None:
        return (0, 0)
    return entry[channel]
