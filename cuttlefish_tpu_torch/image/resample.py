"""Separable image resampling (resize and mipmap generation).

Replaces FreeImage_Rescale and the reference's box/linear fallback paths
(`lib/src/Image.cpp:1324-1511`).  The five filters match the
reference's ResizeFilter enum (Image.h:79-89): Box, Linear (tent), Cubic
(Mitchell-Netravali B=C=1/3, FreeImage's bicubic), CatmullRom, BSpline.

Resampling is expressed as two weight matrices (out x in) applied as matmuls,
so the same code path runs on host numpy and — for the device-resident mip
pipeline — on TPU via jnp, where the matmuls map straight onto the MXU.

Copied from ``cuttlefish_tpu/image/resample.py`` with its imports pointed at
the port; its logic is unchanged.
"""

from __future__ import annotations

import numpy as np


def _box(x):
    return (np.abs(x) <= 0.5).astype(np.float64)


def _linear(x):
    return np.maximum(1.0 - np.abs(x), 0.0)


def _bc_spline(x, b, c):
    """Mitchell-Netravali two-parameter cubic, support 2."""
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    p1 = ((12 - 9 * b - 6 * c) * ax3 + (-18 + 12 * b + 6 * c) * ax2 + (6 - 2 * b)) / 6.0
    p2 = (
        (-b - 6 * c) * ax3
        + (6 * b + 30 * c) * ax2
        + (-12 * b - 48 * c) * ax
        + (8 * b + 24 * c)
    ) / 6.0
    return np.where(ax < 1.0, p1, np.where(ax < 2.0, p2, 0.0))


_FILTERS = {
    "box": (_box, 0.5),
    "linear": (_linear, 1.0),
    "cubic": (lambda x: _bc_spline(x, 1.0 / 3.0, 1.0 / 3.0), 2.0),
    "catmullrom": (lambda x: _bc_spline(x, 0.0, 0.5), 2.0),
    "bspline": (lambda x: _bc_spline(x, 1.0, 0.0), 2.0),
}


def resample_weights(
    in_size: int, out_size: int, filter_name: str, edge: str = "clamp"
) -> np.ndarray:
    """Weight matrix W (out_size x in_size) with rows summing to 1.

    Downscales widen the filter support by the scale factor (anti-aliasing).
    ``edge="clamp"``: out-of-range taps clamp to the boundary pixel (their
    weight folds onto it) — FreeImage_Rescale behavior.  ``edge="drop"``:
    out-of-range taps are discarded and in-range weights renormalized —
    the behavior of the reference's box/linear fallback paths and
    generateMips3d (Texture.cpp:103-227).
    """
    fn, support = _FILTERS[filter_name]
    scale = out_size / in_size
    if scale < 1.0:
        fwidth = support / scale
        fscale = 1.0 / scale
    else:
        fwidth = support
        fscale = 1.0

    out = np.zeros((out_size, in_size), np.float64)
    centers = (np.arange(out_size) + 0.5) / scale  # in input pixel coords
    left = np.floor(centers - fwidth + 0.5).astype(np.int64)
    ntaps = int(np.ceil(fwidth * 2)) + 1
    taps = left[:, None] + np.arange(ntaps)[None, :]
    offsets = (taps + 0.5 - centers[:, None]) / fscale
    weights = fn(offsets)
    if edge == "drop":
        weights = np.where((taps >= 0) & (taps < in_size), weights, 0.0)
    weights /= np.sum(weights, axis=1, keepdims=True)
    clamped = np.clip(taps, 0, in_size - 1)
    np.add.at(out, (np.repeat(np.arange(out_size), ntaps), clamped.ravel()), weights.ravel())
    return out


def resize_2d(
    data: np.ndarray, out_w: int, out_h: int, filter_name: str
) -> np.ndarray:
    """Resize (H, W[, C]) float array separably.

    Computes in float32 when the input is float32/float16 (the RGBAF mip
    pipeline — matches the reference's all-float math and halves GEMM
    cost); float64 otherwise (Double/Int formats).
    """
    in_h, in_w = data.shape[:2]
    dtype = np.float32 if data.dtype in (np.float32, np.float16) else np.float64
    result = np.ascontiguousarray(data, dtype)
    chans = result.shape[2:]
    c = int(np.prod(chans)) if chans else 1
    if in_h != out_h:
        wy = resample_weights(in_h, out_h, filter_name).astype(dtype)
        # One flat 2-D GEMM (rows x (W*C)); tensordot's moveaxis copies
        # cost more than the matmul itself on mip-sized images.
        result = (wy @ result.reshape(in_h, in_w * c)).reshape(
            (out_h, in_w) + chans
        )
    if in_w != out_w:
        wx = resample_weights(in_w, out_w, filter_name).astype(dtype)
        flat = np.ascontiguousarray(result.transpose(1, 0, *range(2, result.ndim)))
        flat = (wx @ flat.reshape(in_w, out_h * c)).reshape(
            (out_w, out_h) + chans
        )
        result = np.ascontiguousarray(flat.transpose(1, 0, *range(2, flat.ndim)))
    return result


def resample_weights_z(in_size: int, out_size: int, filter_name: str) -> np.ndarray:
    """Weights for filtering across 3D texture depth (Texture.cpp:103-227).

    The reference's 3D mip path supports Box and tent ("linear") weights; other
    filters fall back to linear there, matching generateMips3d.
    """
    if filter_name == "box":
        return resample_weights(in_size, out_size, "box", edge="drop")
    return resample_weights(in_size, out_size, "linear", edge="drop")
