"""The plain reference's mip chain, in float64 PyTorch.

The resample weights are a frozen copy of
``cuttlefish_tpu_torch/image/resample.py:resample_weights`` (the
reference project's FreeImage_Rescale semantics: the filter's support
widened by the scale on a downscale, taps beyond the edge clamped onto
it, rows summing to 1) as it stood when the benchmark was defined.  Each
level is resampled from the one above it, rows then columns, as two
products with those matrices; an sRGB texture is resampled in linear
light, through the sRGB transfer functions of IEC 61966-2-1, alpha
untouched.  No clamp: the filter's overshoot survives, as in the chain
the configuration names.
"""

from __future__ import annotations

import numpy as np
import torch


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


FILTERS = {
    "box": (_box, 0.5),
    "linear": (_linear, 1.0),
    "cubic": (lambda x: _bc_spline(x, 1.0 / 3.0, 1.0 / 3.0), 2.0),
    "catmullrom": (lambda x: _bc_spline(x, 0.0, 0.5), 2.0),
    "bspline": (lambda x: _bc_spline(x, 1.0, 0.0), 2.0),
}


def resample_weights(in_size: int, out_size: int, filter_name: str) -> np.ndarray:
    """Weight matrix (out_size x in_size), rows summing to 1, edge taps
    clamped onto the border texel."""
    fn, support = FILTERS[filter_name]
    scale = out_size / in_size
    if scale < 1.0:
        fwidth = support / scale
        fscale = 1.0 / scale
    else:
        fwidth = support
        fscale = 1.0
    out = np.zeros((out_size, in_size), np.float64)
    centers = (np.arange(out_size) + 0.5) / scale
    left = np.floor(centers - fwidth + 0.5).astype(np.int64)
    ntaps = int(np.ceil(fwidth * 2)) + 1
    taps = left[:, None] + np.arange(ntaps)[None, :]
    weights = fn((taps + 0.5 - centers[:, None]) / fscale)
    weights /= np.sum(weights, axis=1, keepdims=True)
    clamped = np.clip(taps, 0, in_size - 1)
    np.add.at(out, (np.repeat(np.arange(out_size), ntaps), clamped.ravel()), weights.ravel())
    return out


def srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    rgb = x[..., :3]
    lin = torch.where(rgb <= 0.04045, rgb / 12.92, ((rgb.clamp(min=0.04045) + 0.055) / 1.055) ** 2.4)
    return torch.cat([lin, x[..., 3:]], -1)


def linear_to_srgb(x: torch.Tensor) -> torch.Tensor:
    rgb = x[..., :3]
    enc = torch.where(
        rgb <= 0.0031308, rgb * 12.92, 1.055 * rgb.clamp(min=0.0031308) ** (1.0 / 2.4) - 0.055
    )
    return torch.cat([enc, x[..., 3:]], -1)


def mip_dims(h: int, w: int, levels: int) -> list[tuple[int, int]]:
    return [(max(h >> k, 1), max(w >> k, 1)) for k in range(levels)]


def full_levels(h: int, w: int) -> int:
    return int(max(h, w)).bit_length()


def chain(level0: torch.Tensor, levels: int, filter_name: str, srgb: bool):
    """Level 0 [S,H,W,4] (any float, the texture's colour space) -> the
    float64 levels [S,h,w,4] of the chain, level 0 first."""
    cur = level0.double()
    out = [cur]
    for hh, ww in mip_dims(cur.shape[1], cur.shape[2], levels)[1:]:
        wy = torch.from_numpy(resample_weights(cur.shape[1], hh, filter_name)).to(cur.device)
        wx = torch.from_numpy(resample_weights(cur.shape[2], ww, filter_name)).to(cur.device)
        src = srgb_to_linear(cur) if srgb else cur
        nxt = torch.einsum("oh,shwc->sowc", wy, src)
        nxt = torch.einsum("pw,sowc->sopc", wx, nxt)
        cur = linear_to_srgb(nxt) if srgb else nxt
        out.append(cur)
    return out


def rounding_bound(level0: torch.Tensor, levels: int, filter_name: str):
    """How far a program that builds the same chain in float32 may lie
    from it, texel by texel: at level k, k * 2^-20 times the chain of the
    magnitudes (|weights| applied to |values|), a generous bound on k
    levels of float32 sums of up to 2 x 8 terms each.  Level 0 is
    exact.  -> [S,h,w,4] float64 per level."""
    mag = level0.double().abs()
    out = [torch.zeros_like(mag)]
    for k, (hh, ww) in enumerate(mip_dims(mag.shape[1], mag.shape[2], levels)[1:], 1):
        wy = torch.from_numpy(np.abs(resample_weights(mag.shape[1], hh, filter_name))).to(mag.device)
        wx = torch.from_numpy(np.abs(resample_weights(mag.shape[2], ww, filter_name))).to(mag.device)
        mag = torch.einsum("pw,sowc->sopc", wx, torch.einsum("oh,shwc->sowc", wy, mag))
        out.append(mag * (k * 2.0**-20))
    return out


def tile(level: torch.Tensor, bw: int = 4, bh: int = 4) -> torch.Tensor:
    """[S,h,w,C] -> [S, nby*nbx, bh*bw, C] blocks in raster order, the
    edge texels repeated into partial blocks."""
    s, hh, ww, c = level.shape
    nby, nbx = -(-hh // bh), -(-ww // bw)
    rows = torch.arange(nby * bh, device=level.device).clamp(max=hh - 1)
    cols = torch.arange(nbx * bw, device=level.device).clamp(max=ww - 1)
    x = level.index_select(1, rows).index_select(2, cols)
    return (
        x.reshape(s, nby, bh, nbx, bw, c)
        .permute(0, 1, 3, 2, 4, 5)
        .reshape(s, nby * nbx, bh * bw, c)
    )
