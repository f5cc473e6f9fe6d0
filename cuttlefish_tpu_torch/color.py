"""Color-space math shared by the image pipeline and the encoders.

Matches the reference's transfer functions and grayscale weights
(`lib/include/cuttlefish/Color.h:213-242`): Rec.709 luma,
piecewise sRGB <-> linear.  Implementations are array-module agnostic so the
same code runs on host numpy (image pipeline) and inside jit/jnp (encoders).

Copied from ``cuttlefish_tpu/color.py`` with its imports pointed at
the port; its logic is unchanged.
"""

from __future__ import annotations

import numpy as np

# Rec. 709 luma weights (Color.h:213-217).
GRAYSCALE_WEIGHTS = (0.2126, 0.7152, 0.0722)


def to_grayscale(r, g, b):
    """Rec.709 grayscale (Color.h:213-217)."""
    wr, wg, wb = GRAYSCALE_WEIGHTS
    return r * wr + g * wg + b * wb


def srgb_to_linear(c, xp=np):
    """Piecewise sRGB EOTF (Color.h:224-229). Works for numpy or jnp arrays."""
    c = xp.asarray(c)
    return xp.where(c <= 0.04045, c / 12.92, ((xp.maximum(c, 0.04045) + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(c, xp=np):
    """Piecewise sRGB OETF (Color.h:236-241). Works for numpy or jnp arrays."""
    c = xp.asarray(c)
    return xp.where(
        c <= 0.0031308,
        c * 12.92,
        1.055 * xp.maximum(c, 0.0031308) ** (1.0 / 2.4) - 0.055,
    )


def srgb_to_linear_rgba(rgba, xp=np):
    """Apply sRGB->linear to RGB channels of an (..., 4) array, alpha untouched."""
    rgba = xp.asarray(rgba)
    rgb = srgb_to_linear(rgba[..., :3], xp)
    return xp.concatenate([rgb, rgba[..., 3:]], axis=-1)


def linear_to_srgb_rgba(rgba, xp=np):
    """Apply linear->sRGB to RGB channels of an (..., 4) array, alpha untouched."""
    rgba = xp.asarray(rgba)
    rgb = linear_to_srgb(rgba[..., :3], xp)
    return xp.concatenate([rgb, rgba[..., 3:]], axis=-1)
