"""Albedo textures: seeded members of the test-surface family.

Frozen from ``chip_smoke.py:test_surface`` (itself ``bench.py``'s
``_test_surface``) and ``chip_smoke.py:alpha_surface``: three sinusoids
across the surface in R, G and B, Gaussian noise of 0.02, clipped to
[0, 1]; alpha either 1 or the alpha surface's 0.5 + 0.45 cos(...) with
its own noise.  A member draws the sinusoids' frequencies (0.75-1.25
times the originals) and phases from the seed, so every texture of a
stream is distinct while each is as hard to encode as the original.
The values are the texture's colour-space values (sRGB-encoded for an
sRGB texture), rounded to 8 bits a channel, as the PNG that an asset
build reads holds them.
"""

from __future__ import annotations

import math

import torch


def make(traffic: dict, gen: torch.Generator, device) -> torch.Tensor:
    """-> [pool, 1, size, size, 4] float32 on device; the first
    ``round(pool * alpha_share)`` members carry the alpha surface."""
    size, pool = traffic["size"], traffic["pool"]
    with_alpha = round(pool * traffic["alpha_share"])
    ramp = torch.arange(size, dtype=torch.float32, device=device) / size
    y, x = ramp[:, None], ramp[None, :]
    out = torch.empty((pool, 1, size, size, 4), dtype=torch.float32, device=device)
    freq = 0.75 + 0.5 * torch.rand((pool, 8), generator=gen, device=device)
    phase = 2 * math.pi * torch.rand((pool, 4), generator=gen, device=device)
    noise = torch.randn((pool, size, size, 4), generator=gen, device=device) * 0.02
    for i in range(pool):
        f, p = freq[i], phase[i]
        surf = torch.stack(
            [
                0.5 + 0.5 * torch.sin(6.0 * f[0] * x + 2.0 * f[1] * y + p[0]),
                0.5 + 0.5 * torch.cos(4.0 * f[2] * y + f[3] * x + p[1]),
                0.5 + 0.5 * torch.sin(3.0 * f[4] * (x + y) + p[2]),
                0.5 + 0.45 * torch.cos(5.0 * f[5] * x + 3.0 * f[6] * y + p[3]),
            ],
            -1,
        )
        surf = torch.clamp(surf + noise[i], 0.0, 1.0)
        if i >= with_alpha:
            surf[..., 3] = 1.0
        out[i, 0] = torch.round(surf * 255.0) / 255.0
    return out
