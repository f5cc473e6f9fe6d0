"""HDR sky cubes: seeded, distinct cube maps of an outdoor sky in linear
light, as the EXR or HDR source of a skybox or reflection-probe cube
holds them (float32, alpha 1).

Each of the six faces is looked up by its texels' directions (the DDS
face order +X, -X, +Y, -Y, +Z, -Z).  Above the horizon a sky gradient
from 3-8 at the horizon to 0.5-1.2 at the zenith (a tint drawn a
channel), with clouds of 2-6 where a sum of drifting sinusoids over the
sky plane crosses a threshold; below it a ground of 0.01-0.3; a sun of
2,000-5,000 a channel, 0.45-0.85 degrees across, at a direction drawn
inside one of the four side faces, with a glow of up to 20 around it;
then a multiplicative noise of 1 % a texel and channel, as a capture's
noise.  Every draw comes from the seed; every member has the same sizes
and the same kinds of features, so each cube is as hard to encode as
the others.
"""

from __future__ import annotations

import math

import torch


def _directions(size: int, device) -> torch.Tensor:
    """[6, size, size, 3] unit directions of the faces' texel centres."""
    c = (torch.arange(size, dtype=torch.float32, device=device) + 0.5) * (2.0 / size) - 1.0
    v, u = torch.meshgrid(c, c, indexing="ij")
    one = torch.ones_like(u)
    faces = [
        (one, -v, -u), (-one, -v, u),  # +X, -X
        (u, one, v), (u, -one, -v),  # +Y, -Y
        (u, -v, one), (-u, -v, -one),  # +Z, -Z
    ]
    d = torch.stack([torch.stack(f, -1) for f in faces])
    return d / d.norm(dim=-1, keepdim=True)


# The side faces' centre directions (+X, -X, +Z, -Z): the sun's face.
_SIDES = ((1.0, 0.0), (-1.0, 0.0), (0.0, 1.0), (0.0, -1.0))


def make(traffic: dict, gen: torch.Generator, device) -> torch.Tensor:
    """-> [pool, 6, size, size, 4] float32 on device."""
    size, pool, faces = traffic["size"], traffic["pool"], traffic["faces"]
    if faces != 6:
        raise ValueError("sky content is a cube map: faces must be 6")
    d = _directions(size, device)
    x, y, z = d.unbind(-1)
    elev = y
    # Every member's draws at once, in a fixed order.
    r = torch.rand((pool, 32), generator=gen, device=device)
    noise = torch.randn((pool, 6, size, size, 3), generator=gen, device=device)
    out = torch.empty((pool, 6, size, size, 4), dtype=torch.float32, device=device)
    out[..., 3] = 1.0
    up = elev.clamp(min=0.0)
    # The sky plane: where a ray at this elevation meets a cloud layer.
    px = x / (up + 0.08)
    pz = z / (up + 0.08)
    for i in range(pool):
        p = r[i]
        horizon = 3.0 + 5.0 * p[0:3]
        zenith = 0.5 + 0.7 * p[3:6]
        power = 2.0 + 2.0 * p[6]
        sky = zenith + (horizon - zenith) * ((1.0 - up) ** power)[..., None]
        n = torch.zeros_like(px)
        for k in range(4):
            f = 0.6 * (k + 1) * (0.75 + 0.5 * p[7 + k])
            ang = 2 * math.pi * p[11 + k]
            n = n + torch.sin(f * (math.cos(ang) * px + math.sin(ang) * pz) + 2 * math.pi * p[15 + k]) / (k + 1)
        cover = ((n - 0.2 - 0.4 * p[19]) * 2.5).clamp(0.0, 1.0) * (up * 8.0).clamp(max=1.0)
        cloud = 2.0 + 4.0 * p[20]
        sky = sky * (1.0 - cover)[..., None] + (cloud * torch.tensor([1.0, 0.98, 0.95], device=device)) * cover[..., None]
        g = 0.5 + 0.5 * torch.sin(23.0 * (1 + p[21]) * x + 2 * math.pi * p[22]) * torch.cos(17.0 * (1 + p[23]) * z)
        ground = 0.01 + 0.29 * g[..., None] * torch.tensor([1.0, 0.85, 0.7], device=device)
        blend = ((elev + 0.02) / 0.02).clamp(0.0, 1.0)[..., None]
        col = ground * (1.0 - blend) + sky * blend
        # The sun: inside one side face, 0.12-0.62 rad above the horizon
        # and within 0.5 rad of the face's centre in azimuth.
        side = _SIDES[min(int(p[24] * 4), 3)]
        az = math.atan2(side[1], side[0]) + (p[25] - 0.5)
        el = 0.12 + 0.5 * p[26]
        sun = torch.stack([torch.cos(el) * torch.cos(az), torch.sin(el), torch.cos(el) * torch.sin(az)])
        cosang = (d * sun).sum(-1).clamp(-1.0, 1.0)
        ang = torch.acos(cosang)
        radius = 0.004 + 0.0035 * p[27]
        power_sun = 2000.0 + 3000.0 * p[28:31]
        disc = (1.0 - (ang - radius) / 0.0015).clamp(0.0, 1.0)  # a soft limb of about a texel
        glow = (5.0 + 15.0 * p[31]) * torch.exp(-ang / 0.05)
        col = col + glow[..., None] * torch.tensor([1.0, 0.9, 0.75], device=device)
        col = col * (1.0 - disc)[..., None] + power_sun * disc[..., None]
        out[i, ..., :3] = col * (1.0 + 0.01 * noise[i])
    return out
