"""ASTC HDR profile encoder of the port (torch ops, no hand kernel).

The JAX package encodes ASTC + UFloat on its ``jnp`` path only
(``cuttlefish_tpu/kernels/astc.py:encode_astc_hdr``, a jitted XLA program;
no TPU kernel), so this module is its torch-ops port, function by function
and under the same names, run on whichever device holds the blocks: the
LNS16 targets (``_sf16_to_lns``, ``_to_lns16``), the HDR void extent
(``_void_extent_hdr``), the single-partition CEM 11 (direct submode) and
CEM 14 fits (``_fit_hdr_layout``) on the layouts of
``astc_tables.hdr_layout_menu``, and the merge (``encode_astc_hdr``).
Words are packed by the LDR plain version's ``_pack_1part``, whose bits
are ``_pack_block``'s for one partition.

Layout follows the JAX function: texels ``[N, T, C]``, per block ``[N, C]``.
Sums are written out in the order XLA's CPU backend takes (see
``kernels/jnp_common.py``): the small dots over channels and texels as left
folds, the reductions over texels as ``tsum``, the ``"gt,nt->ng"`` product
by the grid's pseudo-inverse in four texel lanes added as
``(s0 + s1) + (s2 + s3)`` (the LDR plain version's ``_screen_sum``), and
the integer infill ``"tg,ng->nt"`` exactly in float64.  Every float
operation is elementwise, so the CPU and the card compute them alike and
no TF32 setting reaches them.
"""

from __future__ import annotations

import functools

import torch

from cuttlefish_tpu_torch.kernels.astc import _pack_1part, _screen_sum, _table
from cuttlefish_tpu_torch.kernels.astc_tables import (
    _PLAN,
    _prepared_np,
    hdr_layout_menu,
)
from cuttlefish_tpu_torch.kernels.jnp_common import div, fold, ls_solve, principal_axis, tsum


def _sf16_to_lns(h):
    """Half bits (int64) -> 16-bit LNS code (``_sf16_to_lns_jnp``)."""
    h = torch.clamp(h, max=0x7BFF)
    e = h >> 10
    mt = (h & 0x3FF) << 3
    m = torch.where(
        mt < 3 * 512,
        (mt + 1) // 3,
        torch.where(mt < 4 * 1536 - 512, (mt + 514) // 4, (mt + 2050) // 5),
    )
    return (e << 11) | torch.clamp(m, max=0x7FF)


def _half_bits(x):
    """clip(x, 0, 65504) as float16 bits (int64)."""
    h = torch.clamp(x, 0.0, 65504.0).to(torch.float16).view(torch.int16)
    return h.to(torch.int64) & 0xFFFF


def _to_lns16(x):
    """float (>= 0) -> LNS16 code as float32 working values."""
    return _sf16_to_lns(_half_bits(x)).to(torch.float32)


@functools.lru_cache(maxsize=None)
def _grid(bw, bh, gw, gh, device: str):
    """(a [T,G] float64, pinv [G,T] float32) on ``device``."""
    a, pinv = _prepared_np(bw, bh, gw, gh)
    dev = torch.device(device)
    return (
        torch.as_tensor(a, dtype=torch.float64, device=dev),
        torch.as_tensor(pinv, dtype=torch.float32, device=dev),
    )


def _sq_sum(d):
    """((d)**2).sum((1, 2)) of [N,T,C]: per texel the channels' left fold,
    then the texels' ``tsum``."""
    t = d.shape[1]
    return tsum([fold([d[:, i, c] * d[:, i, c] for c in range(d.shape[2])]) for i in range(t)])


def _fit_hdr_layout(t16, lay, iters):
    """Fit CEM 11 (direct) / CEM 14 (``_fit_hdr_layout``).  t16 [N,T,4]
    float: RGB = LNS16 targets, A = UNORM16 target.  Returns (q0, q1, gq,
    err): ISE colour values [N,C], ISE weights [N,G], exact error [N]."""
    dev = t16.device
    a_mat, pinv = _grid(lay.bw, lay.bh, lay.gw, lay.gh, str(dev))
    use_alpha = lay.cem == 14
    nch = 4 if use_alpha else 3
    target = t16[..., :nch]
    n, t, _ = target.shape

    wq_lut = _table("wq", lay.wlevels, str(dev))
    unq_w = _table("unq", lay.wlevels, str(dev))
    up_tab = _table("up", lay.wlevels, str(dev))
    dn_tab = _table("dn", lay.wlevels, str(dev))

    mean = div(tsum([target[:, i] for i in range(t)]), t)
    centered = target - mean[:, None, :]
    axis = principal_axis(centered)
    proj = fold([centered[..., c] * axis[:, None, c] for c in range(nch)])
    e0 = mean + axis * proj.min(1).values[:, None]
    e1 = mean + axis * proj.max(1).values[:, None]

    def quant(e):
        """16-bit targets -> (ISE byte values [N,C], dec16 [N,C])."""
        r = torch.clamp(torch.round(e[:, 0] / 256.0), 0, 255).to(torch.int64)
        g = torch.clamp(torch.round(e[:, 1] / 256.0), 0, 255).to(torch.int64)
        b7 = torch.clamp(torch.round(e[:, 2] / 512.0), 0, 127).to(torch.int64)
        vals = [r, g, 0x80 | b7]
        decs = [r * 256, g * 256, b7 * 512]
        if use_alpha:
            a8 = torch.clamp(torch.round(div(e[:, 3], 257)), 0, 255).to(torch.int64)
            vals.append(a8)
            decs.append(a8 * 257)
        return torch.stack(vals, -1), torch.stack(decs, -1).to(torch.float32)

    def texel_w64(gq_vals):
        """C.2.18 infill of the grid's weights: integer-exact in float64."""
        u = unq_w[gq_vals].to(torch.float64)
        s = torch.matmul(u, a_mat.t()).to(torch.int64)
        return (s + 8) >> 4

    def texel_err(d0, d1, w64):
        """Per texel and channel: decoded value minus target, [N,T,C]."""
        w = w64.to(torch.float32)[..., None]
        c16 = torch.floor((d0[:, None, :] * (64.0 - w) + d1[:, None, :] * w + 32.0) / 64.0)
        return c16 - target

    def ideal_t(d0, d1):
        d = d1 - d0
        denom = fold([d[:, c] * d[:, c] for c in range(nch)]) + 1e-6
        r = target - d0[:, None, :]
        num = fold([r[..., c] * d[:, None, c] for c in range(nch)])
        return torch.clamp(num / denom[:, None], 0.0, 1.0)

    def quant_grid(tw):
        g = _screen_sum(pinv, tw.t()).t()
        w64 = torch.clamp(torch.round(torch.clamp(g, 0.0, 1.0) * 64.0), 0, 64).to(torch.int64)
        return wq_lut[w64]

    full_res = lay.gw == lay.bw and lay.gh == lay.bh

    def refine_grid(d0, d1, gq):
        """+-1 ladder-rung steps by exact decode error, full-res grids only."""
        if not full_res:
            return gq
        for _ in range(2):
            best_g, best_e = gq, None
            for cand in (gq, up_tab[gq], dn_tab[gq]):
                d = texel_err(d0, d1, texel_w64(cand))
                e = fold([d[..., c] * d[..., c] for c in range(nch)])
                if best_e is None:
                    best_e = e
                else:
                    take = e < best_e
                    best_g = torch.where(take, cand, best_g)
                    best_e = torch.minimum(e, best_e)
            gq = best_g
        return gq

    best = None
    for it in range(max(1, iters)):
        q0, d0 = quant(e0)
        q1, d1 = quant(e1)
        gq = quant_grid(ideal_t(d0, d1))
        gq = refine_grid(d0, d1, gq)
        err = _sq_sum(texel_err(d0, d1, texel_w64(gq)))
        cand = (q0, q1, gq, err)
        if best is None:
            best = cand
        else:
            take = err < best[3]
            best = tuple(
                torch.where(take[(...,) + (None,) * (b.dim() - 1)], c, b)
                for c, b in zip(cand, best)
            )
        if it + 1 < iters:
            w = texel_w64(gq).to(torch.float32) / 64.0
            e1n, e0n = ls_solve(target, w)
            e0 = torch.clamp(e0n, 0.0, 65535.0)
            e1 = torch.clamp(e1n, 0.0, 65535.0)
    return best


def _void_extent_hdr(blocks, t16):
    """Solid-color HDR candidate (``_void_extent_hdr``): (words, err)."""
    n, t, _ = blocks.shape
    x = blocks.to(torch.float32)
    mean = div(tsum([x[:, i] for i in range(t)]), t)  # [N,4]
    v16 = _half_bits(mean)
    dec_rgb = _sf16_to_lns(v16[:, :3]).to(torch.float32)
    dec_a = torch.clamp(mean[:, 3:], 0.0, 1.0) * 65535.0
    dec = torch.cat([dec_rgb, dec_a], -1)
    err = _sq_sum(dec[:, None, :] - t16)
    w0 = torch.full((n,), 0x1FC | (1 << 9) | (0b11 << 10) | 0xFFFFF000,
                    dtype=torch.int64, device=blocks.device)
    w1 = torch.full_like(w0, 0xFFFFFFFF)
    w2 = v16[:, 0] | (v16[:, 1] << 16)
    w3 = v16[:, 2] | (v16[:, 3] << 16)
    return torch.stack([w0, w1, w2, w3], -1), err


def _pack(lay, q0, q1, gq):
    words = _pack_1part(
        lay,
        [q0[:, c] for c in range(q0.shape[1])],
        [q1[:, c] for c in range(q1.shape[1])],
        gq.t(),
    )
    return torch.stack(words, -1)


def encode_astc_hdr(blocks, block_w=4, block_h=4, quality=2):
    """Encode [N, bw*bh, 4] float HDR RGBA to ASTC [N,4] uint32 words on the
    blocks' device: RGB HDR through CEM 11 (direct submode, error in the
    spec's LNS space), alpha LDR in [0,1] through CEM 14 (the reference's
    HDR_RGB_LDR_A profile), or the HDR void extent."""
    bw, bh = int(block_w), int(block_h)
    iters = _PLAN[max(0, min(4, int(quality)))]["iters"]
    x = blocks.to(torch.float32)
    if x.shape[0] == 0:
        return torch.zeros((0, 4), dtype=torch.uint32, device=x.device)
    rgb = torch.clamp(x[..., :3], min=0.0)
    alpha = torch.clamp(x[..., 3], 0.0, 1.0)
    t16 = torch.cat([_to_lns16(rgb), (alpha * 65535.0)[..., None]], -1)

    menu = hdr_layout_menu(bw, bh)
    best_words, best_err = _void_extent_hdr(x, t16)

    lay11 = menu[11]
    q0, q1, gq, err = _fit_hdr_layout(t16, lay11, iters)
    # CEM 11 alpha decodes to exactly 1.0; account the unorm16 distance.
    da = t16[..., 3] - 65535.0
    err = err + tsum([da[:, i] * da[:, i] for i in range(da.shape[1])])
    words = _pack(lay11, q0, q1, gq)
    take = err < best_err
    best_words = torch.where(take[:, None], words, best_words)
    best_err = torch.where(take, err, best_err)

    if menu[14] is not None:
        lay14 = menu[14]
        q0, q1, gq, err = _fit_hdr_layout(t16, lay14, iters)
        words = _pack(lay14, q0, q1, gq)
        take = err < best_err
        best_words = torch.where(take[:, None], words, best_words)
    return best_words.to(torch.uint32)
