"""ETC1/ETC2/EAC block encoders: plain PyTorch version and dispatch.

The plain version computes what the TPU kernels of
``cuttlefish_tpu/kernels/etc_pallas.py`` compute, function by function and
under the same names: ``_rgb_words`` (ETC1 differential and, from quality
1, individual mode, both flips, over a quant-index neighbourhood of the
sub-block means ranked by a restricted-table estimate; for ETC2 the planar,
T and H modes, refined at quality 4), ``_eac_alpha`` (EAC 8-bit) and
``_eac_r11`` (EAC 11-bit, unsigned and signed), composed into the five
entries as ``encode_*_pallas`` compose them.  It follows the Pallas kernel,
not the JAX package's ``jnp`` path (``kernels/etc.py``).  Layout follows
``kernels/bc.py``: each channel is a ``[16, N]`` tensor (texels x blocks in
raster order), per-block values are ``[N]``.

Two helpers of ``etc_pallas.py`` are not ported: ``_etc1_candidate`` and
``_quant_bases``.  ``_rgb_words`` never reaches them.

Every sum over the 16 texels and over the three channels is a left fold in
texel (channel) order, every constant the float32 value JAX uses, and
every search keeps the first minimum (strict ``<`` in candidate order), as
the hand kernel (``csrc/etc_encode.cu``) does, so that the two agree bit
for bit.  One operation follows the jitted kernel rather than its source:
EAC's multiplier seed ``span / max_pos[t]`` is ``span * float32(1 /
max_pos[t])``, because XLA rewrites a division by a constant as a product
with its reciprocal; the JAX package computes it that way both in
interpret mode and on its ``jnp`` path.

``encode_etc_rgb``, ``encode_etc2_rgba``, ``encode_eac_alpha``,
``encode_eac_r11`` and ``encode_eac_rg11`` run this plain version for a CPU
tensor and the hand kernel (``kernels/etc_cuda.py``) for a CUDA tensor;
they never fall back from one to the other.
"""

from __future__ import annotations

import numpy as np
import torch

from cuttlefish_tpu_torch.kernels.bc import (
    _csum,
    _device_kind,
    _empty,
    _rt,
    _sel,
    _sq,
    channel_weights,
)
from cuttlefish_tpu_torch.kernels.etc_tables import (
    _A1_PLANAR_PROJ_NP,
    _EAC_MODS_NP,
    _EAC_MULT_CANDS,
    _ETC1_MODS_NP,
    _ETC2_DIST_NP,
    _ETC_A1_MODS_NP,
    _ETC_OFFSETS,
    _RASTER_OF_P_NP,
)
from cuttlefish_tpu_torch.kernels.jnp_common import div

_BIG = 1e30

# EAC: the largest positive modifier of each table, and the float32
# reciprocal that XLA multiplies by where the source divides by it.
_EAC_MAX_POS = _EAC_MODS_NP[:, 4:].max(1)
_EAC_INV_MAX_POS = tuple(float(np.float32(1.0) / np.float32(m)) for m in _EAC_MAX_POS)


def _u(x):
    """Integer tensor -> int64, the carrier of the uint32 words."""
    return x.to(torch.int64)


def _iota16(device):
    return torch.arange(16, device=device).reshape(16, 1)


def _expand4(v):
    return (v << 4) | v


def _expand5(v):
    return (v << 3) | (v >> 2)


def _bswap(w):
    """[N] int64 word -> byte-swapped [N] int64 word."""
    return (
        ((w & 0xFF) << 24)
        | ((w & 0xFF00) << 8)
        | ((w >> 8) & 0xFF00)
        | (w >> 24)
    )


def _index_words(idx):
    """idx [16,N] (raster order) -> lo word [N]: bit p = lsb of pixel p
    (column-major), bit 16+p = msb."""
    lo = torch.zeros_like(_u(idx[0]))
    for p in range(16):
        v = _u(idx[int(_RASTER_OF_P_NP[p])])
        lo = lo | ((v & 1) << p)
        lo = lo | (((v >> 1) & 1) << (16 + p))
    return lo


def _sub_masks(device, flip: int):
    """(sub1, sub2) [16,1] float32 membership (raster order)."""
    it = _iota16(device)
    if flip == 0:
        s2 = ((it % 4) >= 2).to(torch.float32)
    else:
        s2 = ((it // 4) >= 2).to(torch.float32)
    return 1.0 - s2, s2


def _pix_err(px, dec, mod, chw):
    """Per-texel sum over channels of chw * (px - clip(dec + mod))^2."""
    return _csum(
        [
            chw[c] * _sq(px[c] - torch.clamp(dec[c].to(torch.float32) + mod, 0.0, 255.0))
            for c in range(3)
        ]
    )


def _table_errs(px, dec, sub_mask, chw, mods=_ETC1_MODS_NP, allowed=(0, 1, 2, 3)):
    """Per table t: (idx_t [16,N] first-min modifier, err_t [N]).  ``mods``
    [8,4] replaces the modifier table and ``allowed`` lists the indices a
    texel may take (punch-through: not 2)."""
    out = []
    for t in range(8):
        e_t = idx_t = None
        for m in allowed:
            e = _pix_err(px, dec, float(mods[t][m]), chw)
            if e_t is None:
                e_t = e
                idx_t = torch.full_like(e, m, dtype=torch.int32)
            else:
                take = e < e_t
                idx_t = torch.where(take, m, idx_t)
                e_t = torch.minimum(e, e_t)
        out.append((idx_t, _rt(e_t * sub_mask)))
    return out


def _best_table_fit(px, dec, sub_mask, chw, mods=_ETC1_MODS_NP, allowed=(0, 1, 2, 3)):
    """Exhaustive modifier-table fit.  px list of [16,N]; dec list of [N]
    decoded base ints; ``mods``, ``allowed`` as in ``_table_errs``.
    Returns (table [N], idx [16,N], err [N])."""
    best_t = best_idx = best_err = None
    for t, (idx_t, err) in enumerate(_table_errs(px, dec, sub_mask, chw, mods, allowed)):
        tv = torch.full_like(err, t, dtype=torch.int32)
        if best_err is None:
            best_t, best_idx, best_err = tv, idx_t, err
        else:
            take = err < best_err
            best_t = torch.where(take, tv, best_t)
            best_idx = torch.where(take, idx_t, best_idx)
            best_err = torch.minimum(err, best_err)
    return best_t, best_idx, best_err


def _best_table_fit2(px, dec, sub_mask, chw):
    """_best_table_fit + the runner-up table (for the estimate proxy)."""
    fits = _table_errs(px, dec, sub_mask, chw)
    best_t = best_idx = best_err = None
    for t, (idx_t, err) in enumerate(fits):
        tv = torch.full_like(err, t, dtype=torch.int32)
        if best_err is None:
            best_t, best_idx, best_err = tv, idx_t, err
        else:
            take = err < best_err
            best_t = torch.where(take, tv, best_t)
            best_idx = torch.where(take, idx_t, best_idx)
            best_err = torch.minimum(err, best_err)
    t2 = e2 = None
    for t, (_, err) in enumerate(fits):
        ee = torch.where(best_t == t, _BIG, err)
        tv = torch.full_like(ee, t, dtype=torch.int32)
        if t2 is None:
            t2, e2 = tv, ee
        else:
            take = ee < e2
            t2 = torch.where(take, tv, t2)
            e2 = torch.minimum(ee, e2)
    return best_t, t2, best_idx, best_err


def _table_modvals(table):
    """The 4 modifier values of a per-block table: [N] -> 4 [N] floats."""
    mods = torch.tensor(_ETC1_MODS_NP, dtype=torch.float32, device=table.device)
    return [mods[:, mm][table] for mm in range(4)]


def _restricted_err(px, chw, subm, dec, mvals):
    """Block error with the table restricted to ``mvals``, index free."""
    e_best = None
    for mv in mvals:
        e = _pix_err(px, dec, mv, chw)
        e_best = e if e_best is None else torch.minimum(e_best, e)
    return _rt(e_best * subm)


def _topk_pick(ests, chosen):
    """Lowest estimate among the unchosen (first index on ties); marks it."""
    bi = be = None
    for i, e in enumerate(ests):
        ee = torch.where(chosen[i], _BIG, e)
        if bi is None:
            bi = torch.zeros_like(e, dtype=torch.int32)
            be = ee
        else:
            take = ee < be
            bi = torch.where(take, i, bi)
            be = torch.minimum(ee, be)
    for i in range(len(ests)):
        chosen[i] = chosen[i] | (bi == i)
    return bi


def _pick(bi, cands):
    """cands[i] (channel lists) where bi == i."""
    sel = cands[0]
    for i, b in enumerate(cands[1:], start=1):
        sel = [torch.where(bi == i, b[c], sel[c]) for c in range(3)]
    return sel


def _ind_subfit(px, chw, subm, mean, offsets, floor_mode, est_keep=0):
    """Individual-mode per-subblock quant-cube search incl. the
    estimate-then-refine pass.  Returns (base [3 x N], table, idx, err)."""
    qf = torch.floor if floor_mode else torch.round
    base_q = [qf(m * (15.0 / 255.0)) for m in mean]

    def base_of(o):
        return [torch.clamp(base_q[c] + float(o[c]), 0, 15).to(torch.int32) for c in range(3)]

    def full_fit(b):
        t, idx, err = _best_table_fit(px, [_expand4(bc) for bc in b], subm, chw)
        return (b, t, idx, err)

    def merge(best, cand):
        take = cand[3] < best[3]
        return (
            _sel(take, cand[0], best[0]),
            torch.where(take, cand[1], best[1]),
            torch.where(take, cand[2], best[2]),
            torch.minimum(cand[3], best[3]),
        )

    if not est_keep or len(offsets) <= est_keep + 1:
        best = None
        for o in offsets:
            cand = full_fit(base_of(o))
            best = cand if best is None else merge(best, cand)
        return best

    bc = base_of((0, 0, 0))
    t_c, t2_c, idx_c, err_c = _best_table_fit2(px, [_expand4(b) for b in bc], subm, chw)
    best = (bc, t_c, idx_c, err_c)
    mvals = _table_modvals(t_c) + _table_modvals(t2_c)
    bases = [base_of(o) for o in offsets if o != (0, 0, 0)]
    ests = [_restricted_err(px, chw, subm, [_expand4(b) for b in bb], mvals) for bb in bases]
    chosen = [torch.zeros_like(ests[0], dtype=torch.bool) for _ in ests]
    for _ in range(est_keep):
        bi = _topk_pick(ests, chosen)
        best = merge(best, full_fit(_pick(bi, bases)))
    return best


def _diff_fit(px, chw, sub1, sub2, mean1, mean2, offsets, floor_mode, est_keep=0):
    """Differential-mode joint quant-cube search incl. the
    estimate-then-refine pass.  Returns (b1, d, t1, t2, idx1, idx2, err)."""
    qf = torch.floor if floor_mode else torch.round
    base1_q = [qf(m * (31.0 / 255.0)) for m in mean1]
    b2n = [torch.clamp(torch.round(m * (31.0 / 255.0)), 0, 31).to(torch.int32) for m in mean2]

    def b1_of(o):
        return [torch.clamp(base1_q[c] + float(o[c]), 0, 31).to(torch.int32) for c in range(3)]

    def d_of(b1):
        return [torch.clamp(b2n[c] - b1[c], -4, 3) for c in range(3)]

    def full_fit(b1, d):
        b2 = [b1[c] + d[c] for c in range(3)]
        t1, idx1, e1 = _best_table_fit(px, [_expand5(b) for b in b1], sub1, chw)
        t2, idx2, e2 = _best_table_fit(px, [_expand5(b) for b in b2], sub2, chw)
        return (b1, d, t1, t2, idx1, idx2, e1 + e2)

    def merge(best, cand):
        take = cand[6] < best[6]
        return (
            _sel(take, cand[0], best[0]),
            _sel(take, cand[1], best[1]),
            *(torch.where(take, c, b) for c, b in zip(cand[2:6], best[2:6])),
            torch.minimum(cand[6], best[6]),
        )

    if not est_keep or len(offsets) <= est_keep + 1:
        best = None
        for o in offsets:
            b1 = b1_of(o)
            cand = full_fit(b1, d_of(b1))
            best = cand if best is None else merge(best, cand)
        return best

    b1c = b1_of((0, 0, 0))
    dc = d_of(b1c)
    b2c = [b1c[c] + dc[c] for c in range(3)]
    t1c, t1c2, idx1c, e1c = _best_table_fit2(px, [_expand5(b) for b in b1c], sub1, chw)
    t2c, t2c2, idx2c, e2c = _best_table_fit2(px, [_expand5(b) for b in b2c], sub2, chw)
    best = (b1c, dc, t1c, t2c, idx1c, idx2c, e1c + e2c)
    mv1 = _table_modvals(t1c) + _table_modvals(t1c2)
    mv2 = _table_modvals(t2c) + _table_modvals(t2c2)
    b1s = [b1_of(o) for o in offsets if o != (0, 0, 0)]
    ests = []
    for b1 in b1s:
        d = d_of(b1)
        e1 = _restricted_err(px, chw, sub1, [_expand5(b) for b in b1], mv1)
        e2 = _restricted_err(px, chw, sub2, [_expand5(b1[c] + d[c]) for c in range(3)], mv2)
        ests.append(e1 + e2)
    chosen = [torch.zeros_like(ests[0], dtype=torch.bool) for _ in ests]
    for _ in range(est_keep):
        bi = _topk_pick(ests, chosen)
        b1sel = _pick(bi, b1s)
        best = merge(best, full_fit(b1sel, d_of(b1sel)))
    return best


def _pack_etc1(fields, diff, flip, t1, t2, idx):
    f1, f2 = fields
    hi = torch.zeros_like(_u(t1))
    for c in range(3):
        if diff:
            hi = hi | (_u(f1[c]) << (27 - 8 * c))
            hi = hi | ((_u(f2[c]) & 0x7) << (24 - 8 * c))
        else:
            hi = hi | (_u(f1[c]) << (28 - 8 * c))
            hi = hi | (_u(f2[c]) << (24 - 8 * c))
    hi = hi | (_u(t1) << 5) | (_u(t2) << 2)
    if diff:
        hi = hi | 2
    if flip:
        hi = hi | 1
    return hi, _index_words(idx)


# ---------------------------------------------------------------------------
# ETC2 planar
# ---------------------------------------------------------------------------

_PLANAR_PROJ = None


def _planar_proj():
    """The float64 least-squares projection of etc_pallas.py:_planar_proj."""
    global _PLANAR_PROJ
    if _PLANAR_PROJ is None:
        x = np.array([(i % 4) / 4.0 for i in range(16)])
        y = np.array([(i // 4) / 4.0 for i in range(16)])
        basis = np.stack([1.0 - x - y, x, y], axis=0)  # [3,16]
        g = basis @ basis.T
        _PLANAR_PROJ = (np.linalg.inv(g) @ basis).astype(np.float64)
    return _PLANAR_PROJ


def _dec_planar(v, bits):
    if bits == 6:
        return ((v << 2) | (v >> 4)).to(torch.float32)
    return ((v << 1) | (v >> 6)).to(torch.float32)


def _quant_planar(c, bits):
    maxv = (1 << bits) - 1
    v = torch.clamp(torch.round(c * (maxv / 255.0)), 0, maxv).to(torch.int32)
    return v, _dec_planar(v, bits)


def _planar_candidate(px, chw, refine: int = 0):
    proj = _planar_proj()
    coef = [[None] * 3 for _ in range(3)]  # [O/H/V][channel]
    for k in range(3):
        for c in range(3):
            acc = None
            for i in range(16):
                term = float(proj[k][i]) * px[c][i]
                acc = term if acc is None else acc + term
            coef[k][c] = acc
    bits = (6, 7, 6)
    q = [[None] * 3 for _ in range(3)]
    dec = [[None] * 3 for _ in range(3)]
    for k in range(3):
        for c in range(3):
            q[k][c], dec[k][c] = _quant_planar(coef[k][c], bits[c])
    it = _iota16(px[0].device)
    xi = (it % 4).to(torch.float32)
    yi = (it // 4).to(torch.float32)

    def chan_err(c, do_, dh_, dv_):
        val = xi * (dh_ - do_) + yi * (dv_ - do_) + 4.0 * do_ + 2.0
        d = torch.clamp(torch.floor(val * 0.25), 0.0, 255.0)
        return chw[c] * _sq(px[c] - d)

    err = None
    for c in range(3):
        e_px = chan_err(c, dec[0][c], dec[1][c], dec[2][c])
        if refine:
            # The +-1 neighbourhood of each channel's (O, H, V), walked from
            # the current best: later steps start from an accepted one.
            maxv = (1 << bits[c]) - 1
            best_e = _rt(e_px)
            for d0 in (-1, 0, 1):
                for d1 in (-1, 0, 1):
                    for d2 in (-1, 0, 1):
                        if d0 == 0 and d1 == 0 and d2 == 0:
                            continue
                        o = torch.clamp(q[0][c] + d0, 0, maxv)
                        h = torch.clamp(q[1][c] + d1, 0, maxv)
                        v = torch.clamp(q[2][c] + d2, 0, maxv)
                        en_px = chan_err(
                            c, _dec_planar(o, bits[c]), _dec_planar(h, bits[c]),
                            _dec_planar(v, bits[c]),
                        )
                        en = _rt(en_px)
                        take = en < best_e
                        q[0][c] = torch.where(take, o, q[0][c])
                        q[1][c] = torch.where(take, h, q[1][c])
                        q[2][c] = torch.where(take, v, q[2][c])
                        e_px = torch.where(take, en_px, e_px)
                        best_e = torch.minimum(en, best_e)
        err = e_px if err is None else err + e_px
    fields = (
        q[0][0], q[0][1], q[0][2],
        q[1][0], q[1][1], q[1][2],
        q[2][0], q[2][1], q[2][2],
    )
    return _rt(err), fields


def _pack_planar(fields):
    (ro, go, bo, rh, gh, bh, rv, gv, bv) = [_u(f) for f in fields]
    hi = torch.zeros_like(ro)
    hi = hi | (ro << 25)
    hi = hi | ((go >> 6) << 24)
    hi = hi | ((go & 0x3F) << 17)
    hi = hi | ((bo >> 5) << 16)
    hi = hi | (((bo >> 3) & 0x3) << 11)
    hi = hi | ((bo & 0x7) << 7)
    hi = hi | ((rh >> 1) << 2)
    hi = hi | (rh & 0x1)
    hi = hi | 2
    lo = (gh << 25) | (bh << 19) | (rv << 13) | (gv << 6) | bv
    bo43 = (bo >> 3) & 0x3
    bo21 = (bo >> 1) & 0x3
    need_a = (bo43 + bo21) >= 4
    hi = hi | torch.where(need_a, 0x7 << 13, 1 << 10)
    r1 = (ro >> 2) & 0xF
    dr = ((ro & 0x3) << 1) | (go >> 6)
    dr_s = torch.where(dr >= 4, dr - 8, dr)
    hi = hi | torch.where((r1 + dr_s) < 0, 1 << 31, 0)
    g1 = (go >> 2) & 0xF
    dg = ((go & 0x3) << 1) | (bo >> 5)
    dg_s = torch.where(dg >= 4, dg - 8, dg)
    hi = hi | torch.where((g1 + dg_s) < 0, 1 << 23, 0)
    return hi, lo


# ---------------------------------------------------------------------------
# ETC2 T / H
# ---------------------------------------------------------------------------


def _pca_split_means(px, chw):
    """Principal-axis split -> (mean_pos, mean_neg) channel lists [N]."""
    mean = [_rt(px[c]) / 16.0 for c in range(3)]
    cent = [px[c] - mean[c] for c in range(3)]
    cov = [[_rt(cent[c] * cent[d]) for d in range(3)] for c in range(3)]
    norms = _csum([cent[c] * cent[c] for c in range(3)])
    mx = norms.max(dim=0).values
    iota = _iota16(px[0].device)
    fidx = torch.where(norms == mx, iota, 16).min(dim=0).values
    first = (iota == fidx).to(torch.float32)
    start = [_rt(cent[c] * first) for c in range(3)]
    n0 = torch.sqrt(_csum([s * s for s in start]))
    v = [torch.where(n0 > 1e-10, s / (n0 + 1e-20), torch.ones_like(s)) for s in start]
    for _ in range(3):
        nv = [_csum([cov[c][d] * v[d] for d in range(3)]) for c in range(3)]
        nn = torch.sqrt(_csum([x * x for x in nv]))
        v = [torch.where(nn > 1e-10, nv[c] / (nn + 1e-20), v[c]) for c in range(3)]
    t = _csum([cent[c] * v[c] for c in range(3)])
    split = (t > 0).to(torch.float32)
    cp = _rt(split) + 1e-6
    cn = _rt(1.0 - split) + 1e-6
    mp = [_rt(px[c] * split) / cp for c in range(3)]
    mn = [_rt(px[c] * (1.0 - split)) / cn for c in range(3)]
    return mp, mn


def _quant444(c):
    q = [torch.clamp(torch.round(x * (15.0 / 255.0)), 0, 15).to(torch.int32) for x in c]
    return q, [_expand4(v).to(torch.float32) for v in q]


def _pal_err_idx(px, pal, chw, alpha=None):
    """pal: 4 channel lists -> (idx [16,N], per-texel min err).  With
    ``alpha`` (punch-through, [16,N], 1 = opaque) entry 2 is transparent
    black: opaque texels may not take it, transparent ones do, and a
    texel's error is weighted by its alpha."""
    e_best = idx = None
    for k in range(4):
        if alpha is not None and k == 2:
            continue
        e = _csum([chw[c] * _sq(px[c] - pal[k][c]) for c in range(3)])
        if e_best is None:
            e_best = e
            idx = torch.zeros_like(e, dtype=torch.int32)
        else:
            take = e < e_best
            idx = torch.where(take, k, idx)
            e_best = torch.minimum(e, e_best)
    if alpha is not None:
        return torch.where(alpha < 0.5, 2, idx), e_best * alpha
    return idx, e_best


def _dist_of(didx):
    return torch.tensor(_ETC2_DIST_NP, dtype=torch.float32, device=didx.device)[didx]


def _clip255(x):
    return torch.clamp(x, 0.0, 255.0)


def _pack_t(q1, q2, didx, idx):
    r1, g1, b1 = (_u(v) for v in q1)
    r32 = r1 >> 2
    r10 = r1 & 0x3
    hi = (r32 << 27) | (r10 << 24) | (g1 << 20) | (b1 << 16)
    hi = hi | (_u(q2[0]) << 12) | (_u(q2[1]) << 8) | (_u(q2[2]) << 4)
    d = _u(didx)
    hi = hi | ((d >> 1) << 2) | (d & 1) | 2
    use_a = (r32 + r10) >= 4
    hi = hi | torch.where(use_a, 0x7 << 29, 1 << 26)
    return hi, _index_words(idx)


def _pack_h(q1, q2, didx, idx):
    r1, g1, b1 = (_u(v) for v in q1)
    q = 2 * (g1 & 1) + (b1 >> 3)
    b21 = (b1 >> 1) & 0x3
    over = (q + b21) >= 4
    d = _u(didx)
    hi = (r1 << 27) | ((g1 >> 1) << 24) | ((g1 & 1) << 20) | ((b1 >> 3) << 19)
    hi = hi | (((b1 >> 1) & 0x3) << 16) | ((b1 & 0x1) << 15)
    hi = hi | (_u(q2[0]) << 11) | (_u(q2[1]) << 7) | (_u(q2[2]) << 3)
    hi = hi | ((d >> 2) << 2) | ((d >> 1) & 1) | 2
    hi = hi | torch.where(over, 7 << 21, 1 << 18)
    dr = g1 >> 1
    dr_s = torch.where(dr >= 4, dr - 8, dr)
    hi = hi | torch.where((r1 + dr_s) < 0, 1 << 31, 0)
    return hi, _index_words(idx)


def _nudge(q, c, dd):
    """q with channel c moved by dd, clipped to 0..15."""
    return [torch.clamp(q[i] + dd, 0, 15) if i == c else q[i] for i in range(3)]


def _etc2_t_candidate(px, chw, refine: int = 0, means=None, quant=None, alpha=None):
    """Best T-mode word.  The punch-through encoder passes its own cluster
    means and quantiser (its ``jnp`` path's, ``_pca_split_jnp`` and
    ``_quant444_jnp``) and ``alpha``: entry 2 transparent (``_pal_err_idx``)
    and the opaque bit 33 cleared."""
    mp, mn = _pca_split_means(px, chw) if means is None else means
    quant = quant or _quant444

    def pal_of(d1, d2, dist):
        return [d1, [_clip255(d + dist) for d in d2], d2, [_clip255(d - dist) for d in d2]]

    def t_eval(q1, q2, dist_f):
        d1 = [_expand4(v).to(torch.float32) for v in q1]
        d2 = [_expand4(v).to(torch.float32) for v in q2]
        idx, e = _pal_err_idx(px, pal_of(d1, d2, dist_f), chw, alpha)
        return idx, _rt(e)

    best = None
    for c1f, c2f in ((mp, mn), (mn, mp)):
        q1, d1 = quant(c1f)
        q2, d2 = quant(c2f)
        for di in range(8):
            idx, e = _pal_err_idx(px, pal_of(d1, d2, float(_ETC2_DIST_NP[di])), chw, alpha)
            err = _rt(e)
            cand = (q1, q2, torch.full_like(err, di, dtype=torch.int32), idx, err)
            if best is None:
                best = cand
            else:
                take = err < best[4]
                best = (
                    _sel(take, cand[0], best[0]),
                    _sel(take, cand[1], best[1]),
                    torch.where(take, cand[2], best[2]),
                    torch.where(take, cand[3], best[3]),
                    torch.minimum(err, best[4]),
                )
    q1, q2, didx, idx, err = best
    for _ in range(refine):
        # +-1 coordinate descent over the six colour coordinates with the
        # adjacent distance rungs tried per step, then a distance re-sweep.
        for which in (0, 1):
            for c in range(3):
                for dd in (-1, 1):
                    q1n = _nudge(q1, c, dd) if which == 0 else q1
                    q2n = q2 if which == 0 else _nudge(q2, c, dd)
                    for dstep in (-1, 0, 1):
                        didxn = torch.clamp(didx + dstep, 0, 7)
                        idxn, errn = t_eval(q1n, q2n, _dist_of(didxn))
                        take = errn < err
                        q1 = _sel(take, q1n, q1)
                        q2 = _sel(take, q2n, q2)
                        didx = torch.where(take, didxn, didx)
                        idx = torch.where(take, idxn, idx)
                        err = torch.minimum(errn, err)
        for di in range(8):
            idxn, errn = t_eval(q1, q2, torch.full_like(err, float(_ETC2_DIST_NP[di])))
            take = errn < err
            didx = torch.where(take, di, didx)
            idx = torch.where(take, idxn, idx)
            err = torch.minimum(errn, err)
    hi, lo = _pack_t(q1, q2, didx, idx)
    return err, (hi if alpha is None else hi & ~2, lo)


def _etc2_h_candidate(px, chw, refine: int = 0, means=None, quant=None, alpha=None):
    """Best H-mode word; ``means``, ``quant`` and ``alpha`` as in
    ``_etc2_t_candidate``."""
    mp, mn = _pca_split_means(px, chw) if means is None else means
    quant = quant or _quant444

    def packed(q):
        return (q[0] << 8) | (q[1] << 4) | q[2]

    def pal_of(d1, d2, dist):
        return [
            [_clip255(d + dist) for d in d1],
            [_clip255(d - dist) for d in d1],
            [_clip255(d + dist) for d in d2],
            [_clip255(d - dist) for d in d2],
        ]

    def h_eval(q1, q2, dist_f):
        d1 = [_expand4(v).to(torch.float32) for v in q1]
        d2 = [_expand4(v).to(torch.float32) for v in q2]
        idx, e = _pal_err_idx(px, pal_of(d1, d2, dist_f), chw, alpha)
        return idx, _rt(e)

    def canon(q1n, q2n, want):
        p1 = packed(q1n)
        p2 = packed(q2n)
        swap = (p1 >= p2).to(torch.int32) != want
        q1c = _sel(swap, q2n, q1n)
        q2c = _sel(swap, q1n, q2n)
        p1c = torch.where(swap, p2, p1)
        p2c = torch.where(swap, p1, p2)
        ok = ((p1c >= p2c).to(torch.int32) == want).to(torch.float32)
        return q1c, q2c, ok

    best = None
    for c1f, c2f in ((mp, mn), (mn, mp)):
        q1, _ = quant(c1f)
        q2, _ = quant(c2f)
        d1 = [_expand4(v).to(torch.float32) for v in q1]
        d2 = [_expand4(v).to(torch.float32) for v in q2]
        ord_bit = (packed(q1) >= packed(q2)).to(torch.int32)
        for di in range(8):
            valid = ((di & 1) == ord_bit).to(torch.float32)
            idx, e = _pal_err_idx(px, pal_of(d1, d2, float(_ETC2_DIST_NP[di])), chw, alpha)
            err = _rt(e) + (1.0 - valid) * _BIG
            cand = (q1, q2, torch.full_like(err, di, dtype=torch.int32), idx, err)
            if best is None:
                best = cand
            else:
                take = err < best[4]
                best = (
                    _sel(take, cand[0], best[0]),
                    _sel(take, cand[1], best[1]),
                    torch.where(take, cand[2], best[2]),
                    torch.where(take, cand[3], best[3]),
                    torch.minimum(err, best[4]),
                )
    q1, q2, didx, idx, err = best
    for _ in range(refine):
        for which in (0, 1):
            for c in range(3):
                for dd in (-1, 1):
                    q1n = _nudge(q1, c, dd) if which == 0 else q1
                    q2n = q2 if which == 0 else _nudge(q2, c, dd)
                    for dstep in (-1, 0, 1):
                        didxn = torch.clamp(didx + dstep, 0, 7)
                        q1c, q2c, ok = canon(q1n, q2n, didxn & 1)
                        idxn, errn = h_eval(q1c, q2c, _dist_of(didxn))
                        errn = errn + (1.0 - ok) * _BIG
                        take = errn < err
                        q1 = _sel(take, q1c, q1)
                        q2 = _sel(take, q2c, q2)
                        didx = torch.where(take, didxn, didx)
                        idx = torch.where(take, idxn, idx)
                        err = torch.minimum(errn, err)
        q1f, q2f, didxf, idxf, errf = q1, q2, didx, idx, err
        for di in range(8):
            want_d = torch.full_like(didx, di & 1)
            q1c, q2c, ok = canon(q1, q2, want_d)
            idxn, errn = h_eval(q1c, q2c, torch.full_like(err, float(_ETC2_DIST_NP[di])))
            errn = errn + (1.0 - ok) * _BIG
            take = errn < errf
            q1f = _sel(take, q1c, q1f)
            q2f = _sel(take, q2c, q2f)
            didxf = torch.where(take, di, didxf)
            idxf = torch.where(take, idxn, idxf)
            errf = torch.minimum(errn, errf)
        q1, q2, didx, idx, err = q1f, q2f, didxf, idxf, errf
    hi, lo = _pack_h(q1, q2, didx, idx)
    return err, (hi if alpha is None else hi & ~2, lo)


# ---------------------------------------------------------------------------
# EAC
# ---------------------------------------------------------------------------


def _eac_words(base, mult, table, idx):
    """(hi, lo) of an EAC block: base 63..56, mult 55..52, table 51..48,
    pixel p's 3-bit index at bits 45-3p..47-3p (column-major pixels)."""
    hi = (_u(base) << 24) | (_u(mult) << 20) | (_u(table) << 16)
    lo = torch.zeros_like(hi)
    for p in range(16):
        v = _u(idx[int(_RASTER_OF_P_NP[p])])
        bitpos = 45 - 3 * p
        if bitpos >= 32:
            hi = hi | (v << (bitpos - 32))
        elif bitpos >= 30:  # straddles the word boundary
            hi = hi | (v >> (32 - bitpos))
            lo = lo | ((v << bitpos) & 0xFFFFFFFF)
        else:
            lo = lo | (v << bitpos)
    return hi, lo


def _eac_search(vals, quality, base, span, palette):
    """The table x multiplier search shared by EAC alpha and R11.
    palette(mod, mult) -> [N] palette value.  Returns (mult, table, idx)."""
    ncand = _EAC_MULT_CANDS[max(0, min(4, int(quality)))]
    best = None
    for t in range(16):
        m0 = torch.clamp(torch.round(span * _EAC_INV_MAX_POS[t]), 1, 15).to(torch.int32)
        for dm in range(-(ncand // 2), ncand - ncand // 2):
            mult = torch.clamp(m0 + dm, 1, 15)
            e_best = idx = None
            for k in range(8):
                e = _sq(vals - palette(float(_EAC_MODS_NP[t][k]), mult))
                if e_best is None:
                    e_best = e
                    idx = torch.zeros_like(e, dtype=torch.int32)
                else:
                    take = e < e_best
                    idx = torch.where(take, k, idx)
                    e_best = torch.minimum(e, e_best)
            err = _rt(e_best)
            cand = (mult, torch.full_like(err, t, dtype=torch.int32), idx, err)
            if best is None:
                best = cand
            else:
                take = err < best[3]
                best = (
                    torch.where(take, cand[0], best[0]),
                    torch.where(take, cand[1], best[1]),
                    torch.where(take, cand[2], best[2]),
                    torch.minimum(err, best[3]),
                )
    return best[:3]


def _eac_alpha(a, quality: int):
    """a [16,N] 0..255 -> (hi, lo) byte-swap-ready words."""
    lo_v = a.min(dim=0).values
    hi_v = a.max(dim=0).values
    base = torch.clamp(torch.round((lo_v + hi_v) * 0.5), 0, 255).to(torch.int32)
    span = (hi_v - lo_v) * 0.5
    base_f = base.to(torch.float32)

    def palette(mod, mult):
        return torch.clamp(base_f + mod * mult.to(torch.float32), 0.0, 255.0)

    mult, table, idx = _eac_search(a, quality, base, span, palette)
    return _eac_words(base, mult, table, idx)


def _eac_r11(v, quality: int, signed: bool):
    """v [16,N] in the true 11-bit domain (0..2047 unsigned / -1023..1023
    signed) -> (hi, lo) byte-swap-ready words; candidates are searched in
    the /8 domain, as etc_pallas.py:_eac_r11 does."""
    v8 = v / 8.0
    lo_v = v8.min(dim=0).values
    hi_v = v8.max(dim=0).values
    brange = (-127, 127) if signed else (0, 255)
    clip_lo, clip_hi = (-1023.0, 1023.0) if signed else (0.0, 2047.0)
    base = torch.clamp(torch.round((lo_v + hi_v) * 0.5), brange[0], brange[1]).to(torch.int32)
    span = (hi_v - lo_v) * 0.5
    offset = 0.0 if signed else 4.0
    base8 = base.to(torch.float32) * 8.0 + offset

    def palette(mod, mult):
        return torch.clamp(base8 + mod * mult.to(torch.float32) * 8.0, clip_lo, clip_hi) / 8.0

    mult, table, idx = _eac_search(v8, quality, base, span, palette)
    return _eac_words(base & 0xFF, mult, table, idx)


# ---------------------------------------------------------------------------
# ETC RGB sweep and the five entries: plain versions
# ---------------------------------------------------------------------------


def _rgb_words(px, quality, etc2, chw):
    """Full ETC1/ETC2 RGB candidate sweep -> (hi, lo) un-swapped words."""
    best_err = best = None
    floor_mode = _ETC_OFFSETS[quality][0] == "floor"
    offsets = _ETC_OFFSETS[quality][1]
    est_keep = 4 if quality in (2, 3) else (8 if quality >= 4 else 0)
    for flip in (0, 1):
        sub1, sub2 = _sub_masks(px[0].device, flip)
        n1 = _rt(sub1)
        n2 = _rt(sub2)
        mean1 = [_rt(px[c] * sub1) / n1 for c in range(3)]
        mean2 = [_rt(px[c] * sub2) / n2 for c in range(3)]

        b1, d, t1, t2, idx1, idx2, derr = _diff_fit(
            px, chw, sub1, sub2, mean1, mean2, offsets, floor_mode, est_keep
        )
        idx = torch.where(sub2 > 0, idx2, idx1)
        words = _pack_etc1((b1, d), True, flip, t1, t2, idx)
        if best_err is None:
            best_err, best = derr, words
        else:
            take = derr < best_err
            best = tuple(torch.where(take, w, b) for w, b in zip(words, best))
            best_err = torch.minimum(derr, best_err)

        if quality >= 1:
            i1 = _ind_subfit(px, chw, sub1, mean1, offsets, floor_mode, est_keep)
            i2 = _ind_subfit(px, chw, sub2, mean2, offsets, floor_mode, est_keep)
            ierr = i1[3] + i2[3]
            idx = torch.where(sub2 > 0, i2[2], i1[2])
            words = _pack_etc1((i1[0], i2[0]), False, flip, i1[1], i2[1], idx)
            take = ierr < best_err
            best = tuple(torch.where(take, w, b) for w, b in zip(words, best))
            best_err = torch.minimum(ierr, best_err)
    if etc2:
        refine = 2 if quality >= 4 else 0
        perr, fields = _planar_candidate(px, chw, refine=refine)
        take = perr < best_err
        best = tuple(torch.where(take, w, b) for w, b in zip(_pack_planar(fields), best))
        best_err = torch.minimum(perr, best_err)
        for cand_fn in (_etc2_t_candidate, _etc2_h_candidate):
            err, words = cand_fn(px, chw, refine=refine)
            take = err < best_err
            best = tuple(torch.where(take, w, b) for w, b in zip(words, best))
            best_err = torch.minimum(err, best_err)
    return best


def _channels255(blocks, n):
    """[N,16,C] -> n channel tensors [16,N]: clip(0, 1) * 255 (``_run``)."""
    x = torch.clamp(blocks[..., :n].to(torch.float32), 0.0, 1.0) * 255.0
    x = x.permute(2, 1, 0)
    return [x[c].contiguous() for c in range(n)]


def _eac_scaled(vals, signed):
    """The EAC wrappers' input transform (etc_pallas.py:1072-1074)."""
    scale = 1023.0 if signed else 2047.0
    lo_in = -1.0 if signed else 0.0
    return torch.clamp(vals.to(torch.float32), lo_in, 1.0) * scale


def _stack(words):
    return torch.stack([_bswap(w) for w in words], dim=1).to(torch.uint32)


def encode_etc_rgb_plain(blocks, quality=2, etc2=False, chw=(1.0, 1.0, 1.0)):
    """[N,16,>=3] float RGB(A) 0..1 -> ETC1/ETC2 RGB words [N,2] uint32
    (``encode_etc_rgb_pallas``)."""
    if blocks.shape[0] == 0:
        return _empty(blocks, 2)
    px = _channels255(blocks, 3)
    return _stack(_rgb_words(px, int(quality), bool(etc2), chw))


def encode_etc2_rgba_plain(blocks, quality=2, chw=(1.0, 1.0, 1.0)):
    """[N,16,4] float 0..1 -> EAC alpha + ETC2 RGB words [N,4] uint32
    (``encode_etc2_rgba_pallas``)."""
    if blocks.shape[0] == 0:
        return _empty(blocks, 4)
    px = _channels255(blocks, 4)
    q = int(quality)
    return _stack([*_eac_alpha(px[3], q), *_rgb_words(px[:3], q, True, chw)])


def encode_eac_alpha_plain(vals, quality=2):
    """[N,16] float 0..1 -> EAC alpha words [N,2] uint32
    (``encode_eac_alpha_pallas``)."""
    if vals.shape[0] == 0:
        return _empty(vals, 2)
    a = (torch.clamp(vals.to(torch.float32), 0.0, 1.0) * 255.0).t().contiguous()
    return _stack(_eac_alpha(a, int(quality)))


def encode_eac_r11_plain(vals, quality=2, signed=False):
    """[N,16] float ([0,1] unsigned / [-1,1] signed) -> R11 words [N,2]
    uint32 (``encode_eac_r11_pallas``)."""
    if vals.shape[0] == 0:
        return _empty(vals, 2)
    v = _eac_scaled(vals, signed).t().contiguous()
    return _stack(_eac_r11(v, int(quality), bool(signed)))


def encode_eac_rg11_plain(blocks, quality=2, signed=False):
    """[N,16,>=2] -> [N,4] uint32: R11 then G11
    (``encode_eac_rg11_pallas``)."""
    if blocks.shape[0] == 0:
        return _empty(blocks, 4)
    v = _eac_scaled(blocks[..., :2], signed).permute(2, 1, 0)
    q, s = int(quality), bool(signed)
    return _stack([*_eac_r11(v[0].contiguous(), q, s), *_eac_r11(v[1].contiguous(), q, s)])


# ---------------------------------------------------------------------------
# ETC2 punch-through alpha (R8G8B8A1): the JAX package's jnp path
# ---------------------------------------------------------------------------
#
# ``cuttlefish_tpu/kernels/etc.py:encode_etc2_a1`` has no TPU kernel, so its
# port is these torch ops, on whichever device holds the blocks.  It reuses
# the helpers above where their expressions are the jnp path's
# (``_diff_fit``, the table fits, the packers, the T/H searches) and has
# jnp-faithful variants where the TPU kernel's differ: the cluster split
# (``_pca_split_jnp``: counts + 1e-6), the 4-bit quantiser
# (``_quant444_jnp``: ``c * 15 / 255`` as two operations) and the planar
# fit (``_planar_candidate_jnp``: its float32 projection, ``c * maxv /
# 255`` as two operations, its error summed over texels by channel).  Its
# divisions by a constant are IEEE divisions on the card too
# (``jnp_common.div``).

_A1_ALLOWED = (0, 1, 3)  # index 2 is the transparent texel


def _quant444_jnp(c):
    q = [torch.clamp(torch.round(div(x * 15.0, 255.0)), 0, 15).to(torch.int32) for x in c]
    return q, [_expand4(v).to(torch.float32) for v in q]


def _pca_split_jnp(px, w=None):
    """``kernels/etc.py:_pca_split``: principal-axis cluster split ->
    (mean_pos, mean_neg) channel lists [N].  ``w`` [16,N] (1 = opaque)
    keeps transparent texels out of the axis fit and the means."""
    if w is None:
        w = torch.ones_like(px[0])
    cnt = _rt(w) + 1e-6
    mean = [_rt(px[c] * w) / cnt for c in range(3)]
    cent = [(px[c] - mean[c]) * w for c in range(3)]
    cov = [[_rt(cent[c] * cent[d]) for d in range(3)] for c in range(3)]
    norms = _csum([cent[c] * cent[c] for c in range(3)])
    iota = _iota16(px[0].device)
    fidx = torch.where(norms == norms.max(dim=0).values, iota, 16).min(dim=0).values
    first = (iota == fidx).to(torch.float32)
    start = [_rt(cent[c] * first) for c in range(3)]
    n0 = torch.sqrt(_csum([x * x for x in start]))
    v = [torch.where(n0 > 1e-10, x / (n0 + 1e-20), torch.ones_like(x)) for x in start]
    for _ in range(3):
        nv = [_csum([cov[c][d] * v[d] for d in range(3)]) for c in range(3)]
        nn = torch.sqrt(_csum([x * x for x in nv]))
        v = [torch.where(nn > 1e-10, nv[c] / (nn + 1e-20), v[c]) for c in range(3)]
    split = (_csum([cent[c] * v[c] for c in range(3)]) > 0).to(torch.float32) * w

    def cmean(mask):
        n = _rt(mask) + 1e-6
        return [_rt(px[c] * mask) / n for c in range(3)]

    return cmean(split), cmean((1.0 - split) * w)


def _planar_candidate_jnp(px, chw, refine: int = 0):
    """``kernels/etc.py:_planar_candidate`` -> (err [N], fields): each
    channel's error summed over the texels, then weighted."""
    bits = (6, 7, 6)
    q = [[None] * 3 for _ in range(3)]  # [O/H/V][channel]
    for k in range(3):
        for c in range(3):
            coef = _rt(torch.stack([float(_A1_PLANAR_PROJ_NP[k][i]) * px[c][i] for i in range(16)]))
            maxv = (1 << bits[c]) - 1
            q[k][c] = torch.clamp(torch.round(div(coef * float(maxv), 255.0)), 0, maxv).to(
                torch.int32
            )
    it = _iota16(px[0].device)
    xi = (it % 4).to(torch.float32)
    yi = (it // 4).to(torch.float32)

    def chan_err(c, o, h, v):
        do_, dh_, dv_ = (_dec_planar(x, bits[c]) for x in (o, h, v))
        val = xi * (dh_ - do_) + yi * (dv_ - do_) + 4.0 * do_ + 2.0
        return _sq(px[c] - torch.clamp(torch.floor(val / 4.0), 0.0, 255.0))

    err = None
    for c in range(3):
        e_px = chan_err(c, q[0][c], q[1][c], q[2][c])
        if refine:
            maxv = (1 << bits[c]) - 1
            best_e = _rt(e_px)
            for d0 in (-1, 0, 1):
                for d1 in (-1, 0, 1):
                    for d2 in (-1, 0, 1):
                        if d0 == 0 and d1 == 0 and d2 == 0:
                            continue
                        o = torch.clamp(q[0][c] + d0, 0, maxv)
                        h = torch.clamp(q[1][c] + d1, 0, maxv)
                        v = torch.clamp(q[2][c] + d2, 0, maxv)
                        en_px = chan_err(c, o, h, v)
                        en = _rt(en_px)
                        take = en < best_e
                        q[0][c] = torch.where(take, o, q[0][c])
                        q[1][c] = torch.where(take, h, q[1][c])
                        q[2][c] = torch.where(take, v, q[2][c])
                        e_px = torch.where(take, en_px, e_px)
                        best_e = torch.minimum(en, best_e)
        term = _rt(e_px) * chw[c]
        err = term if err is None else err + term
    fields = (
        q[0][0], q[0][1], q[0][2],
        q[1][0], q[1][1], q[1][2],
        q[2][0], q[2][1], q[2][2],
    )
    return err, fields


def _a1_table_modvals(table):
    """The A1 modifier values (indices 0, 1, 3) of a per-block table."""
    mods = torch.tensor(_ETC_A1_MODS_NP, dtype=torch.float32, device=table.device)
    return [mods[:, mm][table] for mm in _A1_ALLOWED]


def _a1_diff_sweep(px, alpha, chw, flip, offsets, floor_mode, est_keep=0):
    """Punch-through differential sweep over the base-1 quant cube
    (``kernels/etc.py:_a1_diff_sweep``): [0, +b, T, -b] modifiers,
    transparent texels out of the fit and at index 2; ``est_keep`` ranks
    the non-centre offsets by the error with the centre's tables and fits
    the per-block best k in full.  Returns (err [N], (hi, lo))."""
    sub1, sub2 = _sub_masks(px[0].device, flip)
    w1 = sub1 * alpha
    w2 = sub2 * alpha
    n1 = _rt(w1) + 1e-6
    n2 = _rt(w2) + 1e-6
    mean1 = [_rt(px[c] * w1) / n1 for c in range(3)]
    mean2 = [_rt(px[c] * w2) / n2 for c in range(3)]
    qf = torch.floor if floor_mode else torch.round
    base1_q = [qf(m * (31.0 / 255.0)) for m in mean1]
    b2n = [torch.clamp(torch.round(m * (31.0 / 255.0)), 0, 31).to(torch.int32) for m in mean2]

    def b1_of(o):
        return [torch.clamp(base1_q[c] + float(o[c]), 0, 31).to(torch.int32) for c in range(3)]

    def d_of(b1):
        return [torch.clamp(b2n[c] - b1[c], -4, 3) for c in range(3)]

    def full_fit(b1):
        d = d_of(b1)
        b2 = [b1[c] + d[c] for c in range(3)]
        t1, idx1, e1 = _best_table_fit(
            px, [_expand5(b) for b in b1], w1, chw, _ETC_A1_MODS_NP, _A1_ALLOWED
        )
        t2, idx2, e2 = _best_table_fit(
            px, [_expand5(b) for b in b2], w2, chw, _ETC_A1_MODS_NP, _A1_ALLOWED
        )
        idx = torch.where(alpha < 0.5, 2, torch.where(sub2 > 0, idx2, idx1))
        hi, lo = _pack_etc1((b1, d), True, flip, t1, t2, idx)
        return e1 + e2, (hi & ~2, lo), t1, t2  # opaque bit 33 = 0

    def merge(best, cand):
        take = cand[0] < best[0]
        return (
            torch.minimum(cand[0], best[0]),
            tuple(torch.where(take, w, b) for w, b in zip(cand[1], best[1])),
        )

    if not est_keep or len(offsets) <= est_keep + 1:
        best = None
        for o in offsets:
            c = full_fit(b1_of(o))[:2]
            best = c if best is None else merge(best, c)
        return best

    err_c, words_c, t1c, t2c = full_fit(b1_of((0, 0, 0)))
    mv1 = _a1_table_modvals(t1c)
    mv2 = _a1_table_modvals(t2c)

    def rest_err(b1):
        d = d_of(b1)
        dec1 = [_expand5(b) for b in b1]
        dec2 = [_expand5(b1[c] + d[c]) for c in range(3)]
        e = None
        for dec, mvs, wm in ((dec1, mv1, w1), (dec2, mv2, w2)):
            eb = None
            for mv in mvs:
                ee = _pix_err(px, dec, mv, chw)
                eb = ee if eb is None else torch.minimum(eb, ee)
            e = _rt(eb * wm) if e is None else e + _rt(eb * wm)
        return e

    b1s = [b1_of(o) for o in offsets if o != (0, 0, 0)]
    ests = [rest_err(b1) for b1 in b1s]
    best = (err_c, words_c)
    chosen = [torch.zeros_like(ests[0], dtype=torch.bool) for _ in ests]
    for _ in range(est_keep):
        bi = _topk_pick(ests, chosen)
        best = merge(best, full_fit(_pick(bi, b1s))[:2])
    return best


def _a1_words(px, alpha, quality, chw):
    """``encode_etc2_a1``'s search -> (hi, lo) un-swapped words.  Opaque
    blocks: differential (no individual mode in A1) and ETC2 planar, T
    and H, opaque bit 1; blocks with a texel of alpha < 0.5: differential,
    T and H with palette entry 2 transparent, opaque bit 0."""
    floor_mode = _ETC_OFFSETS[quality][0] == "floor"
    offsets = _ETC_OFFSETS[quality][1]
    est_keep = 6 if quality in (2, 3) else 0
    refine = 2 if quality >= 4 else 0

    def keep(best, err, words):
        if best is None:
            return err, words
        take = err < best[0]
        return torch.where(take, err, best[0]), tuple(
            torch.where(take, w, b) for w, b in zip(words, best[1])
        )

    opaque = None
    for flip in (0, 1):
        sub1, sub2 = _sub_masks(px[0].device, flip)
        n1 = _rt(sub1)
        n2 = _rt(sub2)
        mean1 = [_rt(px[c] * sub1) / n1 for c in range(3)]
        mean2 = [_rt(px[c] * sub2) / n2 for c in range(3)]
        b1, d, t1, t2, idx1, idx2, derr = _diff_fit(
            px, chw, sub1, sub2, mean1, mean2, offsets, floor_mode, est_keep
        )
        idx = torch.where(sub2 > 0, idx2, idx1)
        opaque = keep(opaque, derr, _pack_etc1((b1, d), True, flip, t1, t2, idx))
    perr, fields = _planar_candidate_jnp(px, chw, refine)
    opaque = keep(opaque, perr, _pack_planar(fields))
    means = _pca_split_jnp(px)
    for cand_fn in (_etc2_t_candidate, _etc2_h_candidate):
        opaque = keep(opaque, *cand_fn(px, chw, refine, means=means, quant=_quant444_jnp))

    punch = None
    for flip in (0, 1):
        punch = keep(punch, *_a1_diff_sweep(px, alpha, chw, flip, offsets, floor_mode, est_keep))
    means = _pca_split_jnp(px, alpha)
    for cand_fn in (_etc2_t_candidate, _etc2_h_candidate):
        punch = keep(
            punch, *cand_fn(px, chw, refine, means=means, quant=_quant444_jnp, alpha=alpha)
        )

    has_alpha = (alpha < 0.5).any(dim=0)
    return tuple(torch.where(has_alpha, t, o) for t, o in zip(punch[1], opaque[1]))


def encode_etc2_a1(blocks, quality=2, ch_weights=None):
    """[N,16,4] float RGBA blocks (0..1) -> ETC2 punch-through alpha
    (R8G8B8A1) [N,2] uint32 words, texels with alpha < 0.5 transparent.

    The JAX package encodes A1 on its ``jnp`` path only, so this is torch
    ops on the tensor's device (CPU or CUDA), with no hand kernel."""
    q, chw = _quality(quality), channel_weights(ch_weights)
    _device_kind(blocks)
    if blocks.shape[0] == 0:
        return _empty(blocks, 2)
    px = _channels255(blocks, 3)
    alpha = (blocks[..., 3].to(torch.float32) >= 0.5).to(torch.float32).t().contiguous()
    return _stack(_a1_words(px, alpha, q, chw))


# ---------------------------------------------------------------------------
# Dispatch (signatures of cuttlefish_tpu/kernels/etc.py)
# ---------------------------------------------------------------------------


def _quality(quality) -> int:
    """Quality clamped to 0-4, as the JAX package's wrappers clamp it."""
    return max(0, min(4, int(quality)))


def _on_cpu(x: torch.Tensor) -> bool:
    return _device_kind(x) == "cpu"


def encode_etc_rgb(blocks, quality=2, etc2=False, ch_weights=None):
    """[N,16,>=3] float RGB(A) blocks (0..1) -> ETC1 (or ETC2 when
    ``etc2``) RGB [N,2] uint32 words.  A CPU tensor runs the plain
    version, a CUDA tensor the hand kernel."""
    q, chw = _quality(quality), channel_weights(ch_weights)
    if _on_cpu(blocks):
        return encode_etc_rgb_plain(blocks, q, bool(etc2), chw)
    from cuttlefish_tpu_torch.kernels import etc_cuda

    return etc_cuda.encode_etc_rgb_cuda(blocks, q, bool(etc2), chw)


def encode_etc2_rgba(blocks, quality=2, ch_weights=None):
    """[N,16,4] -> [N,4] uint32: EAC alpha block then ETC2 RGB block."""
    q, chw = _quality(quality), channel_weights(ch_weights)
    if _on_cpu(blocks):
        return encode_etc2_rgba_plain(blocks, q, chw)
    from cuttlefish_tpu_torch.kernels import etc_cuda

    return etc_cuda.encode_etc2_rgba_cuda(blocks, q, chw)


def encode_eac_alpha(vals, quality=2):
    """[N,16] floats 0..1 -> EAC 8-bit alpha [N,2] uint32 words."""
    q = _quality(quality)
    if _on_cpu(vals):
        return encode_eac_alpha_plain(vals, q)
    from cuttlefish_tpu_torch.kernels import etc_cuda

    return etc_cuda.encode_eac_alpha_cuda(vals, q)


def encode_eac_r11(vals, quality=2, signed=False):
    """[N,16] floats ([0,1] unsigned / [-1,1] signed) -> EAC R11 [N,2]."""
    q = _quality(quality)
    if _on_cpu(vals):
        return encode_eac_r11_plain(vals, q, bool(signed))
    from cuttlefish_tpu_torch.kernels import etc_cuda

    return etc_cuda.encode_eac_r11_cuda(vals, q, bool(signed))


def encode_eac_rg11(blocks, quality=2, signed=False):
    """[N,16,>=2] -> [N,4] uint32 words: R11 then G11."""
    q = _quality(quality)
    if _on_cpu(blocks):
        return encode_eac_rg11_plain(blocks, q, bool(signed))
    from cuttlefish_tpu_torch.kernels import etc_cuda

    return etc_cuda.encode_eac_rg11_cuda(blocks, q, bool(signed))
