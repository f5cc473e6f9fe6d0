"""ASTC LDR block encoder: plain PyTorch version and dispatch.

The plain version computes what the four TPU kernels of
``cuttlefish_tpu/kernels/astc_pallas.py`` compute, function by function and
under the same names: ``_kernel_a`` (void extent, the 1-partition CEM 8/12
layout menu, dual-plane fits and, for near-gray blocks, CEM 0/4),
``_kernel_b`` (2-partition screen over the distinct patterns, top-k, a
continuous-SSE rerank, CEM 8/12 fits), ``_kernel_c`` (3-partition screen and
CEM 8 fit) and ``_kernel_d`` (4-partition luminance CEM 0/4 screen over all
1024 seeds, near-gray blocks only), merged in that order as
``encode_astc_pallas`` merges them: a later kernel's words win only where
its error is strictly lower.  It follows the Pallas kernel, not the JAX
package's ``jnp`` path (``kernels/astc.py:_encode_astc_jnp``).  Layout
follows the kernel: each channel is a ``[T, N]`` tensor (texels x blocks,
T = bw*bh), per-block values are ``[N]``.

Every sum over texels is a left fold in texel order, every sum over
channels or partitions a left fold in their order, every constant the
float32 value JAX uses, every search keeps the first minimum (strict ``<``
in candidate order), as the hand kernel (``csrc/astc_encode.cu``) does, so
that the two agree bit for bit.  The kernel's one-hot matrix products are
what they compute here: a table lookup (colour and weight LUTs, trit/quint
pack blocks, the chosen pattern's membership), a masked sum (the partition
screens, the Gauss-Seidel footprint scores), an integer-exact product (the
C.2.18 infill) or, for the decimated grid's pseudo-inverse, a left fold
over texels.  Two divisions by a constant follow the jitted kernel rather
than its source, because XLA rewrites ``x / c`` as ``x * float32(1 / c)``:
the luma ``(r + g + b) / 3`` of CEM 0/4 and the void extent's mean
``sum / T``.

``encode_astc`` runs this plain version for a CPU tensor and the hand
kernel (``kernels/astc_cuda.py``) for a CUDA tensor; it never falls back
from one to the other.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cuttlefish_tpu_torch.kernels.astc_ise import (
    ise_sequence_layout,
    quint_pack_table,
    range_info,
    trit_pack_table,
    weight_unquant,
)
from cuttlefish_tpu_torch.kernels.astc_partition import (
    partition_table,
    unique_partition_seeds,
)
from cuttlefish_tpu_torch.kernels.astc_tables import (
    GRAY_SPREAD,
    _color_qlut,
    _layouts_b,
    _layouts_d,
    _prepared_grid,
    _tasks_a,
    _weight_neighbors,
    _weight_qlut,
    block_mode_field,
    layout_menu,
    plan_for,
)
from cuttlefish_tpu_torch.kernels.bc import _csum, _device_kind, _rt, _sel
from cuttlefish_tpu_torch.kernels.jnp_common import sqrt_f32

_INF = float("inf")
# float32(1/3): the luma of CEM 0/4 as XLA computes (r + g + b) / 3.0.
_THIRD = float(np.float32(1.0) / np.float32(3.0))
# Near-gray threshold in the kernel's 0..255 domain, as a float32.
_GRAY_255 = float(np.float32(GRAY_SPREAD * 255.0))
# Blocks per pass of the plain version: kernel D's 1024-seed screen holds
# [1024, chunk] tensors per channel and partition (about 6 GB at this size).
CHUNK = 65536


def _sq(x):
    return x * x


# ---------------------------------------------------------------------------
# Tables on a device
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _table(name: str, key, device: str) -> torch.Tensor:
    """Static numpy tables as tensors on ``device`` (cached)."""
    if name == "cq":  # colour LUT: byte -> ISE value
        arr = _color_qlut(key)[0]
    elif name == "cd":  # colour LUT: byte -> decoded byte
        arr = _color_qlut(key)[1]
    elif name == "wq":  # weight LUT: w64 -> ISE value
        arr = _weight_qlut(key)[0]
    elif name == "wu":  # weight LUT: w64 -> decoded w64
        arr = _weight_qlut(key)[1]
    elif name == "unq":  # ISE weight value -> w64
        arr = weight_unquant(key)
    elif name == "up":
        arr = _weight_neighbors(key)[0]
    elif name == "dn":
        arr = _weight_neighbors(key)[1]
    elif name == "trit":
        arr = trit_pack_table().reshape(-1)
    elif name == "quint":
        arr = quint_pack_table().reshape(-1)
    elif name == "grid":  # (bw, bh, gw, gh) -> a, pinv, foot
        a, pinv, foot = _prepared_grid(*key)
        return (
            torch.from_numpy(a).to(device),
            torch.from_numpy(pinv).to(device),
            torch.from_numpy(foot).to(device),
        )
    elif name == "part":  # (bw, bh, nparts, unique) -> [rows, T] int8, seeds
        bw, bh, nparts, unique = key
        tab = partition_table(bw, bh, nparts)
        seeds = unique_partition_seeds(bw, bh, nparts) if unique else np.arange(1024)
        return (
            torch.from_numpy(tab[seeds].astype(np.int64)).to(device),
            torch.from_numpy(seeds.astype(np.int64)).to(device),
        )
    else:
        raise KeyError(name)
    return torch.from_numpy(np.asarray(arr, np.int64)).to(device)


def _grid_of(lay, device):
    if _prepared_grid(lay.bw, lay.bh, lay.gw, lay.gh) is None:
        return None
    return _table("grid", (lay.bw, lay.bh, lay.gw, lay.gh), str(device))


# ---------------------------------------------------------------------------
# ISE packing
# ---------------------------------------------------------------------------


def _bitrev32(x):
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) | (x >> 16)) & 0xFFFFFFFF


def _pack_ise(words, values, levels, for_weights, start, reverse):
    """ORs the ISE stream of ``values`` (list of n [N] int64 tensors) into
    ``words`` (list of 4 [N] int64 holding u32) from stream bit ``start``;
    ``reverse`` writes stream bit p at block bit 127 - p (the weights).
    Mirrors ``astc_pallas.py:_pack_ise_pallas``."""
    kind, b = range_info(levels, for_weights)
    n = len(values)
    dev = values[0].device
    packed = []
    if kind != "b":
        per = 5 if kind == "t" else 3
        radix = 3 if kind == "t" else 5
        table = _table("trit" if kind == "t" else "quint", None, str(dev))
        for g in range((n + per - 1) // per):
            idx = torch.zeros_like(values[0])
            for k in range(per):
                i = g * per + k
                if i < n:
                    idx = idx + (values[i] >> b) * (radix ** (per - 1 - k))
            packed.append(table[idx])
    srcs = values + packed
    entries = []
    for pos, (src, i, j) in enumerate(ise_sequence_layout(n, kind, b)):
        if src == "m":
            if i < 0:
                continue
            row = i
        else:
            row = n + i
        entries.append((pos if reverse else start + pos, row, j))
    acc = [torch.zeros_like(values[0]) for _ in range(4)]
    run = None  # (bb0, row, j0, length)
    for bb, row, j in entries + [(-99, -1, -1)]:
        if (run is not None and row == run[1] and j == run[2] + run[3]
                and bb == run[0] + run[3] and bb % 32 != 0):
            run = (run[0], run[1], run[2], run[3] + 1)
            continue
        if run is not None:
            bb0, r0, j0, ln = run
            field = (srcs[r0] >> j0) & ((1 << ln) - 1)
            acc[bb0 // 32] = acc[bb0 // 32] | (field << (bb0 % 32))
        run = (bb, row, j, 1) if row >= 0 else None
    for w in range(4):
        if reverse:
            words[3 - w] = words[3 - w] | _bitrev32(acc[w])
        else:
            words[w] = words[w] | acc[w]


# ---------------------------------------------------------------------------
# Shared fit machinery (astc_pallas.py:_pca_seed .. _fit_dual)
# ---------------------------------------------------------------------------


def _masked(x, mask):
    return x if mask is None else x * mask


def _count(px0, mask):
    """_rt(mask) + 1e-6 (mask None: all T texels)."""
    if mask is None:
        return torch.full_like(px0[0], float(px0.shape[0])) + 1e-6
    return _rt(mask) + 1e-6


def _pca_seed(px, mask, chn):
    """Masked principal-axis extremes; px list of [T,N], mask [T,N] 0/1 or
    None (every texel)."""
    cnt = _count(px[0], mask)
    mean = [_rt(_masked(px[c], mask)) / cnt for c in range(chn)]
    cent = [_masked(px[c] - mean[c], mask) for c in range(chn)]
    cov = [[_rt(cent[c] * cent[d]) for d in range(chn)] for c in range(chn)]
    v = [torch.ones_like(mean[0]) for _ in range(chn)]
    for _ in range(3):
        nv = [_csum([cov[c][d] * v[d] for d in range(chn)]) for c in range(chn)]
        nn = sqrt_f32(_csum([x * x for x in nv]))
        v = [torch.where(nn > 1e-10, nv[c] / (nn + 1e-20), v[c]) for c in range(chn)]
    t = _csum([cent[c] * v[c] for c in range(chn)])
    if mask is None:
        tmax = t.max(dim=0).values
        tmin = t.min(dim=0).values
    else:
        tmax = torch.where(mask > 0, t, -1e30).max(dim=0).values
        tmin = torch.where(mask > 0, t, 1e30).min(dim=0).values
    e1 = [mean[c] + v[c] * tmax for c in range(chn)]
    e0 = [mean[c] + v[c] * tmin for c in range(chn)]
    return e0, e1


def _orient(e0, e1):
    """sum(rgb) of e0 must not exceed e1's (CEM 8/12 endpoint order)."""
    swap = _csum(e0[:3]) > _csum(e1[:3])
    return _sel(swap, e1, e0), _sel(swap, e0, e1)


def _quant_colors(e, clevels):
    """Channel list of [N] floats 0..255 -> (ISE values, decoded bytes)."""
    qs, ds = [], []
    for ec in e:
        v = torch.clamp(torch.round(ec), 0, 255).to(torch.int64)
        if clevels == 256:
            qs.append(v)
            ds.append(v)
        else:
            dev = str(v.device)
            qs.append(_table("cq", clevels, dev)[v])
            ds.append(_table("cd", clevels, dev)[v])
    return qs, ds


def _ls(px, w, mask, chn):
    """LS endpoints for fixed weights w [T,N] in [0,1]."""
    wv = _masked(w, mask)
    uv = _masked(1.0 - w, mask)
    a11 = _rt(wv * w)
    a12 = _rt(wv * (1.0 - w))
    a22 = _rt(uv * (1.0 - w))
    b1 = [_rt(wv * px[c]) for c in range(chn)]
    b0 = [_rt(uv * px[c]) for c in range(chn)]
    det = a11 * a22 - a12 * a12
    ok = torch.abs(det) > 1e-6
    safe = torch.where(ok, det, 1.0)
    cnt = _count(px[0], mask)
    mean = [_rt(_masked(px[c], mask)) / cnt for c in range(chn)]
    e1 = [torch.where(ok, (a22 * b1[c] - a12 * b0[c]) / safe, mean[c]) for c in range(chn)]
    e0 = [torch.where(ok, (a11 * b0[c] - a12 * b1[c]) / safe, mean[c]) for c in range(chn)]
    return ([torch.clamp(x, 0.0, 255.0) for x in e0],
            [torch.clamp(x, 0.0, 255.0) for x in e1])


def _dec(d0, d1, w64):
    """Decoded byte of the exact decoder model (16-bit endpoint expansion,
    64-weight interpolation, top byte) as float32."""
    c16 = (d0 * 257 * (64 - w64) + d1 * 257 * w64 + 32) >> 6
    return (c16 >> 8).to(torch.float32)


def _eval_exact(px, d0t, d1t, w64, nch):
    """Per-block error over 4 channels; channels >= nch decode to 255."""
    errs = []
    for c in range(4):
        d0 = d0t[c] if c < nch else 255
        d1 = d1t[c] if c < nch else 255
        errs.append(_rt(_sq(_dec(d0, d1, w64) - px[c])))
    return _csum(errs)


def _texel_werr(pxl, d0l, d1l, w64):
    """Per-texel exact-model error for weight w64 (int or [T,N])."""
    return _csum([_sq(_dec(d0l[c], d1l[c], w64) - pxl[c]) for c in range(len(pxl))])


def _wquant_levels(w64, levels):
    """Nearest rung of the weight ladder (ties: lowest ISE value)."""
    dev = str(w64.device)
    return _table("wq", levels, dev)[w64], _table("wu", levels, dev)[w64]


def _wquant_exact(pxl, d0l, d1l, levels):
    """Per-texel weight by exact decode error (full weight grids): a full
    sweep of ladders of <= 8 rungs; finer ladders take the nearest rung to
    the continuous projection and one exact-error step up or down."""
    unq_tab = weight_unquant(levels)
    if levels <= 8:
        best_q = best_u = best_e = None
        for q in range(levels):
            w64 = int(unq_tab[q])
            e = _texel_werr(pxl, d0l, d1l, w64)
            if best_q is None:
                best_q = torch.full(e.shape, q, dtype=torch.int64, device=e.device)
                best_u = torch.full_like(best_q, w64)
                best_e = e
            else:
                take = e < best_e
                best_q = torch.where(take, q, best_q)
                best_u = torch.where(take, w64, best_u)
                best_e = torch.minimum(e, best_e)
        return best_q, best_u
    df = [(d1l[c] - d0l[c]).to(torch.float32) for c in range(len(pxl))]
    denom = _csum([f * f for f in df]) + 1e-6
    proj = _csum([(pxl[c] - d0l[c].to(torch.float32)) * df[c] for c in range(len(pxl))])
    t = torch.clamp(proj / denom, 0.0, 1.0)
    w64i = torch.clamp(torch.round(t * 64.0), 0, 64).to(torch.int64)
    gq, unq = _wquant_levels(w64i, levels)
    dev = str(gq.device)
    unq_t = _table("unq", levels, dev)
    best_q, best_u = gq, unq
    best_e = _texel_werr(pxl, d0l, d1l, unq)
    for name in ("up", "dn"):
        cq = _table(name, levels, dev)[gq]
        cu = unq_t[cq]
        e = _texel_werr(pxl, d0l, d1l, cu)
        take = e < best_e
        best_q = torch.where(take, cq, best_q)
        best_u = torch.where(take, cu, best_u)
        best_e = torch.minimum(e, best_e)
    return best_q, best_u


def _fold_rows(m, x):
    """m [R,T] float x x [T,N] -> [R,N] as a left fold over texels (the
    order the hand kernel sums in)."""
    acc = m[:, 0:1] * x[0]
    for t in range(1, x.shape[0]):
        acc = acc + m[:, t : t + 1] * x[t]
    return acc


def _screen_sum(m, x):
    """m [R,T] 0/1 x x [T,N] -> [R,N], the masked sums of a partition
    screen: four left folds over the texels t = 0, 1, 2, 3 (mod 4), added
    as (s0 + s1) + (s2 + s3), the order XLA's CPU dot takes for the
    kernel's [U,T] x [T,N] screen products."""
    lanes = []
    for k in range(min(4, x.shape[0])):
        acc = m[:, k : k + 1] * x[k]
        for t in range(k + 4, x.shape[0], 4):
            acc = acc + m[:, t : t + 1] * x[t]
        lanes.append(acc)
    while len(lanes) > 1:
        lanes = [lanes[i] + lanes[i + 1] if i + 1 < len(lanes) else lanes[i]
                 for i in range(0, len(lanes), 2)]
    return lanes[0]


def _infill(a_mat, unqg):
    """C.2.18 infill: floor((a @ unq + 8) / 16), integer-exact in float32."""
    s = torch.matmul(a_mat, unqg.to(torch.float32))
    return torch.floor((s + 8.0) / 16.0).to(torch.int64)


def _grid_quant(t, lay, grid):
    """Ideal texel weights t [T,N] -> (gq [G,N] ISE values, w64 [T,N])."""
    if grid is None:
        w64i = torch.clamp(torch.round(t * 64.0), 0, 64).to(torch.int64)
        return _wquant_levels(w64i, lay.wlevels)
    a_mat, pinv = grid[0], grid[1]
    g = _fold_rows(pinv, t)
    w64g = torch.clamp(torch.round(torch.clamp(g, 0.0, 1.0) * 64.0), 0, 64).to(torch.int64)
    gq, unqg = _wquant_levels(w64g, lay.wlevels)
    return gq, _infill(a_mat, unqg)


def _infill_w64(gq, lay, grid):
    return _infill(grid[0], _table("unq", lay.wlevels, str(gq.device))[gq])


def _gs_refine(px, d0x, d1x, nche, gq, lay, grid):
    """One Gauss-Seidel pass over the four (gx%2, gy%2) checkerboard
    classes of a decimated grid: each point tries the next rung up, then
    down, scored by the exact error over its footprint."""
    a_mat, foot_t = grid[0], grid[2]
    dev = str(gq.device)
    unq_t = _table("unq", lay.wlevels, dev)
    gi = torch.arange(lay.gw * lay.gh, device=gq.device).reshape(-1, 1)
    cls = ((gi // lay.gw) % 2) * 2 + (gi % lay.gw) % 2

    def texel_err(g):
        w64 = _infill(a_mat, unq_t[g])
        errs = []
        for c in range(4):
            d0 = d0x[c] if c < nche else 255
            d1 = d1x[c] if c < nche else 255
            errs.append(_sq(_dec(d0, d1, w64) - px[c]))
        return _csum(errs)

    def scores(g):
        return _fold_rows(foot_t, texel_err(g))

    cur = scores(gq)
    for cc in range(4):
        cmask = cls == cc
        for name in ("up", "dn"):
            cand = torch.where(cmask, _table(name, lay.wlevels, dev)[gq], gq)
            sc = scores(cand)
            take = cmask & (sc < cur)
            gq = torch.where(take, cand, gq)
            cur = scores(gq)
    return gq


def _fit_space(px, lay):
    """Fit-space channels by CEM: 8 = RGB, 12 = RGBA, 0 = luma, 4 = luma +
    alpha (decode replicates L to RGB, spec C.2.14)."""
    if lay.cem in (0, 4):
        gray = (px[0] + px[1] + px[2]) * _THIRD
        return [gray, px[3]] if lay.cem == 4 else [gray]
    return px[: (4 if lay.cem == 12 else 3)]


def _expand4(lay, d, nch):
    """Fit-space decoded endpoints -> (4-channel list, eval nch)."""
    if lay.cem == 0:
        return [d[0], d[0], d[0]], 3
    if lay.cem == 4:
        return [d[0], d[0], d[0], d[1]], 4
    return d, nch


def _fit_1part(px, lay, iters, grid):
    """1-partition fit -> (q0, q1, gq, err)."""
    luma = lay.cem in (0, 4)
    pxf = _fit_space(px, lay)
    nch = len(pxf)
    e0, e1 = _pca_seed(pxf, None, nch)
    if not luma:
        e0, e1 = _orient(e0, e1)
    best = None
    for it in range(max(1, iters)):
        q0, d0 = _quant_colors(e0, lay.clevels)
        q1, d1 = _quant_colors(e1, lay.clevels)
        if not luma:
            swap = _csum(d0[:3]) > _csum(d1[:3])
            q0, q1 = _sel(swap, q1, q0), _sel(swap, q0, q1)
            d0, d1 = _sel(swap, d1, d0), _sel(swap, d0, d1)
        d0x, nche = _expand4(lay, d0, nch)
        d1x, _ = _expand4(lay, d1, nch)
        if grid is None:
            gq, unq = _wquant_exact(px[:nche], d0x[:nche], d1x[:nche], lay.wlevels)
        else:
            df = [(d1[c] - d0[c]).to(torch.float32) for c in range(nch)]
            denom = _csum([f * f for f in df]) + 1e-6
            proj = _csum([(pxf[c] - d0[c].to(torch.float32)) * df[c] for c in range(nch)])
            t = torch.clamp(proj / denom, 0.0, 1.0)
            gq, unq = _grid_quant(t, lay, grid)
            if lay.bw * lay.bh > 64:
                gq = _gs_refine(px, d0x, d1x, nche, gq, lay, grid)
                unq = _infill_w64(gq, lay, grid)
        err = _eval_exact(px, d0x, d1x, unq, nche)
        if best is None:
            best = (q0, q1, gq, unq, err)
        else:
            take = err < best[4]
            best = (_sel(take, q0, best[0]), _sel(take, q1, best[1]),
                    torch.where(take, gq, best[2]), torch.where(take, unq, best[3]),
                    torch.where(take, err, best[4]))
        if it + 1 < max(1, iters):
            e0, e1 = _ls(pxf, best[3].to(torch.float32) / 64.0, None, nch)
            if not luma:
                e0, e1 = _orient(e0, e1)
    return best[0], best[1], best[2], best[4]


def _empty_words(like):
    return [torch.zeros_like(like, dtype=torch.int64) for _ in range(4)]


def _pack_1part(lay, q0, q1, gq, ccs: int = 0):
    """Words of a 1-partition block (gq [2G,N] plane-interleaved when dual)."""
    words = _empty_words(q0[0])
    mode = block_mode_field(lay.gw, lay.gh, lay.wlevels, lay.dual)
    words[0] = words[0] | (mode | ((lay.nparts - 1) << 11) | (lay.cem << 13))
    cols = []
    for c in range(len(q0)):
        cols += [q0[c], q1[c]]
    _pack_ise(words, cols, lay.clevels, False, lay.header, False)
    nw = lay.gw * lay.gh * (2 if lay.dual else 1)
    _pack_ise(words, [gq[i] for i in range(nw)], lay.wlevels, True, 0, True)
    if lay.dual:
        pos = 128 - lay.wbits - 2
        for k in range(2):
            if (ccs >> k) & 1:
                w, bo = divmod(pos + k, 32)
                words[w] = words[w] | (1 << bo)
    return words


def _fit_dual(px, lay, ccs, iters, grid):
    """Single-partition dual-plane fit: plane 0 drives the channels other
    than ccs, plane 1 drives ccs -> (q0, q1, gq [2G,N], err)."""
    nch = 4 if lay.cem == 12 else 3
    rest = [c for c in range(nch) if c != ccs]
    pr = [px[c] for c in rest]
    e0r, e1r = _pca_seed(pr, None, len(rest))
    lo_a = px[ccs].min(dim=0).values
    hi_a = px[ccs].max(dim=0).values

    def assemble(r, a):
        out, ri = [], 0
        for c in range(nch):
            if c == ccs:
                out.append(a)
            else:
                out.append(r[ri])
                ri += 1
        return out

    e0, e1 = _orient(assemble(e0r, lo_a), assemble(e1r, hi_a))
    best = None
    for it in range(max(1, iters)):
        q0, d0 = _quant_colors(e0, lay.clevels)
        q1, d1 = _quant_colors(e1, lay.clevels)
        swap = _csum(d0[:3]) > _csum(d1[:3])
        q0, q1 = _sel(swap, q1, q0), _sel(swap, q0, q1)
        d0, d1 = _sel(swap, d1, d0), _sel(swap, d0, d1)
        dfr = [(d1[c] - d0[c]).to(torch.float32) for c in rest]
        denom = _csum([f * f for f in dfr]) + 1e-6
        proj = _csum([(px[c] - d0[c].to(torch.float32)) * f for c, f in zip(rest, dfr)])
        t0 = torch.clamp(proj / denom, 0.0, 1.0)
        da = (d1[ccs] - d0[ccs]).to(torch.float32)
        dasafe = torch.where(torch.abs(da) > 1e-6, da, 1.0)
        t1 = torch.clamp((px[ccs] - d0[ccs].to(torch.float32)) / dasafe, 0.0, 1.0)
        if grid is None:
            gq0, unq0 = _wquant_exact(pr, [d0[c] for c in rest], [d1[c] for c in rest],
                                      lay.wlevels)
            gq1, unq1 = _wquant_exact([px[ccs]], [d0[ccs]], [d1[ccs]], lay.wlevels)
        else:
            gq0, unq0 = _grid_quant(t0, lay, grid)
            gq1, unq1 = _grid_quant(t1, lay, grid)
        errs = []
        for c in range(4):
            dd0 = d0[c] if c < nch else 255
            dd1 = d1[c] if c < nch else 255
            w64 = unq1 if c == ccs else unq0
            errs.append(_rt(_sq(_dec(dd0, dd1, w64) - px[c])))
        err = _csum(errs)
        g = lay.gw * lay.gh
        gq = torch.stack([gq0[: g], gq1[: g]], dim=1).reshape(2 * g, -1)
        if best is None:
            best = (q0, q1, gq, unq0, unq1, err)
        else:
            take = err < best[5]
            best = (_sel(take, q0, best[0]), _sel(take, q1, best[1]),
                    torch.where(take, gq, best[2]), torch.where(take, unq0, best[3]),
                    torch.where(take, unq1, best[4]), torch.where(take, err, best[5]))
        if it + 1 < max(1, iters):
            w0 = best[3].to(torch.float32) / 64.0
            w1 = best[4].to(torch.float32) / 64.0
            e0r2, e1r2 = _ls(pr, w0, None, len(rest))
            e0a2, e1a2 = _ls([px[ccs]], w1, None, 1)
            e0, e1 = _orient(assemble(e0r2, e0a2[0]), assemble(e1r2, e1a2[0]))
    return best[0], best[1], best[2], best[5]


def _void_extent(px, t_count):
    inv = float(np.float32(1.0) / np.float32(t_count))
    v16 = [torch.clamp(torch.round(_rt(px[c]) * inv * 257.0), 0, 65535).to(torch.int64)
           for c in range(4)]
    err = _csum([_rt(_sq((v16[c] >> 8).to(torch.float32) - px[c])) for c in range(4)])
    err = err - 1e-3  # tie-break toward the void extent
    w0 = torch.full_like(v16[0], (0x1FC | (0b11 << 10)) | 0xFFFFF000)
    w1 = torch.full_like(v16[0], 0xFFFFFFFF)
    return [w0, w1, v16[0] | (v16[1] << 16), v16[2] | (v16[3] << 16)], err


def _gray_mask(px):
    """[N] bool: every texel of the block is near-gray (RGB spread below
    GRAY_SPREAD in the 0..255 domain)."""
    hi = torch.maximum(torch.maximum(px[0], px[1]), px[2])
    lo = torch.minimum(torch.minimum(px[0], px[1]), px[2])
    return (hi - lo).max(dim=0).values < _GRAY_255


def _merge(words, err, lwords, lerr):
    if words is None:
        return lwords, lerr
    take = lerr < err
    return [torch.where(take, a, b) for a, b in zip(lwords, words)], torch.minimum(lerr, err)


# ---------------------------------------------------------------------------
# Kernel A: void extent + 1-partition layouts
# ---------------------------------------------------------------------------


def _kernel_a(px, bw, bh, quality, gray=True, alpha=True):
    """-> (4 word tensors [N], err [N])."""
    plan = plan_for(quality, bw, bh)
    iters = plan["iters"]
    iters12 = plan.get("iters12", iters)
    dev = px[0].device

    def run(tasks, words, err, mask=None):
        for lay, ccs in tasks:
            grid = _grid_of(lay, dev)
            it_n = iters12 if lay.cem == 12 else iters
            if ccs is None:
                q0, q1, gq, lerr = _fit_1part(px, lay, it_n, grid)
                lwords = _pack_1part(lay, q0, q1, gq)
            else:
                q0, q1, gq, lerr = _fit_dual(px, lay, ccs, it_n, grid)
                lwords = _pack_1part(lay, q0, q1, gq, ccs)
            if mask is not None:
                lerr = torch.where(mask, lerr, _INF)
            take = lerr < err
            words = [torch.where(take, a, b) for a, b in zip(lwords, words)]
            err = torch.where(take, lerr, err)
        return words, err

    base, gray_tasks = _tasks_a(bw, bh, quality, gray, alpha)
    words, err = _void_extent(px, bw * bh)
    words, err = run(base, words, err)
    if gray_tasks:
        words, err = run(gray_tasks, words, err, _gray_mask(px))
    return words, err


# ---------------------------------------------------------------------------
# Kernels B-D: partition screens + multi-partition fits
# ---------------------------------------------------------------------------


def _fit_2part(px, masks, lay, iters, grid):
    """Multi-partition fit with [T,N] 0/1 membership masks (summing to 1)
    -> (qs [(q0, q1)] per partition, gq [G,N], err)."""
    luma = lay.cem in (0, 4)
    pxf = _fit_space(px, lay)
    nch = len(pxf)
    nparts = len(masks)
    seeds = [_pca_seed(pxf, m, nch) for m in masks]
    if not luma:
        seeds = [_orient(*s) for s in seeds]
    best = None
    for it in range(max(1, iters)):
        qs, ds = [], []
        for p in range(nparts):
            q0, d0 = _quant_colors(seeds[p][0], lay.clevels)
            q1, d1 = _quant_colors(seeds[p][1], lay.clevels)
            if not luma:
                swap = _csum(d0[:3]) > _csum(d1[:3])
                q0, q1 = _sel(swap, q1, q0), _sel(swap, q0, q1)
                d0, d1 = _sel(swap, d1, d0), _sel(swap, d0, d1)
            qs.append((q0, q1))
            ds.append((d0, d1))
        d0t = [_csum([ds[p][0][c].to(torch.float32) * masks[p] for p in range(nparts)])
               for c in range(nch)]
        d1t = [_csum([ds[p][1][c].to(torch.float32) * masks[p] for p in range(nparts)])
               for c in range(nch)]
        d0x, nche = _expand4(lay, d0t, nch)
        d1x, _ = _expand4(lay, d1t, nch)
        d0i = [d.to(torch.int64) for d in d0x]
        d1i = [d.to(torch.int64) for d in d1x]
        if grid is None:
            gq, unq = _wquant_exact(px[:nche], d0i[:nche], d1i[:nche], lay.wlevels)
        else:
            df = [d1t[c] - d0t[c] for c in range(nch)]
            denom = _csum([f * f for f in df]) + 1e-6
            proj = _csum([(pxf[c] - d0t[c]) * df[c] for c in range(nch)])
            t = torch.clamp(proj / denom, 0.0, 1.0)
            gq, unq = _grid_quant(t, lay, grid)
            if lay.bw * lay.bh > 64:
                gq = _gs_refine(px, d0i, d1i, nche, gq, lay, grid)
                unq = _infill_w64(gq, lay, grid)
        err = _eval_exact(px, d0i, d1i, unq, nche)
        if best is None:
            best = (qs, gq, unq, err)
        else:
            take = err < best[3]
            newqs = [(_sel(take, qs[p][0], best[0][p][0]), _sel(take, qs[p][1], best[0][p][1]))
                     for p in range(nparts)]
            best = (newqs, torch.where(take, gq, best[1]), torch.where(take, unq, best[2]),
                    torch.where(take, err, best[3]))
        if it + 1 < max(1, iters):
            w = best[2].to(torch.float32) / 64.0
            seeds = [_ls(pxf, w, m, nch) for m in masks]
            if not luma:
                seeds = [_orient(*s) for s in seeds]
    return best[0], best[1], best[3]


def _pack_2part(lay, qs, gq, seed):
    """Words of a same-CEM multi-partition block; seed [N] int64."""
    nch = (lay.cem >> 2) + 1
    words = _empty_words(seed)
    mode = block_mode_field(lay.gw, lay.gh, lay.wlevels)
    words[0] = words[0] | (mode | ((lay.nparts - 1) << 11))
    words[0] = words[0] | (seed << 13)
    words[0] = words[0] | ((lay.cem << 2) << 23)
    cols = []
    for p in range(lay.nparts):
        for c in range(nch):
            cols += [qs[p][0][c], qs[p][1][c]]
    _pack_ise(words, cols, lay.clevels, False, lay.header, False)
    _pack_ise(words, [gq[i] for i in range(lay.gw * lay.gh)], lay.wlevels, True, 0, True)
    return words


def _screen_inputs(px):
    sq_all = _rt(_csum([px[c] * px[c] for c in range(4)]))
    s_all = [_rt(px[c]) for c in range(4)]
    return sq_all, s_all


def _topk(sse, k):
    """Row indices of the k least values per block, lowest row on ties,
    in order of extraction."""
    nrows = sse.shape[0]
    iota = torch.arange(nrows, device=sse.device).reshape(-1, 1)
    out = []
    for _ in range(k):
        smin = sse.min(dim=0).values
        seed = torch.where(sse == smin, iota, nrows).min(dim=0).values
        sse = torch.where(iota == seed, _INF, sse)
        out.append(seed)
    return out


def _rank_keep(seeds, ests, keep):
    """Per block, the ``keep`` seeds of least estimate, in order, the
    first of equal estimates first (astc_pallas.py:_kernel_b winners)."""
    chosen = [torch.zeros_like(e, dtype=torch.bool) for e in ests]
    winners = []
    for _ in range(keep):
        bi = be = bseed = None
        for i, (seed, e) in enumerate(zip(seeds, ests)):
            ee = torch.where(chosen[i], _INF, e)
            if bi is None:
                bi = torch.zeros_like(seed)
                be, bseed = ee, seed
            else:
                take = ee < be
                bi = torch.where(take, i, bi)
                be = torch.minimum(ee, be)
                bseed = torch.where(take, seed, bseed)
        winners.append(bseed)
        for i in range(len(ests)):
            chosen[i] = chosen[i] | (bi == i)
    return winners


def _member(tab, seed, j):
    """[T,N] float 0/1: texels of partition j under each block's pattern row."""
    return (tab[seed] == j).to(torch.float32).t()


def _cont_sse(px, m1):
    """Continuous-SSE rank of a 2-partition split: per-subset masked-PCA
    line residual, subsets 0 then 1."""
    tot = None
    for m in (1.0 - m1, m1):
        cnt = _rt(m) + 1e-6
        mean = [_rt(px[c] * m) / cnt for c in range(4)]
        cent = [(px[c] - mean[c]) * m for c in range(4)]
        cov = [[_rt(cent[a] * cent[d]) for d in range(4)] for a in range(4)]
        v = [torch.ones_like(cnt) for _ in range(4)]
        for _ in range(3):
            nv = [_csum([cov[a][d] * v[d] for d in range(4)]) for a in range(4)]
            nn = sqrt_f32(_csum([x * x for x in nv]))
            v = [torch.where(nn > 1e-10, nv[a] / (nn + 1e-20), v[a]) for a in range(4)]
        proj = _csum([cent[c] * v[c] for c in range(4)])
        e = _rt(_csum([cent[c] * cent[c] for c in range(4)])) - _rt(proj * proj)
        tot = e if tot is None else tot + e
    return tot


def _kernel_b(px, bw, bh, quality, alpha=True):
    plan = plan_for(quality, bw, bh)
    topk = max(1, plan["seeds2"])
    lays = _layouts_b(bw, bh, quality, alpha)
    t_count = float(bw * bh)
    dev = px[0].device
    tab, smap = _table("part", (bw, bh, 2, True), str(dev))
    pt = (tab == 1).to(torch.float32)  # [U,T]
    ns = pt.sum(dim=1, keepdim=True)
    s1 = [_screen_sum(pt, px[c]) for c in range(4)]
    sq_all, s_all = _screen_inputs(px)
    n1 = ns + 1e-6
    n0 = (t_count - ns) + 1e-6
    explained = (_csum([s1[c] * s1[c] for c in range(4)]) / n1
                 + _csum([_sq(s_all[c] - s1[c]) for c in range(4)]) / n0)
    sse = sq_all - explained
    sse = torch.where((ns < 1.0) | (ns > t_count - 1.0), _INF, sse)
    seeds_l = _topk(sse, topk)
    keep = min(max(1, plan.get("keep2", 1)), topk)
    if topk > keep:
        ests = [_cont_sse(px, _member(tab, s, 1)) for s in seeds_l]
        seeds_l = _rank_keep(seeds_l, ests, keep)
    words = err = None
    p2_iters = plan.get("p2_iters", plan["iters"])
    for seed in seeds_l:
        m1 = _member(tab, seed, 1)
        for lay in lays:
            qs, gq, lerr = _fit_2part(px, (1.0 - m1, m1), lay, p2_iters, _grid_of(lay, dev))
            words, err = _merge(words, err, _pack_2part(lay, qs, gq, smap[seed]), lerr)
    return words, err


def _kernel_c(px, bw, bh, quality):
    plan = plan_for(quality, bw, bh)
    topk = max(1, plan["seeds3"])
    lay = layout_menu(bw, bh)[(8, 3)][0]
    t_count = float(bw * bh)
    dev = px[0].device
    grid = _grid_of(lay, dev)
    tab, smap = _table("part", (bw, bh, 3, True), str(dev))
    p1 = (tab == 1).to(torch.float32)
    p2 = (tab == 2).to(torch.float32)
    n1 = p1.sum(dim=1, keepdim=True)
    n2 = p2.sum(dim=1, keepdim=True)
    s1 = [_screen_sum(p1, px[c]) for c in range(4)]
    s2 = [_screen_sum(p2, px[c]) for c in range(4)]
    sq_all, s_all = _screen_inputs(px)
    n0 = t_count - n1 - n2
    explained = (
        _csum([_sq(s_all[c] - s1[c] - s2[c]) for c in range(4)]) / torch.clamp(n0, min=1.0)
        + _csum([s1[c] * s1[c] for c in range(4)]) / torch.clamp(n1, min=1.0)
        + _csum([s2[c] * s2[c] for c in range(4)]) / torch.clamp(n2, min=1.0)
    )
    sse = sq_all - explained
    sse = torch.where((n0 < 1.0) | (n1 < 1.0) | (n2 < 1.0), _INF, sse)
    seeds_l = _topk(sse, topk)

    def masks(seed):
        m1, m2 = _member(tab, seed, 1), _member(tab, seed, 2)
        return (1.0 - m1 - m2, m1, m2)

    keep3 = min(max(1, plan.get("keep3", 1)), topk)
    if topk > keep3:
        ests = [_fit_2part(px, masks(s), lay, 1, grid)[2] for s in seeds_l]
        seeds_l = _rank_keep(seeds_l, ests, keep3)
    words = err = None
    for seed in seeds_l:
        qs, gq, lerr = _fit_2part(px, masks(seed), lay, plan["iters"], grid)
        words, err = _merge(words, err, _pack_2part(lay, qs, gq, smap[seed]), lerr)
    return words, err


def _kernel_d(px, bw, bh, quality):
    """4-partition luminance fits; blocks that are not near-gray get
    zero words and an infinite error."""
    lays = _layouts_d(bw, bh)
    plan = plan_for(quality, bw, bh)
    topk = max(1, plan["seeds4"])
    t_count = float(bw * bh)
    dev = px[0].device
    tab, _ = _table("part", (bw, bh, 4, False), str(dev))
    ps = [(tab == j).to(torch.float32) for j in (1, 2, 3)]
    ns = [p.sum(dim=1, keepdim=True) for p in ps]
    s_p = [[_screen_sum(p, px[c]) for c in range(4)] for p in ps]
    sq_all, s_all = _screen_inputs(px)
    n0 = t_count - ns[0] - ns[1] - ns[2]
    explained = _csum(
        [_sq(s_all[c] - s_p[0][c] - s_p[1][c] - s_p[2][c]) for c in range(4)]
    ) / torch.clamp(n0, min=1.0)
    for j in range(3):
        explained = explained + _csum([s_p[j][c] * s_p[j][c] for c in range(4)]) / torch.clamp(
            ns[j], min=1.0)
    sse = sq_all - explained
    degenerate = n0 < 1.0
    for nj in ns:
        degenerate = degenerate | (nj < 1.0)
    sse = torch.where(degenerate, _INF, sse)
    seeds_l = _topk(sse, topk)

    def masks(seed):
        m1, m2, m3 = (_member(tab, seed, j) for j in (1, 2, 3))
        return (1.0 - m1 - m2 - m3, m1, m2, m3)

    if topk > 1:
        bs = be = None
        for seed in seeds_l:
            e = _fit_2part(px, masks(seed), lays[0], 1, _grid_of(lays[0], dev))[2]
            if bs is None:
                bs, be = seed, e
            else:
                take = e < be
                bs = torch.where(take, seed, bs)
                be = torch.minimum(e, be)
        seeds_l = [bs]
    words = err = None
    for seed in seeds_l:
        for lay in lays:
            qs, gq, lerr = _fit_2part(px, masks(seed), lay, plan["iters"], _grid_of(lay, dev))
            words, err = _merge(words, err, _pack_2part(lay, qs, gq, seed), lerr)
    gray = _gray_mask(px)
    words = [torch.where(gray, w, 0) for w in words]
    return words, torch.where(gray, err, _INF)


# ---------------------------------------------------------------------------
# Entries
# ---------------------------------------------------------------------------


def stages(bw: int, bh: int, quality: int, gray: bool = True, alpha: bool = True):
    """Which kernels an encode runs, in merge order: ``"a"`` always, then
    ``"b"``, ``"c"`` and ``"d"`` as ``encode_astc_pallas`` gates them."""
    plan = plan_for(quality, bw, bh)
    out = ["a"]
    if plan["seeds2"] and _layouts_b(bw, bh, quality, alpha):
        out.append("b")
    if plan["seeds3"] and layout_menu(bw, bh)[(8, 3)]:
        out.append("c")
    if plan["seeds4"] and _layouts_d(bw, bh) and gray:
        out.append("d")
    return out


def channels255(blocks):
    """[N,T,4] -> 4 channel tensors [T,N]: clip(0, 1) * 255."""
    x = torch.clamp(blocks.to(torch.float32), 0.0, 1.0) * 255.0
    x = x.permute(2, 1, 0)
    return [x[c].contiguous() for c in range(4)]


def run_stage(stage, px, bw, bh, quality, gray=True, alpha=True):
    """One kernel body of the plain version -> (4 word tensors, err)."""
    if stage == "a":
        return _kernel_a(px, bw, bh, quality, gray, alpha)
    if stage == "b":
        return _kernel_b(px, bw, bh, quality, alpha)
    if stage == "c":
        return _kernel_c(px, bw, bh, quality)
    return _kernel_d(px, bw, bh, quality)


def stage_plain(stage, blocks, bw, bh, quality, gray=True, alpha=True):
    """One kernel body on [N,T,4] blocks -> ([N,4] uint32 words, [N] err),
    in chunks of ``CHUNK`` blocks."""
    ws, es = [], []
    for s in range(0, blocks.shape[0], CHUNK):
        px = channels255(blocks[s : s + CHUNK])
        words, err = run_stage(stage, px, bw, bh, quality, gray, alpha)
        ws.append(torch.stack(words, dim=1))
        es.append(err)
    return torch.cat(ws).to(torch.uint32), torch.cat(es)


def merge_stage(stage, words, err, swords, serr):
    """The wrapper's merge: a later kernel wins where its error is lower."""
    take = serr < err
    words = torch.where(take[:, None], swords, words)
    return words, (err if stage == "d" else torch.where(take, serr, err))


def encode_astc_plain(blocks, block_w=4, block_h=4, quality=2, gray=True, alpha=True):
    """[N, bw*bh, 4] float RGBA (0..1) -> ASTC [N,4] uint32 words
    (``encode_astc_pallas``), in chunks of ``CHUNK`` blocks."""
    bw, bh, q = int(block_w), int(block_h), _quality(quality)
    n = blocks.shape[0]
    if n == 0:
        return torch.zeros((0, 4), dtype=torch.uint32, device=blocks.device)
    out = []
    for s in range(0, n, CHUNK):
        px = channels255(blocks[s : s + CHUNK])
        words = err = None
        for stage in stages(bw, bh, q, gray, alpha):
            sw, se = run_stage(stage, px, bw, bh, q, gray, alpha)
            sw = torch.stack(sw, dim=1)
            if words is None:
                words, err = sw, se
            else:
                words, err = merge_stage(stage, words, err, sw, se)
        out.append(words)
    return torch.cat(out).to(torch.uint32)


def _quality(quality) -> int:
    return max(0, min(4, int(quality)))


def encode_astc(blocks, block_w=4, block_h=4, quality=2, gray=True, alpha=True):
    """[N, bw*bh, 4] float RGBA blocks (0..1) -> ASTC LDR [N,4] uint32
    words.  ``gray=False`` skips the luminance CEM 0/4 fits (the caller's
    scan found no near-gray block, ``astc_tables.has_gray_blocks``);
    ``alpha=False`` skips CEM 12 and dual plane (no texel below opaque,
    ``has_alpha_blocks``).  A CPU tensor runs the plain version, a CUDA
    tensor the hand kernel."""
    bw, bh, q = int(block_w), int(block_h), _quality(quality)
    if _device_kind(blocks) == "cpu":
        return encode_astc_plain(blocks, bw, bh, q, bool(gray), bool(alpha))
    from cuttlefish_tpu_torch.kernels import astc_cuda

    return astc_cuda.encode_astc_cuda(blocks, bw, bh, q, bool(gray), bool(alpha))
