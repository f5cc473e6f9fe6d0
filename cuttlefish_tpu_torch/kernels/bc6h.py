"""BC6H block encoder (HDR RGB, unsigned and signed half floats): plain
PyTorch version and dispatch.

The plain version computes what the TPU kernel
``cuttlefish_tpu/kernels/bc6h_pallas.py:_kernel`` computes: the one-region
modes 11 (10.10) and, from quality 2, 12 (11.9 delta), each a PCA seed and
least-squares refinement; from quality 2 the two-region modes of
``_TWO_REGION_PLAN`` on the partition that a 32-partition cluster screen
ranks first, at quality 3-4 the winner of a shallow float fit over the top
``_PART_SEEDS`` partitions.  Fitting runs in the half-float bit domain (the
"proxy"); the palette model is the spec decoder's exact integer
unquantise -> interpolate -> finalise; candidates are kept by their exact
error in the linear value domain (``metric="value"``) or in the half-bit
code domain (``metric="code"``).

Layout follows the TPU kernel: each channel is a ``[16, N]`` tensor
(texels x blocks), per-block values are ``[N]``.  Every reduction over the
16 texels runs in texel order, as the hand kernel (``csrc/bc6h_encode.cu``)
sums them.  The partition screen is an exact masked sum (the TPU kernel
used matmuls against the 0/1 membership matrix).

``encode_bc6h`` runs this plain version for a CPU tensor and the hand
kernel for a CUDA tensor; it never falls back from one to the other.
"""

from __future__ import annotations

import numpy as np
import torch

from cuttlefish_tpu_torch.kernels.bc6h_tables import TWO_REGION_LAYOUT, TWO_REGION_MODES
from cuttlefish_tpu_torch.kernels.bc7 import _Packer, _csum, _masked_sums, _rt, _sel, _take, _w64
from cuttlefish_tpu_torch.kernels.bc7_tables import ANCHOR2, PARTITION2, WEIGHTS4

_HALF_MAX = 0x7BFF  # largest finite half

# cuttlefish_tpu/kernels/bc6h.py:444-462: quality -> LS iterations,
# two-region mode ids, partitions ranked by the shallow float fit.
_BC6H_ITERS = (1, 2, 3, 5, 8)
_TWO_REGION_PLAN = {
    0: (),
    1: (),
    2: (1, 2, 10),
    3: (1, 2, 6, 10),
    4: tuple(range(1, 11)),
}
_PART_SEEDS = {0: 1, 1: 1, 2: 1, 3: 2, 4: 6}

_METRICS = ("value", "code")


def _to_proxy(rgb: torch.Tensor, signed: bool) -> torch.Tensor:
    """float32 [..., 3] -> half-bit proxy ints as float32
    (``cuttlefish_tpu/kernels/bc6h.py:_to_proxy``)."""
    h = rgb.to(torch.float32).to(torch.float16).view(torch.int16).to(torch.int32)
    h = h & 0xFFFF
    mag = torch.clamp(h & 0x7FFF, max=_HALF_MAX)
    sign = (h & 0x8000) != 0
    out = torch.where(sign, -mag, mag) if signed else torch.where(sign, 0, mag)
    return out.to(torch.float32)


# ---------------------------------------------------------------------------
# Decode model (proxy half-bit domain)
# ---------------------------------------------------------------------------


def _unquant_unsigned(q, bits: int):
    maxq = (1 << bits) - 1
    u = ((q << 16) + 0x8000) >> bits
    return torch.where(q == 0, 0, torch.where(q == maxq, 0xFFFF, u))


def _unquant_signed(q, bits: int):
    aq = torch.abs(q)
    maxa = (1 << (bits - 1)) - 1
    u = ((aq << 15) + 0x4000) >> (bits - 1)
    u = torch.where(aq == 0, 0, torch.where(aq >= maxa, 0x7FFF, u))
    return torch.where(q < 0, -u, u)


def _unquant(q, bits: int, signed: bool):
    return _unquant_signed(q, bits) if signed else _unquant_unsigned(q, bits)


def _finalize(v, signed: bool):
    if signed:
        return torch.sign(v) * ((torch.abs(v) * 31) >> 5)
    return (v * 31) >> 6


def _pow2_segment(a):
    """(e, 2^(e-25)) of |proxy| a: the exponent segment, the power of two
    written into the float32 exponent field (not exp2)."""
    e = torch.clamp(torch.floor(a * (1.0 / 1024.0)), max=120.0)
    p2 = ((e.to(torch.int32) + 102) << 23).view(torch.float32)
    return e, p2


def _proxy_to_value(b):
    """Half-bit proxy (possibly fractional or negative) -> float32 value."""
    a = torch.abs(b)
    e, p2 = _pow2_segment(a)
    m = a - e * 1024.0
    val = torch.where(a < 1024.0, a * (2.0**-24), p2 * (1024.0 + m))
    return torch.where(b < 0, -val, val)


def _proxy_scale(b):
    """d(value)/d(proxy) per texel: 2^(e-25), 2^-24 in the denormal
    segment."""
    a = torch.abs(b)
    _, p2 = _pow2_segment(a)
    return torch.where(a < 1024.0, 2.0**-24, p2)


def _quant_candidates(e, bits: int, signed: bool):
    """Channel list of [N] proxy targets -> the best of round +/-1 under
    the exact decode model, per channel."""
    if signed:
        maxq = (1 << (bits - 1)) - 1
        scale = 31.0 * (1 << 11) / (1 << bits)
        lo, hi = -maxq, maxq
    else:
        maxq = (1 << bits) - 1
        scale = 31.0 * (1 << 10) / (1 << bits)
        lo, hi = 0, maxq
    out = []
    for ec in e:
        base = torch.round(ec * (1.0 / scale)).to(torch.int32)
        best_q = best_e = None
        for d in (-1, 0, 1):
            q = torch.clamp(base + d, lo, hi)
            dec = _finalize(_unquant(q, bits, signed), signed).to(torch.float32)
            err = (dec - ec) * (dec - ec)
            if best_q is None:
                best_q, best_e = q, err
            else:
                take = err < best_e
                best_q = torch.where(take, q, best_q)
                best_e = torch.minimum(err, best_e)
        out.append(best_q)
    return out


def _decoded(u0, u1, w, signed: bool):
    """Finalised palette entry at weight w [16,N], per channel, float32."""
    return [
        _finalize((u0[c] * (64 - w) + u1[c] * w + 32) >> 6, signed).to(torch.float32)
        for c in range(3)
    ]


def _exact_error(pxv, dec, code: bool):
    """Per-texel error of the chosen entries in the selection domain."""
    ev = torch.zeros_like(pxv[0])
    for c in range(3):
        d = dec[c] if code else _proxy_to_value(dec[c])
        ev = ev + (pxv[c] - d) * (pxv[c] - d)
    return ev


def _nearest_index(px, pxs, u0, u1, lof, hif, levels: int, signed: bool):
    """Projection on the endpoint line, then the best of the 3 nearest
    indices by the linearised error."""
    dd = [hif[c] - lof[c] for c in range(3)]
    denom = _csum([d * d for d in dd]) + 1e-6
    t = torch.clamp(_csum([(px[c] - lof[c]) * dd[c] for c in range(3)]) / denom, 0.0, 1.0)
    k = torch.clamp(torch.round(t * (levels - 1)), 0, levels - 1).to(torch.int32)
    best_i = best_e = None
    for dk in (-1, 0, 1):
        kk = torch.clamp(k + dk, 0, levels - 1)
        dec = _decoded(u0, u1, _w64(kk, levels), signed)
        e = torch.zeros_like(px[0])
        for c in range(3):
            x = (px[c] - dec[c]) * pxs[c]
            e = e + x * x
        if best_i is None:
            best_i, best_e = kk, e
        else:
            take = e < best_e
            best_i = torch.where(take, kk, best_i)
            best_e = torch.minimum(e, best_e)
    return best_i


def _assign_full(px, pxv, pxs, q0, q1, bits: int, signed: bool, code: bool):
    """16-level index per texel and the exact block error
    (``bc6h_pallas.py:_assign_full``).  -> (idx [16,N], err [N])."""
    u0 = [_unquant(q0[c], bits, signed) for c in range(3)]
    u1 = [_unquant(q1[c], bits, signed) for c in range(3)]
    lof = [_finalize(u, signed).to(torch.float32) for u in u0]
    hif = [_finalize(u, signed).to(torch.float32) for u in u1]
    idx = _nearest_index(px, pxs, u0, u1, lof, hif, 16, signed)
    dec = _decoded(u0, u1, _w64(idx, 16), signed)
    return idx, _rt(_exact_error(pxv, dec, code))


def _pca_seed(px, mask):
    """Principal-axis extremes of the masked texels; power iteration from
    (1,1,1) (``bc6h_pallas.py:_pca_seed``).  -> (hi, lo)."""
    cnt = _rt(mask) + 1e-6
    mean = [_rt(px[c] * mask) / cnt for c in range(3)]
    cent = [(px[c] - mean[c]) * mask for c in range(3)]
    cov = [[_rt(cent[c] * cent[d]) for d in range(3)] for c in range(3)]
    v = [torch.ones_like(mean[0]) for _ in range(3)]
    for _ in range(3):
        nv = [_csum([cov[c][d] * v[d] for d in range(3)]) for c in range(3)]
        nn = torch.sqrt(_csum([x * x for x in nv]))
        v = [torch.where(nn > 1e-10, nv[c] / (nn + 1e-20), v[c]) for c in range(3)]
    t = _csum([cent[c] * v[c] for c in range(3)])
    member = mask > 0
    tmax = torch.where(member, t, -1e30).max(dim=0).values
    tmin = torch.where(member, t, 1e30).min(dim=0).values
    hi = [mean[c] + v[c] * tmax for c in range(3)]
    lo = [mean[c] + v[c] * tmin for c in range(3)]
    return hi, lo


def _ls(px, w, mask):
    """Least-squares endpoints for fixed weights w [16,N].  -> (e1, e0)."""
    wv = w * mask
    uv = (1.0 - w) * mask
    a11 = _rt(wv * w)
    a12 = _rt(wv * (1.0 - w))
    a22 = _rt(uv * (1.0 - w))
    b1 = [_rt(wv * px[c]) for c in range(3)]
    b0 = [_rt(uv * px[c]) for c in range(3)]
    det = a11 * a22 - a12 * a12
    ok = torch.abs(det) > 1e-6
    safe = torch.where(ok, det, 1.0)
    cnt = _rt(mask) + 1e-6
    mean = [_rt(px[c] * mask) / cnt for c in range(3)]
    e1 = [torch.where(ok, (a22 * b1[c] - a12 * b0[c]) / safe, mean[c]) for c in range(3)]
    e0 = [torch.where(ok, (a11 * b0[c] - a12 * b1[c]) / safe, mean[c]) for c in range(3)]
    return e1, e0


# ---------------------------------------------------------------------------
# One-region modes 11 / 12
# ---------------------------------------------------------------------------


def _fit_mode(px, pxv, pxs, bits, signed, iters, delta_bits=0, code=False):
    """Seed, quantise, assign, LS-refine for mode 11 (bits 10) or 12
    (bits 11, 9-bit delta).  -> (q0, q1, idx, err)."""
    ones = torch.ones_like(px[0])
    w4 = torch.tensor([float(w) / 64.0 for w in WEIGHTS4], device=px[0].device)

    def candidate(e0, e1):
        q0 = _quant_candidates(e0, bits, signed)
        q1 = _quant_candidates(e1, bits, signed)
        if delta_bits:
            half = 1 << (delta_bits - 1)
            q1 = [q0[c] + torch.clamp(q1[c] - q0[c], -half, half - 1) for c in range(3)]
        idx, err = _assign_full(px, pxv, pxs, q0, q1, bits, signed, code)
        return q0, q1, idx, err

    hi, lo = _pca_seed(px, ones)
    best = candidate(hi, lo)
    for _ in range(iters):
        e1f, e0f = _ls(px, w4[best[2].long()], ones)
        cand = candidate(e0f, e1f)
        take = cand[3] < best[3]
        best = (
            _sel(take, cand[0], best[0]),
            _sel(take, cand[1], best[1]),
            torch.where(take, cand[2], best[2]),
            torch.minimum(cand[3], best[3]),
        )
    return best


def _anchor_swap(q0, q1, idx):
    swap = idx[0] >= 8
    return _sel(swap, q1, q0), _sel(swap, q0, q1), torch.where(swap, 15 - idx, idx)


def _pack_indices4(pk, idx):
    """16 4-bit indices; the anchor (texel 0) stores 3 bits."""
    pk.put(idx[0], 3)
    for i in range(1, 16):
        pk.put(idx[i], 4)


def _pack_mode11(q0, q1, idx):
    q0, q1, idx = _anchor_swap(q0, q1, idx)
    pk = _Packer(q0[0].shape[0], q0[0].device)
    pk.put(torch.full_like(q0[0], 0x03), 5)
    for c in range(3):
        pk.put(q0[c], 10)
    for c in range(3):
        pk.put(q1[c], 10)
    _pack_indices4(pk, idx)
    return pk.words


def _pack_mode12(q0, q1, idx):
    q0, q1, idx = _anchor_swap(q0, q1, idx)
    pk = _Packer(q0[0].shape[0], q0[0].device)
    pk.put(torch.full_like(q0[0], 0x07), 5)
    for c in range(3):
        pk.put(q0[c], 10)
    for c in range(3):
        pk.put(torch.clamp(q1[c] - q0[c], -256, 255), 9)
        pk.put((q0[c] >> 10) & 1, 1)
    _pack_indices4(pk, idx)
    return pk.words


# ---------------------------------------------------------------------------
# Two-region modes
# ---------------------------------------------------------------------------


def _screen2(px, part32, k: int):
    """The k lowest within-cluster SSEs of the 32 BPTC partitions, best
    first, ties to the lowest partition (``bc6h_pallas.py:_screen2``)."""
    ns = part32.sum(dim=1, keepdim=True)  # [32,1], exact
    s1 = [_masked_sums(part32, px[c]) for c in range(3)]
    sq_all = _rt(_csum([px[c] * px[c] for c in range(3)]))
    s_all = [_rt(px[c]) for c in range(3)]
    n1 = ns + 1e-6
    n0 = (16.0 - ns) + 1e-6
    explained = _csum([s1[c] * s1[c] for c in range(3)]) / n1 + _csum(
        [(s_all[c] - s1[c]) * (s_all[c] - s1[c]) for c in range(3)]
    ) / n0
    work = sq_all - explained
    iota = torch.arange(32, device=px[0].device)[:, None]
    ds = []
    for _ in range(max(1, k)):
        d = torch.argmax((work == work.min(dim=0).values).to(torch.uint8), dim=0)
        ds.append(d.to(torch.int32))
        work = torch.where(iota == d, 3.0e38, work)
    return ds


def _fit_regions_float(px, pxs, masks, anchor_oh, iters: int):
    """Shared float endpoints per region, refined by alternating LS and
    kept by the continuous line-fit SSE; each region oriented so that its
    anchor texel is nearer e0 (``bc6h_pallas.py:_fit_regions_float``).
    -> (e0 per region, e1 per region, sse [N])."""
    e0s, e1s = [], []
    for m in masks:
        hi, lo = _pca_seed(px, m)
        e0s.append(lo)
        e1s.append(hi)

    def texel_w(e0s, e1s):
        e0t = [e0s[0][c] * masks[0] + e0s[1][c] * masks[1] for c in range(3)]
        e1t = [e1s[0][c] * masks[0] + e1s[1][c] * masks[1] for c in range(3)]
        dd = [e1t[c] - e0t[c] for c in range(3)]
        denom = _csum([d * d for d in dd]) + 1e-6
        w = torch.clamp(
            _csum([(px[c] - e0t[c]) * dd[c] for c in range(3)]) / denom, 0.0, 1.0
        )
        return w, e0t, dd

    def cont_sse(w, e0t, dd):
        terms = []
        for c in range(3):
            x = (e0t[c] + w * dd[c] - px[c]) * pxs[c]
            terms.append(x * x)
        return _rt(_csum(terms))

    w, e0t, dd = texel_w(e0s, e1s)
    best_e0 = [list(e0s[p]) for p in range(2)]
    best_e1 = [list(e1s[p]) for p in range(2)]
    best_sse = cont_sse(w, e0t, dd)
    for _ in range(max(0, iters - 1)):
        for p in range(2):
            e1s[p], e0s[p] = _ls(px, w, masks[p])
        w, e0t, dd = texel_w(e0s, e1s)
        sse = cont_sse(w, e0t, dd)
        take = sse < best_sse
        for p in range(2):
            best_e0[p] = _sel(take, e0s[p], best_e0[p])
            best_e1[p] = _sel(take, e1s[p], best_e1[p])
        best_sse = torch.minimum(sse, best_sse)
    out0, out1 = [], []
    for p in range(2):
        if p == 0:
            a_t = [px[c][0] for c in range(3)]
        else:
            a_t = [_rt(px[c] * anchor_oh) for c in range(3)]
        x0 = [a_t[c] - best_e0[p][c] for c in range(3)]
        x1 = [a_t[c] - best_e1[p][c] for c in range(3)]
        d0 = _csum([x * x for x in x0])
        d1 = _csum([x * x for x in x1])
        flip = d1 < d0
        out0.append(_sel(flip, best_e1[p], best_e0[p]))
        out1.append(_sel(flip, best_e0[p], best_e1[p]))
    return out0, out1, best_sse


def _fit_two_region(px, pxv, pxs, masks, anchor_oh, e0, e1, mode_id, signed, code):
    """Quantise the region endpoints for one two-region mode, index every
    texel (3 bits, 2 at the anchors) and measure the exact error.
    -> (fields, idx [16,N], err [N])."""
    _, _, epbits, dbits, direct = TWO_REGION_MODES[mode_id]
    q0 = [_quant_candidates(e0[p], epbits, signed) for p in range(2)]
    q1 = [_quant_candidates(e1[p], epbits, signed) for p in range(2)]
    rw = q0[0]
    fields = {"rw": rw}
    effs = []
    for name, val in (("rx", q1[0]), ("ry", q0[1]), ("rz", q1[1])):
        if direct:
            fields[name] = val
            effs.append(val)
        else:
            dlt = [
                torch.clamp(val[c] - rw[c], -(1 << (dbits[c] - 1)), (1 << (dbits[c] - 1)) - 1)
                for c in range(3)
            ]
            fields[name] = dlt
            effs.append([rw[c] + dlt[c] for c in range(3)])
    v01, v10, v11 = effs

    sel1 = masks[1] > 0.5
    u0 = [torch.where(sel1, _unquant(v10[c], epbits, signed), _unquant(rw[c], epbits, signed))
          for c in range(3)]
    u1 = [torch.where(sel1, _unquant(v11[c], epbits, signed), _unquant(v01[c], epbits, signed))
          for c in range(3)]
    lof = [_finalize(u, signed).to(torch.float32) for u in u0]
    hif = [_finalize(u, signed).to(torch.float32) for u in u1]
    best_i = _nearest_index(px, pxs, u0, u1, lof, hif, 8, signed)
    # Anchor texels clamp their 3-bit index to the 2-bit range; the error
    # is that of the clamped indices.
    iota16 = torch.arange(16, device=px[0].device)[:, None]
    is_anchor = (iota16 == 0) | (anchor_oh > 0.5)
    idx = torch.where(is_anchor, torch.clamp(best_i, max=3), best_i)
    dec = _decoded(u0, u1, _w64(idx, 8), signed)
    return fields, idx, _rt(_exact_error(pxv, dec, code))


def _pack_two_region(mode_id, fields, d, idx, anchor1):
    mv = TWO_REGION_MODES[mode_id][0]
    pk = _Packer(d.shape[0], d.device)
    words = pk.words
    words[0] = words[0] | mv
    for block_bit, field, field_bit, ch in TWO_REGION_LAYOUT[mode_id]:
        bit = (fields[field][ch].to(torch.int64) >> field_bit) & 1
        w, bo = divmod(block_bit, 32)
        words[w] = words[w] | (bit << bo)
    dv = d.to(torch.int64)
    for i in range(5):
        w, bo = divmod(77 + i, 32)
        words[w] = words[w] | (((dv >> i) & 1) << bo)
    # 3-bit indices from bit 82; the anchors (texel 0 and anchor1) 2-bit.
    iota16 = torch.arange(16, device=d.device)[:, None]
    bits = 3 - (iota16 == 0).to(torch.int32) - (iota16 == anchor1).to(torch.int32)
    pos = torch.full_like(d, 82, dtype=torch.int32)
    for i in range(16):
        pk.put_dynamic(idx[i], pos, 3)
        pos = pos + bits[i]
    return pk.words


# ---------------------------------------------------------------------------
# The kernel's body and the encoder
# ---------------------------------------------------------------------------


def _encode(px, quality: int, signed: bool, metric: str, part32, anchors32):
    """``bc6h_pallas.py:_kernel`` on proxy channels px (3 x [16,N])."""
    code = metric == "code"
    if code:
        pxv = px
        pxs = [torch.ones_like(px[c]) for c in range(3)]
    else:
        pxv = [_proxy_to_value(px[c]) for c in range(3)]
        pxs = [_proxy_scale(px[c]) for c in range(3)]
    iters = _BC6H_ITERS[quality]

    q0, q1, idx, err = _fit_mode(px, pxv, pxs, 10, signed, iters, code=code)
    words = _pack_mode11(q0, q1, idx)
    if quality >= 2:
        q0, q1, idx, e12 = _fit_mode(px, pxv, pxs, 11, signed, iters, delta_bits=9, code=code)
        words, err = _take(words, err, _pack_mode12(q0, q1, idx), e12)

    mode_ids = _TWO_REGION_PLAN[quality]
    if not mode_ids:
        return words
    iota16 = torch.arange(16, device=px[0].device)[:, None]

    def geometry(dk):
        m1 = part32[dk.long()].T  # [16,N]
        anchor1 = anchors32[dk.long()]
        return m1, anchor1, (iota16 == anchor1).to(torch.float32)

    k2 = _PART_SEEDS[quality]
    cands = _screen2(px, part32, k2)
    d = cands[0]
    cand_ds = [d]
    if k2 > 1:
        # Rank the screened partitions by a shallow (2-iteration) float
        # fit; fit the winner with every mode and the screen's first with
        # the q2 modes, so that the quality ladder stays monotone.
        dwin, fit_sse = d, None
        for dk in cands:
            m1, _, aoh = geometry(dk)
            _, _, sse = _fit_regions_float(px, pxs, (1.0 - m1, m1), aoh, 2)
            if fit_sse is None:
                fit_sse = sse
            else:
                dwin = torch.where(sse < fit_sse, dk, dwin)
                fit_sse = torch.minimum(fit_sse, sse)
        cand_ds = [dwin, d]
    for gi, dk in enumerate(cand_ds):
        gmodes = mode_ids if gi == 0 else _TWO_REGION_PLAN[2]
        m1, anchor1, aoh = geometry(dk)
        masks = (1.0 - m1, m1)
        e0, e1, _ = _fit_regions_float(px, pxs, masks, aoh, iters)
        for mode_id in gmodes:
            fields, idx2, err2 = _fit_two_region(
                px, pxv, pxs, masks, aoh, e0, e1, mode_id, signed, code
            )
            words, err = _take(
                words, err, _pack_two_region(mode_id, fields, dk, idx2, anchor1), err2
            )
    return words


_TABLES: dict = {}


def _partition_tables(device):
    """The first 32 rows of the 2-subset partition and anchor tables (the
    BPTC partitions BC6H uses), on ``device``."""
    key = str(device)
    t = _TABLES.get(key)
    if t is None:
        t = (
            torch.tensor(PARTITION2[:32], dtype=torch.float32, device=device),
            torch.tensor(ANCHOR2[:32], dtype=torch.int32, device=device),
        )
        _TABLES[key] = t
    return t


def encode_bc6h_plain(
    blocks: torch.Tensor, quality: int, signed: bool, metric: str = "value"
) -> torch.Tensor:
    """Plain PyTorch version: [N,16,3] float32 RGB -> [N,4] uint32."""
    if blocks.shape[0] == 0:
        return torch.empty((0, 4), dtype=torch.uint32, device=blocks.device)
    proxy = _to_proxy(blocks[..., :3], signed).permute(2, 1, 0)  # [3,16,N]
    px = [proxy[c].contiguous() for c in range(3)]
    words = _encode(px, quality, signed, metric, *_partition_tables(blocks.device))
    return torch.stack(words, dim=1).to(torch.uint32)


def _check(quality, metric) -> int:
    quality = int(quality)
    if not 0 <= quality <= 4:
        raise ValueError(f"BC6H quality must be 0-4, got {quality}")
    if metric not in _METRICS:
        raise ValueError(f"BC6H metric must be one of {_METRICS}, got {metric!r}")
    return quality


def encode_bc6h(
    blocks: torch.Tensor, quality: int = 2, signed: bool = False, metric: str = "value"
) -> torch.Tensor:
    """Encode [N,16,3] float RGB (HDR) blocks to BC6H [N,4] uint32 words.

    The counterpart of ``cuttlefish_tpu/kernels/bc6h.py:encode_bc6h``
    (metric "value": linear value-domain selection; "code": half-bit
    code-domain selection).  A CPU tensor runs the plain version; a CUDA
    tensor launches the hand kernel (``kernels/bc6h_cuda.py``) and raises
    if that fails.
    """
    quality = _check(quality, str(metric))
    signed = bool(signed)
    if blocks.device.type == "cpu":
        return encode_bc6h_plain(blocks, quality, signed, str(metric))
    if blocks.device.type == "cuda":
        from cuttlefish_tpu_torch.kernels import bc6h_cuda

        return bc6h_cuda.encode_bc6h_cuda(blocks, quality, signed, str(metric))
    raise ValueError(f"unsupported device {blocks.device}")


def layout_table() -> tuple[np.ndarray, np.ndarray]:
    """The two-region modes as the hand kernel's constant tables.

    Returns (modes [10,6] int32: mode bits, endpoint bits, delta bits r/g/b,
    direct; layout [10,76] int32: block_bit | field << 8 | field_bit << 12 |
    channel << 16, unused entries -1), mode id m at row m-1.
    """
    fields = {"rw": 0, "rx": 1, "ry": 2, "rz": 3}
    modes = np.zeros((10, 6), np.int32)
    layout = np.full((10, 76), -1, np.int32)
    for m in range(1, 11):
        mv, _, epbits, dbits, direct = TWO_REGION_MODES[m]
        modes[m - 1] = (mv, epbits, *dbits, int(direct))
        for i, (block_bit, field, field_bit, ch) in enumerate(TWO_REGION_LAYOUT[m]):
            layout[m - 1, i] = block_bit | fields[field] << 8 | field_bit << 12 | ch << 16
    return modes, layout
