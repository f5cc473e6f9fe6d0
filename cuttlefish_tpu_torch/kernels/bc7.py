"""BC7 block encoder, quality 0-2: plain PyTorch version and dispatch.

The plain version computes what the TPU kernel
``cuttlefish_tpu/kernels/bc7_pallas.py:_kernel`` computes: modes 6 -> 1 ->
5 -> 4 (mode 1 from quality 1, modes 5 and 4 from quality 2), each a PCA
seed, least-squares refinement and the exact integer-decode error, keeping
the lowest error.  Layout follows that kernel: each channel is a
``[16, N]`` tensor (texels x blocks), per-block values are ``[N]``.

Every reduction over the 16 texels runs in texel order, one add at a time,
as the hand kernel (``csrc/bc7_encode.cu``) sums them: the two agree bit
for bit apart from rounding inside the device's own operations.  The
64-partition screen of mode 1 is an exact masked sum over the same moments
(the TPU kernel used matmuls against the 0/1 membership matrix).

``encode_bc7`` runs this plain version for a CPU tensor and the hand kernel
for a CUDA tensor; it never falls back from one to the other.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cuttlefish_tpu_torch.kernels import bc7_tables as T

_PERCEPTUAL = (0.55, 1.1, 0.35, 1.0)
_UNIFORM = (1.0, 1.0, 1.0, 1.0)
_ITERS = {0: 1, 1: 2, 2: 2}
_U32_MASK = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class Bc7Constants:
    """The operands the TPU kernel's wrapper fed its ``pallas_call``
    (``bc7_pallas.py:1178-1192``), in the port's two forms.

    part2/anchor2 are device tensors for the plain version; masks (one
    uint16 per partition, bit t set when texel t is in subset 1) and
    anchors are the hand kernel's constant-memory form; chw are the four
    float32 channel weights.
    """

    part2: torch.Tensor  # [64,16] float32 0/1
    anchor2: torch.Tensor  # [64] int32
    masks: np.ndarray  # [64] uint16
    anchors: np.ndarray  # [64] int32
    chw: tuple


def bc7_constants(partition2, anchor2, chw, device) -> Bc7Constants:
    """Turn the reference's numpy operands into the port's state."""
    p2 = np.asarray(partition2)
    bits = (p2.astype(np.uint32) & 1) << np.arange(16, dtype=np.uint32)
    masks = bits.sum(axis=1).astype(np.uint16)
    anchors = np.asarray(anchor2, np.int32)
    return Bc7Constants(
        part2=torch.tensor(p2, dtype=torch.float32, device=device),
        anchor2=torch.tensor(anchors, dtype=torch.int32, device=device),
        masks=masks,
        anchors=anchors,
        chw=tuple(float(np.float32(w)) for w in chw),
    )


def channel_weights(perceptual: bool) -> tuple:
    return _PERCEPTUAL if perceptual else _UNIFORM


# ---------------------------------------------------------------------------
# Per-batch primitives: texel tensors [16,N], per-block tensors [N]
# ---------------------------------------------------------------------------


def _rt(x):
    """Sum over the texel axis in texel order: [16,N] -> [N]."""
    acc = x[0]
    for t in range(1, x.shape[0]):
        acc = acc + x[t]
    return acc


def _csum(terms):
    """Left-to-right sum of a channel list."""
    acc = terms[0]
    for x in terms[1:]:
        acc = acc + x
    return acc


def _w64(kk, levels: int):
    """BC7 weight round(k*64/(L-1)) as the f32 floor of an odd quotient."""
    num = (kk * 128 + (levels - 1)).to(torch.float32)
    return torch.floor(num * (1.0 / (2 * (levels - 1)))).to(torch.int32)


def _replicate(v, bits: int):
    if bits == 8:
        return v
    return (v << (8 - bits)) | (v >> (2 * bits - 8))


def _sel(take, a, b):
    if isinstance(a, (list, tuple)):
        return [torch.where(take, x, y) for x, y in zip(a, b)]
    return torch.where(take, a, b)


def _qround(x, maxv: int):
    return torch.clamp(torch.round(x), 0, maxv).to(torch.int32)


def _pca_seed(px, mask, chn=3):
    """Principal-axis extremes of the masked texel set
    (``bc7_pallas.py:_pca_seed``).  Returns (hi, lo, axis, mean)."""
    cnt = _rt(mask) + 1e-6
    mean = [_rt(px[c] * mask) / cnt for c in range(chn)]
    cent = [(px[c] - mean[c]) * mask for c in range(chn)]
    cov = [[_rt(cent[c] * cent[d]) for d in range(chn)] for c in range(chn)]
    norms = _csum([cent[c] * cent[c] for c in range(chn)])
    # First texel at the maximum norm (ties pick the lowest texel).
    fidx = torch.argmax(
        (norms == norms.max(dim=0).values).to(torch.uint8), dim=0
    )
    start = [cent[c].gather(0, fidx[None])[0] for c in range(chn)]
    n0 = torch.sqrt(_csum([s * s for s in start]))
    v = [
        torch.where(n0 > 1e-10, s / (n0 + 1e-20), torch.ones_like(s))
        for s in start
    ]
    for _ in range(4):
        nv = [_csum([cov[c][d] * v[d] for d in range(chn)]) for c in range(chn)]
        nn = torch.sqrt(_csum([x * x for x in nv]))
        v = [
            torch.where(nn > 1e-10, nv[c] / (nn + 1e-20), v[c])
            for c in range(chn)
        ]
    t = _csum([cent[c] * v[c] for c in range(chn)])
    member = mask > 0
    tmax = torch.where(member, t, -1e30).max(dim=0).values
    tmin = torch.where(member, t, 1e30).min(dim=0).values
    hi = [mean[c] + v[c] * tmax for c in range(chn)]
    lo = [mean[c] + v[c] * tmin for c in range(chn)]
    return hi, lo, v, mean


def _quant_pbit_each(e, bits: int, chw):
    """Per-endpoint p-bit quantisation -> (v, p, dec)."""
    maxv = (1 << bits) - 1
    full = (1 << (bits + 1)) - 1
    best = None
    for p in (0, 1):
        v = [_qround((ec * (full / 255.0) - p) * 0.5, maxv) for ec in e]
        dec = [_replicate((vc << 1) | p, bits + 1) for vc in v]
        err = _csum(
            [chw[c] * _sq(e[c] - dec[c].to(torch.float32)) for c in range(len(e))]
        )
        pv = torch.full_like(v[0], p)
        if best is None:
            best = (v, pv, dec, err)
        else:
            take = err < best[3]
            best = (
                _sel(take, v, best[0]),
                _sel(take, pv, best[1]),
                _sel(take, dec, best[2]),
                torch.minimum(err, best[3]),
            )
    return best[0], best[1], best[2]


def _quant_pbit_shared(e0, e1, bits: int, chw):
    """One p-bit shared by both endpoints (mode 1) -> (v0, v1, p, d0, d1)."""
    maxv = (1 << bits) - 1
    full = (1 << (bits + 1)) - 1
    best = None
    for p in (0, 1):
        v0 = [_qround((ec * (full / 255.0) - p) * 0.5, maxv) for ec in e0]
        v1 = [_qround((ec * (full / 255.0) - p) * 0.5, maxv) for ec in e1]
        d0 = [_replicate((v << 1) | p, bits + 1) for v in v0]
        d1 = [_replicate((v << 1) | p, bits + 1) for v in v1]
        err = _csum(
            [
                chw[c]
                * (
                    _sq(e0[c] - d0[c].to(torch.float32))
                    + _sq(e1[c] - d1[c].to(torch.float32))
                )
                for c in range(len(e0))
            ]
        )
        pv = torch.full_like(v0[0], p)
        if best is None:
            best = (v0, v1, pv, d0, d1, err)
        else:
            take = err < best[5]
            best = (
                _sel(take, v0, best[0]),
                _sel(take, v1, best[1]),
                _sel(take, pv, best[2]),
                _sel(take, d0, best[3]),
                _sel(take, d1, best[4]),
                torch.minimum(err, best[5]),
            )
    return best[:5]


def _quant_plain(e, bits: int):
    maxv = (1 << bits) - 1
    v = [_qround(ec * (maxv / 255.0), maxv) for ec in e]
    return v, [_replicate(vc, bits) for vc in v]


def _sq(x):
    return x * x


def _assign(px, d0, d1, levels: int, mask, chw):
    """Nearest palette index by line projection plus a 3-candidate exact
    check.  Returns (idx [16,N] int32, masked block error [N])."""
    chn = len(d0)
    df = [(d1[c] - d0[c]).to(torch.float32) for c in range(chn)]
    cw = _csum([chw[c] * df[c] * df[c] for c in range(chn)])
    b = _csum(
        [chw[c] * (px[c] - d0[c].to(torch.float32)) * df[c] for c in range(chn)]
    )
    t = b / (cw + 1e-10)
    k = _qround(t * (levels - 1), levels - 1)
    best_idx = None
    best_e = None
    for dk in (-1, 0, 1):
        kk = torch.clamp(k + dk, 0, levels - 1)
        w = _w64(kk, levels)
        e = _csum(
            [
                chw[c]
                * _sq(
                    px[c]
                    - ((d0[c] * (64 - w) + d1[c] * w + 32) >> 6).to(torch.float32)
                )
                for c in range(chn)
            ]
        )
        if best_e is None:
            best_idx, best_e = kk, e
        else:
            take = e < best_e
            best_idx = torch.where(take, kk, best_idx)
            best_e = torch.where(take, e, best_e)
    return best_idx, _rt(best_e * mask)


def _ls(px, w, mask, chn):
    """Least-squares endpoints for fixed weights w [16,N] in [0,1].
    Returns (e_w1, e_w0)."""
    wv = w * mask
    uv = (1.0 - w) * mask
    a11 = _rt(wv * w)
    a12 = _rt(wv * (1.0 - w))
    a22 = _rt(uv * (1.0 - w))
    b0 = [_rt(wv * px[c]) for c in range(chn)]
    b1 = [_rt(uv * px[c]) for c in range(chn)]
    det = a11 * a22 - a12 * a12
    ok = torch.abs(det) > 1e-8
    safe = torch.where(ok, det, 1.0)
    cnt = _rt(mask) + 1e-12
    mean = [_rt(px[c] * mask) / cnt for c in range(chn)]
    ew1 = [
        torch.where(ok, (a22 * b0[c] - a12 * b1[c]) / safe, mean[c])
        for c in range(chn)
    ]
    ew0 = [
        torch.where(ok, (a11 * b1[c] - a12 * b0[c]) / safe, mean[c])
        for c in range(chn)
    ]
    return ew1, ew0


def _fit(px, mask, levels: int, quant, iters: int, chw, seed):
    """Seed -> quantise -> assign -> LS refine.  quant(e0, e1) returns a
    state tuple ending in (d0, d1).  Returns (state, idx, err)."""
    hi, lo = seed
    chn = len(hi)

    def candidate(e0, e1):
        st = quant(e0, e1)
        idx, err = _assign(px, st[-2], st[-1], levels, mask, chw)
        return st, idx, err

    best = candidate(hi, lo)
    for _ in range(iters):
        w = _w64(best[1], levels).to(torch.float32) * (1.0 / 64.0)
        ew1, ew0 = _ls(px, w, mask, chn)
        st, idx, err = candidate(ew0, ew1)
        take = err < best[2]
        best = (
            tuple(_sel(take, a, b) for a, b in zip(st, best[0])),
            torch.where(take, idx, best[1]),
            torch.where(take, err, best[2]),
        )
    return best


class _Packer:
    """Bit packer into four 32-bit words held as int64 [N] tensors."""

    def __init__(self, n: int, device):
        self.words = [
            torch.zeros(n, dtype=torch.int64, device=device) for _ in range(4)
        ]
        self.pos = 0

    def put(self, value, nbits: int):
        v = value.to(torch.int64) & ((1 << nbits) - 1)
        w, b = divmod(self.pos, 32)
        self.words[w] = self.words[w] | ((v << b) & _U32_MASK)
        if b + nbits > 32:
            self.words[w + 1] = self.words[w + 1] | (v >> (32 - b))
        self.pos += nbits

    def put_dynamic(self, value, pos, maxbits: int):
        """Put at a per-block bit position pos [N] (mode-1 indices)."""
        v = value.to(torch.int64) & ((1 << maxbits) - 1)
        for w in range(4):
            rel = (pos - 32 * w).to(torch.int64)
            part = torch.where(
                rel >= 0,
                (v << rel.clamp(0, 31)) & _U32_MASK,
                v >> (-rel).clamp(0, 31),
            )
            valid = (rel > -maxbits) & (rel < 32)
            self.words[w] = self.words[w] | torch.where(valid, part, 0)


# ---------------------------------------------------------------------------
# Modes
# ---------------------------------------------------------------------------


def _mode6(px, iters: int, chw):
    ones = torch.ones_like(px[0])
    hi, lo, _, _ = _pca_seed(px, ones, chn=4)

    def quant(e0, e1):
        v0, p0, d0 = _quant_pbit_each(e0, 7, chw)
        v1, p1, d1 = _quant_pbit_each(e1, 7, chw)
        return (v0, v1, p0, p1, d0, d1)

    (v0, v1, p0, p1, _, _), idx, err = _fit(
        px, ones, 16, quant, iters, chw, (hi, lo)
    )
    swap = idx[0] >= 8
    v0, v1 = _sel(swap, v1, v0), _sel(swap, v0, v1)
    p0, p1 = _sel(swap, p1, p0), _sel(swap, p0, p1)
    idx = torch.where(swap, 15 - idx, idx)

    pk = _Packer(p0.shape[0], p0.device)
    pk.put(torch.full_like(p0, 64), 7)
    for c in range(4):
        pk.put(v0[c], 7)
        pk.put(v1[c], 7)
    pk.put(p0, 1)
    pk.put(p1, 1)
    pk.put(idx[0], 3)
    for i in range(1, 16):
        pk.put(idx[i], 4)
    return pk.words, err


def _masked_sums(part2, x):
    """[64,16] 0/1 membership x [16,N] -> [64,N], summed in texel order."""
    acc = part2[:, 0:1] * x[0]
    for t in range(1, 16):
        acc = acc + part2[:, t : t + 1] * x[t]
    return acc


def _mode1(px, iters: int, chw, part2, anchor2):
    """Mode 1: 64-partition screen, then the top-1 partition's fit."""
    cw = (chw[0], chw[1], chw[2], 0.0)
    ones = torch.ones_like(px[0])
    _, _, axis, mean = _pca_seed(px, ones, chn=3)
    cent = [px[c] - mean[c] for c in range(3)]
    proj = _csum([cent[c] * axis[c] for c in range(3)])
    w2 = _csum([cw[c] * px[c] * px[c] for c in range(3)])

    ns = part2.sum(dim=1, keepdim=True)  # [64,1], exact
    s1 = [_masked_sums(part2, px[c]) for c in range(3)]
    tot = _masked_sums(part2, w2)
    pssum = _masked_sums(part2, proj)
    ps2 = _masked_sums(part2, proj * proj)
    tot_all = _rt(w2)
    s1_all = [_rt(px[c]) for c in range(3)]
    ps_all = _rt(proj)
    ps2_all = _rt(proj * proj)

    def sub_err(tot_s, s1_s, pss, ps2_s, ns_s):
        mean_term = _csum([cw[c] * s1_s[c] * s1_s[c] for c in range(3)]) / ns_s
        along = ps2_s - pss * pss / ns_s
        return tot_s - mean_term - torch.clamp(along, min=0.0)

    score = sub_err(tot, s1, pssum, ps2, ns + 1e-6) + sub_err(
        tot_all - tot,
        [s1_all[c] - s1[c] for c in range(3)],
        ps_all - pssum,
        ps2_all - ps2,
        (16.0 - ns) + 1e-6,
    )  # [64,N]
    # First partition at the minimum score.
    part = torch.argmax(
        (score == score.min(dim=0).values).to(torch.uint8), dim=0
    ).to(torch.int32)
    m1 = part2[part.long()].T  # [16,N] membership of subset 1
    anchor1 = anchor2[part.long()]

    def seed_of(m):
        cnt = _rt(m) + 1e-6
        mean_s = [_rt(px[c] * m) / cnt for c in range(3)]
        ts = _csum([(px[c] - mean_s[c]) * axis[c] for c in range(3)])
        member = m > 0
        tmax = torch.where(member, ts, -1e30).max(dim=0).values
        tmin = torch.where(member, ts, 1e30).min(dim=0).values
        hi = [mean_s[c] + axis[c] * tmax for c in range(3)]
        lo = [mean_s[c] + axis[c] * tmin for c in range(3)]
        return hi, lo

    def quant(e0, e1):
        return _quant_pbit_shared(e0, e1, 6, cw)

    px3 = px[:3]
    m0 = 1.0 - m1
    st0, idx0, err0 = _fit(px3, m0, 8, quant, iters, cw[:3], seed_of(m0))
    st1, idx1, err1 = _fit(px3, m1, 8, quant, iters, cw[:3], seed_of(m1))
    alpha_pen = _rt(chw[3] * _sq(px[3] - 255.0))
    err = err0 + err1 + alpha_pen

    sel1 = m1 > 0
    idx = torch.where(sel1, idx1, idx0)
    (v00, v01, pb0, _, _) = st0
    (v10, v11, pb1, _, _) = st1

    swap0 = idx[0] >= 4
    idx = torch.where(swap0 & ~sel1, 7 - idx, idx)
    iota16 = torch.arange(16, dtype=torch.int32, device=px[0].device)[:, None]
    is_a1 = iota16 == anchor1
    a1val = idx.gather(0, anchor1.long()[None])[0]
    swap1 = a1val >= 4
    idx = torch.where(swap1 & sel1, 7 - idx, idx)
    v00, v01 = _sel(swap0, v01, v00), _sel(swap0, v00, v01)
    v10, v11 = _sel(swap1, v11, v10), _sel(swap1, v10, v11)

    pk = _Packer(part.shape[0], part.device)
    pk.put(torch.full_like(part, 2), 2)
    pk.put(part, 6)
    for c in range(3):
        pk.put(v00[c], 6)
        pk.put(v01[c], 6)
        pk.put(v10[c], 6)
        pk.put(v11[c], 6)
    pk.put(pb0, 1)
    pk.put(pb1, 1)
    # Index bits: 3 each, minus 1 at texel 0 and at the subset-1 anchor.
    bits = 3 - (iota16 == 0).to(torch.int32) - is_a1.to(torch.int32)
    pos = torch.full_like(part, pk.pos)
    for i in range(16):
        pk.put_dynamic(idx[i], pos, 3)
        pos = pos + bits[i]
    return pk.words, err


def _fit_alpha(a, levels: int, qbits: int, iters: int):
    """Scalar alpha fit: a [16,N] -> (q0, q1, idx, err)."""
    ones = torch.ones_like(a)
    maxq = (1 << qbits) - 1

    def cand(e0, e1):
        q0 = _qround(e0 * (maxq / 255.0), maxq)
        q1 = _qround(e1 * (maxq / 255.0), maxq)
        d0, d1 = _replicate(q0, qbits), _replicate(q1, qbits)
        best_i = None
        best_e = None
        for k in range(levels):
            w = (k * 128 + levels - 1) // (2 * (levels - 1))  # as _w64
            pal = (d0 * (64 - w) + d1 * w + 32) >> 6
            e = _sq(a - pal.to(torch.float32))
            if best_e is None:
                best_i = torch.zeros_like(a, dtype=torch.int32)
                best_e = e
            else:
                take = e < best_e
                best_i = torch.where(take, k, best_i)
                best_e = torch.minimum(e, best_e)
        return q0, q1, best_i, _rt(best_e)

    best = cand(a.max(dim=0).values, a.min(dim=0).values)
    for _ in range(iters):
        w = _w64(best[2], levels).to(torch.float32) * (1.0 / 64.0)
        ew1, ew0 = _ls([a], w, ones, 1)
        c = cand(ew0[0], ew1[0])
        take = c[3] < best[3]
        best = tuple(torch.where(take, x, y) for x, y in zip(c, best))
    q0, q1, idx, err = best
    swap = idx[0] >= (levels // 2)
    q0, q1 = _sel(swap, q1, q0), _sel(swap, q0, q1)
    idx = torch.where(swap, (levels - 1) - idx, idx)
    return q0, q1, idx, err


def _mode5(px, iters: int, chw):
    cw = (chw[0], chw[1], chw[2])
    ones = torch.ones_like(px[0])
    hi, lo, _, _ = _pca_seed(px, ones, chn=3)

    def quant(e0, e1):
        v, d = _quant_plain(e0, 7)
        v1, d1 = _quant_plain(e1, 7)
        return (v, v1, d, d1)

    (v0, v1, _, _), cidx, cerr = _fit(px[:3], ones, 4, quant, iters, cw, (hi, lo))
    cswap = cidx[0] >= 2
    v0, v1 = _sel(cswap, v1, v0), _sel(cswap, v0, v1)
    cidx = torch.where(cswap, 3 - cidx, cidx)

    a0, a1, aidx, aerr = _fit_alpha(px[3], 4, 8, iters)
    err = cerr + chw[3] * aerr

    pk = _Packer(a0.shape[0], a0.device)
    pk.put(torch.full_like(a0, 32), 6)
    pk.put(torch.zeros_like(a0), 2)  # rotation 0
    for c in range(3):
        pk.put(v0[c], 7)
        pk.put(v1[c], 7)
    pk.put(a0, 8)
    pk.put(a1, 8)
    pk.put(cidx[0], 1)
    for i in range(1, 16):
        pk.put(cidx[i], 2)
    pk.put(aidx[0], 1)
    for i in range(1, 16):
        pk.put(aidx[i], 2)
    return pk.words, err


def _mode4(px, iters: int, chw):
    """Mode 4, rotation 0, index mode 0 only (2-bit colour, 3-bit alpha)."""
    cw = (chw[0], chw[1], chw[2])
    ones = torch.ones_like(px[0])
    hi, lo, _, _ = _pca_seed(px, ones, chn=3)

    def quant(e0, e1):
        v, d = _quant_plain(e0, 5)
        v1, d1 = _quant_plain(e1, 5)
        return (v, v1, d, d1)

    (v0, v1, _, _), cidx, cerr = _fit(px[:3], ones, 4, quant, iters, cw, (hi, lo))
    cswap = cidx[0] >= 2
    v0, v1 = _sel(cswap, v1, v0), _sel(cswap, v0, v1)
    cidx = torch.where(cswap, 3 - cidx, cidx)

    a0, a1, aidx, aerr = _fit_alpha(px[3], 8, 6, iters)
    err = cerr + chw[3] * aerr

    pk = _Packer(a0.shape[0], a0.device)
    pk.put(torch.full_like(a0, 16), 5)
    pk.put(torch.zeros_like(a0), 2)  # rotation 0
    pk.put(torch.zeros_like(a0), 1)  # index mode 0
    for c in range(3):
        pk.put(v0[c], 5)
        pk.put(v1[c], 5)
    pk.put(a0, 6)
    pk.put(a1, 6)
    pk.put(cidx[0], 1)
    for i in range(1, 16):
        pk.put(cidx[i], 2)
    pk.put(aidx[0], 2)
    for i in range(1, 16):
        pk.put(aidx[i], 3)
    return pk.words, err


def _take(words, err, cand_words, cand_err):
    take = cand_err < err
    return (
        [torch.where(take, a, b) for a, b in zip(cand_words, words)],
        torch.minimum(cand_err, err),
    )


def encode_bc7_plain(
    blocks: torch.Tensor, quality: int, consts: Bc7Constants
) -> torch.Tensor:
    """Plain PyTorch version: [N,16,4] float32 (0..1) -> [N,4] uint32."""
    if blocks.shape[0] == 0:
        return torch.empty((0, 4), dtype=torch.uint32, device=blocks.device)
    x = torch.clamp(blocks.to(torch.float32), 0.0, 1.0) * 255.0
    x = x.permute(2, 1, 0)  # [4,16,N]
    px = [x[c].contiguous() for c in range(4)]
    chw = consts.chw
    iters = _ITERS[quality]

    words, err = _mode6(px, iters, chw)
    if quality >= 1:
        words, err = _take(
            words, err, *_mode1(px, iters, chw, consts.part2, consts.anchor2)
        )
    if quality >= 2:
        words, err = _take(words, err, *_mode5(px, iters, chw))
        words, err = _take(words, err, *_mode4(px, iters, chw))
    return torch.stack(words, dim=1).to(torch.uint32)


_CONSTS: dict = {}


def _constants(perceptual: bool, device) -> Bc7Constants:
    key = (bool(perceptual), str(device))
    c = _CONSTS.get(key)
    if c is None:
        c = bc7_constants(
            T.PARTITION2, T.ANCHOR2, channel_weights(perceptual), device
        )
        _CONSTS[key] = c
    return c


def encode_bc7(
    blocks: torch.Tensor, quality: int = 2, perceptual: bool = False
) -> torch.Tensor:
    """Encode [N,16,4] float RGBA blocks (0..1) to BC7 [N,4] uint32 words.

    The counterpart of ``cuttlefish_tpu/kernels/bc7.py:encode_bc7``.  A CPU
    tensor runs the plain version; a CUDA tensor launches the hand kernel
    (``kernels/bc7_cuda.py``) and raises if that fails.
    """
    quality = int(quality)
    if quality in (3, 4):
        raise NotImplementedError(
            "BC7 quality 3-4 is not ported yet (ROADMAP queue 2, item 2)"
        )
    if quality not in _ITERS:
        raise ValueError(f"BC7 quality must be 0-4, got {quality}")
    consts = _constants(perceptual, blocks.device)
    if blocks.device.type == "cpu":
        return encode_bc7_plain(blocks, quality, consts)
    if blocks.device.type == "cuda":
        from cuttlefish_tpu_torch.kernels import bc7_cuda

        return bc7_cuda.encode_bc7_cuda(blocks, quality, consts)
    raise ValueError(f"unsupported device {blocks.device}")
