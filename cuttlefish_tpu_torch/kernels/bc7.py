"""BC7 block encoder, every quality: plain PyTorch version and dispatch.

Quality 0-2 computes what the TPU kernel
``cuttlefish_tpu/kernels/bc7_pallas.py:_kernel`` computes: modes 6 -> 1 ->
5 -> 4 (mode 1 from quality 1, modes 5 and 4 from quality 2), each a PCA
seed, least-squares refinement and the exact integer-decode error, keeping
the lowest error.  Quality 3-4 computes what ``_kernel_hq`` computes
(``_HQ_PLAN``): mode 6; modes 5 and 4 (both index modes) at rotation 0, or
at q4 at the better of the two rotations a PCA screen ranks first; modes
1/3/7 over their top-k 2-subset partitions and modes 0/2 over their top-k
3-subset partitions, each estimate-then-refine.  Layout follows the TPU
kernels: each channel is a ``[16, N]`` tensor (texels x blocks), per-block
values are ``[N]``.

Every reduction over the 16 texels runs in texel order, one add at a time,
as the hand kernels (``csrc/bc7_encode.cu``, ``csrc/bc7_hq_encode.cu``) sum
them: the two agree bit for bit apart from rounding inside the device's own
operations.  The partition screens are exact masked sums over the same
moments (the TPU kernels used matmuls against the 0/1 membership matrices).

``encode_bc7`` runs this plain version for a CPU tensor and a hand kernel
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
# quality -> (iters, top-k per mode, rotations) of the high-quality kernel
# (bc7_pallas.py:_HQ_PLAN).
_HQ_PLAN = {
    3: {"iters": 3, "m1": 2, "m3": 2, "m7": 0, "m0": 1, "m2": 0,
        "rot": (0,)},
    4: {"iters": 4, "m1": 4, "m3": 4, "m7": 2, "m0": 2, "m2": 2,
        "rot": (0, 1, 2, 3)},
}
_U32_MASK = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class Bc7Constants:
    """The operands the TPU kernels' wrapper fed its ``pallas_call``s
    (``bc7_pallas.py:1178-1192`` and ``:1216-1219``), in the port's two
    forms.

    part2/anchor2 and part3/anchor3 are device tensors for the plain
    version; masks (one uint16 per partition, bit t set when texel t is in
    subset 1), masks3 (one uint16 per partition and subset) and the anchor
    arrays are the hand kernels' constant-memory form; chw are the four
    float32 channel weights.
    """

    part2: torch.Tensor  # [64,16] float32 0/1
    anchor2: torch.Tensor  # [64] int32
    masks: np.ndarray  # [64] uint16
    anchors: np.ndarray  # [64] int32
    chw: tuple
    part3: torch.Tensor  # [3,64,16] float32 0/1, one membership per subset
    anchor3: torch.Tensor  # [2,64] int32: anchors of subsets 1 and 2
    masks3: np.ndarray  # [64,3] uint16
    anchors3: np.ndarray  # [64,2] int32


def _texel_bits(member) -> np.ndarray:
    """[..., 16] 0/1 -> [...] uint16 with bit t set for texel t."""
    bits = (np.asarray(member).astype(np.uint32) & 1) << np.arange(16, dtype=np.uint32)
    return bits.sum(axis=-1).astype(np.uint16)


def bc7_constants(partition2, anchor2, chw, device) -> Bc7Constants:
    """Turn the reference's numpy operands, and the port's 3-subset tables,
    into the port's state."""
    p2 = np.asarray(partition2)
    p3 = np.stack([T.PARTITION3 == s for s in range(3)])  # [3,64,16]
    anchors = np.asarray(anchor2, np.int32)
    anchors3 = np.stack([T.ANCHOR3_2, T.ANCHOR3_3], axis=1).astype(np.int32)
    return Bc7Constants(
        part2=torch.tensor(p2, dtype=torch.float32, device=device),
        anchor2=torch.tensor(anchors, dtype=torch.int32, device=device),
        masks=_texel_bits(p2),
        anchors=anchors,
        chw=tuple(float(np.float32(w)) for w in chw),
        part3=torch.tensor(p3, dtype=torch.float32, device=device),
        anchor3=torch.tensor(anchors3.T.copy(), dtype=torch.int32, device=device),
        masks3=np.ascontiguousarray(_texel_bits(p3).T),
        anchors3=anchors3,
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


def _masked_sums(part, x):
    """[P,16] 0/1 membership x [16,N] -> [P,N], summed in texel order."""
    acc = part[:, 0:1] * x[0]
    for t in range(1, 16):
        acc = acc + part[:, t : t + 1] * x[t]
    return acc


def _screen_2subset(px, cw, part2, chn):
    """Within-subset residual score over the 64 2-subset partitions
    (``bc7_pallas.py:_screen_2subset``).  Returns (score [64,N], axis)."""
    ones = torch.ones_like(px[0])
    _, _, axis, mean = _pca_seed(px[:3], ones, chn=3)
    cent = [px[c] - mean[c] for c in range(3)]
    proj = _csum([cent[c] * axis[c] for c in range(3)])
    w2 = _csum([cw[c] * px[c] * px[c] for c in range(chn)])

    ns = part2.sum(dim=1, keepdim=True)  # [64,1], exact
    s1 = [_masked_sums(part2, px[c]) for c in range(chn)]
    tot = _masked_sums(part2, w2)
    pssum = _masked_sums(part2, proj)
    ps2 = _masked_sums(part2, proj * proj)
    tot_all = _rt(w2)
    s1_all = [_rt(px[c]) for c in range(chn)]
    ps_all = _rt(proj)
    ps2_all = _rt(proj * proj)

    def sub_err(tot_s, s1_s, pss, ps2_s, ns_s):
        mean_term = _csum([cw[c] * s1_s[c] * s1_s[c] for c in range(chn)]) / ns_s
        along = ps2_s - pss * pss / ns_s
        return tot_s - mean_term - torch.clamp(along, min=0.0)

    score = sub_err(tot, s1, pssum, ps2, ns + 1e-6) + sub_err(
        tot_all - tot,
        [s1_all[c] - s1[c] for c in range(chn)],
        ps_all - pssum,
        ps2_all - ps2,
        (16.0 - ns) + 1e-6,
    )
    return score, axis


def _first_min(score):
    """Lowest row index at the column minimum: [P,N] -> [N] int32."""
    return torch.argmax(
        (score == score.min(dim=0).values).to(torch.uint8), dim=0
    ).to(torch.int32)


def _seed_of(px, m, axis, chn=3):
    """Extremes of the masked texels along the block's principal axis;
    channel 3 (mode 7's alpha) sits at its subset mean."""
    cnt = _rt(m) + 1e-6
    mean_s = [_rt(px[c] * m) / cnt for c in range(chn)]
    ts = _csum([(px[c] - mean_s[c]) * axis[c] for c in range(3)])
    member = m > 0
    tmax = torch.where(member, ts, -1e30).max(dim=0).values
    tmin = torch.where(member, ts, 1e30).min(dim=0).values
    hi = [mean_s[c] + (axis[c] if c < 3 else 0.0) * tmax for c in range(chn)]
    lo = [mean_s[c] + (axis[c] if c < 3 else 0.0) * tmin for c in range(chn)]
    return hi, lo


def _alpha_penalty(px, chw):
    """Error of decoding alpha as 255 (the modes without alpha)."""
    return _rt(chw[3] * _sq(px[3] - 255.0))


def _iota16(device):
    return torch.arange(16, dtype=torch.int32, device=device)[:, None]


def _mode1(px, iters: int, chw, part2, anchor2):
    """Mode 1: 64-partition screen, then the top-1 partition's fit."""
    cw = (chw[0], chw[1], chw[2], 0.0)
    score, axis = _screen_2subset(px, cw, part2, 3)
    part = _first_min(score)
    m1 = part2[part.long()].T  # [16,N] membership of subset 1
    anchor1 = anchor2[part.long()]

    def quant(e0, e1):
        return _quant_pbit_shared(e0, e1, 6, cw)

    px3 = px[:3]
    m0 = 1.0 - m1
    st0, idx0, err0 = _fit(px3, m0, 8, quant, iters, cw[:3], _seed_of(px, m0, axis))
    st1, idx1, err1 = _fit(px3, m1, 8, quant, iters, cw[:3], _seed_of(px, m1, axis))
    err = err0 + err1 + _alpha_penalty(px, chw)

    sel1 = m1 > 0
    idx = torch.where(sel1, idx1, idx0)
    (v00, v01, pb0, _, _) = st0
    (v10, v11, pb1, _, _) = st1

    swap0 = idx[0] >= 4
    idx = torch.where(swap0 & ~sel1, 7 - idx, idx)
    iota16 = _iota16(px[0].device)
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


def _rot_perm(rot: int):
    """Channel order of rotation rot: channel rot-1 swaps with alpha."""
    perm = [0, 1, 2, 3]
    if rot:
        perm[rot - 1], perm[3] = 3, rot - 1
    return perm


def _apply_rot(px, chw, rotv):
    """Per-block channel rotation (``bc7_pallas.py:_apply_rot``).

    rotv [N] int32 in 0..3.  Channel c of the result is px[perm_r[c]] for
    each block's rotation r; non-uniform weights become per-block [N]
    tensors, permuted alike (uniform ones stay as they are).
    """
    perms = [_rot_perm(r) for r in range(4)]
    uniform = len(set(chw)) == 1
    one = torch.ones_like(px[0][0])
    out_px, out_w = [], []
    for c in range(4):
        v = px[perms[0][c]]
        w = None if uniform else one * chw[perms[0][c]]
        for r in (1, 2, 3):
            take = rotv == r
            v = torch.where(take, px[perms[r][c]], v)
            if not uniform:
                w = torch.where(take, one * chw[perms[r][c]], w)
        out_px.append(v)
        out_w.append(chw[c] if uniform else w)
    return out_px, tuple(out_w)


def _screen_rot(px, chw):
    """Rotation screen, one score [N] per rotation (lower is better): the
    weighted rank-1 residual of the colour triple plus a lightly weighted
    SSE of the rotated-out channel (``bc7_pallas.py:_screen_rot``)."""
    scores = []
    ones = torch.ones_like(px[0])
    for r in range(4):
        perm = _rot_perm(r)
        p3 = [px[perm[c]] for c in range(3)]
        w3 = [chw[perm[c]] for c in range(3)]
        _, _, axis, mean = _pca_seed(p3, ones, chn=3)
        cent = [p3[c] - mean[c] for c in range(3)]
        proj = _csum([cent[c] * axis[c] for c in range(3)])
        resid = _csum(
            [w3[c] * _rt(_sq(cent[c] - proj * axis[c])) for c in range(3)]
        )
        pa = px[perm[3]]
        amean = _rt(pa) / 16.0
        asse = _rt(_sq(pa - amean))
        scores.append(resid + 0.03 * chw[perm[3]] * asse)
    return scores


def _rotated(px, chw, rot):
    """An int rotation permutes here; a per-block [N] one was applied by
    the caller (``_apply_rot``)."""
    if isinstance(rot, int):
        perm = _rot_perm(rot)
        return [px[p] for p in perm], tuple(chw[p] for p in perm)
    return px, chw


def _put_rot(pk, rot, like):
    pk.put(torch.full_like(like, rot) if isinstance(rot, int) else rot, 2)


def _mode5(px, iters: int, chw, rot=0):
    """Mode 5: 7-bit colour with 2-bit indices, 8-bit alpha, at rotation
    rot (an int, or a per-block [N] tensor already applied)."""
    px, chw = _rotated(px, chw, rot)
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
    _put_rot(pk, rot, a0)
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


def _mode4(px, iters: int, chw, rot=0, idx_modes=(0, 1)):
    """Mode 4: 5-bit colour, 6-bit alpha, at rotation rot; index mode 0
    is 2-bit colour / 3-bit alpha indices, index mode 1 the reverse."""
    px, chw = _rotated(px, chw, rot)
    cw = (chw[0], chw[1], chw[2])
    ones = torch.ones_like(px[0])
    hi, lo, _, _ = _pca_seed(px, ones, chn=3)

    def quant(e0, e1):
        v, d = _quant_plain(e0, 5)
        v1, d1 = _quant_plain(e1, 5)
        return (v, v1, d, d1)

    best_words = best_err = None
    for idx_mode in idx_modes:
        clev = 4 if idx_mode == 0 else 8
        alev = 8 if idx_mode == 0 else 4
        (v0, v1, _, _), cidx, cerr = _fit(
            px[:3], ones, clev, quant, iters, cw, (hi, lo)
        )
        cswap = cidx[0] >= clev // 2
        v0, v1 = _sel(cswap, v1, v0), _sel(cswap, v0, v1)
        cidx = torch.where(cswap, (clev - 1) - cidx, cidx)

        a0, a1, aidx, aerr = _fit_alpha(px[3], alev, 6, iters)
        err = cerr + chw[3] * aerr

        pk = _Packer(a0.shape[0], a0.device)
        pk.put(torch.full_like(a0, 16), 5)
        _put_rot(pk, rot, a0)
        pk.put(torch.full_like(a0, idx_mode), 1)
        for c in range(3):
            pk.put(v0[c], 5)
            pk.put(v1[c], 5)
        pk.put(a0, 6)
        pk.put(a1, 6)
        idx2, idx3 = (cidx, aidx) if idx_mode == 0 else (aidx, cidx)
        pk.put(idx2[0], 1)
        for i in range(1, 16):
            pk.put(idx2[i], 2)
        pk.put(idx3[0], 2)
        for i in range(1, 16):
            pk.put(idx3[i], 3)
        if best_words is None:
            best_words, best_err = pk.words, err
        else:
            best_words, best_err = _take(best_words, best_err, pk.words, err)
    return best_words, best_err


def _anchor_fix(idx, sel, anchor, levels):
    """Clear the anchor texel's index MSB by inverting its subset's
    indices.  idx [16,N]; sel [16,N] bool; anchor [N].  -> (swap, idx)."""
    g = anchor.long()[None]
    aval = torch.where(sel.gather(0, g)[0], idx.gather(0, g)[0], 0)
    swap = aval >= (levels // 2)
    return swap, torch.where(swap & sel, (levels - 1) - idx, idx)


def _topk_parts(score, k):
    """The k lowest-score partitions [N] each, ties to the lowest index."""
    iota = torch.arange(score.shape[0], device=score.device)[:, None]
    out = []
    for _ in range(k):
        part = _first_min(score)
        out.append(part)
        score = torch.where(iota == part, torch.inf, score)
    return out


def _put_indices(pk, idx, nbits, anchors):
    """Indices at per-block bit positions: nbits each, one fewer at texel
    0 and at each subset anchor ([N] tensors)."""
    iota16 = _iota16(idx.device)
    wbits = nbits - (iota16 == 0).to(torch.int32)
    for a in anchors:
        wbits = wbits - (iota16 == a).to(torch.int32)
    pos = torch.full_like(anchors[0], pk.pos)
    for i in range(16):
        pk.put_dynamic(idx[i], pos, nbits)
        pos = pos + wbits[i]


def _best_estimate(parts, est):
    """The partition of lowest estimated error (first on ties)."""
    bp = be = None
    for part in parts:
        e = est(part)
        if bp is None:
            bp, be = part, e
        else:
            bp = torch.where(e < be, part, bp)
            be = torch.minimum(e, be)
    return bp


def _mode_2subset(px, iters, chw, part2, anchor2, mode, topk):
    """Modes 1/3/7 over the top-k 2-subset partitions, estimate-then-refine
    (``bc7_pallas.py:_mode_2subset``).  Mode 1: RGB 6.6 shared p-bit, 3-bit
    indices; mode 3: RGB 7.7 p-bit each, 2-bit; mode 7: RGBA 5.5 p-bit
    each, 2-bit."""
    chn = 4 if mode == 7 else 3
    cw = chw if mode == 7 else (chw[0], chw[1], chw[2], 0.0)
    score, axis = _screen_2subset(px, cw, part2, chn)
    parts = _topk_parts(score, topk)
    levels, bits = {1: (8, 6), 3: (4, 7), 7: (4, 5)}[mode]

    def quant(e0, e1):
        if mode == 1:
            v0, v1, p, d0, d1 = _quant_pbit_shared(e0, e1, bits, cw[:3])
            return (v0, v1, p, p, d0, d1)
        v0, p0, d0 = _quant_pbit_each(e0, bits, cw[:chn])
        v1, p1, d1 = _quant_pbit_each(e1, bits, cw[:chn])
        return (v0, v1, p0, p1, d0, d1)

    pxc = px[:chn]

    def fit(m, it):
        return _fit(pxc, m, levels, quant, it, cw[:chn], _seed_of(px, m, axis, chn))

    def estimate(part):
        m1 = part2[part.long()].T
        return fit(1.0 - m1, 0)[2] + fit(m1, 0)[2]

    part = parts[0] if len(parts) == 1 else _best_estimate(parts, estimate)
    m1 = part2[part.long()].T
    anchor1 = anchor2[part.long()]
    st0, idx0, err0 = fit(1.0 - m1, iters)
    st1, idx1, err1 = fit(m1, iters)
    err = err0 + err1
    if mode != 7:
        err = err + _alpha_penalty(px, chw)

    sel1 = m1 > 0
    idx = torch.where(sel1, idx1, idx0)
    (v00, v01, p00, p01, _, _) = st0
    (v10, v11, p10, p11, _, _) = st1
    swap0, idx = _anchor_fix(idx, ~sel1, torch.zeros_like(anchor1), levels)
    swap1, idx = _anchor_fix(idx, sel1, anchor1, levels)
    v00, v01 = _sel(swap0, v01, v00), _sel(swap0, v00, v01)
    p00, p01 = _sel(swap0, p01, p00), _sel(swap0, p00, p01)
    v10, v11 = _sel(swap1, v11, v10), _sel(swap1, v10, v11)
    p10, p11 = _sel(swap1, p11, p10), _sel(swap1, p10, p11)

    pk = _Packer(part.shape[0], part.device)
    header = {1: (2, 2), 3: (8, 4), 7: (128, 8)}[mode]
    pk.put(torch.full_like(part, header[0]), header[1])
    pk.put(part, 6)
    for c in range(chn):
        pk.put(v00[c], bits)
        pk.put(v01[c], bits)
        pk.put(v10[c], bits)
        pk.put(v11[c], bits)
    for p in ((p00, p10) if mode == 1 else (p00, p01, p10, p11)):
        pk.put(p, 1)
    _put_indices(pk, idx, 3 if mode == 1 else 2, [anchor1])
    return pk.words, err


def _mode_3subset(px, iters, chw, part3, anchor3, mode, topk):
    """Modes 0/2 over the top-k 3-subset partitions, estimate-then-refine
    (``bc7_pallas.py:_mode_3subset``).  Mode 0: the first 16 partitions,
    RGB 4.4 p-bit each, 3-bit indices; mode 2: 64 partitions, RGB 5.5, no
    p-bits, 2-bit indices.  part3 [3,64,16]; anchor3 [2,64]."""
    cw = (chw[0], chw[1], chw[2], 0.0)
    ones = torch.ones_like(px[0])
    _, _, axis, mean = _pca_seed(px, ones, chn=3)
    cent = [px[c] - mean[c] for c in range(3)]
    proj = _csum([cent[c] * axis[c] for c in range(3)])
    w2 = _csum([cw[c] * px[c] * px[c] for c in range(3)])

    score = None
    for ms in part3:
        ns = ms.sum(dim=1, keepdim=True) + 1e-6
        s1 = [_masked_sums(ms, px[c]) for c in range(3)]
        tot = _masked_sums(ms, w2)
        pssum = _masked_sums(ms, proj)
        ps2 = _masked_sums(ms, proj * proj)
        mean_term = _csum([cw[c] * s1[c] * s1[c] for c in range(3)]) / ns
        along = ps2 - pssum * pssum / ns
        sc = tot - mean_term - torch.clamp(along, min=0.0)
        score = sc if score is None else score + sc
    if mode == 0:
        score = score.clone()
        score[16:] = torch.inf
    parts = _topk_parts(score, topk)
    levels, bits = (8, 4) if mode == 0 else (4, 5)

    def quant(e0, e1):
        if mode == 0:
            v0, p0, d0 = _quant_pbit_each(e0, bits, cw[:3])
            v1, p1, d1 = _quant_pbit_each(e1, bits, cw[:3])
            return (v0, v1, p0, p1, d0, d1)
        v0, d0 = _quant_plain(e0, bits)
        v1, d1 = _quant_plain(e1, bits)
        zero = torch.zeros_like(v0[0])
        return (v0, v1, zero, zero, d0, d1)

    px3 = px[:3]

    def fit(m, it):
        return _fit(px3, m, levels, quant, it, cw[:3], _seed_of(px, m, axis))

    def members(part):
        return [part3[s][part.long()].T for s in range(3)]

    def estimate(part):
        subm = members(part)
        return fit(subm[0], 0)[2] + fit(subm[1], 0)[2] + fit(subm[2], 0)[2]

    part = parts[0] if len(parts) == 1 else _best_estimate(parts, estimate)
    subm = members(part)
    a2, a3 = anchor3[0][part.long()], anchor3[1][part.long()]
    anchors = [torch.zeros_like(a2), a2, a3]
    err = _alpha_penalty(px, chw)
    states, idxs = [], []
    for m in subm:
        st, si, se = fit(m, iters)
        states.append(st)
        idxs.append(si)
        err = err + se
    idx = torch.where(subm[1] > 0, idxs[1], idxs[0])
    idx = torch.where(subm[2] > 0, idxs[2], idx)

    vs, ps = [], []
    for s in range(3):
        v0, v1, p0, p1, _, _ = states[s]
        swap, idx = _anchor_fix(idx, subm[s] > 0, anchors[s], levels)
        vs.append((_sel(swap, v1, v0), _sel(swap, v0, v1)))
        ps.append((_sel(swap, p1, p0), _sel(swap, p0, p1)))

    pk = _Packer(part.shape[0], part.device)
    if mode == 0:
        pk.put(torch.full_like(part, 1), 1)
        pk.put(part, 4)
    else:
        pk.put(torch.full_like(part, 4), 3)
        pk.put(part, 6)
    for c in range(3):
        for s in range(3):
            pk.put(vs[s][0][c], bits)
            pk.put(vs[s][1][c], bits)
    if mode == 0:
        for s in range(3):
            pk.put(ps[s][0], 1)
            pk.put(ps[s][1], 1)
    _put_indices(pk, idx, 3 if mode == 0 else 2, [a2, a3])
    return pk.words, err


def _take(words, err, cand_words, cand_err):
    take = cand_err < err
    return (
        [torch.where(take, a, b) for a, b in zip(cand_words, words)],
        torch.minimum(cand_err, err),
    )


def _encode_hq(px, quality: int, consts: Bc7Constants):
    """``bc7_pallas.py:_kernel_hq``: q3-4 mode search -> (words, err)."""
    plan = _HQ_PLAN[quality]
    iters = plan["iters"]
    chw = consts.chw
    words, err = _mode6(px, iters, chw)
    if len(plan["rot"]) <= 1:
        for rot in plan["rot"]:
            words, err = _take(words, err, *_mode5(px, iters, chw, rot))
            words, err = _take(words, err, *_mode4(px, iters, chw, rot))
    else:
        # Screen the four rotations, rank the best two by one unrefined
        # mode-5 fit, and fit modes 5 and 4 at the per-block winner only.
        scores = _screen_rot(px, chw)
        r1 = torch.zeros_like(scores[0], dtype=torch.int32)
        s1 = scores[0]
        for r in (1, 2, 3):
            r1 = torch.where(scores[r] < s1, r, r1)
            s1 = torch.minimum(scores[r], s1)
        r2 = torch.zeros_like(r1)
        s2 = torch.where(r1 == 0, 3e38, scores[0])
        for r in (1, 2, 3):
            sr = torch.where(r1 == r, 3e38, scores[r])
            r2 = torch.where(sr < s2, r, r2)
            s2 = torch.minimum(sr, s2)
        ests = []
        for rv in (r1, r2):
            pxr, chwr = _apply_rot(px, chw, rv)
            ests.append(_mode5(pxr, 0, chwr, rv)[1])
        rbest = torch.where(ests[1] < ests[0], r2, r1)
        pxr, chwr = _apply_rot(px, chw, rbest)
        words, err = _take(words, err, *_mode5(pxr, iters, chwr, rbest))
        words, err = _take(words, err, *_mode4(pxr, iters, chwr, rbest))
    for mode in (1, 3, 7):
        k = plan[f"m{mode}"]
        if k:
            words, err = _take(words, err, *_mode_2subset(
                px, iters, chw, consts.part2, consts.anchor2, mode, k))
    for mode in (0, 2):
        k = plan[f"m{mode}"]
        if k:
            words, err = _take(words, err, *_mode_3subset(
                px, iters, chw, consts.part3, consts.anchor3, mode, k))
    return words, err


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
    if quality >= 3:
        words, _ = _encode_hq(px, quality, consts)
        return torch.stack(words, dim=1).to(torch.uint32)
    iters = _ITERS[quality]

    words, err = _mode6(px, iters, chw)
    if quality >= 1:
        words, err = _take(
            words, err, *_mode1(px, iters, chw, consts.part2, consts.anchor2)
        )
    if quality >= 2:
        # Index mode 0 only at q2, as the TPU kernel (_kernel) runs it.
        words, err = _take(words, err, *_mode5(px, iters, chw))
        words, err = _take(words, err, *_mode4(px, iters, chw, idx_modes=(0,)))
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
    tensor runs the plain version; a CUDA tensor launches a hand kernel
    (``kernels/bc7_cuda.py`` for quality 0-2, ``kernels/bc7_hq_cuda.py``
    for 3-4) and raises if that fails.
    """
    quality = int(quality)
    if quality not in _ITERS and quality not in _HQ_PLAN:
        raise ValueError(f"BC7 quality must be 0-4, got {quality}")
    consts = _constants(perceptual, blocks.device)
    if blocks.device.type == "cpu":
        return encode_bc7_plain(blocks, quality, consts)
    if blocks.device.type == "cuda":
        if quality >= 3:
            from cuttlefish_tpu_torch.kernels import bc7_hq_cuda

            return bc7_hq_cuda.encode_bc7_hq_cuda(blocks, quality, consts)
        from cuttlefish_tpu_torch.kernels import bc7_cuda

        return bc7_cuda.encode_bc7_cuda(blocks, quality, consts)
    raise ValueError(f"unsupported device {blocks.device}")
