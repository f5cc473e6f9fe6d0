"""BC1-BC5 block encoders: plain PyTorch version and dispatch.

The plain version computes what the TPU kernels of
``cuttlefish_tpu/kernels/bc_pallas.py`` compute, function by function and
under the same names: ``_bc1_tile`` (PCA seed, least-squares refinement,
the 565 lattice sweep from quality 2, the 3-colour mode with black or
punch-through alpha) and ``_bc4_tile`` (8-value mode, and from quality 2
the 6-value mode with the fixed extremes), composed into BC1/BC2/BC3/BC4/
BC5 as ``encode_bc*_pallas`` compose them.  It follows the Pallas kernel,
not the JAX package's ``jnp`` path (``kernels/bc.py``), which the reference
holds to it only on 99 % of blocks.  Layout follows that kernel: each
channel is a ``[16, N]`` tensor (texels x blocks), per-block values ``[N]``.

Every sum over the 16 texels and over the three channels is a left fold in
texel (channel) order, every constant the float32 value JAX uses, and every
palette search keeps the first minimum, as the hand kernel
(``csrc/bc_encode.cu``) does, so that the two agree bit for bit.

``encode_bc1`` .. ``encode_bc5`` run this plain version for a CPU tensor
and the hand kernel (``kernels/bc_cuda.py``) for a CUDA tensor; they never
fall back from one to the other.
"""

from __future__ import annotations

import torch

_BC1_4C_W = (1.0, 0.0, 2.0 / 3.0, 1.0 / 3.0)
_BC1_3C_W = (1.0, 0.0, 0.5, 0.0)
_BC4_8V_W = (1.0, 0.0, 6 / 7, 5 / 7, 4 / 7, 3 / 7, 2 / 7, 1 / 7)
_BC4_6V_W = (1.0, 0.0, 4 / 5, 3 / 5, 2 / 5, 1 / 5)

_LS_ITERS = (1, 2, 3, 6, 10)

_INV255 = 1.0 / 255.0
_INV127 = 1.0 / 127.0


def ls_iters(quality: int) -> int:
    return _LS_ITERS[max(0, min(4, int(quality)))]


# ---------------------------------------------------------------------------
# Shared primitives: texel tensors [16,N], per-block tensors [N]
# ---------------------------------------------------------------------------


def _rt(x):
    """Sum over the texel axis in texel order: [16,N] -> [N]."""
    acc = x[0]
    for t in range(1, x.shape[0]):
        acc = acc + x[t]
    return acc


def _csum(terms):
    """Left-to-right sum of a channel list (Python ``sum``)."""
    acc = terms[0]
    for x in terms[1:]:
        acc = acc + x
    return acc


def _sel(take, a, b):
    if isinstance(a, (list, tuple)):
        return [torch.where(take, x, y) for x, y in zip(a, b)]
    return torch.where(take, a, b)


def _wtable(idx, table):
    """Index -> float32 weight (``bc_pallas.py:_wtable``)."""
    return torch.tensor(table, dtype=torch.float32, device=idx.device)[idx]


def _pca_seed3(px, mask):
    """(hi, lo) channel lists [N] via principal-axis extremes: 6 power
    iterations from the first texel of largest norm
    (``bc_pallas.py:_pca_seed3``)."""
    cnt = _rt(mask) + 1e-12
    mean = [_rt(px[c] * mask) / cnt for c in range(3)]
    cent = [(px[c] - mean[c]) * mask for c in range(3)]
    cov = [[_rt(cent[c] * cent[d]) for d in range(3)] for c in range(3)]
    norms = _csum([cent[c] * cent[c] for c in range(3)])
    # First texel at the maximum norm (ties pick the lowest texel).
    fidx = torch.argmax((norms == norms.max(dim=0).values).to(torch.uint8), dim=0)
    start = [cent[c].gather(0, fidx[None])[0] for c in range(3)]
    n0 = torch.sqrt(_csum([s * s for s in start]))
    v = [torch.where(n0 > 1e-10, s / (n0 + 1e-20), torch.ones_like(s)) for s in start]
    for _ in range(6):
        nv = [_csum([cov[c][d] * v[d] for d in range(3)]) for c in range(3)]
        nn = torch.sqrt(_csum([x * x for x in nv]))
        v = [torch.where(nn > 1e-10, nv[c] / (nn + 1e-20), v[c]) for c in range(3)]
    t = _csum([cent[c] * v[c] for c in range(3)])
    tmax = t.max(dim=0).values
    tmin = t.min(dim=0).values
    hi = [mean[c] + v[c] * tmax for c in range(3)]
    lo = [mean[c] + v[c] * tmin for c in range(3)]
    return hi, lo


def _ls1(vals, w, pv):
    """Least-squares endpoints for weights w (w=1 -> e0): [16,N] -> [N] x2."""
    wv = w * pv
    uv = (1.0 - w) * pv
    a11 = _rt(wv * w)
    a12 = _rt(wv * (1.0 - w))
    a22 = _rt(uv * (1.0 - w))
    b0 = _rt(wv * vals)
    b1 = _rt(uv * vals)
    det = a11 * a22 - a12 * a12
    ok = torch.abs(det) > 1e-8
    safe = torch.where(ok, det, torch.ones_like(det))
    mean = _rt(vals * pv) / (_rt(pv) + 1e-12)
    e0 = torch.where(ok, (a22 * b0 - a12 * b1) / safe, mean)
    e1 = torch.where(ok, (a11 * b1 - a12 * b0) / safe, mean)
    return e0, e1


def _ls3(px, w, pv):
    wv = w * pv
    uv = (1.0 - w) * pv
    a11 = _rt(wv * w)
    a12 = _rt(wv * (1.0 - w))
    a22 = _rt(uv * (1.0 - w))
    det = a11 * a22 - a12 * a12
    ok = torch.abs(det) > 1e-8
    safe = torch.where(ok, det, torch.ones_like(det))
    cnt = _rt(pv) + 1e-12
    e0, e1 = [], []
    for c in range(3):
        b0 = _rt(wv * px[c])
        b1 = _rt(uv * px[c])
        mean = _rt(px[c] * pv) / cnt
        e0.append(torch.where(ok, (a22 * b0 - a12 * b1) / safe, mean))
        e1.append(torch.where(ok, (a11 * b1 - a12 * b0) / safe, mean))
    return e0, e1


# ---------------------------------------------------------------------------
# BC1 tile
# ---------------------------------------------------------------------------


def _dq565(r, g, b):
    return [
        ((r << 3) | (r >> 2)).to(torch.float32) * _INV255,
        ((g << 2) | (g >> 4)).to(torch.float32) * _INV255,
        ((b << 3) | (b >> 2)).to(torch.float32) * _INV255,
    ]


def _quant565(e):
    r = torch.round(torch.clamp(e[0], 0.0, 1.0) * 31.0).to(torch.int32)
    g = torch.round(torch.clamp(e[1], 0.0, 1.0) * 63.0).to(torch.int32)
    b = torch.round(torch.clamp(e[2], 0.0, 1.0) * 31.0).to(torch.int32)
    return (r << 11) | (g << 5) | b, _dq565(r, g, b)


def _bc1_assign(px, d0, d1, weights, chw, black=False, pv=None):
    """Nearest palette entry per texel, first minimum in table order (the
    black entry last).  Returns (idx [16,N], block error [N])."""
    best_i = best_e = None
    entries = list(weights) + ([None] if black else [])
    for k, w in enumerate(entries):
        if w is None:
            e = _csum([chw[c] * px[c] * px[c] for c in range(3)])
        else:
            e = _csum(
                [
                    chw[c] * _sq(px[c] - (w * d0[c] + (1.0 - w) * d1[c]))
                    for c in range(3)
                ]
            )
        if best_e is None:
            best_i, best_e = torch.zeros_like(e, dtype=torch.int32), e
        else:
            take = e < best_e
            best_i = torch.where(take, k, best_i)
            best_e = torch.minimum(e, best_e)
    if pv is not None:
        best_e = best_e * pv
    return best_i, _rt(best_e)


def _sq(x):
    return x * x


def _bc1_tile(px, amask, iters, chw, punch_through, allow_black, quality):
    """px: [r,g,b] [16,N] floats; amask [16,N] (1 = opaque).

    Returns (c0, c1 [N] int32, idx [16,N] int32)."""
    ones = torch.ones_like(px[0])
    hi, lo = _pca_seed3(px, ones)

    def cand4(e0, e1):
        c0, d0 = _quant565(e0)
        c1, d1 = _quant565(e1)
        idx, err = _bc1_assign(px, d0, d1, _BC1_4C_W, chw)
        return c0, c1, idx, err

    best4 = cand4(hi, lo)
    for _ in range(iters):
        w = _wtable(best4[2], _BC1_4C_W)
        e0, e1 = _ls3(px, w, ones)
        cand = cand4(e0, e1)
        take = cand[3] < best4[3]
        best4 = tuple(_sel(take, c, b) for c, b in zip(cand, best4))
    if quality >= 2:
        # Per-channel +-1 sweep of both 565 endpoints around the pass's
        # starting pair: 2 passes x 3 channels x 8 neighbour pairs.
        for _ in range(2):
            base0, base1 = best4[0], best4[1]
            for shift, maxv in ((11, 31), (5, 63), (0, 31)):
                for d0 in (-1, 0, 1):
                    for d1 in (-1, 0, 1):
                        if d0 == 0 and d1 == 0:
                            continue
                        f0 = torch.clamp(((base0 >> shift) & maxv) + d0, 0, maxv)
                        f1 = torch.clamp(((base1 >> shift) & maxv) + d1, 0, maxv)
                        c0n = (base0 & ~(maxv << shift)) | (f0 << shift)
                        c1n = (base1 & ~(maxv << shift)) | (f1 << shift)
                        idx, err = _bc1_assign(
                            px, _dq565_word(c0n), _dq565_word(c1n), _BC1_4C_W, chw
                        )
                        take = err < best4[3]
                        best4 = tuple(
                            _sel(take, c, b) for c, b in zip((c0n, c1n, idx, err), best4)
                        )
    c0_4, c1_4, idx_4, err_4 = best4

    swap = c0_4 < c1_4
    c0o = torch.where(swap, c1_4, c0_4)
    c1o = torch.where(swap, c0_4, c1_4)
    idx_4o = torch.where(swap, idx_4 ^ 1, idx_4)
    idx_4o = torch.where(c0o == c1o, 0, idx_4o)

    use3 = punch_through or (allow_black and quality >= 2)
    if not use3:
        return c0o, c1o, idx_4o

    def cand3(e0, e1):
        c0, d0 = _quant565(e0)
        c1, d1 = _quant565(e1)
        if not punch_through:
            idx, err = _bc1_assign(px, d0, d1, _BC1_3C_W[:3], chw, black=True)
        else:
            idx, err = _bc1_assign(px, d0, d1, _BC1_3C_W[:3], chw, pv=amask)
            idx = torch.where(amask < 0.5, 3, idx)
        return c0, c1, idx, err

    best3 = cand3(hi, lo)
    for _ in range(iters):
        w = _wtable(best3[2], _BC1_3C_W)
        pv = amask * (best3[2] != 3).to(torch.float32)
        e0, e1 = _ls3(px, w, pv)
        cand = cand3(e0, e1)
        take = cand[3] < best3[3]
        best3 = tuple(_sel(take, c, b) for c, b in zip(cand, best3))
    c0_3, c1_3, idx_3, err_3 = best3

    swap3 = c0_3 > c1_3
    c0_3o = torch.where(swap3, c1_3, c0_3)
    c1_3o = torch.where(swap3, c0_3, c1_3)
    idx_3o = torch.where(swap3 & (idx_3 < 2), idx_3 ^ 1, idx_3)

    pick3 = err_3 < err_4
    if punch_through:
        pick3 = (amask < 0.5).any(dim=0) | pick3
    c0 = torch.where(pick3, c0_3o, c0o)
    c1 = torch.where(pick3, c1_3o, c1o)
    idx = torch.where(pick3, idx_3o, idx_4o)
    return c0, c1, idx


def _dq565_word(c16):
    return _dq565((c16 >> 11) & 31, (c16 >> 5) & 63, c16 & 31)


def _bc1_words(c0, c1, idx):
    """-> two [N] int64 words (uint32 values)."""
    w0 = c0.to(torch.int64) | (c1.to(torch.int64) << 16)
    idx = idx.to(torch.int64)
    w1 = torch.zeros_like(w0)
    for i in range(16):
        w1 = w1 | (idx[i] << (2 * i))
    return w0, w1


# ---------------------------------------------------------------------------
# BC4 tile
# ---------------------------------------------------------------------------


def _quant_bc4(e, signed):
    """-> (stored byte, decoded endpoint)."""
    if signed:
        q = torch.round(torch.clamp(e, -1.0, 1.0) * 127.0).to(torch.int32)
        return q & 0xFF, q.to(torch.float32) * _INV127
    q = torch.round(torch.clamp(e, 0.0, 1.0) * 255.0).to(torch.int32)
    return q, q.to(torch.float32) * _INV255


def _bc4_assign(vals, d0, d1, weights, extremes=None):
    best_i = best_e = None
    for k, w in enumerate(weights):
        pal = w * d0 + (1.0 - w) * d1
        e = _sq(vals - pal)
        if best_e is None:
            best_i, best_e = torch.zeros_like(e, dtype=torch.int32), e
        else:
            take = e < best_e
            best_i = torch.where(take, k, best_i)
            best_e = torch.minimum(e, best_e)
    if extremes is not None:
        for j, ext in enumerate(extremes):
            e = _sq(vals - ext) - 1e-12
            take = e < best_e
            best_i = torch.where(take, len(weights) + j, best_i)
            best_e = torch.minimum(e, best_e)
    return best_i, _rt(torch.clamp(best_e, min=0.0))


def _bc4_tile(vals, iters, signed, quality):
    """vals [16,N] -> (q0, q1 [N] int32, idx [16,N] int32)."""
    ones = torch.ones_like(vals)
    lo_ext, hi_ext = (-1.0, 1.0) if signed else (0.0, 1.0)
    hi = vals.max(dim=0).values
    lo = vals.min(dim=0).values

    def cand8(e0, e1):
        q0, d0 = _quant_bc4(e0, signed)
        q1, d1 = _quant_bc4(e1, signed)
        idx, err = _bc4_assign(vals, d0, d1, _BC4_8V_W)
        return q0, q1, d0, d1, idx, err

    best8 = cand8(hi, lo)
    for _ in range(iters):
        w = _wtable(best8[4], _BC4_8V_W)
        e0, e1 = _ls1(vals, w, ones)
        cand = cand8(e0, e1)
        take = cand[5] < best8[5]
        best8 = tuple(_sel(take, c, b) for c, b in zip(cand, best8))
    q0_8, q1_8, d0_8, d1_8, idx_8, err_8 = best8

    swap = d0_8 < d1_8
    q0o = torch.where(swap, q1_8, q0_8)
    q1o = torch.where(swap, q0_8, q1_8)
    idx_8o = torch.where(swap, torch.where(idx_8 < 2, idx_8 ^ 1, 9 - idx_8), idx_8)
    idx_8o = torch.where(q0o == q1o, 0, idx_8o)
    if quality < 2:
        return q0o, q1o, idx_8o

    def cand6(e0, e1):
        q0, d0 = _quant_bc4(e0, signed)
        q1, d1 = _quant_bc4(e1, signed)
        idx, err = _bc4_assign(vals, d0, d1, _BC4_6V_W, extremes=(lo_ext, hi_ext))
        return q0, q1, d0, d1, idx, err

    tol = 1.0 / 255.0
    interior = (vals > lo_ext + tol) & (vals < hi_ext - tol)
    hi_i = torch.where(interior, vals, -1e30).max(dim=0).values
    lo_i = torch.where(interior, vals, 1e30).min(dim=0).values
    hi_s = torch.where(hi_i > -1e29, hi_i, hi)
    lo_s = torch.where(lo_i < 1e29, lo_i, lo)
    best6 = cand6(hi_s, lo_s)
    w6 = _BC4_6V_W + (0.0, 0.0)
    for _ in range(iters):
        w = _wtable(best6[4], w6)
        pv = (best6[4] < 6).to(torch.float32)
        e0, e1 = _ls1(vals, w, pv)
        cand = cand6(e0, e1)
        take = cand[5] < best6[5]
        best6 = tuple(_sel(take, c, b) for c, b in zip(cand, best6))
    q0_6, q1_6, d0_6, d1_6, idx_6, err_6 = best6
    swap6 = d0_6 > d1_6
    q0_6o = torch.where(swap6, q1_6, q0_6)
    q1_6o = torch.where(swap6, q0_6, q1_6)
    idx_6o = torch.where(
        swap6 & (idx_6 < 6), torch.where(idx_6 < 2, idx_6 ^ 1, 7 - idx_6), idx_6
    )
    pick6 = err_6 < err_8
    q0f = torch.where(pick6, q0_6o, q0o)
    q1f = torch.where(pick6, q1_6o, q1o)
    idx = torch.where(pick6, idx_6o, idx_8o)
    return q0f, q1f, idx


def _bc4_words(q0, q1, idx):
    """-> two [N] int64 words (uint32 values); texel 5's index straddles
    the two words."""
    idx = idx.to(torch.int64)
    low = (q0.to(torch.int64) & 0xFF) | ((q1.to(torch.int64) & 0xFF) << 8)
    for i in range(5):
        low = low | (idx[i] << (16 + 3 * i))
    low = low | ((idx[5] & 1) << 31)
    high = idx[5] >> 1
    for i in range(6, 16):
        high = high | (idx[i] << (3 * i - 16))
    return low, high


# ---------------------------------------------------------------------------
# The five entry points: plain versions
# ---------------------------------------------------------------------------


def _channels(blocks, n):
    """[N,16,C] -> n channel tensors [16,N] float32."""
    x = blocks.to(torch.float32).permute(2, 1, 0)
    return [x[c].contiguous() for c in range(n)]


def _stack(words):
    return torch.stack(words, dim=1).to(torch.uint32)


def _empty(blocks, nwords):
    return torch.empty((0, nwords), dtype=torch.uint32, device=blocks.device)


def encode_bc1_plain(
    blocks, quality=2, punch_through=False, allow_black=True, chw=(1.0, 1.0, 1.0)
):
    """[N,16,4] float RGBA -> [N,2] uint32 (``encode_bc1_pallas``)."""
    if blocks.shape[0] == 0:
        return _empty(blocks, 2)
    x = _channels(blocks, 4)
    px = x[:3]
    if punch_through:
        amask = (x[3] >= 0.5).to(torch.float32)
    else:
        amask = torch.ones_like(px[0])
    c0, c1, idx = _bc1_tile(
        px, amask, ls_iters(quality), chw, punch_through, allow_black, int(quality)
    )
    return _stack(_bc1_words(c0, c1, idx))


def _bc2_alpha(a):
    """[16,N] alpha -> explicit 4-bit alpha words (``bc_pallas.py:496-501``)."""
    q = torch.round(torch.clamp(a, 0.0, 1.0) * 15.0).to(torch.int64)
    a0 = torch.zeros_like(q[0])
    a1 = torch.zeros_like(q[0])
    for i in range(8):
        a0 = a0 | (q[i] << (4 * i))
        a1 = a1 | (q[i + 8] << (4 * i))
    return a0, a1


def encode_bc2_plain(blocks, quality=2, chw=(1.0, 1.0, 1.0)):
    """[N,16,4] -> [N,4] uint32: explicit alpha + BC1 without black."""
    if blocks.shape[0] == 0:
        return _empty(blocks, 4)
    x = _channels(blocks, 4)
    a0, a1 = _bc2_alpha(x[3])
    ones = torch.ones_like(x[0])
    c0, c1, idx = _bc1_tile(x[:3], ones, ls_iters(quality), chw, False, False, int(quality))
    return _stack([a0, a1, *_bc1_words(c0, c1, idx)])


def encode_bc3_plain(blocks, quality=2, chw=(1.0, 1.0, 1.0)):
    """[N,16,4] -> [N,4] uint32: BC4 alpha + BC1 without black."""
    if blocks.shape[0] == 0:
        return _empty(blocks, 4)
    x = _channels(blocks, 4)
    iters = ls_iters(quality)
    q0, q1, aidx = _bc4_tile(x[3], iters, False, int(quality))
    ones = torch.ones_like(x[0])
    c0, c1, idx = _bc1_tile(x[:3], ones, iters, chw, False, False, int(quality))
    return _stack([*_bc4_words(q0, q1, aidx), *_bc1_words(c0, c1, idx)])


def encode_bc4_plain(vals, quality=2, signed=False):
    """[N,16] float -> [N,2] uint32 (``encode_bc4_pallas``)."""
    if vals.shape[0] == 0:
        return _empty(vals, 2)
    v = vals.to(torch.float32).t().contiguous()
    q0, q1, idx = _bc4_tile(v, ls_iters(quality), signed, int(quality))
    return _stack(_bc4_words(q0, q1, idx))


def encode_bc5_plain(blocks, quality=2, signed=False):
    """[N,16,>=2] -> [N,4] uint32: BC4 tiles on red and green."""
    if blocks.shape[0] == 0:
        return _empty(blocks, 4)
    x = _channels(blocks, 2)
    iters = ls_iters(quality)
    r = _bc4_words(*_bc4_tile(x[0], iters, signed, int(quality)))
    g = _bc4_words(*_bc4_tile(x[1], iters, signed, int(quality)))
    return _stack([*r, *g])


# ---------------------------------------------------------------------------
# Dispatch (signatures of cuttlefish_tpu/kernels/bc.py)
# ---------------------------------------------------------------------------


def channel_weights(ch_weights) -> tuple:
    """Channel weights as three Python floats holding float32 values, the
    form the TPU kernel took them in (``bc.py:_static_chw``)."""
    if ch_weights is None:
        return (1.0, 1.0, 1.0)
    return tuple(float(torch.tensor(float(w), dtype=torch.float32)) for w in ch_weights)


def _check_quality(quality) -> int:
    q = int(quality)
    if not 0 <= q <= 4:
        raise ValueError(f"BC1-BC5 quality must be 0-4, got {q}")
    return q


def _device_kind(x: torch.Tensor) -> str:
    if x.device.type in ("cpu", "cuda"):
        return x.device.type
    raise ValueError(f"unsupported device {x.device}")


def encode_bc1(blocks, quality=2, punch_through=False, allow_black=True, ch_weights=None):
    """[N,16,4] float RGBA blocks -> BC1 [N,2] uint32 words.

    punch_through: BC1A, texels with alpha < 0.5 become transparent black.
    allow_black: permit the 3-colour + black mode for opaque BC1 (q >= 2).
    A CPU tensor runs the plain version, a CUDA tensor the hand kernel.
    """
    q = _check_quality(quality)
    chw = channel_weights(ch_weights)
    if _device_kind(blocks) == "cpu":
        return encode_bc1_plain(blocks, q, punch_through, allow_black, chw)
    from cuttlefish_tpu_torch.kernels import bc_cuda

    return bc_cuda.encode_bc1_cuda(blocks, q, punch_through, allow_black, chw)


def encode_bc2(blocks, quality=2, ch_weights=None):
    """[N,16,4] -> [N,4] uint32: explicit 4-bit alpha + BC1 colours."""
    q = _check_quality(quality)
    chw = channel_weights(ch_weights)
    if _device_kind(blocks) == "cpu":
        return encode_bc2_plain(blocks, q, chw)
    from cuttlefish_tpu_torch.kernels import bc_cuda

    return bc_cuda.encode_bc2_cuda(blocks, q, chw)


def encode_bc3(blocks, quality=2, ch_weights=None):
    """[N,16,4] -> [N,4] uint32: BC4 alpha + BC1 colours (no 3-colour mode)."""
    q = _check_quality(quality)
    chw = channel_weights(ch_weights)
    if _device_kind(blocks) == "cpu":
        return encode_bc3_plain(blocks, q, chw)
    from cuttlefish_tpu_torch.kernels import bc_cuda

    return bc_cuda.encode_bc3_cuda(blocks, q, chw)


def encode_bc4(vals, quality=2, signed=False):
    """[N,16] floats (unsigned [0,1] / signed [-1,1]) -> [N,2] uint32."""
    q = _check_quality(quality)
    if _device_kind(vals) == "cpu":
        return encode_bc4_plain(vals, q, signed)
    from cuttlefish_tpu_torch.kernels import bc_cuda

    return bc_cuda.encode_bc4_cuda(vals, q, signed)


def encode_bc5(blocks, quality=2, signed=False):
    """[N,16,>=2] -> [N,4] uint32: two BC4 channels (red, green)."""
    q = _check_quality(quality)
    if _device_kind(blocks) == "cpu":
        return encode_bc5_plain(blocks, q, signed)
    from cuttlefish_tpu_torch.kernels import bc_cuda

    return bc_cuda.encode_bc5_cuda(blocks, q, signed)
