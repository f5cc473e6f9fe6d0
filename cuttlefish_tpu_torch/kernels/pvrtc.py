"""PVRTC1/PVRTC2 encoders of the port (whole-surface torch ops).

The JAX package encodes PVRTC with one jitted XLA program per surface
(``cuttlefish_tpu/kernels/pvrtc.py:_encode_pvrtc``) and has no TPU kernel
for it, so this module is its torch-ops port, function by function and
under the same names, run on whichever device holds the surface: per-block
principal-axis endpoints, the 554/555 (opaque) and 3443/3444
(translucent) colour quantisers, the bilinear upscale, the modulation
choice, the punch-through (4bpp) and hard-transition (PVRTC2) decisions,
the keep-best damped Jacobi refinement and the packing.

The bilinear basis has at most two nonzero taps a row
(``pvrtc_tables._basis_matrix``), so every product by it is written as
elementwise products and adds over its nonzero taps (``_Taps``): the
upscale sums each row's two taps, rows first and then columns, as XLA's
two dots do (with two nonzero terms every summation order rounds alike);
the refinement's adjoint sums each block's footprint as a left fold in
texel order.  No matrix unit and no TF32 setting can reach them, and the
CPU and the card compute them alike.  Every other sum is a left fold in
a fixed order (the whole-surface error a halving tree), every search
keeps the first minimum, as XLA's argmin does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cuttlefish_tpu_torch.kernels.jnp_common import div, fold, principal_axis, tsum
from cuttlefish_tpu_torch.kernels.pvrtc_tables import (
    _MOD_W_4BPP,
    _basis_matrix,
    _owner_matrix,
)

_MOD_W_2BPP = np.array([0, 8], np.float32)
_REFINES = {0: 0, 1: 1, 2: 2, 3: 4, 4: 8}


def _e5(q):
    return div(((q << 3) | (q >> 2)).to(torch.float32), 255)


def _e4(q):
    return div((q * 17).to(torch.float32), 255)


def _e3to4(q):
    q4 = (q << 1) | (q >> 2)
    return _e4(q4)


def _q(x, top):
    """clip(round(x), 0, top) as int64 (round half to even, as jnp.round)."""
    return torch.clamp(torch.round(x), 0, top).to(torch.int64)


def _quant_a(c, opaque=None, flag_bit=True):
    """Color A field (``kernels/pvrtc.py:_quant_a``): c [..., 4] float RGBA
    0..1 -> (packed 16-bit int64, decoded RGBA float32); opaque 1.5.5.4 or
    translucent 0.3.4.4.3.  PVRTC2 passes the block-global opacity and
    ``flag_bit=False``."""
    if opaque is None:
        opaque = c[..., 3] >= 15.0 / 16.0
    r5 = _q(c[..., 0] * 31.0, 31)
    g5 = _q(c[..., 1] * 31.0, 31)
    b4 = _q(c[..., 2] * 15.0, 15)
    pack_o = (0x8000 if flag_bit else 0) | (r5 << 10) | (g5 << 5) | (b4 << 1)
    b5 = (b4 << 1) | (b4 >> 3)
    dec_o = torch.stack([_e5(r5), _e5(g5), _e5(b5), torch.ones_like(c[..., 3])], -1)
    qa = _q(c[..., 3] * 16.0 / 2.0, 7)
    r4 = _q(c[..., 0] * 15.0, 15)
    g4 = _q(c[..., 1] * 15.0, 15)
    b3 = _q(c[..., 2] * 7.0, 7)
    pack_t = (qa << 12) | (r4 << 8) | (g4 << 4) | (b3 << 1)
    a4 = qa << 1
    dec_t = torch.stack(
        [_e4(r4), _e4(g4), _e3to4(b3), _e4(a4)], -1
    )
    packed = torch.where(opaque, pack_o, pack_t)
    dec = torch.where(opaque[..., None], dec_o, dec_t)
    return packed, dec


def _quant_b(c, opaque=None):
    """Color B field (``kernels/pvrtc.py:_quant_b``): opaque 1.5.5.5 or
    translucent 0.3.4.4.4."""
    if opaque is None:
        opaque = c[..., 3] >= 15.0 / 16.0
    qo = _q(c[..., :3] * 31.0, 31)
    pack_o = 0x8000 | (qo[..., 0] << 10) | (qo[..., 1] << 5) | qo[..., 2]
    dec_o = torch.stack(
        [_e5(qo[..., 0]), _e5(qo[..., 1]), _e5(qo[..., 2]), torch.ones_like(c[..., 3])], -1
    )
    qa = _q(c[..., 3] * 16.0 / 2.0, 7)
    qt = _q(c[..., :3] * 15.0, 15)
    pack_t = (qa << 12) | (qt[..., 0] << 8) | (qt[..., 1] << 4) | qt[..., 2]
    a4 = qa << 1
    dec_t = torch.stack(
        [_e4(qt[..., 0]), _e4(qt[..., 1]), _e4(qt[..., 2]),
         _e4(a4)], -1
    )
    packed = torch.where(opaque, pack_o, pack_t)
    dec = torch.where(opaque[..., None], dec_o, dec_t)
    return packed, dec


# ---------------------------------------------------------------------------
# The bilinear basis as taps
# ---------------------------------------------------------------------------


class _Taps:
    """The nonzero entries of a basis matrix M [n_texels, n_blocks] on a
    device.  ``ridx``/``rw`` [2, n_texels]: each texel's two blocks and
    weights (the second weight 0 where the row has one tap).  ``cidx``/
    ``cw`` [lanes, K, n_blocks]: each block's footprint texels in
    ascending order and their weights, split into ``lanes`` lanes by
    texel index mod ``lanes`` and padded with weight 0."""

    def __init__(self, m: np.ndarray, device, lanes: int = 1):
        n, nb = m.shape
        idx = np.zeros((2, n), np.int64)
        w = np.zeros((2, n), np.float32)
        for y in range(n):
            nz = np.flatnonzero(m[y])
            idx[:, y] = nz[0]
            w[0, y] = m[y, nz[0]]
            if nz.size > 1:
                idx[1, y] = nz[1]
                w[1, y] = m[y, nz[1]]
        cols = [
            [c[c % lanes == lane] for c in (np.flatnonzero(m[:, j]) for j in range(nb))]
            for lane in range(lanes)
        ]
        k = max(c.size for lane in cols for c in lane)
        cidx = np.zeros((lanes, k, nb), np.int64)
        cw = np.zeros((lanes, k, nb), np.float32)
        for lane in range(lanes):
            for j, c in enumerate(cols[lane]):
                cidx[lane, : c.size, j] = c
                cw[lane, : c.size, j] = m[c, j]
        t = functools.partial(torch.as_tensor, device=device)
        self.ridx, self.rw = t(idx), t(w)
        self.cidx, self.cw = t(cidx), t(cw)
        self.cw2 = self.cw * self.cw


@functools.lru_cache(maxsize=None)
def _taps(kind: str, n_texels: int, block: int, n_blocks: int, wrap: bool, device: str,
          lanes: int = 1) -> _Taps:
    """Taps of the bilinear basis (``kind`` "basis") or of the one-hot
    region-owner matrix (``kind`` "owner", transposed to [texels, blocks])."""
    if kind == "basis":
        m = _basis_matrix(n_texels, block, n_blocks, wrap)
    else:
        m = np.ascontiguousarray(_owner_matrix(n_texels, block, n_blocks).T)
    return _Taps(m, torch.device(device), lanes)


def _up_axis(g, taps: _Taps, dim: int):
    """Product by the basis along ``dim``: out[y] = w0[y]*g[i0[y]] + w1[y]*g[i1[y]]."""
    shape = [1] * g.dim()
    shape[dim] = -1
    w0 = taps.rw[0].view(shape)
    w1 = taps.rw[1].view(shape)
    return w0 * g.index_select(dim, taps.ridx[0]) + w1 * g.index_select(dim, taps.ridx[1])


def _adj_axis(x, taps: _Taps, dim: int, squared: bool = False):
    """Product by the basis' transpose along ``dim`` (the refinement's
    scatter-adjoint, the region sums): out[j] = sum over block j's
    footprint of M[y,j]*x[y], each lane a left fold in texel order, the
    lanes added as a halving tree ((l0 + l1) + (l2 + l3) for four, the
    order of XLA's CPU dot over that axis); ``squared`` takes M[y,j]**2."""
    shape = [1] * x.dim()
    shape[dim] = -1
    cw = taps.cw2 if squared else taps.cw
    lanes = [
        fold([cw[lane, k].view(shape) * x.index_select(dim, taps.cidx[lane, k])
              for k in range(taps.cidx.shape[1])])
        for lane in range(taps.cidx.shape[0])
    ]
    while len(lanes) > 1:
        lanes = [lanes[i] + lanes[i + 1] for i in range(0, len(lanes), 2)]
    return lanes[0]


def upscale_bilinear(grid: torch.Tensor, bw: int, bh: int, wrap: bool = True) -> torch.Tensor:
    """[nby, nbx, C] block colors -> [nby*bh, nbx*bw, C] with the PVRTC
    4x/2x bilinear rule (``kernels/pvrtc.py:upscale_bilinear``): rows by
    the y basis first, then columns by the x basis, as XLA contracts
    ``"yj,jic,xi->yxc"``.  PVRTC1 wraps, PVRTC2 clamps (``wrap=False``)."""
    nby, nbx = grid.shape[:2]
    dev = str(grid.device)
    ty = _taps("basis", nby * bh, bh, nby, bool(wrap), dev)
    tx = _taps("basis", nbx * bw, bw, nbx, bool(wrap), dev)
    rows = _up_axis(grid.to(torch.float32), ty, 0)
    return _up_axis(rows, tx, 1)


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of every element as a halving tree of elementwise adds (zero
    padded to a power of two): the same rounding on the CPU and the card."""
    v = x.reshape(-1)
    n = 1 << max(0, (v.numel() - 1).bit_length())
    if n != v.numel():
        v = torch.cat([v, v.new_zeros(n - v.numel())])
    while v.numel() > 1:
        h = v.numel() // 2
        v = v[:h] + v[h:]
    return v[0]


def _block_endpoints(surface: torch.Tensor, bw: int, bh: int):
    """Per-block principal-axis extreme colors -> (lo, hi) [nby,nbx,C]
    (``kernels/pvrtc.py:_block_endpoints``: ``bc.py:_principal_axis``'s
    power loop, 4 iterations)."""
    h, w, nch = surface.shape
    nby, nbx = h // bh, w // bw
    t = bh * bw
    blocks = surface.reshape(nby, bh, nbx, bw, nch).permute(0, 2, 1, 3, 4)
    blocks = blocks.reshape(nby * nbx, t, nch)
    mean = div(tsum([blocks[:, i] for i in range(t)]), t)  # [N,C]
    centered = blocks - mean[:, None, :]
    v = principal_axis(centered, iters=4)
    proj = fold([centered[..., c] * v[:, None, c] for c in range(nch)])  # [N,T]
    hi = mean + v * proj.max(1).values[:, None]
    lo = mean + v * proj.min(1).values[:, None]
    return lo.reshape(nby, nbx, nch), hi.reshape(nby, nbx, nch)


def _argmin_first(e):
    """Index of the first minimum over the last axis (strict < in
    candidate order), and the minimum."""
    best = e[..., 0]
    idx = torch.zeros_like(best, dtype=torch.int64)
    for k in range(1, e.shape[-1]):
        take = e[..., k] < best
        idx = torch.where(take, k, idx)
        best = torch.where(take, e[..., k], best)
    return idx, best


def _sq_err(rgba, cand):
    """((rgba - cand)**2).sum(-1): a left fold over the four channels."""
    d = rgba - cand
    return fold([d[..., c] * d[..., c] for c in range(4)])


def _encode_pvrtc(surface, bpp2=False, quality=2, wrap=True, pvrtc2=False):
    """Encode an RGB(A) surface (H, W, 4) float 0..1 -> [nblocks, 2] int64
    words (u32 values) in raster order (caller applies the Morton
    permutation); ``kernels/pvrtc.py:_encode_pvrtc``."""
    bw, bh = (8, 4) if bpp2 else (4, 4)
    rgba = surface[..., :4].to(torch.float32)
    h, w, _ = rgba.shape
    nby, nbx = h // bh, w // bw
    dev = rgba.device

    lo, hi = _block_endpoints(rgba, bw, bh)
    refines = _REFINES[max(0, min(4, int(quality)))]
    mod_w = torch.as_tensor(_MOD_W_2BPP if bpp2 else _MOD_W_4BPP, device=dev)

    def quant_pair(lo_g, hi_g):
        if pvrtc2:
            opq = (lo_g[..., 3] >= 15.0 / 16.0) & (hi_g[..., 3] >= 15.0 / 16.0)
            pa, dec_a = _quant_a(lo_g, opaque=opq, flag_bit=False)
            pb, dec_b = _quant_b(hi_g, opaque=opq)
        else:
            pa, dec_a = _quant_a(lo_g)
            pb, dec_b = _quant_b(hi_g)
        return pa, dec_a, pb, dec_b

    cand_t = mod_w / 8.0

    def modulate(lo_g, hi_g):
        _, dec_a, _, dec_b = quant_pair(lo_g, hi_g)
        a_img = upscale_bilinear(dec_a, bw, bh, wrap=wrap)
        b_img = upscale_bilinear(dec_b, bw, bh, wrap=wrap)
        d = b_img - a_img
        denom = fold([d[..., c] * d[..., c] for c in range(4)]) + 1e-8
        r = rgba - a_img
        t = fold([r[..., c] * d[..., c] for c in range(4)]) / denom
        mi, _ = _argmin_first(torch.abs(t[..., None] - cand_t))
        return mi, a_img, b_img

    mi, a_img, b_img = modulate(lo, hi)

    bits = 1 if bpp2 else 2
    if pvrtc2:
        oy = _taps("owner", h, bh, nby, False, str(dev))
        ox = _taps("owner", w, bw, nbx, False, str(dev), 4)
        own_y, own_x = oy.ridx[0], ox.ridx[0]

    def region_sum(e):
        """oy @ e @ ox.T: each decode region's texel errors, rows (a left
        fold) then columns (four lanes, as XLA's dot sums them)."""
        return _adj_axis(_adj_axis(e, oy, 0), ox, 1)

    def finalize(lo_, hi_, mi_, a_, b_):
        """(total error, final modulation, punch flags, hard flags) of one
        endpoint state (``_encode_pvrtc.finalize``)."""
        punch = torch.zeros((nby, nbx), dtype=torch.int64, device=dev)
        if not bpp2:
            std_w = torch.as_tensor(_MOD_W_4BPP / np.float32(8.0), device=dev)
            e_std = torch.stack(
                [_sq_err(rgba, a_ * (1.0 - std_w[k]) + b_ * std_w[k]) for k in range(4)], -1
            )
            mi_std, e_std = _argmin_first(e_std)
            p_w = torch.as_tensor(np.array([0.0, 0.5, 0.5, 1.0], np.float32), device=dev)
            cands = []
            for k in range(4):
                c = a_ * (1.0 - p_w[k]) + b_ * p_w[k]
                if k == 2:
                    c = torch.cat([c[..., :3], torch.zeros_like(c[..., 3:])], -1)
                cands.append(_sq_err(rgba, c))
            mi_p, e_p = _argmin_first(torch.stack(cands, -1))

            def bsum(e):
                eb = e.reshape(nby, bh, nbx, bw)
                return fold([eb[:, i, :, j] for i in range(bh) for j in range(bw)])

            use_punch = bsum(e_p) < bsum(e_std)
            punch = use_punch.to(torch.int64)
            up = use_punch.repeat_interleave(bh, 0).repeat_interleave(bw, 1)
            mi_f = torch.where(up, mi_p, mi_std)
            e_tex = torch.where(up, e_p, e_std)
        else:
            s = (mod_w[mi_] / 8.0)[..., None]
            out = a_ * (1.0 - s) + b_ * s
            mi_f = mi_
            e_tex = _sq_err(rgba, out)

        hard = torch.zeros((nby, nbx), dtype=torch.int64, device=dev)
        if pvrtc2:
            _, dec_a_, _, dec_b_ = quant_pair(lo_, hi_)
            a_hard = dec_a_.repeat_interleave(bh, 0).repeat_interleave(bw, 1)
            b_hard = dec_b_.repeat_interleave(bh, 0).repeat_interleave(bw, 1)
            std_w = mod_w / 8.0
            e_h = torch.stack(
                [_sq_err(rgba, a_hard * (1.0 - std_w[k]) + b_hard * std_w[k])
                 for k in range(mod_w.shape[0])], -1
            )
            mi_hard, e_hard = _argmin_first(e_h)
            r_hard = region_sum(e_hard)
            r_int = region_sum(e_tex)
            pf = punch.bool()
            pr = torch.cat([pf, pf[-1:]], 0)
            pr = torch.cat([pr, pr[:, -1:]], 1)
            veto = pr[:-1, :-1] | pr[:-1, 1:] | pr[1:, :-1] | pr[1:, 1:]
            hard_b = (r_hard < r_int) & ~veto
            hard = hard_b.to(torch.int64)
            hard_tex = hard_b[own_y][:, own_x]
            mi_f = torch.where(hard_tex, mi_hard, mi_f)
            e_tex = torch.where(hard_tex, e_hard, e_tex)

        return _tree_sum(e_tex), mi_f, punch, hard

    fin = finalize(lo, hi, mi, a_img, b_img)
    best = (fin[0], lo, hi, fin[1], fin[2], fin[3])

    if refines:
        ty = _taps("basis", h, bh, nby, bool(wrap), str(dev))
        tx = _taps("basis", w, bw, nbx, bool(wrap), str(dev))
        damp = 0.6
        for _ in range(refines):
            s = (mod_w[mi] / 8.0)[..., None]  # [H,W,1]
            out = a_img * (1.0 - s) + b_img * s
            r = rgba - out
            num_a = _adj_axis(_adj_axis((1.0 - s) * r, ty, 0), tx, 1)
            num_b = _adj_axis(_adj_axis(s * r, ty, 0), tx, 1)
            g_a = (1.0 - s[..., 0]) * (1.0 - s[..., 0])
            g_b = s[..., 0] * s[..., 0]
            den_a = _adj_axis(_adj_axis(g_a, ty, 0, True), tx, 1, True)
            den_b = _adj_axis(_adj_axis(g_b, ty, 0, True), tx, 1, True)
            lo = lo + damp * num_a / (den_a[..., None] + 1e-6)
            hi = hi + damp * num_b / (den_b[..., None] + 1e-6)
            lo = torch.clamp(lo, 0.0, 1.0)
            hi = torch.clamp(hi, 0.0, 1.0)
            mi, a_img, b_img = modulate(lo, hi)
            fin = finalize(lo, hi, mi, a_img, b_img)
            keep = fin[0] < best[0]
            best = tuple(
                torch.where(keep, new, old)
                for new, old in zip((fin[0], lo, hi, fin[1], fin[2], fin[3]), best)
            )
    _, lo, hi, mi, punch_flag, hard_flag = best

    pa, _, pb, _ = quant_pair(lo, hi)

    # Modulation word per block: texel (fx, fy) at bit (fy*bw+fx)*bits.
    mb = mi.reshape(nby, bh, nbx, bw).permute(0, 2, 1, 3).reshape(nby * nbx, bh * bw)
    shifts = bits * torch.arange(bh * bw, device=dev, dtype=torch.int64)
    modword = fold([(mb[:, i] << shifts[i]) for i in range(bh * bw)])
    colorword = (
        (pb.reshape(-1) << 16)
        | pa.reshape(-1)
        | punch_flag.reshape(-1)
        | (hard_flag.reshape(-1) << 15)
    )
    return torch.stack([modword, colorword], -1)


def encode_pvrtc1(surface: torch.Tensor, bpp2: bool = False, quality: int = 2) -> torch.Tensor:
    """PVRTC1 (wraparound interpolation): (H, W, 4) float surface ->
    [nblocks, 2] uint32 words in raster order, on the surface's device."""
    return _encode_pvrtc(surface, bpp2=bpp2, quality=quality, wrap=True).to(torch.uint32)


def encode_pvrtc2(surface: torch.Tensor, bpp2: bool = False, quality: int = 2) -> torch.Tensor:
    """PVRTC2 (clamped borders, block-global opacity flag, hard-transition
    regions): (H, W, 4) float surface -> [nblocks, 2] uint32 words in
    raster order, on the surface's device."""
    words = _encode_pvrtc(surface, bpp2=bpp2, quality=quality, wrap=False, pvrtc2=True)
    return words.to(torch.uint32)
