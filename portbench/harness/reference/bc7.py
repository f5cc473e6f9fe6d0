"""BC7 decoder of the plain reference, vectorised in PyTorch, and the
index gap that judges the encoder's indices.

Written from the D3D11 functional spec (BC7 format): all eight modes, the
2- and 3-subset partitions with their anchors, p-bits, index modes and
rotations.  Each block is read bit by bit from its 128 bits, so the same
code runs on the CPU and on the card.  It imports nothing of the program.

``analyse(data, src, chw)`` decodes [N,16] block bytes and, for every
texel, measures by how much the encoder's stored index is worse than a
baseline selection for the stored endpoints, in the weighted squared
error against the reference's own source texels: the index gap
(``index_gaps``).  The baseline is the plain selection of a BC7 encoder:
project the texel on the line between the end entries (weighted), round
to the nearest index and keep the best of it and its two neighbours.  An
encoder that reads the same source as the reference and selects at least
as well scores 0 up to rounding; one that read another source (a lower
precision, another level, another texture) or altered an index does not.
"""

from __future__ import annotations

import torch

from . import bc7_tables as T

# DDS: DXGI_FORMAT_BC7_UNORM (98) and BC7_UNORM_SRGB (99), and the DX10
# alpha mode: 1, DDS_ALPHA_MODE_STRAIGHT, where the format holds alpha.
DDS_ALPHA_MODE = 1


def dds_format(type_: str, srgb: bool) -> int:
    return {("UNorm", False): 98, ("UNorm", True): 99}[(type_, srgb)]


# mode -> (subsets, partition bits, rotation bits, index-mode bits,
#          colour bits, alpha bits, p-bits, index bits, second index bits)
MODES = {
    0: (3, 4, 0, 0, 4, 0, "each", 3, 0),
    1: (2, 6, 0, 0, 6, 0, "shared", 3, 0),
    2: (3, 6, 0, 0, 5, 0, "none", 2, 0),
    3: (2, 6, 0, 0, 7, 0, "each", 2, 0),
    4: (1, 0, 2, 1, 5, 6, "none", 2, 3),
    5: (1, 0, 2, 0, 7, 8, "none", 2, 2),
    6: (1, 0, 0, 0, 7, 7, "each", 4, 0),
    7: (2, 6, 0, 0, 5, 5, "each", 2, 0),
}
_WEIGHTS = {2: T.WEIGHTS2, 3: T.WEIGHTS3, 4: T.WEIGHTS4}


def unpack_bits(data: torch.Tensor) -> torch.Tensor:
    """[N,16] uint8 -> [N,128] int64 bits, bit i of the little-endian
    128-bit block at column i."""
    shifts = torch.arange(8, device=data.device)
    bits = (data.long()[:, :, None] >> shifts) & 1
    return bits.reshape(data.shape[0], 128)


def field(bits: torch.Tensor, pos: int, n: int) -> torch.Tensor:
    """Unsigned n-bit field at bit pos, LSB first: [N,128] -> [N]."""
    if n == 0:
        return torch.zeros(bits.shape[0], dtype=torch.long, device=bits.device)
    shifts = torch.arange(n, device=bits.device)
    return (bits[:, pos : pos + n] << shifts).sum(1)


def read_indices(bits, pos: int, nbits: int, anchor: torch.Tensor):
    """16 indices of nbits each from bit pos; a texel marked in anchor
    [N,16] stores one bit less.  -> (indices [N,16], next pos)."""
    width = nbits - anchor.long()
    start = pos + torch.cumsum(width, 1) - width
    ks = torch.arange(nbits, device=bits.device)
    at = (start[:, :, None] + ks).clamp_(max=127).reshape(bits.shape[0], -1)
    vals = bits.gather(1, at).reshape(bits.shape[0], 16, nbits)
    keep = ks < width[:, :, None]
    idx = ((vals * keep) << ks).sum(-1)
    return idx, pos + 16 * nbits - int(anchor[0].sum()) if anchor.shape[0] else pos


def _expand(v, bits: int):
    """Replicate a bits-wide value to 8 bits."""
    if bits >= 8:
        return v
    return (v << (8 - bits)) | (v >> (2 * bits - 8))


def _palette(e0, e1, nbits: int):
    """Endpoints [n,16,C] -> every palette entry [n,16,L,C]."""
    w = torch.tensor(_WEIGHTS[nbits], device=e0.device).long()[None, None, :, None]
    return (e0[:, :, None] * (64 - w) + e1[:, :, None] * w + 32) >> 6


def _decode_mode(bits, m: int):
    """Blocks of mode m -> (decoded [n,16,4], [(index [n,16], palette
    [n,16,L,4])]): each index set with the palette of every index, the
    channels it does not govern held at their decoded values."""
    ns, pb, rb, ib, cb, ab, pmode, i1b, i2b = MODES[m]
    n, dev = bits.shape[0], bits.device
    pos = m + 1
    part = field(bits, pos, pb)
    pos += pb
    rot = field(bits, pos, rb)
    pos += rb
    idx_mode = field(bits, pos, ib)
    pos += ib
    neps = 2 * ns
    ep = torch.zeros((n, neps, 4), dtype=torch.long, device=dev)
    for c in range(3):
        for e in range(neps):
            ep[:, e, c] = field(bits, pos, cb)
            pos += cb
    if ab:
        for e in range(neps):
            ep[:, e, 3] = field(bits, pos, ab)
            pos += ab
    cbits, abits = cb, ab
    if pmode == "each":
        p = torch.stack([field(bits, pos + e, 1) for e in range(neps)], 1)
        pos += neps
    elif pmode == "shared":
        p = torch.stack([field(bits, pos + e // 2, 1) for e in range(neps)], 1)
        pos += ns
    else:
        p = None
    if p is not None:
        ep = (ep << 1) | p[:, :, None]
        cbits, abits = cb + 1, (ab + 1 if ab else 0)
    ep[:, :, :3] = _expand(ep[:, :, :3], cbits)
    ep[:, :, 3] = _expand(ep[:, :, 3], abits) if ab else 255

    anchor = torch.zeros((n, 16), dtype=torch.bool, device=dev)
    anchor[:, 0] = True
    if ns == 1:
        subset = torch.zeros((n, 16), dtype=torch.long, device=dev)
    elif ns == 2:
        subset = torch.tensor(T.PARTITION2, device=dev).long()[part]
        anchor.scatter_(1, torch.tensor(T.ANCHOR2, device=dev).long()[part][:, None], True)
    else:
        subset = torch.tensor(T.PARTITION3, device=dev).long()[part]
        anchor.scatter_(1, torch.tensor(T.ANCHOR3_2, device=dev).long()[part][:, None], True)
        anchor.scatter_(1, torch.tensor(T.ANCHOR3_3, device=dev).long()[part][:, None], True)
    idx1, pos = read_indices(bits, pos, i1b, anchor)
    e0 = ep.gather(1, (2 * subset)[:, :, None].expand(n, 16, 4))
    e1 = ep.gather(1, (2 * subset + 1)[:, :, None].expand(n, 16, 4))

    if i2b == 0:
        pal = _palette(e0, e1, i1b)
        dec = pal.gather(2, idx1[:, :, None, None].expand(n, 16, 1, 4))[:, :, 0]
        return dec, [(idx1, pal)]

    # Modes 4 and 5: colour and alpha indices apart, then the rotation.
    first = torch.zeros((n, 16), dtype=torch.bool, device=dev)
    first[:, 0] = True
    idx2, _ = read_indices(bits, pos, i2b, first)
    swap = (idx_mode == 1)[:, None]
    cidx = torch.where(swap, idx2, idx1)
    aidx = torch.where(swap, idx1, idx2)
    cbw = torch.where(idx_mode == 1, i2b, i1b)
    abw = torch.where(idx_mode == 1, i1b, i2b)
    sets = []
    outs = []
    for cn, an in {(int(c), int(a)) for c, a in zip(cbw.tolist(), abw.tolist())}:
        sel = (cbw == cn) & (abw == an)
        cpal = _palette(e0[sel][..., :3], e1[sel][..., :3], cn)
        apal = _palette(e0[sel][..., 3:], e1[sel][..., 3:], an)
        ci, ai = cidx[sel], aidx[sel]
        k = ci.shape[0]
        col = cpal.gather(2, ci[:, :, None, None].expand(k, 16, 1, 3))[:, :, 0]
        alp = apal.gather(2, ai[:, :, None, None].expand(k, 16, 1, 1))[:, :, 0]
        cfull = torch.cat([cpal, alp[:, :, None].expand(k, 16, cpal.shape[2], 1)], -1)
        afull = torch.cat([col[:, :, None].expand(k, 16, apal.shape[2], 3), apal], -1)
        outs.append((sel, torch.cat([col, alp], -1), ci, cfull, ai, afull))
    dec = torch.zeros((n, 16, 4), dtype=torch.long, device=dev)
    for sel, d, ci, cfull, ai, afull in outs:
        dec[sel] = d
        sets.append((sel, ci, cfull))
        sets.append((sel, ai, afull))
    perm = torch.tensor([[0, 1, 2, 3], [3, 1, 2, 0], [0, 3, 2, 1], [0, 1, 3, 2]], device=dev)
    dec = dec.gather(2, perm[rot][:, None, :].expand(n, 16, 4))
    rotated = []
    for sel, i, pal in sets:
        pr = perm[rot[sel]][:, None, None, :].expand(pal.shape)
        rotated.append((sel, i, pal.gather(3, pr)))
    return dec, rotated


def index_gaps(src, pal, idx, err_w, proj_w, eps: float, capped=None, unsure=None):
    """The gap and the worse mark of each texel's stored index ``idx``
    [n,16] against the baseline selection.

    The baseline: the index nearest the source's projection on the end
    entries' line (weights ``proj_w`` on the products), then the best of
    it and its neighbours by the error (weights ``err_w``; ties to the
    lower); texels marked in ``capped`` pick among those candidates in
    the palette's lower half only.  The gap is how much the stored
    entry's error exceeds the baseline's (0 where it does not).  A texel
    is worse where the gap exceeds a thousandth of the baseline's error
    (plus 0.001), and its projection does not lie within a hundredth of
    an index of a rounding boundary, where the float32 the encoder
    computes in and the reference's float64 may round apart; nor is a
    texel marked in ``unsure`` [n,16].
    src [n,16,C], pal [n,16,L,C] float64, err_w broadcast to pal ->
    (gap, worse) [n,16]."""
    levels = pal.shape[2]
    err = (((src[:, :, None, :] - pal) * err_w) ** 2).sum(-1)
    lo, hi = pal[:, :, 0], pal[:, :, -1]
    dd = hi - lo
    t = ((src - lo) * dd * proj_w).sum(-1) / ((dd * dd * proj_w).sum(-1) + eps)
    x = t.clamp(0.0, 1.0) * (levels - 1)
    k = torch.round(x).long()
    ambiguous = ((x - torch.floor(x)) - 0.5).abs() < 0.01
    top = torch.full_like(k, levels - 1)
    if capped is not None:
        top = torch.where(capped, levels // 2 - 1, top)
    best_e = None
    for dk in (-1, 0, 1):
        kk = torch.minimum((k + dk).clamp(0, levels - 1), top)
        e = err.gather(2, kk[:, :, None])[:, :, 0]
        best_e = e if best_e is None else torch.minimum(e, best_e)
    chosen = err.gather(2, idx[:, :, None])[:, :, 0]
    gap = (chosen - best_e).clamp(min=0.0)
    worse = (gap > 1e-3 * (1.0 + best_e)) & ~ambiguous
    if unsure is not None:
        worse &= ~unsure
    return gap, worse


def _mode_of(bits):
    """Mode of each block: its lowest set bit among bits 0-7; 8 where
    none is set (reserved)."""
    low = bits[:, :8]
    has = low.any(1)
    first = torch.argmax(low, 1)
    return torch.where(has, first, torch.full_like(first, 8))


def analyse(data: torch.Tensor, src: torch.Tensor | None = None, chw=(1.0, 1.0, 1.0, 1.0)):
    """[N,16] uint8 blocks -> (decoded [N,16,4] int64 0..255, valid [N]
    bool, gap [N,16] float64 or None, worse [N,16] bool or None).

    ``src`` [N,16,4] float64 on the 0..255 scale: the reference's source
    texels.  A texel's gap and worse mark are those of ``index_gaps``,
    the gap summed and the marks joined over its index sets, in the
    squared error weighted by ``chw``.  Reserved blocks (mode 8) decode
    to 0, are not valid and have no gap.
    """
    n, dev = data.shape[0], data.device
    bits = unpack_bits(data)
    mode = _mode_of(bits)
    dec = torch.zeros((n, 16, 4), dtype=torch.long, device=dev)
    gap = worse = None
    if src is not None:
        gap = torch.zeros((n, 16), dtype=torch.float64, device=dev)
        worse = torch.zeros((n, 16), dtype=torch.bool, device=dev)
    w = torch.tensor(chw, dtype=torch.float64, device=dev)
    for m in range(8):
        where = torch.nonzero(mode == m)[:, 0]
        if where.numel() == 0:
            continue
        d, sets = _decode_mode(bits[where], m)
        dec[where] = d
        if gap is None:
            continue
        s = src[where]
        g = torch.zeros((where.numel(), 16), dtype=torch.float64, device=dev)
        bad = torch.zeros((where.numel(), 16), dtype=torch.bool, device=dev)
        for item in sets:
            sel, i, pal = (None, *item) if len(item) == 2 else item
            ss = s if sel is None else s[sel]
            part, mark = index_gaps(ss, pal.double(), i, w.sqrt(), w, 1e-10)
            if sel is None:
                g += part
                bad |= mark
            else:
                g[sel] += part
                bad[sel] |= mark
        gap[where] = g
        worse[where] = bad
    return dec, mode < 8, gap, worse


def judge_blocks(blocks: torch.Tensor, src: torch.Tensor, bound: torch.Tensor, config: dict) -> dict:
    """The check's sums over [n,16] block bytes against the reference's
    source blocks [n,16,4] (texture colour space): the gap and the error
    on the 0..255 scale, the channel weights of the configuration.  The
    source is not quantised before the encoder reads it, so the float32
    rounding ``bound`` matters only at a projection's rounding boundary,
    which ``index_gaps`` leaves out already.  ``fit_sum`` is the decoded
blocks' squared error in the channel weights, ``plain_sum`` that of the
reference's own plain fit (``plain_fit_error``) of the same source."""
    ref = src.clamp(0.0, 1.0) * 255.0
    chw = config["channel_weights"]
    dec, ok, gap, worse = analyse(blocks, ref, chw)
    good = ok[:, None]
    w = torch.tensor(chw, dtype=torch.float64, device=ref.device)
    return {
        "bad_blocks": int((~ok).sum()),
        "gap_sum": float((gap * good).sum()),
        "worse_texels": int((worse & good).sum()),
        "err_sum": float((dec.double() - ref).abs().sum()),
        "fit_sum": float((((dec.double() - ref) ** 2) * w).sum()),
        "plain_sum": float(plain_fit_error(ref, chw).sum()),
        "texels": gap.numel(),
        "values": ref.numel(),
    }


def plain_fit_error(src: torch.Tensor, chw) -> torch.Tensor:
    """The weighted squared error of each block of a plain mode-6 fit of
    its own: the principal axis of the block's texels (in the weighted
    space), its ends at the extreme projections, each end quantised to
    seven bits and the p-bit that suits it best, and each texel's nearest
    of the 16 palette entries.  An independent yardstick of how hard a
    block is to encode, which the program's own error is held against.
    src [n,16,4] float64 on the 0..255 scale -> [n] float64."""
    w = torch.tensor(chw, dtype=torch.float64, device=src.device)
    sw = w.sqrt()
    x = src * sw
    mean = x.mean(1, keepdim=True)
    d = x - mean
    cov = d.transpose(1, 2) @ d
    # The principal axis by power iteration from the widest channel's row
    # of the covariance (a flat block keeps a zero axis: both ends at the
    # mean).
    axis = cov.gather(1, cov.diagonal(dim1=1, dim2=2).argmax(1)[:, None, None].expand(-1, 1, 4))
    axis = axis.transpose(1, 2)
    for _ in range(16):
        axis = cov @ axis
        axis = axis / axis.norm(dim=1, keepdim=True).clamp(min=1e-30)
    t = (d @ axis)[:, :, 0]
    ends = mean + torch.stack([t.min(1).values, t.max(1).values], 1)[:, :, None] * axis[:, None, :, 0]
    ends = (ends / sw).clamp(0.0, 255.0)
    best = None
    for p in (0, 1):
        q = ((ends - p) / 2).round().clamp(0, 127) * 2 + p
        e = (((q - ends) * sw) ** 2).sum(-1, keepdim=True)
        best = (q, e) if best is None else (torch.where(e < best[1], q, best[0]), torch.minimum(e, best[1]))
    q = best[0].long()
    pal = _palette(q[:, :1].expand(-1, 16, -1), q[:, 1:].expand(-1, 16, -1), 4).double()
    err = (((src[:, :, None, :] - pal) * sw) ** 2).sum(-1)
    return err.min(2).values.sum(1)


def texel1_msb(block: int) -> int:
    """Bit position of the highest bit of texel 1's index in a BC7 block
    (texel 1 is an anchor in no mode, so its index has all its bits)."""
    bits = unpack_bits(torch.tensor(list(block.to_bytes(16, "little")), dtype=torch.uint8)[None])
    m = int(_mode_of(bits)[0])
    ns, pb, rb, ib, cb, ab, pmode, i1b, _ = MODES[m]
    pbits = {"each": 2 * ns, "shared": ns}.get(pmode, 0)
    start = m + 1 + pb + rb + ib + 6 * ns * cb + 2 * ns * ab + pbits
    return start + 2 * (i1b - 1)
