"""BC6H decoder of the plain reference, vectorised in PyTorch, and the
index gap that judges the encoder's indices.

Written from the D3D11 functional spec (BC6H format, unsigned: UF16):
all 14 modes (the ten two-region modes with their transformed or direct
endpoints, the one-region 10.10, 11.9, 12.8 and 16.4 modes), the 32
two-subset partitions with their anchors, the four reserved mode headers
(decoded to 0 and not valid), unquantisation, the 64-weight
interpolation and the finishing step to half-float bits.  Each block is read
bit by bit from its 128 bits, so the same code runs on the CPU and on the
card.  It imports nothing of the program.

The units: a texel's value is its half-float code (``proxy``, the IEEE
binary16 bits read as an integer, clamped to the largest finite half;
negative values 0), so errors are in half-float code steps, the same
relative precision at every brightness.  ``err_mean`` is the mean
absolute code difference of every decoded channel from the reference's
source.  The fit ratio is read in linear value, each block's error
relative to the plain fit's (``judge_blocks``).

The index gap follows the selection rule that the encoder states for
its ``value`` metric (``kernels/bc6h.py:_nearest_index`` and
``csrc/bc6h_encode.cu:nearest_index`` of the program, read, not
imported): project the texel's code on the line between the finished end
entries of its region (codes, unweighted), round to the nearest index,
keep the best of it and its two neighbours by the linearised error, in
which each channel's code difference is scaled by the value step of the
texel's own code (2^(e-25) in exponent segment e, 2^-24 among the
denormals), ties to the lower index; then the two anchors of a
two-region block store at most index 3.  The gap is how
much the stored entry's linearised error exceeds that baseline's.  The
texel is read as the encoder reads it: the half-float code of the
source, rounded to nearest even.  Where the float32 chain the program
builds may round to another code than the reference's float64 chain
(the rounding bound spans a code boundary), the texel is left out of
``worse_texels``.
"""

from __future__ import annotations

import re

import torch

from . import bc7_tables as T
from .bc7 import unpack_bits

# DDS: DXGI_FORMAT_BC6H_UF16 (95), and the DX10 alpha mode: 3,
# DDS_ALPHA_MODE_OPAQUE, which the reference project's writer
# (lib/src/SaveDds.cpp:611-655) sets for a format that holds no alpha.
DDS_ALPHA_MODE = 3


def dds_format(type_: str, srgb: bool) -> int:
    return {"UFloat": 95}[type_]


HALF_MAX = 0x7BFF

# The spec's endpoint layouts, from bit 0 up: m = the mode bits; r0/g0/b0
# the base (region 0, end 0), r1.. region 0 end 1, r2.. region 1 end 0,
# r3.. region 1 end 1.  A field x[a:b] holds bits b .. a of the value
# in storage order (b lowest), so x[10:15] stores bit 15 first.
_LAYOUTS = {
    1: "m[1:0],g2[4],b2[4],b3[4],r0[9:0],g0[9:0],b0[9:0],r1[4:0],g3[4],g2[3:0],g1[4:0],b3[0],"
       "g3[3:0],b1[4:0],b3[1],b2[3:0],r2[4:0],b3[2],r3[4:0],b3[3]",
    2: "m[1:0],g2[5],g3[4],g3[5],r0[6:0],b3[0],b3[1],b2[4],g0[6:0],b2[5],b3[2],g2[4],b0[6:0],"
       "b3[3],b3[5],b3[4],r1[5:0],g2[3:0],g1[5:0],g3[3:0],b1[5:0],b2[3:0],r2[5:0],r3[5:0]",
    3: "m[4:0],r0[9:0],g0[9:0],b0[9:0],r1[4:0],r0[10],g2[3:0],g1[3:0],g0[10],b3[0],g3[3:0],"
       "b1[3:0],b0[10],b3[1],b2[3:0],r2[4:0],b3[2],r3[4:0],b3[3]",
    4: "m[4:0],r0[9:0],g0[9:0],b0[9:0],r1[3:0],r0[10],g3[4],g2[3:0],g1[4:0],g0[10],g3[3:0],"
       "b1[3:0],b0[10],b3[1],b2[3:0],r2[3:0],b3[0],b3[2],r3[3:0],g2[4],b3[3]",
    5: "m[4:0],r0[9:0],g0[9:0],b0[9:0],r1[3:0],r0[10],b2[4],g2[3:0],g1[3:0],g0[10],b3[0],"
       "g3[3:0],b1[4:0],b0[10],b2[3:0],r2[3:0],b3[1],b3[2],r3[3:0],b3[4],b3[3]",
    6: "m[4:0],r0[8:0],b2[4],g0[8:0],g2[4],b0[8:0],b3[4],r1[4:0],g3[4],g2[3:0],g1[4:0],b3[0],"
       "g3[3:0],b1[4:0],b3[1],b2[3:0],r2[4:0],b3[2],r3[4:0],b3[3]",
    7: "m[4:0],r0[7:0],g3[4],b2[4],g0[7:0],b3[2],g2[4],b0[7:0],b3[3],b3[4],r1[5:0],g2[3:0],"
       "g1[4:0],b3[0],g3[3:0],b1[4:0],b3[1],b2[3:0],r2[5:0],r3[5:0]",
    8: "m[4:0],r0[7:0],b3[0],b2[4],g0[7:0],g2[5],g2[4],b0[7:0],g3[5],b3[4],r1[4:0],g3[4],"
       "g2[3:0],g1[5:0],g3[3:0],b1[4:0],b3[1],b2[3:0],r2[4:0],b3[2],r3[4:0],b3[3]",
    9: "m[4:0],r0[7:0],b3[1],b2[4],g0[7:0],b2[5],g2[4],b0[7:0],b3[5],b3[4],r1[4:0],g3[4],"
       "g2[3:0],g1[4:0],b3[0],g3[3:0],b1[5:0],b2[3:0],r2[4:0],b3[2],r3[4:0],b3[3]",
    10: "m[4:0],r0[5:0],g3[4],b3[0],b3[1],b2[4],g0[5:0],g2[5],b2[5],b3[2],g2[4],b0[5:0],g3[5],"
        "b3[3],b3[5],b3[4],r1[5:0],g2[3:0],g1[5:0],g3[3:0],b1[5:0],b2[3:0],r2[5:0],r3[5:0]",
    11: "m[4:0],r0[9:0],g0[9:0],b0[9:0],r1[9:0],g1[9:0],b1[9:0]",
    12: "m[4:0],r0[9:0],g0[9:0],b0[9:0],r1[8:0],r0[10],g1[8:0],g0[10],b1[8:0],b0[10]",
    13: "m[4:0],r0[9:0],g0[9:0],b0[9:0],r1[7:0],r0[10:11],g1[7:0],g0[10:11],b1[7:0],b0[10:11]",
    14: "m[4:0],r0[9:0],g0[9:0],b0[9:0],r1[3:0],r0[10:15],g1[3:0],g0[10:15],b1[3:0],b0[10:15]",
}
# mode -> (header value, header bits, endpoint bits, delta bits per channel
# or None where the endpoints are stored whole)
MODES = {
    1: (0b00, 2, 10, (5, 5, 5)),
    2: (0b01, 2, 7, (6, 6, 6)),
    3: (0b00010, 5, 11, (5, 4, 4)),
    4: (0b00110, 5, 11, (4, 5, 4)),
    5: (0b01010, 5, 11, (4, 4, 5)),
    6: (0b01110, 5, 9, (5, 5, 5)),
    7: (0b10010, 5, 8, (6, 5, 5)),
    8: (0b10110, 5, 8, (5, 6, 5)),
    9: (0b11010, 5, 8, (5, 5, 6)),
    10: (0b11110, 5, 6, None),
    11: (0b00011, 5, 10, None),
    12: (0b00111, 5, 11, (9, 9, 9)),
    13: (0b01011, 5, 12, (8, 8, 8)),
    14: (0b01111, 5, 16, (4, 4, 4)),
}
_TOKEN = re.compile(r"([mrgb])(\d?)\[(\d+)(?::(\d+))?\]")


def _layout(mode: int) -> list[tuple[int, int, int, int]]:
    """(block bit, field 0-3, channel 0-2, value bit) of every endpoint
    bit of a mode."""
    out, pos = [], 0
    for tok in _LAYOUTS[mode].split(","):
        ch, fld, a, b = _TOKEN.fullmatch(tok).groups()
        a = int(a)
        b = a if b is None else int(b)
        step = 1 if a >= b else -1
        for bit in range(b, a + step, step):
            if ch != "m":
                out.append((pos, int(fld), "rgb".index(ch), bit))
            pos += 1
    assert pos == (77 if mode <= 10 else 65), (mode, pos)
    return out


_MATRICES: dict = {}


def _field_matrix(mode: int, device) -> torch.Tensor:
    """[128, 12] float64: block bits -> the 4 x 3 endpoint fields."""
    key = (mode, str(device))
    if key not in _MATRICES:
        m = torch.zeros((128, 12), dtype=torch.float64)
        for pos, fld, ch, bit in _layout(mode):
            m[pos, fld * 3 + ch] = float(1 << bit)
        _MATRICES[key] = m.to(device)
    return _MATRICES[key]


def _unquantize(q: torch.Tensor, bits: int) -> torch.Tensor:
    if bits >= 15:
        return q
    u = ((q << 16) + 0x8000) >> bits
    return torch.where(q == 0, 0, torch.where(q == (1 << bits) - 1, 0xFFFF, u))


def _finish(v: torch.Tensor) -> torch.Tensor:
    """Interpolated component -> half-float bits, as an integer code."""
    return (v * 31) >> 6


def _mode_of(bits: torch.Tensor) -> torch.Tensor:
    """Mode 1-14 of each block, 0 for a reserved header."""
    low2 = bits[:, 0] | (bits[:, 1] << 1)
    low5 = low2 | (bits[:, 2] << 2) | (bits[:, 3] << 3) | (bits[:, 4] << 4)
    mode = torch.zeros_like(low2)
    for m, (value, nbits, _, _) in MODES.items():
        mode = torch.where((low2 if nbits == 2 else low5) == value, m, mode)
    return mode


def _endpoints(bits: torch.Tensor, m: int) -> torch.Tensor:
    """Blocks of mode m -> unquantised endpoints [n, regions, 2, 3]."""
    _, _, ep, delta = MODES[m]
    f = (bits.double() @ _field_matrix(m, bits.device)).long().reshape(-1, 4, 3)
    nf = 4 if m <= 10 else 2
    f = f[:, :nf]
    if delta is not None:
        d = torch.tensor(delta, device=bits.device)
        rest = f[:, 1:] - ((f[:, 1:] >> (d - 1)) & 1) * 2**d  # sign-extended by channel
        f[:, 1:] = (f[:, :1] + rest) & ((1 << ep) - 1)
    return _unquantize(f, ep).reshape(-1, nf // 2, 2, 3)


def _indices(bits: torch.Tensor, m: int, part: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (indices [n,16], anchor [n,16]: texels whose index has one bit
    less)."""
    n, dev = bits.shape[0], bits.device
    anchor = torch.zeros((n, 16), dtype=torch.bool, device=dev)
    anchor[:, 0] = True
    if m <= 10:
        anchor.scatter_(1, torch.as_tensor(T.ANCHOR2, device=dev).long()[part][:, None], True)
        pos, nbits = 82, 3
    else:
        pos, nbits = 65, 4
    width = nbits - anchor.long()
    start = pos + torch.cumsum(width, 1) - width
    ks = torch.arange(nbits, device=dev)
    at = (start[:, :, None] + ks).clamp_(max=127).reshape(n, -1)
    vals = bits.gather(1, at).reshape(n, 16, nbits)
    idx = ((vals * (ks < width[:, :, None])) << ks).sum(-1)
    return idx, anchor


def decode(data: torch.Tensor):
    """[N,16] uint8 blocks -> (codes [N,16,3] int64: each texel's half
    bits as an integer; valid [N] bool;
    mode [N]; the texels' palettes [N,16,L,3] of finished codes, L = 8 or
    16 by mode, padded to 16 by repeating the last; indices [N,16];
    anchor [N,16]; two_region [N])."""
    n, dev = data.shape[0], data.device
    bits = unpack_bits(data)
    mode = _mode_of(bits)
    codes = torch.zeros((n, 16, 3), dtype=torch.long, device=dev)
    pal = torch.zeros((n, 16, 16, 3), dtype=torch.long, device=dev)
    idx = torch.zeros((n, 16), dtype=torch.long, device=dev)
    anchor = torch.zeros((n, 16), dtype=torch.bool, device=dev)
    for m in MODES:
        where = torch.nonzero(mode == m)[:, 0]
        if where.numel() == 0:
            continue
        b = bits[where]
        ends = _endpoints(b, m)
        k = where.numel()
        if m <= 10:
            part = sum(b[:, 77 + i] << i for i in range(5))
            region = torch.as_tensor(T.PARTITION2, device=dev).long()[part]
            weights = torch.as_tensor(T.WEIGHTS3, device=dev).long()
        else:
            part = torch.zeros(k, dtype=torch.long, device=dev)
            region = torch.zeros((k, 16), dtype=torch.long, device=dev)
            weights = torch.as_tensor(T.WEIGHTS4, device=dev).long()
        i, a = _indices(b, m, part)
        e = ends.gather(1, region[:, :, None, None].expand(k, 16, 2, 3))  # [k,16,2,3]
        w = weights[None, None, :, None]
        p = _finish((e[:, :, None, 0] * (64 - w) + e[:, :, None, 1] * w + 32) >> 6)
        levels = weights.numel()
        if levels < 16:
            p = torch.cat([p, p[:, :, -1:].expand(k, 16, 16 - levels, 3)], 2)
        pal[where] = p
        idx[where] = i
        anchor[where] = a
        codes[where] = p.gather(2, i[:, :, None, None].expand(k, 16, 1, 3))[:, :, 0]
    return codes, mode > 0, mode, pal, idx, anchor, (mode >= 1) & (mode <= 10)


def to_float(codes: torch.Tensor) -> torch.Tensor:
    """Half-float codes -> float64 values."""
    a = codes.double()
    e = torch.floor(a / 1024.0)
    return torch.where(e == 0, a * 2.0**-24, torch.exp2(e - 25.0) * (1024.0 + a - e * 1024.0))


def proxy(x: torch.Tensor) -> torch.Tensor:
    """float64 values -> their half-float codes as the encoder reads them:
    rounded to nearest even, clamped to the largest finite half, negatives
    0.  -> int64."""
    a = x.abs()
    mant, ex = torch.frexp(a)  # a = mant * 2^ex, mant in [0.5, 1)
    normal = (ex >= -13) & (a > 0)  # a >= 2^-14
    frac = torch.where(normal, (mant * 2.0 - 1.0) * 1024.0, a * 2.0**24)
    code = torch.round(frac) + torch.where(normal, (ex.double() + 14.0) * 1024.0, 0.0)
    code = code.clamp(max=float(HALF_MAX)).long()
    return torch.where(x < 0, 0, code)


def value_step(code: torch.Tensor) -> torch.Tensor:
    """The value step of one code at this code (2^(e-25) in exponent
    segment e, 2^-24 among the denormals), as the encoder linearises."""
    e = torch.floor(code.double() / 1024.0).clamp(min=1.0)
    return torch.exp2(e - 25.0)


def index_gaps(px: torch.Tensor, pal: torch.Tensor, idx: torch.Tensor, anchor2: torch.Tensor,
               levels: int, scale: torch.Tensor):
    """The gap and the worse mark of each stored index against the
    baseline selection (the module's docstring).  px [n,16,3] and pal
    [n,16,L,3] codes, anchor2 [n,16] the texels that store at most index
    3, scale [n,16,3] the linearisation -> (gap [n,16] float64, worse
    [n,16] bool, ambiguous [n,16] bool)."""
    p = pal[:, :, :levels].double()
    x = px.double()
    err = (((x[:, :, None] - p) * scale[:, :, None]) ** 2).sum(-1)
    lo, hi = p[:, :, 0], p[:, :, -1]
    dd = hi - lo
    t = (((x - lo) * dd).sum(-1) / ((dd * dd).sum(-1) + 1e-6)).clamp(0.0, 1.0)
    at = t * (levels - 1)
    k = torch.round(at).long()
    ambiguous = ((at - torch.floor(at)) - 0.5).abs() < 0.01
    best_k = best_e = None
    for dk in (-1, 0, 1):
        kk = (k + dk).clamp(0, levels - 1)
        e = err.gather(2, kk[:, :, None])[:, :, 0]
        if best_e is None:
            best_k, best_e = kk, e
        else:
            take = e < best_e
            best_k = torch.where(take, kk, best_k)
            best_e = torch.minimum(e, best_e)
    best_k = torch.where(anchor2, best_k.clamp(max=3), best_k)
    base = err.gather(2, best_k[:, :, None])[:, :, 0]
    chosen = err.gather(2, idx[:, :, None])[:, :, 0]
    gap = (chosen - base).clamp(min=0.0)
    worse = gap > 1e-3 * base + 1e-3 * (scale * scale).sum(-1)
    return gap, worse, ambiguous


def analyse(data: torch.Tensor, src: torch.Tensor, bound: torch.Tensor | None):
    """[N,16] block bytes and the reference's source texels [N,16,3]
    float64 (with the float32 chain's rounding bound, or None) -> (codes
    [N,16,3], valid [N], px [N,16,3], gap [N,16], worse [N,16])."""
    codes, valid, mode, pal, idx, anchor, two = decode(data)
    px = proxy(src)
    unsure = torch.zeros(px.shape[:2], dtype=torch.bool, device=px.device)
    if bound is not None:
        unsure = (proxy(src - bound) != proxy(src + bound)).any(-1)
    scale = value_step(px)
    gap = torch.zeros(px.shape[:2], dtype=torch.float64, device=px.device)
    worse = torch.zeros_like(unsure)
    for levels, sel in ((8, two), (16, valid & ~two)):
        if not bool(sel.any()):
            continue
        a2 = anchor[sel] if levels == 8 else torch.zeros_like(anchor[sel])
        g, w, amb = index_gaps(px[sel], pal[sel], idx[sel], a2, levels, scale[sel])
        gap[sel] = g
        worse[sel] = w & ~amb & ~unsure[sel]
    return codes, valid, px, gap, worse


def judge_blocks(blocks: torch.Tensor, src: torch.Tensor, bound: torch.Tensor | None, config: dict) -> dict:
    """The check's sums over [n,16] block bytes against the reference's
    source blocks [n,16,4] (linear light, float64) and the float32
    chain's rounding bound [n,16,4]: the index gap in the linearised
    error of the ``value`` metric; ``err_sum`` the absolute half-float
    code difference of every channel from the source's code; ``fit_sum``
    and ``plain_sum`` the squared error in linear value of the decoded
    block and of the reference's plain fit (``plain_fit_error``), each
    block's over the sum of its plain fit's error and its floor (every
    channel off by half a code step, the least that half floats allow),
    summed over the blocks.  So each block weighs by its error relative
    to the plain fit's, not by its brightness (a sun's block would
    outweigh the sky's thousands), and a block that the plain fit already
    encodes to the half floats' rounding weighs little."""
    if (config["type"], config.get("hdr_metric", "value")) != ("UFloat", "value"):
        raise ValueError("the BC6H reference judges UFloat with the value metric only")
    b = None if bound is None else bound[..., :3].double()
    codes, ok, px, gap, worse = analyse(blocks, src[..., :3].double(), b)
    good = ok[:, None]
    scale = value_step(px)
    plain = plain_fit_error(px)
    weight = 1.0 / (plain + (0.25 * scale * scale).sum((1, 2)))
    fit = ((to_float(codes) - to_float(px)) ** 2).sum((1, 2))
    return {
        "bad_blocks": int((~ok).sum()),
        "gap_sum": float((gap * good).sum()),
        "worse_texels": int((worse & good).sum()),
        "err_sum": float((codes - px).abs().sum()),
        "fit_sum": float((fit * weight).sum()),
        "plain_sum": float((plain * weight).sum()),
        "texels": gap.numel(),
        "values": px.numel(),
    }


def plain_fit_error(px: torch.Tensor) -> torch.Tensor:
    """The squared error, in linear value, of each block of a plain
    one-region fit of its own: mode 11 (10-bit endpoints) along the
    principal axis of the block's codes, its ends at the extreme
    projections, each end channel quantised to the 10-bit value whose
    finished code lies nearest, and each texel's nearest of the 16
    palette entries in value.  An independent yardstick of how hard a
    block is to encode, which the program's own error is held against.
    px [n,16,3] codes -> [n] float64."""
    x = px.double()
    mean = x.mean(1, keepdim=True)
    d = x - mean
    cov = d.transpose(1, 2) @ d
    axis = cov.gather(1, cov.diagonal(dim1=1, dim2=2).argmax(1)[:, None, None].expand(-1, 1, 3))
    axis = axis.transpose(1, 2)
    for _ in range(16):
        axis = cov @ axis
        axis = axis / axis.norm(dim=1, keepdim=True).clamp(min=1e-30)
    t = (d @ axis)[:, :, 0]
    ends = mean + torch.stack([t.min(1).values, t.max(1).values], 1)[:, :, None] * axis[:, None, :, 0]
    base = torch.round(ends / 31.0).long()  # a 10-bit end q finishes at about 31 q codes
    best_q = best_e = None
    for dq in (-1, 0, 1):
        q = (base + dq).clamp(0, 1023)
        err = (_finish(_unquantize(q, 10)).double() - ends) ** 2
        if best_q is None:
            best_q, best_e = q, err
        else:
            take = err < best_e
            best_q = torch.where(take, q, best_q)
            best_e = torch.minimum(err, best_e)
    u = _unquantize(best_q, 10)  # [n,2,3]
    w = torch.as_tensor(T.WEIGHTS4, device=px.device).long()[None, :, None]
    pal = to_float(_finish((u[:, :1] * (64 - w) + u[:, 1:] * w + 32) >> 6))  # [n,16,3]
    err = ((to_float(px)[:, :, None] - pal[:, None]) ** 2).sum(-1)
    return err.min(2).values.sum(1)


def texel1_msb(block: int) -> int:
    """Bit position of the highest bit of texel 1's index in a BC6H block
    (texel 1 is an anchor of none of the 32 partitions, so its index has
    all its bits: 3 from bit 84 in a two-region mode, 4 from bit 68 in a
    one-region mode)."""
    bits = torch.tensor([(block >> i) & 1 for i in range(128)])[None]
    m = int(_mode_of(bits)[0])
    if m == 0:
        raise ValueError("reserved BC6H mode")
    return 86 if m <= 10 else 71
