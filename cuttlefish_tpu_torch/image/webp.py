"""Lossless WebP (VP8L) decoder.

Pure-Python implementation of the VP8L bitstream (the lossless half of
the WebP format): LSB-first bit reading, canonical Huffman trees (simple
and code-length-coded), meta-Huffman groups, the color cache, LZ77
backward references with the 2D distance mapping, and the four inverse
transforms (predictor, color, subtract-green, color-indexing incl.
pixel-bundling).  Lossy VP8 streams raise (PIL covers them).

Validated against PIL byte-for-byte in tests/test_load.py over random
and structured content at several quality/method settings (PIL encodes
with lossless=True; both decoders must agree exactly — VP8L is
lossless, so equality is the spec).

Copied from ``cuttlefish_tpu/image/webp.py`` with its imports pointed at
the port; its logic is unchanged.
"""

from __future__ import annotations

import struct

import numpy as np


class WebpError(ValueError):
    pass


class _Bits:
    """LSB-first bit reader over a byte buffer."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # bit position

    def read(self, n: int) -> int:
        v = 0
        p = self.pos
        d = self.data
        for i in range(n):
            b = p + i
            byte = d[b >> 3] if (b >> 3) < len(d) else 0
            v |= ((byte >> (b & 7)) & 1) << i
        self.pos = p + n
        return v

    def read_bit(self) -> int:
        p = self.pos
        byte = self.data[p >> 3] if (p >> 3) < len(self.data) else 0
        self.pos = p + 1
        return (byte >> (p & 7)) & 1


# order in which code-length code lengths are stored
_CLCL_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13,
               14, 15)


class _Huffman:
    """Canonical Huffman decoder from per-symbol code lengths."""

    __slots__ = ("fast", "fast_bits", "codes", "single")

    def __init__(self, lengths):
        lengths = np.asarray(lengths, np.int32)
        nz = np.nonzero(lengths)[0]
        self.single = None
        if len(nz) == 0:
            raise WebpError("empty Huffman tree")
        if len(nz) == 1:
            self.single = int(nz[0])
            self.fast = None
            return
        max_len = int(lengths.max())
        # canonical code assignment (per the WebP spec / DEFLATE rules)
        bl_count = np.bincount(lengths, minlength=max_len + 1)
        bl_count[0] = 0
        next_code = np.zeros(max_len + 1, np.int64)
        code = 0
        for bits in range(1, max_len + 1):
            code = (code + int(bl_count[bits - 1])) << 1
            next_code[bits] = code
        # build a flat lookup table over max_len bits (max_len <= 15)
        self.fast_bits = max_len
        table_sym = np.full(1 << max_len, -1, np.int32)
        table_len = np.zeros(1 << max_len, np.int32)
        for sym in nz:
            ln = int(lengths[sym])
            c = int(next_code[ln])
            next_code[ln] += 1
            # reverse the code bits (we read LSB-first)
            rev = 0
            for i in range(ln):
                rev |= ((c >> i) & 1) << (ln - 1 - i)
            step = 1 << ln
            for fill in range(rev, 1 << max_len, step):
                table_sym[fill] = sym
                table_len[fill] = ln
        self.fast = (table_sym, table_len)

    def read(self, br: _Bits) -> int:
        if self.single is not None:
            return self.single
        sym_t, len_t = self.fast
        p = br.pos
        d = br.data
        v = 0
        for i in range(self.fast_bits):
            b = p + i
            byte = d[b >> 3] if (b >> 3) < len(d) else 0
            v |= ((byte >> (b & 7)) & 1) << i
        sym = int(sym_t[v])
        if sym < 0:
            raise WebpError("bad Huffman code")
        br.pos = p + int(len_t[v])
        return sym


def _read_huffman_code(br: _Bits, alphabet_size: int) -> _Huffman:
    simple = br.read_bit()
    if simple:
        nsym = br.read_bit() + 1
        first_8 = br.read_bit()
        syms = [br.read(8 if first_8 else 1)]
        if nsym == 2:
            syms.append(br.read(8))
        lengths = np.zeros(alphabet_size, np.int32)
        for s in syms:
            if s >= alphabet_size:
                raise WebpError("simple symbol out of range")
        if nsym == 1:
            lengths[syms[0]] = 1
            h = _Huffman(lengths)
            h.single = syms[0]
            return h
        lengths[syms[0]] = 1
        lengths[syms[1]] = 1
        return _Huffman(lengths)

    # code-length codes
    num_codes = br.read(4) + 4
    cl_lengths = np.zeros(19, np.int32)
    for i in range(num_codes):
        cl_lengths[_CLCL_ORDER[i]] = br.read(3)
    cl_tree = _Huffman(cl_lengths)

    if br.read_bit():  # max_symbol present
        length_nbits = 2 + 2 * br.read(3)
        max_symbol = 2 + br.read(length_nbits)
    else:
        max_symbol = alphabet_size

    lengths = np.zeros(alphabet_size, np.int32)
    prev_len = 8
    sym = 0
    while sym < alphabet_size:
        if max_symbol <= 0:
            break
        max_symbol -= 1
        code = cl_tree.read(br)
        if code < 16:
            lengths[sym] = code
            sym += 1
            if code:
                prev_len = code
        elif code == 16:
            rep = 3 + br.read(2)
            lengths[sym : sym + rep] = prev_len
            sym += rep
        elif code == 17:
            sym += 3 + br.read(3)
        else:  # 18
            sym += 11 + br.read(7)
    return _Huffman(lengths)


_NUM_LITERAL = 256 + 24  # green: literals + length prefixes (+ cache later)
_NUM_DISTANCE = 40

# 2D distance mapping for codes 1..120: the neighborhood (dx, dy)
# offsets sorted by squared distance (ascending), then dy (descending),
# then dx (positive before negative) — the first 120 of the
# {dy 0..7, dx -8..8, dy>0 or dx>0} candidate set.  This generative rule
# reproduces libwebp's table (validated transitively: LZ77-heavy PIL
# fixtures decode byte-equal in tests/test_load.py).
def _gen_dist_map():
    cands = []
    for dy in range(8):
        for dx in range(-8, 9):
            if dy == 0 and dx <= 0:
                continue
            cands.append((dx, dy))
    cands.sort(key=lambda p: (p[0] * p[0] + p[1] * p[1], -p[1], -p[0]))
    return tuple(cands[:120])


_DIST_MAP = _gen_dist_map()
assert len(_DIST_MAP) == 120
assert _DIST_MAP[:8] == (
    (0, 1), (1, 0), (1, 1), (-1, 1), (0, 2), (2, 0), (1, 2), (-1, 2)
)


def _prefix_value(br: _Bits, code: int) -> int:
    """LZ77 length/distance prefix code -> value (spec 'prefix coding')."""
    if code < 4:
        return code + 1
    extra = (code - 2) >> 1
    offset = (2 + (code & 1)) << extra
    return offset + br.read(extra) + 1


def _div_round_up(a: int, b: int) -> int:
    return (a + b - 1) // b


def _decode_image(br: _Bits, w: int, h: int, allow_recursion: bool):
    """Decode a VP8L 'spatially coded image' -> uint32 ARGB [h, w]."""
    # transforms apply to the top-level image only
    return _decode_entropy_image(br, w, h, allow_recursion)


def _decode_entropy_image(br: _Bits, w: int, h: int, is_main: bool):
    transforms = []
    xsize = w
    if is_main:
        while br.read_bit():
            ttype = br.read(2)
            if ttype in (0, 1):  # predictor / color transform
                size_bits = br.read(3) + 2
                tw = _div_round_up(xsize, 1 << size_bits)
                th = _div_round_up(h, 1 << size_bits)
                timg = _decode_entropy_image(br, tw, th, False)
                transforms.append((ttype, size_bits, timg))
            elif ttype == 2:  # subtract green
                transforms.append((2, None, None))
            elif ttype == 3:  # color indexing
                ncolors = br.read(8) + 1
                pal = _decode_entropy_image(br, ncolors, 1, False)
                # palettes are delta-coded left-to-right
                pal = pal[0]
                acc = np.zeros(4, np.uint8)
                out_pal = np.zeros((ncolors, 4), np.uint8)
                for i in range(ncolors):
                    px = pal[i]
                    comp = np.array(
                        [(px >> 24) & 0xFF, (px >> 16) & 0xFF,
                         (px >> 8) & 0xFF, px & 0xFF], np.uint16
                    )
                    acc = ((acc.astype(np.uint16) + comp) & 0xFF).astype(
                        np.uint8
                    )
                    out_pal[i] = acc
                if ncolors <= 2:
                    width_bits = 3
                elif ncolors <= 4:
                    width_bits = 2
                elif ncolors <= 16:
                    width_bits = 1
                else:
                    width_bits = 0
                transforms.append((3, width_bits, out_pal))
                xsize = _div_round_up(xsize, 1 << width_bits)
            else:
                raise WebpError("bad transform type")

    # color cache
    cache_bits = 0
    if br.read_bit():
        cache_bits = br.read(4)
        if cache_bits < 1 or cache_bits > 11:
            raise WebpError("bad color cache size")

    # meta-Huffman
    if is_main and br.read_bit():
        meta_bits = br.read(3) + 2
        mw = _div_round_up(xsize, 1 << meta_bits)
        mh = _div_round_up(h, 1 << meta_bits)
        meta = _decode_entropy_image(br, mw, mh, False)
        # group index = (red << 8) | green
        meta_idx = (((meta >> 16) & 0xFF) << 8) | ((meta >> 8) & 0xFF)
        num_groups = int(meta_idx.max()) + 1
    else:
        meta_bits = 0
        meta_idx = None
        num_groups = 1

    green_size = _NUM_LITERAL + (1 << cache_bits if cache_bits else 0)
    groups = []
    for _ in range(num_groups):
        g = _read_huffman_code(br, green_size)
        r = _read_huffman_code(br, 256)
        b = _read_huffman_code(br, 256)
        a = _read_huffman_code(br, 256)
        d = _read_huffman_code(br, _NUM_DISTANCE)
        groups.append((g, r, b, a, d))

    cache = (
        np.zeros(1 << cache_bits, np.uint32) if cache_bits else None
    )

    def cache_insert(px):
        # hash = (0x1E35A7BD * px) mod 2^32 >> (32 - cache_bits)
        cache[
            ((0x1E35A7BD * int(px)) & 0xFFFFFFFF) >> (32 - cache_bits)
        ] = px

    npix = xsize * h
    out = np.zeros(npix, np.uint32)
    pos = 0
    gcur = groups[0]
    last_meta_x = -1
    while pos < npix:
        if meta_idx is not None:
            x = pos % xsize
            y = pos // xsize
            mx = x >> meta_bits
            if mx != last_meta_x or x == 0:
                gcur = groups[int(meta_idx[y >> meta_bits, mx])]
                last_meta_x = mx
        gtree, rtree, btree, atree, dtree = gcur
        code = gtree.read(br)
        if code < 256:  # literal
            red = rtree.read(br)
            blue = btree.read(br)
            alpha = atree.read(br)
            px = (alpha << 24) | (red << 16) | (code << 8) | blue
            out[pos] = px
            if cache is not None:
                cache_insert(px)
            pos += 1
        elif code < 256 + 24:  # LZ77 backward reference
            length = _prefix_value(br, code - 256)
            dist_code = _prefix_value(br, dtree.read(br))
            if dist_code > 120:
                dist = dist_code - 120
            else:
                dx, dy = _DIST_MAP[dist_code - 1]
                dist = dy * xsize + dx
                if dist < 1:
                    dist = 1
            if dist > pos:
                raise WebpError("distance before start")
            for _ in range(length):
                if pos >= npix:
                    break
                px = out[pos - dist]
                out[pos] = px
                if cache is not None:
                    cache_insert(px)
                pos += 1
        else:  # color cache
            px = cache[code - 256 - 24]
            out[pos] = px
            # cache hits re-insert (hash of the same pixel: no-op)
            pos += 1

    img = out.reshape(h, xsize)

    # apply inverse transforms in reverse order
    for ttype, p1, p2 in reversed(transforms):
        if ttype == 3:
            img = _inverse_color_indexing(img, p1, p2, w)
        elif ttype == 2:
            img = _inverse_subtract_green(img)
        elif ttype == 1:
            img = _inverse_color_transform(img, p1, p2)
        elif ttype == 0:
            img = _inverse_predictor(img, p1, p2)
    return img


def _inverse_subtract_green(img):
    g = (img >> np.uint32(8)) & np.uint32(0xFF)
    r = (((img >> np.uint32(16)) & np.uint32(0xFF)) + g) & np.uint32(0xFF)
    b = ((img & np.uint32(0xFF)) + g) & np.uint32(0xFF)
    return (
        (img & np.uint32(0xFF00FF00)) | (r << np.uint32(16)) | b
    ).astype(np.uint32)


def _inverse_color_indexing(img, width_bits, palette, full_w):
    h = img.shape[0]
    idx = (img >> np.uint32(8)) & np.uint32(0xFF)  # green channel
    if width_bits == 0:
        indices = idx
    else:
        per = 1 << width_bits
        bits = 8 >> width_bits  # bits per pixel index
        cols = []
        for k in range(per):
            cols.append((idx >> np.uint32(k * bits)) & np.uint32(
                (1 << bits) - 1
            ))
        indices = np.stack(cols, axis=-1).reshape(h, -1)
    indices = indices[:, :full_w].astype(np.int64)
    pal = palette.astype(np.uint32)
    px = (
        (pal[:, 0] << np.uint32(24)) | (pal[:, 1] << np.uint32(16))
        | (pal[:, 2] << np.uint32(8)) | pal[:, 3]
    )
    # spec: indices beyond the palette decode to 0x00000000
    oob = indices >= palette.shape[0]
    return np.where(oob, np.uint32(0), px[np.where(oob, 0, indices)])


def _inverse_color_transform(img, size_bits, timg):
    h, w = img.shape
    out = img.copy()
    # element packing (libwebp): green_to_red in the BLUE byte,
    # green_to_blue in the GREEN byte, red_to_blue in the RED byte.
    g2r = (timg & np.uint32(0xFF)).astype(np.int8)
    g2b = ((timg >> np.uint32(8)) & np.uint32(0xFF)).astype(np.int8)
    r2b = ((timg >> np.uint32(16)) & np.uint32(0xFF)).astype(np.int8)
    by = np.arange(h) >> size_bits
    bx = np.arange(w) >> size_bits
    cg2r = g2r[by][:, bx].astype(np.int32)
    cg2b = g2b[by][:, bx].astype(np.int32)
    cr2b = r2b[by][:, bx].astype(np.int32)
    g = ((out >> np.uint32(8)) & np.uint32(0xFF)).astype(np.int32)
    r = ((out >> np.uint32(16)) & np.uint32(0xFF)).astype(np.int32)
    b = (out & np.uint32(0xFF)).astype(np.int32)

    def s8(v):
        return np.where(v >= 128, v - 256, v)

    gsig = s8(g)
    r = (r + ((cg2r * gsig) >> 5)) & 0xFF
    rsig = s8(r)
    b = (b + ((cg2b * gsig) >> 5) + ((cr2b * rsig) >> 5)) & 0xFF
    return (
        (out & np.uint32(0xFF00FF00))
        | (r.astype(np.uint32) << np.uint32(16))
        | b.astype(np.uint32)
    )


def _unpack(img):
    a = (img >> np.uint32(24)) & np.uint32(0xFF)
    r = (img >> np.uint32(16)) & np.uint32(0xFF)
    g = (img >> np.uint32(8)) & np.uint32(0xFF)
    b = img & np.uint32(0xFF)
    return (
        a.astype(np.int32), r.astype(np.int32), g.astype(np.int32),
        b.astype(np.int32),
    )


def _pack(a, r, g, b):
    return (
        (a.astype(np.uint32) << np.uint32(24))
        | (r.astype(np.uint32) << np.uint32(16))
        | (g.astype(np.uint32) << np.uint32(8))
        | b.astype(np.uint32)
    )


def _clamp_add_subtract_full(c1, c2, c3):
    return np.clip(c1 + c2 - c3, 0, 255)


def _clamp_add_subtract_half(c1, c2):
    return np.clip(c1 + (c1 - c2) // 2, 0, 255)


def _inverse_predictor(img, size_bits, timg):
    """Predictor transform inverse (spec 4.1): residuals + prediction,
    per component mod 256.  TR at the right edge reads the flat-buffer
    neighbor argb[(y-1)*w + x + 1], i.e. the first pixel of row y."""
    h, w = img.shape
    modes = ((timg >> np.uint32(8)) & np.uint32(0xFF)).astype(np.int32)
    out = img.astype(np.uint32).copy()

    def comps(v):
        return np.array(
            [(v >> 24) & 0xFF, (v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF],
            np.int32,
        )

    def pack1(val):
        return np.uint32(
            (int(val[0]) << 24) | (int(val[1]) << 16)
            | (int(val[2]) << 8) | int(val[3])
        )

    black = comps(0xFF000000)
    for y in range(h):
        for x in range(w):
            if x == 0 and y == 0:
                p = black
            elif y == 0:
                p = comps(int(out[0, x - 1]))
            elif x == 0:
                p = comps(int(out[y - 1, 0]))
            else:
                mode = int(modes[y >> size_bits, x >> size_bits])
                L = comps(int(out[y, x - 1]))
                T = comps(int(out[y - 1, x]))
                TL = comps(int(out[y - 1, x - 1]))
                TR = (
                    comps(int(out[y - 1, x + 1]))
                    if x + 1 < w
                    else comps(int(out[y, 0]))
                )
                if mode == 0:
                    p = black
                elif mode == 1:
                    p = L
                elif mode == 2:
                    p = T
                elif mode == 3:
                    p = TR
                elif mode == 4:
                    p = TL
                elif mode == 5:
                    p = ((L + TR) // 2 + T) // 2
                elif mode == 6:
                    p = (L + TL) // 2
                elif mode == 7:
                    p = (L + T) // 2
                elif mode == 8:
                    p = (TL + T) // 2
                elif mode == 9:
                    p = (T + TR) // 2
                elif mode == 10:
                    p = ((L + TL) // 2 + (T + TR) // 2) // 2
                elif mode == 11:  # Select
                    pred_full = L + T - TL
                    pL = np.abs(pred_full - L).sum()
                    pT = np.abs(pred_full - T).sum()
                    p = L if pL < pT else T
                elif mode == 12:
                    p = np.clip(L + T - TL, 0, 255)
                elif mode == 13:
                    avg = (L + T) // 2
                    p = np.clip(avg + (avg - TL) // 2, 0, 255)
                else:
                    raise WebpError("bad predictor mode")
            cur = comps(int(out[y, x]))
            out[y, x] = pack1((cur + p) & 0xFF)
    return out


def decode_webp_lossless(data: bytes) -> np.ndarray:
    """WebP bytes -> RGBA8 array (VP8L streams only)."""
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise WebpError("not a WebP file")
    pos = 12
    payload = None
    while pos + 8 <= len(data):
        tag = data[pos : pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        body = data[pos + 8 : pos + 8 + size]
        if tag == b"VP8L":
            payload = body
            break
        if tag == b"VP8 ":
            raise WebpError("lossy WebP (VP8) not supported natively")
        pos += 8 + size + (size & 1)
    if payload is None:
        raise WebpError("no VP8L chunk")
    if not payload or payload[0] != 0x2F:
        raise WebpError("bad VP8L signature")
    br = _Bits(payload[1:])
    w = br.read(14) + 1
    h = br.read(14) + 1
    br.read_bit()  # alpha hint
    if br.read(3) != 0:
        raise WebpError("bad VP8L version")
    img = _decode_image(br, w, h, True)
    a = ((img >> np.uint32(24)) & np.uint32(0xFF)).astype(np.uint8)
    r = ((img >> np.uint32(16)) & np.uint32(0xFF)).astype(np.uint8)
    g = ((img >> np.uint32(8)) & np.uint32(0xFF)).astype(np.uint8)
    b = (img & np.uint32(0xFF)).astype(np.uint8)
    return np.stack([r, g, b, a], axis=-1)
