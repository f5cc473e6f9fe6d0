"""ASTC Integer Sequence Encoding (trits/quints) and unquantization.

Host-side numpy tables + layout helpers shared by the encoder
(`kernels/astc.py`) and the spec decoder (`decode/astc.py`).  Replaces the
round-1 bits-only subset with the full ISE ladder the reference's astcenc
uses (the presets of Cuttlefish's `lib/src/AstcConverter.cpp` lean on fine
weight/endpoint ranges).

Every table here is validated bit-exactly against Mesa llvmpipe's
independent ASTC decoder in tests/test_gl_parity.py (probe blocks sweep
each quantized value of each range and read the decoded result back).

Terminology: an ISE range is (levels, kind, bits) with kind "b" (plain
bits), "t" (trit: levels = 3<<bits), or "q" (quint: levels = 5<<bits).  A
quantized value v splits as v = D * 2^bits + m (D = trit/quint digit, m =
the plain bits).

Copied from ``cuttlefish_tpu/kernels/astc_ise.py`` unchanged (numpy only).
"""

from __future__ import annotations

import functools

import numpy as np

# ---------------------------------------------------------------------------
# Trit / quint block coding (spec C.2.12)
# ---------------------------------------------------------------------------


def decode_trit_block(t8: int) -> tuple[int, int, int, int, int]:
    """8-bit packed block -> 5 trits."""
    t = t8
    if ((t >> 2) & 0x7) == 0b111:
        c = (((t >> 5) & 0x7) << 2) | (t & 0x3)
        t4 = t3 = 2
    else:
        c = t & 0x1F
        if ((t >> 5) & 0x3) == 0b11:
            t4 = 2
            t3 = (t >> 7) & 1
        else:
            t4 = (t >> 7) & 1
            t3 = (t >> 5) & 0x3
    if (c & 0x3) == 0b11:
        t2 = 2
        t1 = (c >> 4) & 1
        t0 = (((c >> 3) & 1) << 1) | ((c >> 2) & 1 & ~((c >> 3) & 1))
    elif ((c >> 2) & 0x3) == 0b11:
        t2 = 2
        t1 = 2
        t0 = c & 0x3
    else:
        t2 = (c >> 4) & 1
        t1 = (c >> 2) & 0x3
        t0 = ((c & 0x2)) | ((c & 1) & ~((c >> 1) & 1))
    return t0, t1, t2, t3, t4


def decode_quint_block(q7: int) -> tuple[int, int, int]:
    """7-bit packed block -> 3 quints."""
    q = q7
    if ((q >> 1) & 0x3) == 0b11 and ((q >> 5) & 0x3) == 0b00:
        q2 = (
            ((q & 1) << 2)
            | (((q >> 4) & 1 & ~(q & 1)) << 1)
            | ((q >> 3) & 1 & ~(q & 1))
        )
        q1 = 4
        q0 = 4
    else:
        if ((q >> 1) & 0x3) == 0b11:
            q2 = 4
            c = (((q >> 3) & 0x3) << 3) | ((~(q >> 5) & 0x3) << 1) | (q & 1)
        else:
            q2 = (q >> 5) & 0x3
            c = q & 0x1F
        if (c & 0x7) == 0b101:
            q1 = 4
            q0 = (c >> 3) & 0x3
        else:
            q1 = (c >> 3) & 0x3
            q0 = c & 0x7
    return q0, q1, q2


@functools.lru_cache(maxsize=None)
def trit_pack_table() -> np.ndarray:
    """[3,3,3,3,3] -> smallest 8-bit block decoding to those trits."""
    out = np.full((3, 3, 3, 3, 3), -1, np.int32)
    for t8 in range(256):
        trits = decode_trit_block(t8)
        if all(v < 3 for v in trits) and out[trits] < 0:
            out[trits] = t8
    assert (out >= 0).all(), "trit decode does not cover all 243 tuples"
    return out


@functools.lru_cache(maxsize=None)
def quint_pack_table() -> np.ndarray:
    """[5,5,5] -> smallest 7-bit block decoding to those quints."""
    out = np.full((5, 5, 5), -1, np.int32)
    for q7 in range(128):
        quints = decode_quint_block(q7)
        if all(v < 5 for v in quints) and out[quints] < 0:
            out[quints] = q7
    assert (out >= 0).all(), "quint decode does not cover all 125 tuples"
    return out


# ---------------------------------------------------------------------------
# ISE bit layout
# ---------------------------------------------------------------------------
#
# A trit group holds 5 values in 8 + 5b bits, interleaved
#   m0[b] T[1:0] m1[b] T[3:2] m2[b] T[4] m3[b] T[6:5] m4[b] T[7]
# A quint group holds 3 values in 7 + 3b bits, interleaved
#   m0[b] Q[2:0] m1[b] Q[4:3] m2[b] Q[6:5]
# Partial final groups are truncated at the bit level; the decoder
# zero-extends.  pack tables prefer the smallest block value, which keeps
# truncated high bits consistent (asserted below for every partial length).

_TRIT_SLOTS = ((0, 2), (2, 2), (4, 1), (5, 2), (7, 1))  # (T low bit, width)
_QUINT_SLOTS = ((0, 3), (3, 2), (5, 2))


def ise_bits(n: int, kind: str, b: int) -> int:
    """Total encoded bits for n values."""
    if kind == "b":
        return n * b
    if kind == "t":
        return (8 * n + 4) // 5 + n * b
    return (7 * n + 2) // 3 + n * b


def ise_sequence_layout(n: int, kind: str, b: int):
    """Describe where each encoded bit of the sequence comes from.

    Returns a list of (source, index, bit) triples in stream order, where
    source is "m" (value index's plain bits) or "p" (packed trit/quint
    block index's bits).  Used to build vectorized packers/unpackers.
    """
    out = []
    if kind == "b":
        for i in range(n):
            for j in range(b):
                out.append(("m", i, j))
        return out
    per, slots = (5, _TRIT_SLOTS) if kind == "t" else (3, _QUINT_SLOTS)
    total = ise_bits(n, kind, b)
    for g in range((n + per - 1) // per):
        for k in range(per):
            i = g * per + k
            vi = min(i, n - 1)  # padded values reuse the last index's zeros
            for j in range(b):
                out.append(("m", i if i < n else -1, j))
            lo, width = slots[k]
            for j in range(lo, lo + width):
                out.append(("p", g, j))
    return out[:total]


def _check_truncation(kind: str):
    """Partial final groups must decode correctly after zero-extension."""
    per = 5 if kind == "t" else 3
    radix = 3 if kind == "q" else 3
    radix = 3 if kind == "t" else 5
    pack = trit_pack_table() if kind == "t" else quint_pack_table()
    decode = decode_trit_block if kind == "t" else decode_quint_block
    slots = _TRIT_SLOTS if kind == "t" else _QUINT_SLOTS
    nbits = 8 if kind == "t" else 7
    for present in range(1, per):
        # bits kept: slots for values 0..present-1 (with b=0 for simplicity:
        # kept packed bits = slots[0..present-1])
        keep = 0
        for k in range(present):
            lo, width = slots[k]
            for j in range(lo, lo + width):
                keep |= 1 << j
        import itertools

        for digits in itertools.product(range(radix), repeat=present):
            full = tuple(list(digits) + [0] * (per - present))
            t8 = int(pack[full])
            trunc = t8 & keep
            got = decode(trunc)[:present]
            assert got == digits, (kind, present, digits, t8, got)


_check_truncation("t")
_check_truncation("q")


# ---------------------------------------------------------------------------
# Unquantization (spec C.2.13 colors, C.2.16/17 weights)
# ---------------------------------------------------------------------------

# Weight ranges: levels -> (kind, bits, C multiplier).
_WEIGHT_RANGES = {
    2: ("b", 1, 0),
    3: ("t", 0, 0),
    4: ("b", 2, 0),
    5: ("q", 0, 0),
    6: ("t", 1, 50),
    8: ("b", 3, 0),
    10: ("q", 1, 28),
    12: ("t", 2, 23),
    16: ("b", 4, 0),
    20: ("q", 2, 13),
    24: ("t", 3, 11),
    32: ("b", 5, 0),
}

# Color unquantization tables for trit/quint ranges, extracted value-
# by-value from Mesa llvmpipe texel probes (see tests/test_gl_parity.py
# which re-derives and asserts them when a GL is available).
_COLOR_UNQUANT_TABLES = {
    6: [0, 255, 51, 204, 102, 153],
    10: [0, 255, 28, 227, 56, 199, 84, 171, 113, 142],
    12: [0, 255, 69, 186, 23, 232, 92, 163, 46, 209, 116, 139],
    20: [0, 255, 67, 188, 13, 242, 80, 175, 27, 228, 94, 161, 40, 215, 107, 148, 54, 201, 121, 134],
    24: [0, 255, 33, 222, 66, 189, 99, 156, 11, 244, 44, 211, 77, 178, 110, 145, 22, 233, 55, 200, 88, 167, 121, 134],
    40: [0, 255, 32, 223, 65, 190, 97, 158, 6, 249, 39, 216, 71, 184, 104, 151, 13, 242, 45, 210, 78, 177, 110, 145, 19, 236, 52, 203, 84, 171, 117, 138, 26, 229, 58, 197, 91, 164, 123, 132],
    48: [0, 255, 16, 239, 32, 223, 48, 207, 65, 190, 81, 174, 97, 158, 113, 142, 5, 250, 21, 234, 38, 217, 54, 201, 70, 185, 86, 169, 103, 152, 119, 136, 11, 244, 27, 228, 43, 212, 59, 196, 76, 179, 92, 163, 108, 147, 124, 131],
    80: [0, 255, 16, 239, 32, 223, 48, 207, 64, 191, 80, 175, 96, 159, 112, 143, 3, 252, 19, 236, 35, 220, 51, 204, 67, 188, 83, 172, 100, 155, 116, 139, 6, 249, 22, 233, 38, 217, 54, 201, 71, 184, 87, 168, 103, 152, 119, 136, 9, 246, 25, 230, 42, 213, 58, 197, 74, 181, 90, 165, 106, 149, 122, 133, 13, 242, 29, 226, 45, 210, 61, 194, 77, 178, 93, 162, 109, 146, 125, 130],
    96: [0, 255, 8, 247, 16, 239, 24, 231, 32, 223, 40, 215, 48, 207, 56, 199, 64, 191, 72, 183, 80, 175, 88, 167, 96, 159, 104, 151, 112, 143, 120, 135, 2, 253, 10, 245, 18, 237, 26, 229, 35, 220, 43, 212, 51, 204, 59, 196, 67, 188, 75, 180, 83, 172, 91, 164, 99, 156, 107, 148, 115, 140, 123, 132, 5, 250, 13, 242, 21, 234, 29, 226, 37, 218, 45, 210, 53, 202, 61, 194, 70, 185, 78, 177, 86, 169, 94, 161, 102, 153, 110, 145, 118, 137, 126, 129],
    160: [0, 255, 8, 247, 16, 239, 24, 231, 32, 223, 40, 215, 48, 207, 56, 199, 64, 191, 72, 183, 80, 175, 88, 167, 96, 159, 104, 151, 112, 143, 120, 135, 1, 254, 9, 246, 17, 238, 25, 230, 33, 222, 41, 214, 49, 206, 57, 198, 65, 190, 73, 182, 81, 174, 89, 166, 97, 158, 105, 150, 113, 142, 121, 134, 3, 252, 11, 244, 19, 236, 27, 228, 35, 220, 43, 212, 51, 204, 59, 196, 67, 188, 75, 180, 83, 172, 91, 164, 99, 156, 107, 148, 115, 140, 123, 132, 4, 251, 12, 243, 20, 235, 28, 227, 36, 219, 44, 211, 52, 203, 60, 195, 68, 187, 76, 179, 84, 171, 92, 163, 100, 155, 108, 147, 116, 139, 124, 131, 6, 249, 14, 241, 22, 233, 30, 225, 38, 217, 46, 209, 54, 201, 62, 193, 70, 185, 78, 177, 86, 169, 94, 161, 102, 153, 110, 145, 118, 137, 126, 129],
    192: [0, 255, 4, 251, 8, 247, 12, 243, 16, 239, 20, 235, 24, 231, 28, 227, 32, 223, 36, 219, 40, 215, 44, 211, 48, 207, 52, 203, 56, 199, 60, 195, 64, 191, 68, 187, 72, 183, 76, 179, 80, 175, 84, 171, 88, 167, 92, 163, 96, 159, 100, 155, 104, 151, 108, 147, 112, 143, 116, 139, 120, 135, 124, 131, 1, 254, 5, 250, 9, 246, 13, 242, 17, 238, 21, 234, 25, 230, 29, 226, 33, 222, 37, 218, 41, 214, 45, 210, 49, 206, 53, 202, 57, 198, 61, 194, 65, 190, 69, 186, 73, 182, 77, 178, 81, 174, 85, 170, 89, 166, 93, 162, 97, 158, 101, 154, 105, 150, 109, 146, 113, 142, 117, 138, 121, 134, 125, 130, 2, 253, 6, 249, 10, 245, 14, 241, 18, 237, 22, 233, 26, 229, 30, 225, 34, 221, 38, 217, 42, 213, 46, 209, 50, 205, 54, 201, 58, 197, 62, 193, 66, 189, 70, 185, 74, 181, 78, 177, 82, 173, 86, 169, 90, 165, 94, 161, 98, 157, 102, 153, 106, 149, 110, 145, 114, 141, 118, 137, 122, 133, 126, 129],
}

# Color ranges: levels -> (kind, bits, C multiplier).
_COLOR_RANGES = {
    3: ("t", 0, 0),
    5: ("q", 0, 0),
    6: ("t", 1, 204),
    10: ("q", 1, 113),
    12: ("t", 2, 93),
    20: ("q", 2, 54),
    24: ("t", 3, 44),
    40: ("q", 3, 26),
    48: ("t", 4, 22),
    80: ("q", 4, 13),
    96: ("t", 5, 11),
    160: ("q", 5, 6),
    192: ("t", 6, 5),
    # bits-only ranges 2..256 handled by bit replication
}


def _bit(v: int, i: int) -> int:
    return (v >> i) & 1


def _weight_B(kind: str, b: int, m: int) -> int:
    """7-bit B pattern from the plain bits above the LSB (spec C.2.17).

    Validated value-by-value against Mesa llvmpipe probes (each range's
    full unquantization ladder read back through texel decodes).
    """
    if b <= 1:
        return 0
    x = _bit(m, 1)
    if b == 2 and kind == "t":
        return (x << 6) | (x << 2) | (x << 0)
    if b == 2 and kind == "q":
        return (x << 6) | (x << 1)
    if b == 3 and kind == "t":
        y = _bit(m, 2)
        return (y << 6) | (x << 5) | (y << 1) | (x << 0)
    raise ValueError((kind, b))


@functools.lru_cache(maxsize=None)
def weight_unquant(levels: int) -> np.ndarray:
    """[levels] quantized weight value -> unquantized 0..64."""
    kind, b, c = _WEIGHT_RANGES[levels]
    out = np.zeros(levels, np.int32)
    if kind == "b":
        for v in range(levels):
            x, shift = 0, 6
            while shift > 0:
                shift -= b
                x |= (v << shift) if shift >= 0 else (v >> -shift)
            x &= 0x3F
            if x > 32:
                x += 1
            out[v] = x
        return out
    if b == 0:
        # Direct tables for trit/quint with no bits.
        return np.array([0, 32, 64] if kind == "t" else [0, 16, 32, 48, 64], np.int32)
    nd = 1 << b
    for v in range(levels):
        d, m = v // nd, v % nd
        a = 0x7F if (m & 1) else 0
        t = d * c + _weight_B(kind, b, m)
        t ^= a
        t = (a & 0x20) | (t >> 2)
        if t > 32:
            t += 1
        out[v] = t
    return out


@functools.lru_cache(maxsize=None)
def color_unquant(levels: int) -> np.ndarray:
    """[levels] quantized color value -> unquantized 0..255."""
    if levels in _COLOR_UNQUANT_TABLES:
        return np.asarray(_COLOR_UNQUANT_TABLES[levels], np.int32)
    # bits-only: replicate to 8 bits
    b = int(levels).bit_length() - 1
    assert (1 << b) == levels
    out = np.zeros(levels, np.int32)
    for v in range(levels):
        x, shift = 0, 8
        while shift > 0:
            shift -= b
            x |= (v << shift) if shift >= 0 else (v >> -shift)
        out[v] = x & 0xFF
    return out


def range_info(levels: int, for_weights: bool):
    """(kind, bits) for an ISE range."""
    table = _WEIGHT_RANGES if for_weights else _COLOR_RANGES
    if levels in table:
        return table[levels][0], table[levels][1]
    b = int(levels).bit_length() - 1
    assert (1 << b) == levels, f"unknown ISE range {levels}"
    return "b", b


# ---------------------------------------------------------------------------
# Sequence encode / decode (numpy, host side)
# ---------------------------------------------------------------------------


def ise_encode(values: np.ndarray, levels: int, for_weights: bool) -> tuple[np.ndarray, int]:
    """Encode [N,n] quantized values -> ([N, nbits] bit array, nbits)."""
    values = np.asarray(values, np.int64)
    n = values.shape[1]
    kind, b = range_info(levels, for_weights)
    nbits = ise_bits(n, kind, b)
    out = np.zeros((values.shape[0], nbits), np.uint8)
    if kind == "b":
        for i in range(n):
            for j in range(b):
                out[:, i * b + j] = (values[:, i] >> j) & 1
        return out, nbits
    per = 5 if kind == "t" else 3
    radix = 3 if kind == "t" else 5
    pack = trit_pack_table() if kind == "t" else quint_pack_table()
    ngroups = (n + per - 1) // per
    digits = np.zeros((values.shape[0], ngroups * per), np.int64)
    ms = np.zeros((values.shape[0], ngroups * per), np.int64)
    digits[:, :n] = values >> b
    ms[:, :n] = values & ((1 << b) - 1)
    packed = np.zeros((values.shape[0], ngroups), np.int64)
    for g in range(ngroups):
        idx = tuple(digits[:, g * per + k] for k in range(per))
        packed[:, g] = pack[idx]
    layout = ise_sequence_layout(n, kind, b)
    for pos, (src, i, j) in enumerate(layout):
        if src == "m":
            if i >= 0:
                out[:, pos] = (ms[:, i] >> j) & 1
        else:
            out[:, pos] = (packed[:, i] >> j) & 1
    return out, nbits


def ise_decode(bits: np.ndarray, n: int, levels: int, for_weights: bool) -> np.ndarray:
    """Decode [N, >=nbits] bit array -> [N, n] quantized values."""
    kind, b = range_info(levels, for_weights)
    nbits = ise_bits(n, kind, b)
    bits = np.asarray(bits, np.uint8)
    if bits.shape[1] < nbits:
        pad = np.zeros((bits.shape[0], nbits - bits.shape[1]), np.uint8)
        bits = np.concatenate([bits, pad], axis=1)
    out = np.zeros((bits.shape[0], n), np.int64)
    if kind == "b":
        for i in range(n):
            for j in range(b):
                out[:, i] |= bits[:, i * b + j].astype(np.int64) << j
        return out
    per = 5 if kind == "t" else 3
    ngroups = (n + per - 1) // per
    packed = np.zeros((bits.shape[0], ngroups), np.int64)
    ms = np.zeros((bits.shape[0], ngroups * per), np.int64)
    layout = ise_sequence_layout(n, kind, b)
    for pos, (src, i, j) in enumerate(layout):
        if src == "m":
            if i >= 0:
                ms[:, i] |= bits[:, pos].astype(np.int64) << j
        else:
            packed[:, i] |= bits[:, pos].astype(np.int64) << j
    decode = decode_trit_block if kind == "t" else decode_quint_block
    for row in range(bits.shape[0]):
        for g in range(ngroups):
            ds = decode(int(packed[row, g]))
            for k in range(per):
                i = g * per + k
                if i < n:
                    out[row, i] = ds[k] * (1 << b) + ms[row, i]
    return out
