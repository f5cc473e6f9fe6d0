"""ETC1/ETC2/EAC block decoders (numpy/python, per the Khronos specs).

Covers ETC1 individual/differential, ETC2 T/H/planar (opaque and
punch-through), EAC alpha and R11 (signed + unsigned).  Blocks are
big-endian 64-bit words with column-major pixel order.

Copied from ``cuttlefish_tpu/decode/etc.py`` with its one import pointed at
the port's copy of the tables (``kernels/etc_tables.py``).
"""

from __future__ import annotations

import numpy as np

from cuttlefish_tpu_torch.kernels.etc_tables import _EAC_MODS_NP, _ETC1_MODS_NP


def _clamp(v):
    return max(0, min(255, v))


def _expand4(v):
    return (v << 4) | v


def _expand5(v):
    return (v << 3) | (v >> 2)


def _sext(v, bits):
    return v - (1 << bits) if v & (1 << (bits - 1)) else v


def _decode_etc_rgb_block(block: int, etc2: bool) -> np.ndarray:
    """64-bit int -> [16,3] uint8, raster order."""
    out = np.zeros((16, 3), np.uint8)
    diff = (block >> 33) & 1
    flip = (block >> 32) & 1

    if diff:
        b1 = [(block >> 59) & 0x1F, (block >> 51) & 0x1F, (block >> 43) & 0x1F]
        d2 = [
            _sext((block >> 56) & 0x7, 3),
            _sext((block >> 48) & 0x7, 3),
            _sext((block >> 40) & 0x7, 3),
        ]
        b2 = [b1[c] + d2[c] for c in range(3)]
        if etc2:
            if not 0 <= b2[0] <= 31:
                return _decode_t(block)
            if not 0 <= b2[1] <= 31:
                return _decode_h(block)
            if not 0 <= b2[2] <= 31:
                return _decode_planar(block)
        base1 = [_expand5(v) for v in b1]
        base2 = [_expand5(max(0, min(31, v))) for v in b2]
    else:
        base1 = [
            _expand4((block >> 60) & 0xF),
            _expand4((block >> 52) & 0xF),
            _expand4((block >> 44) & 0xF),
        ]
        base2 = [
            _expand4((block >> 56) & 0xF),
            _expand4((block >> 48) & 0xF),
            _expand4((block >> 40) & 0xF),
        ]

    t1 = (block >> 37) & 0x7
    t2 = (block >> 34) & 0x7
    for p in range(16):  # column-major pixel number
        x, y = p // 4, p % 4
        in_sub2 = (x >= 2) if not flip else (y >= 2)
        base = base2 if in_sub2 else base1
        table = t2 if in_sub2 else t1
        msb = (block >> (16 + p)) & 1
        lsb = (block >> p) & 1
        mod = _ETC1_MODS_NP[table][(msb << 1) | lsb]
        ri = 4 * y + x
        out[ri] = [_clamp(base[c] + mod) for c in range(3)]
    return out


_T_DIST = [3, 6, 11, 16, 23, 32, 41, 64]


def _decode_t(block: int) -> np.ndarray:
    """T mode: palette [C1, C2+d, C2, C2-d] with 4-bit colors."""
    def e4(v):
        return (v << 4) | v

    r1 = (((block >> 59) & 0x3) << 2) | ((block >> 56) & 0x3)
    g1 = (block >> 52) & 0xF
    b1 = (block >> 48) & 0xF
    r2 = (block >> 44) & 0xF
    g2 = (block >> 40) & 0xF
    b2 = (block >> 36) & 0xF
    didx = (((block >> 34) & 0x3) << 1) | ((block >> 32) & 1)
    d = _T_DIST[didx]
    c1 = [e4(r1), e4(g1), e4(b1)]
    c2 = [e4(r2), e4(g2), e4(b2)]
    pal = [
        c1,
        [_clamp(v + d) for v in c2],
        c2,
        [_clamp(v - d) for v in c2],
    ]
    out = np.zeros((16, 3), np.uint8)
    for p in range(16):
        x, y = p // 4, p % 4
        msb = (block >> (16 + p)) & 1
        lsb = (block >> p) & 1
        out[4 * y + x] = pal[(msb << 1) | lsb]
    return out


def _decode_h(block: int) -> np.ndarray:
    """H mode: palette [C1+d, C1-d, C2+d, C2-d]; d[0] from color ordering."""
    def e4(v):
        return (v << 4) | v

    r1 = (block >> 59) & 0xF
    g1 = (((block >> 56) & 0x7) << 1) | ((block >> 52) & 1)
    b1 = (((block >> 51) & 1) << 3) | (((block >> 48) & 0x3) << 1) | ((block >> 47) & 1)
    r2 = (block >> 43) & 0xF
    g2 = (block >> 39) & 0xF
    b2 = (block >> 35) & 0xF
    packed1 = (r1 << 8) | (g1 << 4) | b1
    packed2 = (r2 << 8) | (g2 << 4) | b2
    didx = (
        (((block >> 34) & 1) << 2)
        | (((block >> 32) & 1) << 1)
        | (1 if packed1 >= packed2 else 0)
    )
    d = _T_DIST[didx]
    c1 = [e4(r1), e4(g1), e4(b1)]
    c2 = [e4(r2), e4(g2), e4(b2)]
    pal = [
        [_clamp(v + d) for v in c1],
        [_clamp(v - d) for v in c1],
        [_clamp(v + d) for v in c2],
        [_clamp(v - d) for v in c2],
    ]
    out = np.zeros((16, 3), np.uint8)
    for p in range(16):
        x, y = p // 4, p % 4
        msb = (block >> (16 + p)) & 1
        lsb = (block >> p) & 1
        out[4 * y + x] = pal[(msb << 1) | lsb]
    return out


def _decode_planar(block: int) -> np.ndarray:
    def ext6(v):
        return (v << 2) | (v >> 4)

    def ext7(v):
        return (v << 1) | (v >> 6)

    ro = ext6((block >> 57) & 0x3F)
    go = ext7((((block >> 56) & 1) << 6) | ((block >> 49) & 0x3F))
    bo = ext6(
        (((block >> 48) & 1) << 5)
        | (((block >> 43) & 0x3) << 3)
        | ((block >> 39) & 0x7)
    )
    rh = ext6((((block >> 34) & 0x1F) << 1) | ((block >> 32) & 1))
    gh = ext7((block >> 25) & 0x7F)
    bh = ext6((block >> 19) & 0x3F)
    rv = ext6((block >> 13) & 0x3F)
    gv = ext7((block >> 6) & 0x7F)
    bv = ext6(block & 0x3F)
    out = np.zeros((16, 3), np.uint8)
    O = [ro, go, bo]
    H = [rh, gh, bh]
    V = [rv, gv, bv]
    for y in range(4):
        for x in range(4):
            for c in range(3):
                v = (x * (H[c] - O[c]) + y * (V[c] - O[c]) + 4 * O[c] + 2) >> 2
                out[4 * y + x, c] = _clamp(v)
    return out


def decode_etc_rgb(data: np.ndarray, etc2: bool = False) -> np.ndarray:
    """[N*8] or [N,8] uint8 -> [N,16,3] uint8 (raster order)."""
    data = np.asarray(data, np.uint8).reshape(-1, 8)
    out = np.zeros((data.shape[0], 16, 3), np.uint8)
    for n in range(data.shape[0]):
        out[n] = _decode_etc_rgb_block(
            int.from_bytes(data[n].tobytes(), "big"), etc2
        )
    return out


def _decode_eac_block(block: int):
    """64-bit int -> (base, mult, table, idx[16] raster order)."""
    base = (block >> 56) & 0xFF
    mult = (block >> 52) & 0xF
    table = (block >> 48) & 0xF
    idx = np.zeros(16, np.int32)
    for p in range(16):
        x, y = p // 4, p % 4
        idx[4 * y + x] = (block >> (45 - 3 * p)) & 0x7
    return base, mult, table, idx


def decode_eac_alpha(data: np.ndarray) -> np.ndarray:
    """[N*8] uint8 -> [N,16] uint8 alpha (raster order)."""
    data = np.asarray(data, np.uint8).reshape(-1, 8)
    out = np.zeros((data.shape[0], 16), np.uint8)
    for n in range(data.shape[0]):
        base, mult, table, idx = _decode_eac_block(
            int.from_bytes(data[n].tobytes(), "big")
        )
        mods = _EAC_MODS_NP[table][idx]
        out[n] = np.clip(base + mods * mult, 0, 255)
    return out


def decode_eac_r11(data: np.ndarray, signed: bool = False) -> np.ndarray:
    """[N*8] uint8 -> [N,16] float in [0,1] ([-1,1] signed), raster order."""
    data = np.asarray(data, np.uint8).reshape(-1, 8)
    out = np.zeros((data.shape[0], 16), np.float64)
    for n in range(data.shape[0]):
        base, mult, table, idx = _decode_eac_block(
            int.from_bytes(data[n].tobytes(), "big")
        )
        mods = _EAC_MODS_NP[table][idx]
        if signed:
            sbase = base - 256 if base >= 128 else base
            sbase = max(-127, sbase)
            m = mult * 8 if mult else 1
            v = np.clip(sbase * 8 + mods * m, -1023, 1023)
            out[n] = v / 1023.0
        else:
            m = mult * 8 if mult else 1
            v = np.clip(base * 8 + 4 + mods * m, 0, 2047)
            out[n] = v / 2047.0
    return out


def decode_etc2_a1(data: np.ndarray) -> np.ndarray:
    """ETC2 punch-through alpha: [N*8] uint8 -> [N,16,4] uint8.

    Bit 33 is the opaque flag: 1 -> differential ETC2 decode (alpha 255);
    0 -> diff bases with the punch-through modifier set ([0, b, T, -b]),
    index 2 decodes to transparent black.
    """
    data = np.asarray(data, np.uint8).reshape(-1, 8)
    out = np.zeros((data.shape[0], 16, 4), np.uint8)
    for n in range(data.shape[0]):
        block = int.from_bytes(data[n].tobytes(), "big")
        opaque = (block >> 33) & 1
        if opaque:
            out[n, :, :3] = _decode_etc_rgb_block(block, etc2=True)
            out[n, :, 3] = 255
            continue
        flip = (block >> 32) & 1
        b1 = [(block >> 59) & 0x1F, (block >> 51) & 0x1F, (block >> 43) & 0x1F]
        d2 = [
            _sext((block >> 56) & 0x7, 3),
            _sext((block >> 48) & 0x7, 3),
            _sext((block >> 40) & 0x7, 3),
        ]
        b2 = [b1[c] + d2[c] for c in range(3)]
        if not all(0 <= v <= 31 for v in b2):
            # Punch-through T/H: same palettes, entry 2 = transparent
            # black (Khronos DFS punch-through tables); planar has no
            # transparent entry and decodes fully opaque.
            if not 0 <= b2[0] <= 31:
                rgb, punch_idx = _decode_t(block), 2
            elif not 0 <= b2[1] <= 31:
                rgb, punch_idx = _decode_h(block), 2
            else:
                rgb, punch_idx = _decode_planar(block), None
            out[n, :, :3] = rgb
            out[n, :, 3] = 255
            if punch_idx is not None:
                for p in range(16):
                    x, y = p // 4, p % 4
                    idx = (((block >> (16 + p)) & 1) << 1) | ((block >> p) & 1)
                    if idx == punch_idx:
                        out[n, 4 * y + x] = [0, 0, 0, 0]
            continue
        base1 = [_expand5(v) for v in b1]
        base2 = [_expand5(v) for v in b2]
        t1 = (block >> 37) & 0x7
        t2 = (block >> 34) & 0x7
        for p in range(16):
            x, y = p // 4, p % 4
            in_sub2 = (x >= 2) if not flip else (y >= 2)
            base = base2 if in_sub2 else base1
            table = t2 if in_sub2 else t1
            msb = (block >> (16 + p)) & 1
            lsb = (block >> p) & 1
            idx = (msb << 1) | lsb
            ri = 4 * y + x
            if idx == 2:
                out[n, ri] = [0, 0, 0, 0]
            else:
                mod = int(_ETC1_MODS_NP[table][idx])
                if idx == 0:
                    mod = 0
                out[n, ri, :3] = [_clamp(base[c] + mod) for c in range(3)]
                out[n, ri, 3] = 255
    return out


def decode_etc2_rgba(data: np.ndarray) -> np.ndarray:
    """[N*16] uint8 -> [N,16,4] uint8."""
    data = np.asarray(data, np.uint8).reshape(-1, 16)
    alpha = decode_eac_alpha(data[:, :8])
    rgb = decode_etc_rgb(data[:, 8:], etc2=True)
    return np.concatenate([rgb, alpha[..., None]], axis=-1)


def decode_eac_rg11(data: np.ndarray, signed: bool = False) -> np.ndarray:
    """[N*16] uint8 -> [N,16,2] float."""
    data = np.asarray(data, np.uint8).reshape(-1, 16)
    r = decode_eac_r11(data[:, :8], signed)
    g = decode_eac_r11(data[:, 8:], signed)
    return np.stack([r, g], axis=-1)
