"""BC6H block decoder (numpy/python, per the D3D11.3 functional spec).

A copy of ``cuttlefish_tpu/decode/bc6h.py`` on the port's tables and
``packfloat``, so that a BC6H file loads and decodes where JAX is not
installed.  Decodes the one-region modes 11 (10.10) and 12 (11.9 delta)
and the ten two-region modes that the encoder emits.  Returns half-float
bits; use ``decode_bc6h_f32`` for values.
"""

from __future__ import annotations

import numpy as np

from cuttlefish_tpu_torch.kernels.bc7_tables import WEIGHTS4
from cuttlefish_tpu_torch.packfloat import half_bits_to_f32


def _unquant_unsigned(q: int, bits: int) -> int:
    maxq = (1 << bits) - 1
    if q == 0:
        return 0
    if q == maxq:
        return 0xFFFF
    return ((q << 16) + 0x8000) >> bits


def _unquant_signed(q: int, bits: int) -> int:
    s = q < 0
    aq = abs(q)
    maxa = (1 << (bits - 1)) - 1
    if aq == 0:
        u = 0
    elif aq >= maxa:
        u = 0x7FFF
    else:
        u = ((aq << 15) + 0x4000) >> (bits - 1)
    return -u if s else u


def _finalize(v: int, signed: bool) -> int:
    if signed:
        mag = (abs(v) * 31) >> 5
        return (0x8000 | mag) if v < 0 else mag
    return (v * 31) >> 6


def _sext(v: int, bits: int) -> int:
    if v & (1 << (bits - 1)):
        return v - (1 << bits)
    return v


def _decode_two_region(block: int, mode_id: int, signed: bool) -> np.ndarray:
    from cuttlefish_tpu_torch.kernels.bc6h_tables import (
        TWO_REGION_LAYOUT,
        TWO_REGION_MODES,
    )
    from cuttlefish_tpu_torch.kernels.bc7_tables import ANCHOR2, PARTITION2, WEIGHTS3

    _, _, epbits, dbits, direct = TWO_REGION_MODES[mode_id]
    fields = {f: [0, 0, 0] for f in ("rw", "rx", "ry", "rz")}
    for block_bit, field, field_bit, ch in TWO_REGION_LAYOUT[mode_id]:
        fields[field][ch] |= ((block >> block_bit) & 1) << field_bit
    mask = (1 << epbits) - 1
    e = np.zeros((2, 2, 3), np.int64)  # [region][endpoint][ch]
    for c in range(3):
        base = fields["rw"][c]
        if signed:
            base = _sext(base, epbits)
        if direct:
            vals = [fields["rx"][c], fields["ry"][c], fields["rz"][c]]
            if signed:
                vals = [_sext(v, epbits) for v in vals]
        else:
            vals = []
            for f, db in (("rx", dbits[c]), ("ry", dbits[c]), ("rz", dbits[c])):
                d = _sext(fields[f][c], db)
                v = (base + d) & mask
                if signed:
                    v = _sext(v, epbits)
                vals.append(v)
        e[0, 0, c] = base
        e[0, 1, c] = vals[0]
        e[1, 0, c] = vals[1]
        e[1, 1, c] = vals[2]

    d5 = (block >> 77) & 0x1F
    part = PARTITION2[d5]
    anchor1 = ANCHOR2[d5]
    unq = _unquant_signed if signed else _unquant_unsigned
    u = np.zeros((2, 2, 3), np.int64)
    for r in range(2):
        for k in range(2):
            for c in range(3):
                u[r, k, c] = unq(int(e[r, k, c]), epbits)

    out = np.zeros((16, 3), np.uint16)
    pos = 82
    for i in range(16):
        n = 2 if (i == 0 or i == anchor1) else 3
        w = WEIGHTS3[(block >> pos) & ((1 << n) - 1)]
        pos += n
        r = part[i]
        for c in range(3):
            interp = (u[r, 0, c] * (64 - w) + u[r, 1, c] * w + 32) >> 6
            out[i, c] = _finalize(int(interp), signed) & 0xFFFF
    return out


def _decode_block(block: int, signed: bool) -> np.ndarray:
    out = np.zeros((16, 3), np.uint16)
    from cuttlefish_tpu_torch.kernels.bc6h_tables import TWO_REGION_MODES

    header2 = block & 0x3
    if header2 in (0, 1):
        return _decode_two_region(block, 1 if header2 == 0 else 2, signed)
    header5 = block & 0x1F
    for mode_id, (mv, ml, _, _, _) in TWO_REGION_MODES.items():
        if ml == 5 and mv == header5:
            return _decode_two_region(block, mode_id, signed)
    pos = 5
    def rd(n):
        nonlocal pos
        v = (block >> pos) & ((1 << n) - 1)
        pos += n
        return v

    if header5 == 0x03:  # mode 11: 10.10 absolute
        e0 = [rd(10) for _ in range(3)]
        e1 = [rd(10) for _ in range(3)]
        if signed:
            e0 = [_sext(v, 10) for v in e0]
            e1 = [_sext(v, 10) for v in e1]
        bits = 10
    elif header5 == 0x07:  # mode 12: 11-bit base, 9-bit delta
        e0 = [rd(10) for _ in range(3)]
        e1 = []
        for c in range(3):
            d = _sext(rd(9), 9)
            e0[c] |= rd(1) << 10
            e1.append(d)
        if signed:
            e0 = [_sext(v, 11) for v in e0]
        e1 = [(e0[c] + e1[c]) & 0x7FF for c in range(3)]
        if signed:
            e1 = [_sext(v, 11) for v in e1]
        bits = 11
    else:
        raise NotImplementedError(f"BC6H mode header {header5:#x} not supported")

    unq = _unquant_signed if signed else _unquant_unsigned
    u0 = [unq(v, bits) for v in e0]
    u1 = [unq(v, bits) for v in e1]
    for i in range(16):
        n = 3 if i == 0 else 4
        w = WEIGHTS4[(block >> pos) & ((1 << n) - 1)]
        pos += n
        for c in range(3):
            interp = (u0[c] * (64 - w) + u1[c] * w + 32) >> 6
            out[i, c] = _finalize(int(interp), signed) & 0xFFFF
    return out


def decode_bc6h(data: np.ndarray, signed: bool = False) -> np.ndarray:
    """[N*16] or [N,16] uint8 -> [N,16,3] uint16 half bits."""
    data = np.asarray(data, np.uint8).reshape(-1, 16)
    out = np.zeros((data.shape[0], 16, 3), np.uint16)
    for n in range(data.shape[0]):
        out[n] = _decode_block(int.from_bytes(data[n].tobytes(), "little"), signed)
    return out


def decode_bc6h_f32(data: np.ndarray, signed: bool = False) -> np.ndarray:
    """Decode to float32 values."""
    return half_bits_to_f32(decode_bc6h(data, signed))
