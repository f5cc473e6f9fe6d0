"""BC7 block decoder (numpy/python, per the D3D11.3 functional spec).

A copy of cuttlefish_tpu/decode/bc7.py on the port's tables, so that it
runs where JAX is not installed.  Implements all 8 modes; 3-subset
partition constants (modes 0/2) use the spec's 3-subset tables.  Used for
encoder parity checks and PSNR scoring, not on the encode hot path: it is
a per-block Python loop, so callers decode a sample of blocks.
"""

from __future__ import annotations

import numpy as np

from cuttlefish_tpu_torch.kernels import bc7_tables as T
from cuttlefish_tpu_torch.kernels.bc7_tables import ANCHOR3_2, ANCHOR3_3, PARTITION3


_WEIGHTS = {2: T.WEIGHTS2, 3: T.WEIGHTS3, 4: T.WEIGHTS4}

# mode -> (subsets, partition_bits, rot_bits, idxmode_bits, color_bits,
#          alpha_bits, pbit_mode, idx_bits, idx2_bits)
_MODES = {
    0: (3, 4, 0, 0, 4, 0, "each", 3, 0),
    1: (2, 6, 0, 0, 6, 0, "shared", 3, 0),
    2: (3, 6, 0, 0, 5, 0, "none", 2, 0),
    3: (2, 6, 0, 0, 7, 0, "each", 2, 0),
    4: (1, 0, 2, 1, 5, 6, "none", 2, 3),
    5: (1, 0, 2, 0, 7, 8, "none", 2, 2),
    6: (1, 0, 0, 0, 7, 7, "each", 4, 0),
    7: (2, 6, 0, 0, 5, 5, "each", 2, 0),
}


class _Reader:
    def __init__(self, block: int):
        self.v = block
        self.pos = 0

    def read(self, n: int) -> int:
        r = (self.v >> self.pos) & ((1 << n) - 1)
        self.pos += n
        return r


def _interp(a, b, w):
    return (a * (64 - w) + b * w + 32) >> 6


def _decode_block(block: int) -> np.ndarray:
    mode = 0
    while mode < 8 and not (block >> mode) & 1:
        mode += 1
    out = np.zeros((16, 4), np.uint8)
    if mode >= 8:
        return out  # reserved: all-zero
    (ns, pb, rb, ib, cb, ab, pmode, i1b, i2b) = _MODES[mode]
    r = _Reader(block)
    r.read(mode + 1)
    partition = r.read(pb)
    rotation = r.read(rb)
    idx_mode = r.read(ib)

    # Endpoints: channel-major (all R, all G, all B, then A), endpoint order
    # [subset0 e0, subset0 e1, subset1 e0, ...].
    neps = 2 * ns
    chans = 3 + (1 if ab else 0)
    ep = np.zeros((neps, 4), np.int32)
    for c in range(chans):
        bits = ab if c == 3 else cb
        for e in range(neps):
            ep[e, c] = r.read(bits)
    # P-bits.
    if pmode == "each":
        pbits = [r.read(1) for _ in range(neps)]
    elif pmode == "shared":
        pbits = []
        for s in range(ns):
            p = r.read(1)
            pbits += [p, p]
    else:
        pbits = None
    # Expand to 8 bits.
    for e in range(neps):
        for c in range(4):
            bits = ab if c == 3 else cb
            if c == 3 and ab == 0:
                ep[e, c] = 255
                continue
            v = ep[e, c]
            if pbits is not None:
                v = (v << 1) | pbits[e]
                bits += 1
            if bits < 8:
                v = (v << (8 - bits)) | (v >> (2 * bits - 8))
            ep[e, c] = v
    if mode in (1, 3):  # RGB modes: alpha = 255
        ep[:, 3] = 255

    # Subset assignment + anchors.
    if ns == 1:
        subset = np.zeros(16, np.int32)
        anchors = {0: 0}
    elif ns == 2:
        subset = T.PARTITION2[partition]
        anchors = {0: 0, 1: int(T.ANCHOR2[partition])}
    else:
        subset = PARTITION3[partition]
        anchors = {
            0: 0,
            1: int(ANCHOR3_2[partition]),
            2: int(ANCHOR3_3[partition]),
        }

    # Anchor elision: pixel i loses a bit iff it IS the anchor of its subset.
    def read_idx(nbits):
        idx = np.zeros(16, np.int32)
        anchor_pixels = {a for a in anchors.values()}
        for i in range(16):
            n = nbits - (1 if i in anchor_pixels else 0)
            idx[i] = r.read(n)
        return idx

    idx1 = read_idx(i1b)
    idx2 = read_idx(i2b) if i2b else None

    w1 = _WEIGHTS[i1b]
    for i in range(16):
        s = subset[i]
        e0, e1 = ep[2 * s], ep[2 * s + 1]
        if mode == 4:
            # idx_mode selects which index set drives color vs alpha.
            cw = _WEIGHTS[3][idx2[i]] if idx_mode else _WEIGHTS[2][idx1[i]]
            aw = _WEIGHTS[2][idx1[i]] if idx_mode else _WEIGHTS[3][idx2[i]]
            col = [_interp(e0[c], e1[c], cw) for c in range(3)]
            col.append(_interp(e0[3], e1[3], aw))
        elif mode == 5:
            cw = _WEIGHTS[2][idx1[i]]
            aw = _WEIGHTS[2][idx2[i]]
            col = [_interp(e0[c], e1[c], cw) for c in range(3)]
            col.append(_interp(e0[3], e1[3], aw))
        else:
            w = w1[idx1[i]]
            col = [_interp(e0[c], e1[c], w) for c in range(4)]
        if rotation:  # swap A with R/G/B
            c = rotation - 1
            col[3], col[c] = col[c], col[3]
        out[i] = col
    return out


def decode_bc7(data: np.ndarray) -> np.ndarray:
    """[N*16] or [N,16] uint8 -> [N,16,4] uint8 RGBA."""
    data = np.asarray(data, np.uint8).reshape(-1, 16)
    out = np.zeros((data.shape[0], 16, 4), np.uint8)
    for n in range(data.shape[0]):
        out[n] = _decode_block(int.from_bytes(data[n].tobytes(), "little"))
    return out
