"""ASTC partition pattern generation (the spec's seed-based hash).

Generates the texel->partition assignment for every 10-bit seed and
partition count, as numpy constant tables the encoder screens with
matmuls (same trick as the BC7 partition screening).  Validated
texel-by-texel against Mesa llvmpipe probe blocks in
tests/test_gl_parity.py.

Replaces astc-encoder's partition table machinery
(Cuttlefish's `lib/src/AstcConverter.cpp` relies on astcenc's
partition search).

Copied from ``cuttlefish_tpu/kernels/astc_partition.py`` unchanged (numpy only).
"""

from __future__ import annotations

import functools

import numpy as np

_M32 = 0xFFFFFFFF


def _hash52(p: np.ndarray) -> np.ndarray:
    """The spec's 52-bit avalanche hash (vectorized, uint64 holding u32)."""
    p = p.astype(np.uint64) & _M32
    p ^= p >> 15
    p = (p - ((p << 17) & _M32)) & _M32
    p = (p + ((p << 7) & _M32)) & _M32
    p = (p + ((p << 4) & _M32)) & _M32
    p ^= p >> 5
    p = (p + ((p << 16) & _M32)) & _M32
    p ^= p >> 7
    p ^= p >> 3
    p = (p ^ ((p << 6) & _M32)) & _M32
    p ^= p >> 17
    return p & _M32


def select_partition(
    seed: np.ndarray, x: np.ndarray, y: np.ndarray, z, partition_count: int,
    small_block: bool,
) -> np.ndarray:
    """Texel -> partition index (vectorized over broadcastable inputs)."""
    seed = np.asarray(seed, np.uint64)
    x = np.asarray(x, np.int64).copy()
    y = np.asarray(y, np.int64).copy()
    z = np.asarray(z, np.int64).copy()
    if small_block:
        x <<= 1
        y <<= 1
        z <<= 1
    seed = seed + np.uint64((partition_count - 1) * 1024)
    rnum = _hash52(seed)
    s = [((rnum >> np.uint64(sh)) & np.uint64(0xF)).astype(np.int64) for sh in
         (0, 4, 8, 12, 16, 20, 24, 28)]
    s9 = ((rnum >> np.uint64(18)) & np.uint64(0xF)).astype(np.int64)
    s10 = ((rnum >> np.uint64(22)) & np.uint64(0xF)).astype(np.int64)
    s11 = ((rnum >> np.uint64(26)) & np.uint64(0xF)).astype(np.int64)
    s12 = (((rnum >> np.uint64(30)) | (rnum << np.uint64(2))) & np.uint64(0xF)).astype(np.int64)
    seeds = [v * v for v in s + [s9, s10, s11, s12]]

    seed_i = seed.astype(np.int64)
    sh1 = np.where(seed_i & 1, np.where(seed_i & 2, 4, 5), 6 if partition_count == 3 else 5)
    sh2 = np.where(seed_i & 1, 6 if partition_count == 3 else 5, np.where(seed_i & 2, 4, 5))
    sh3 = np.where(seed_i & 0x10, sh1, sh2)

    sds = [
        seeds[0] >> sh1, seeds[1] >> sh2, seeds[2] >> sh1, seeds[3] >> sh2,
        seeds[4] >> sh1, seeds[5] >> sh2, seeds[6] >> sh1, seeds[7] >> sh2,
        seeds[8] >> sh3, seeds[9] >> sh3, seeds[10] >> sh3, seeds[11] >> sh3,
    ]
    rn = rnum.astype(np.int64)
    a = (sds[0] * x + sds[1] * y + sds[10] * z + (rn >> 14)) & 0x3F
    b = (sds[2] * x + sds[3] * y + sds[9] * z + (rn >> 10)) & 0x3F
    c = (sds[4] * x + sds[5] * y + sds[8] * z + (rn >> 6)) & 0x3F
    d = (sds[6] * x + sds[7] * y + sds[11] * z + (rn >> 2)) & 0x3F
    if partition_count < 4:
        d = np.zeros_like(d)
    if partition_count < 3:
        c = np.zeros_like(c)
    if partition_count < 2:
        b = np.zeros_like(b)
    out = np.where(
        (a >= b) & (a >= c) & (a >= d), 0,
        np.where((b >= c) & (b >= d), 1, np.where(c >= d, 2, 3)),
    )
    return out


@functools.lru_cache(maxsize=32)
def partition_table(bw: int, bh: int, partition_count: int) -> np.ndarray:
    """[1024, bw*bh] int8 texel->partition map for every seed."""
    small = bw * bh < 31
    xs = np.tile(np.arange(bw), bh)
    ys = np.repeat(np.arange(bh), bw)
    seeds = np.arange(1024, dtype=np.uint64)[:, None]
    return select_partition(
        seeds, xs[None, :], ys[None, :], np.zeros((1, bw * bh), np.int64),
        partition_count, small,
    ).astype(np.int8)


@functools.lru_cache(maxsize=32)
def unique_partition_seeds(bw: int, bh: int, partition_count: int):
    """Representative seed ids for the distinct partition patterns.

    The 10-bit seed hash maps many seeds to the same texel->partition
    pattern (4x4 2-subset: 438 distinct of 1024, counting a pattern and
    its complement once — the 2-subset fit is symmetric in the subsets);
    screening only the representatives shrinks the partition matmul and
    the top-k extraction proportionally.  Returns a sorted int32 array
    of the lowest seed per pattern.
    """
    table = partition_table(bw, bh, partition_count)
    seen = {}
    for seed in range(1024):
        key = tuple(int(v) for v in table[seed])
        if partition_count == 2:
            comp = tuple(1 - v for v in key)
            key = min(key, comp)
        if key not in seen:
            seen[key] = seed
    return np.asarray(sorted(seen.values()), np.int32)
