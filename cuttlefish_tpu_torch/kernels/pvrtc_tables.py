"""Static tables of the PVRTC1/PVRTC2 encoder and decoder (numpy only).

Copied unchanged from ``cuttlefish_tpu/kernels/pvrtc.py``: the 4bpp
modulation weights (``_MOD_W_4BPP``), the PVR container's Morton block
order (``morton_order``) and the host-precomputed region-owner and
bilinear basis matrices (``_owner_matrix``, ``_basis_matrix``).  The
encoder is ``kernels/pvrtc.py``.
"""

from __future__ import annotations

import functools

import numpy as np

# Modulation blend weights (of 8): result = (A*(8-w) + B*w) / 8.
_MOD_W_4BPP = np.array([0, 3, 5, 8], np.float32)


def morton_order(nbx: int, nby: int) -> np.ndarray:
    """Block index permutation: output[i] = raster index of i-th stored
    block (PVR container Morton layout; extra bits of the larger dimension
    are appended linearly above the interleaved bits)."""
    n = nbx * nby
    out = np.zeros(n, np.int64)
    minb = min(nbx, nby)
    logm = int(minb).bit_length() - 1
    for i in range(n):
        # De-interleave the low 2*logm bits, rest goes to the larger dim.
        low = i & ((1 << (2 * logm)) - 1)
        x = y = 0
        for b in range(logm):
            y |= ((low >> (2 * b)) & 1) << b
            x |= ((low >> (2 * b + 1)) & 1) << b
        rest = i >> (2 * logm)
        if nbx >= nby:
            x |= rest << logm
        else:
            y |= rest << logm
        out[i] = y * nbx + x
    return out


@functools.lru_cache(maxsize=None)
def _owner_matrix(n_texels: int, block: int, n_blocks: int):
    """One-hot region-owner matrix O [n_blocks, n_texels]: O[j, y] = 1 if
    texel y lies in the half-block-offset decode region owned by block j
    (the window between the centers of j and j+1, clamped at borders).
    Region error sums and hard-flag expansion are then dense matmuls."""
    m = np.zeros((n_blocks, n_texels), np.float32)
    owner = np.clip(
        (np.arange(n_texels) - block // 2) // block, 0, n_blocks - 1
    )
    m[owner, np.arange(n_texels)] = 1.0
    return m


@functools.lru_cache(maxsize=None)
def _basis_matrix(n_texels: int, block: int, n_blocks: int, wrap: bool):
    """1-D bilinear basis matrix M [n_texels, n_blocks]: upscaled(y) =
    Σ_j M[y, j] · grid[j] along one axis (the 2-D basis is the outer
    product).  Border accumulation (clamp mode maps both neighbors of an
    edge texel to the same block) is already summed into M, so φ_j(y,x) =
    My[y, jy] · Mx[x, jx] exactly.  Host-precomputed; the refinement's
    scatter-adjoint becomes two dense matmuls (MXU) instead of TPU-hostile
    scatters."""
    m = np.zeros((n_texels, n_blocks), np.float32)
    half = block // 2
    for y in range(n_texels):
        f = y % block
        j = y // block
        if f < half:
            p_raw = j - 1
            w = (f + half) / block
        else:
            p_raw = j
            w = (f - half) / block
        if wrap:
            p = p_raw % n_blocks
            q = (p_raw + 1) % n_blocks
        else:
            # Clamp the bracketing PAIR (p_raw, p_raw+1) so border texels
            # collapse to the pure border block, matching upscale_bilinear.
            p = min(max(p_raw, 0), n_blocks - 1)
            q = min(max(p_raw + 1, 0), n_blocks - 1)
        m[y, p] += 1.0 - w
        m[y, q] += w
    return m
