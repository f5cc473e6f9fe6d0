"""Block tiling: surfaces <-> batched block arrays.

The TPU encoders operate on [N, bh*bw, C] batches.  Tiling replicates edge
texels into partial blocks (clamp-to-edge), matching the reference's block
gather (`lib/src/S3tcConverter.cpp:242-255`).  Raster order of
blocks (row-major over the block grid) is preserved so the encoded bytes
concatenate directly into container surfaces.

Copied from ``cuttlefish_tpu/convert/blocks.py`` with its imports pointed at
the port; its logic is unchanged.
"""

from __future__ import annotations

import numpy as np


def extract_blocks(
    surface: np.ndarray, block_w: int, block_h: int
) -> tuple[np.ndarray, int, int]:
    """(H, W, C) -> ([nby*nbx, block_h*block_w, C], nbx, nby).

    Edge-clamps to a block multiple first.
    """
    h, w = surface.shape[:2]
    nbx = -(-w // block_w)
    nby = -(-h // block_h)
    pad_w = nbx * block_w - w
    pad_h = nby * block_h - h
    if pad_w or pad_h:
        surface = np.pad(surface, ((0, pad_h), (0, pad_w), (0, 0)), mode="edge")
    c = surface.shape[2]
    blocks = (
        surface.reshape(nby, block_h, nbx, block_w, c)
        .transpose(0, 2, 1, 3, 4)
        .reshape(nby * nbx, block_h * block_w, c)
    )
    return np.ascontiguousarray(blocks), nbx, nby


def interleave_block_bytes(words: np.ndarray) -> np.ndarray:
    """[N, k] little-endian uint32/uint16 words per block -> [N*k*itemsize] bytes."""
    return np.ascontiguousarray(words.astype(words.dtype.newbyteorder("<"))).reshape(
        words.shape[0], -1
    ).view(np.uint8).reshape(-1)
