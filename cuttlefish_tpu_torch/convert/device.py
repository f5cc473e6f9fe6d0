"""Host <-> device block batching for the port's block converters.

Counterpart of ``cuttlefish_tpu/convert/device.py:BlockConverter``: tile
every surface with the reused ``extract_blocks``, concatenate, send the
blocks to the device as u8, dequantise there, encode once, fetch, and
interleave the words into raster-order bytes.  PyTorch runs eagerly, so
there is no power-of-two bucket (an XLA jit-cache device) and no padding.
"""

from __future__ import annotations

import numpy as np
import torch

from cuttlefish_tpu import profiling
from cuttlefish_tpu.convert import Converter, EncodeParams
from cuttlefish_tpu.convert.blocks import extract_blocks, interleave_block_bytes

# float32(1/255): dequantisation multiplies by it, as the JAX path does, so
# the kernel's later *255 sees the same float32 values.
_INV255 = 1.0 / 255.0


def wire_u8(blocks: np.ndarray) -> np.ndarray:
    """Host-side u8 wire format: round half up after clipping to [0,1]."""
    return (np.clip(blocks, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def dequant_u8(u8: torch.Tensor) -> torch.Tensor:
    """Inverse of ``wire_u8``, on the tensor's device."""
    return u8.to(torch.float32) * _INV255


class BlockConverter(Converter):
    """Base for block-compressed formats of the port.

    Subclasses implement ``encode_blocks([N, bh*bw, 4] float32 tensor on
    self.device, params) -> [N, words] uint32 tensor``.
    """

    block_w = 4
    block_h = 4

    def __init__(self, device):
        self.device = torch.device(device)

    def encode_blocks(self, blocks: torch.Tensor, params: EncodeParams):
        raise NotImplementedError

    def encode(self, surface: np.ndarray, params: EncodeParams) -> np.ndarray:
        return self.encode_many([surface], params)[0]

    def encode_many(self, surfaces: list, params: EncodeParams) -> list[np.ndarray]:
        """One encode for every surface: blocks of all surfaces are
        concatenated on the batch axis and split back afterwards.

        Records the phases tile, upload, kernel, fetch and interleave in
        ``profiling.last_phases``; on a CUDA device upload and kernel end
        in a synchronise, so each phase holds its own device time.
        """
        with profiling.phase("tile"):
            all_blocks = []
            counts = []
            for surface in surfaces:
                blocks, _, _ = extract_blocks(
                    np.asarray(surface, np.float32), self.block_w, self.block_h
                )
                all_blocks.append(blocks)
                counts.append(blocks.shape[0])
            blocks = (
                np.concatenate(all_blocks) if len(all_blocks) > 1 else all_blocks[0]
            )
            u8 = torch.from_numpy(wire_u8(blocks))
        with profiling.phase("upload"):
            blocks = dequant_u8(u8.to(self.device))
            self._sync()
        with profiling.phase("kernel"):
            words = self.encode_blocks(blocks, params)
            self._sync()
        with profiling.phase("fetch"):
            words = words.cpu().numpy().astype(np.uint32)
        with profiling.phase("interleave"):
            out = []
            start = 0
            for c in counts:
                out.append(interleave_block_bytes(words[start : start + c]))
                start += c
        return out

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
