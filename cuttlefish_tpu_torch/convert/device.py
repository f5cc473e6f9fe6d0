"""Host <-> device block batching for the port's block converters.

Counterpart of ``cuttlefish_tpu/convert/device.py:BlockConverter``: remap
each surface (``prepare_surface``), tile it with ``extract_blocks``,
concatenate, send the blocks to the device on the converter's wire
(``transfer_dtype``: u8 for 8-bit-domain formats, f16 for signed ones),
widen them to float32 there, encode once, fetch, and interleave the words
into raster-order bytes.  PyTorch runs eagerly, so there is no power-of-two
bucket (an XLA jit-cache device) and no padding.
"""

from __future__ import annotations

import numpy as np
import torch

from cuttlefish_tpu_torch import profiling
from cuttlefish_tpu_torch.convert import Converter, EncodeParams
from cuttlefish_tpu_torch.convert.blocks import extract_blocks, interleave_block_bytes

# float32(1/255): dequantisation multiplies by it, as the JAX path does, so
# the kernel's later *255 sees the same float32 values.
_INV255 = 1.0 / 255.0


def wire_u8(blocks: np.ndarray) -> np.ndarray:
    """Host-side u8 wire format: round half up after clipping to [0,1]."""
    return (np.clip(blocks, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def dequant_u8(u8: torch.Tensor) -> torch.Tensor:
    """Inverse of ``wire_u8``, on the tensor's device."""
    return u8.to(torch.float32) * _INV255


def wire(blocks: np.ndarray, dtype: str) -> torch.Tensor:
    """Host blocks -> the CPU tensor that travels (``_wire`` of the JAX
    package): u8 as ``wire_u8``, f16 as ``astype(float16)``."""
    if dtype == "u8":
        return torch.from_numpy(wire_u8(blocks))
    if dtype == "f16":
        return torch.from_numpy(blocks.astype(np.float16))
    raise ValueError(f"unknown transfer dtype {dtype!r}")


def dequant(blocks: torch.Tensor) -> torch.Tensor:
    """Inverse of ``wire``, on the tensor's device."""
    if blocks.dtype == torch.uint8:
        return dequant_u8(blocks)
    return blocks.to(torch.float32)


class BlockConverter(Converter):
    """Base for block-compressed formats of the port.

    Subclasses implement ``encode_blocks([N, bh*bw, 4] float32 tensor on
    self.device, params) -> [N, words] uint32 tensor``.  ``device`` ``None``
    is the CUDA card; a CPU device runs the plain PyTorch versions.
    """

    block_w = 4
    block_h = 4
    transfer_dtype = "u8"  # "u8" | "f16"

    def __init__(self, device=None):
        self.device = torch.device("cuda" if device is None else device)

    def encode_blocks(self, blocks: torch.Tensor, params: EncodeParams):
        raise NotImplementedError

    def prepare_surface(self, surface: np.ndarray, params: EncodeParams) -> np.ndarray:
        """Hook for input-domain remaps (as in the JAX package)."""
        return surface

    def refine_params(self, host_blocks: np.ndarray, params: EncodeParams) -> EncodeParams:
        """Hook: inspect the host float blocks of the whole batch and return
        params with content-derived flags filled in (as in the JAX
        package; ASTC sets ``content_gray`` and ``content_alpha``)."""
        return params

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
                surface = self.prepare_surface(np.asarray(surface, np.float32), params)
                blocks, _, _ = extract_blocks(surface, self.block_w, self.block_h)
                all_blocks.append(blocks)
                counts.append(blocks.shape[0])
            blocks = (
                np.concatenate(all_blocks) if len(all_blocks) > 1 else all_blocks[0]
            )
            params = self.refine_params(blocks, params)
            host = wire(blocks, self.transfer_dtype)
        with profiling.phase("upload"):
            blocks = dequant(host.to(self.device))
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
