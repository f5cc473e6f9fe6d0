"""PVRTC1/2 converters of the port (counterpart of
``cuttlefish_tpu/convert/pvrtc.py``).

PVRTC modulation reads neighbouring colour words, so blocks are not
independent: each surface is one whole-surface encode
(``kernels/pvrtc.py``, torch ops on the converter's device; the JAX
package has no TPU kernel for it), and ``encode_many`` is the base
``Converter``'s, surface by surface, as in the JAX package.  PVRTC1
RGB/RGBA 2bpp and 4bpp wrap around the surface; PVRTC2 RGBA 2/4bpp clamps
at its borders.

Surfaces must be power-of-two; smaller ones are edge-padded up to the
format's minimum (16x8 for 2bpp, 8x8 for 4bpp), matching PVRTC1 hardware
constraints.  Blocks are stored in the PVR container's Morton order.
"""

from __future__ import annotations

import numpy as np
import torch

from cuttlefish_tpu_torch import profiling
from cuttlefish_tpu_torch.convert import Converter, EncodeParams
from cuttlefish_tpu_torch.convert.device import BlockConverter
from cuttlefish_tpu_torch.formats import TextureFormat, TextureType

_F = TextureFormat


class Pvrtc1Converter(Converter):
    """PVRTC1 on a torch device: ``device`` ``None`` is the CUDA card, a
    CPU device runs the same torch ops on the host.  Records the phases
    pad, upload, kernel, fetch and morton in ``profiling.last_phases``."""

    version = 1

    def __init__(self, bpp2: bool, device=None):
        self._bpp2 = bpp2
        self.device = torch.device("cuda" if device is None else device)

    _sync = BlockConverter._sync

    def encode(self, surface: np.ndarray, params: EncodeParams) -> np.ndarray:
        from cuttlefish_tpu_torch.kernels.pvrtc import encode_pvrtc1, encode_pvrtc2
        from cuttlefish_tpu_torch.kernels.pvrtc_tables import morton_order

        with profiling.phase("pad"):
            surface = np.asarray(surface, np.float32)
            h, w = surface.shape[:2]
            bw, bh = (8, 4) if self._bpp2 else (4, 4)
            min_w, min_h = (16, 8) if self._bpp2 else (8, 8)
            # Small mip levels of a power-of-two chain are edge-padded up to
            # the format's minimum surface (PVRTC stores at least 2x2 color
            # words).
            if w < min_w or h < min_h:
                pw, ph = max(w, min_w), max(h, min_h)
                surface = np.pad(surface, ((0, ph - h), (0, pw - w), (0, 0)), mode="edge")
                h, w = ph, pw
            if w % bw or h % bh or (w & (w - 1)) or (h & (h - 1)):
                raise ValueError(
                    f"PVRTC1 requires power-of-two surfaces, multiple of {bw}x{bh}"
                )
        with profiling.phase("upload"):
            dev_surface = torch.from_numpy(np.ascontiguousarray(surface)).to(self.device)
            self._sync()
        with profiling.phase("kernel"):
            encode = encode_pvrtc1 if self.version == 1 else encode_pvrtc2
            words = encode(dev_surface, bpp2=self._bpp2, quality=int(params.quality))
            self._sync()
        with profiling.phase("fetch"):
            words = words.cpu().numpy().astype(np.uint32)
        with profiling.phase("morton"):
            perm = morton_order(w // bw, h // bh)
            words = words[perm]
            out = np.ascontiguousarray(words.astype("<u4")).view(np.uint8).reshape(-1)
        return out


class Pvrtc2Converter(Pvrtc1Converter):
    """PVRTC2 2/4bpp (``PvrtcConverter.cpp:90-93``): clamped-border variant."""

    version = 2


def create_pvrtc_converter(
    fmt: TextureFormat, type_: TextureType, device=None
) -> Converter | None:
    if fmt in (_F.PVRTC1_RGB_2BPP, _F.PVRTC1_RGBA_2BPP):
        return Pvrtc1Converter(bpp2=True, device=device)
    if fmt in (_F.PVRTC1_RGB_4BPP, _F.PVRTC1_RGBA_4BPP):
        return Pvrtc1Converter(bpp2=False, device=device)
    if fmt == _F.PVRTC2_RGBA_2BPP:
        return Pvrtc2Converter(bpp2=True, device=device)
    if fmt == _F.PVRTC2_RGBA_4BPP:
        return Pvrtc2Converter(bpp2=False, device=device)
    return None
