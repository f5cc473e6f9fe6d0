"""Converter layer: (format, type) -> block encoder dispatch.

``EncodeParams`` and ``Converter`` are copied from
``cuttlefish_tpu/convert/__init__.py`` unchanged; ``create_converter`` is
the port's.  Uncompressed formats go to the copied host converters of
``convert/standard.py``; BC1-BC7 (``convert/s3tc.py``), ETC1, ETC2 and
EAC (``convert/etc.py``) and ASTC LDR (``convert/astc.py``) go to the
port's block converters on a torch device, ASTC UFloat to its HDR
profile, and PVRTC1/2 to the whole-surface converters of
``convert/pvrtc.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from cuttlefish_tpu_torch.formats import (
    Alpha,
    ColorMask,
    ColorSpace,
    Quality,
    TextureFormat,
    TextureType,
    is_format_valid,
)


@dataclasses.dataclass(frozen=True)
class EncodeParams:
    """Runtime knobs threaded to every encoder (Texture.h:740-742)."""

    quality: Quality = Quality.Normal
    alpha_type: Alpha = Alpha.Standard
    color_mask: ColorMask = dataclasses.field(default_factory=ColorMask)
    color_space: ColorSpace = ColorSpace.Linear
    # Host content analysis (set per dispatch by BlockConverter via
    # refine_params): near-gray blocks present?  ASTC gates its luminance
    # CEM 0/4 fits on this; True (conservative) means "keep the fits".
    content_gray: bool = True
    # Non-opaque alpha present?  ASTC gates its CEM 12 / dual-plane fits
    # on this (CEM 8's implicit alpha is exact for opaque batches).
    content_alpha: bool = True
    # BC6H candidate-selection error domain: "value" (linear SSE, peak-
    # relative PSNR) or "code" (half-bit/log SSE, the ispc-class HDR
    # objective).  See kernels/bc6h.py:encode_bc6h; ignored elsewhere.
    hdr_metric: str = "value"


class Converter:
    """Base: encode a (H, W, 4) float32 RGBA surface to raster-order bytes."""

    def encode(self, surface: np.ndarray, params: EncodeParams) -> np.ndarray:
        raise NotImplementedError

    def encode_many(
        self, surfaces: list, params: EncodeParams
    ) -> list[np.ndarray]:
        """Encode several surfaces of one texture (all mips/faces/depths).

        Block-compressed formats override this to batch every surface's
        blocks into ONE device dispatch (the reference runs one thread pool
        over all images the same way, `Converter.cpp:508-593`); the default
        encodes surface-by-surface.
        """
        return [self.encode(s, params) for s in surfaces]


def create_converter(
    fmt: TextureFormat, type_: TextureType, device=None
) -> Converter | None:
    """Factory keyed on (format, type); None = invalid combination.

    ``device`` is where block encoders run: ``None`` is the CUDA card, a
    CPU device runs the plain PyTorch versions.
    """
    if not is_format_valid(fmt, type_):
        return None
    F = TextureFormat
    from cuttlefish_tpu_torch.convert import standard

    std = standard.create_standard_converter(fmt, type_)
    if std is not None:
        return std
    if fmt in (F.BC1_RGB, F.BC1_RGBA, F.BC2, F.BC3, F.BC4, F.BC5, F.BC6H, F.BC7):
        from cuttlefish_tpu_torch.convert import s3tc

        return s3tc.create_s3tc_converter(fmt, type_, device)
    if fmt in (
        F.ETC1, F.ETC2_R8G8B8, F.ETC2_R8G8B8A1, F.ETC2_R8G8B8A8, F.EAC_R11, F.EAC_R11G11,
    ):
        from cuttlefish_tpu_torch.convert import etc

        return etc.create_etc_converter(fmt, type_, device)
    if fmt.name.startswith("ASTC_"):
        from cuttlefish_tpu_torch.convert import astc

        return astc.create_astc_converter(fmt, type_, device)
    if fmt.name.startswith("PVRTC"):
        from cuttlefish_tpu_torch.convert import pvrtc

        return pvrtc.create_pvrtc_converter(fmt, type_, device)
    return None
