"""ASTC converters of the port (counterpart of ``cuttlefish_tpu/convert/astc.py``).

All 14 2D block sizes.  UNorm (sRGB included) is the LDR profile,
``AstcConverter``, through ``kernels/astc.py:encode_astc`` on the u8 wire;
``refine_params`` scans the host blocks before they travel, as the JAX
package does: a batch with no near-gray block skips the luminance CEM 0/4
fits and the 4-partition kernel, and an opaque batch skips CEM 12 and dual
plane.  UFloat is the HDR profile, ``AstcHdrConverter`` (CEM 11 direct
submode + CEM 14, the reference's HDR / HDR_RGB_LDR_A at
``AstcConverter.cpp:151-163``), through ``kernels/astc_hdr.py:
encode_astc_hdr`` (torch ops on the converter's device; the JAX package
has no TPU kernel for it) on the f16 wire.  It has no content gates, so it
keeps the base ``refine_params`` and the fused mip pipeline skips its host
scan of level 0.
"""

from __future__ import annotations

import dataclasses

from cuttlefish_tpu_torch.convert import Converter, EncodeParams
from cuttlefish_tpu_torch.convert.device import BlockConverter
from cuttlefish_tpu_torch.formats import (
    TextureFormat,
    TextureType,
    block_height,
    block_width,
)


class AstcConverter(BlockConverter):
    def __init__(self, fmt: TextureFormat, device=None):
        super().__init__(device)
        self.block_w = block_width(fmt)
        self.block_h = block_height(fmt)

    def refine_params(self, host_blocks, params: EncodeParams) -> EncodeParams:
        """Gate the CEM 0/4 fits on near-gray content and the CEM 12 /
        dual-plane fits on non-opaque alpha (the JAX package's
        ``AstcConverter.refine_params``)."""
        from cuttlefish_tpu_torch.kernels import astc_tables

        return dataclasses.replace(
            params,
            content_gray=astc_tables.has_gray_blocks(host_blocks),
            content_alpha=astc_tables.has_alpha_blocks(host_blocks),
        )

    def encode_blocks(self, blocks, params: EncodeParams):
        from cuttlefish_tpu_torch.kernels import astc

        return astc.encode_astc(
            blocks,
            block_w=self.block_w,
            block_h=self.block_h,
            quality=int(params.quality),
            gray=params.content_gray,
            alpha=params.content_alpha,
        )


class AstcHdrConverter(BlockConverter):
    transfer_dtype = "f16"  # HDR profile: half-float domain

    def __init__(self, fmt: TextureFormat, device=None):
        super().__init__(device)
        self.block_w = block_width(fmt)
        self.block_h = block_height(fmt)

    def encode_blocks(self, blocks, params: EncodeParams):
        from cuttlefish_tpu_torch.kernels import astc_hdr

        # Alpha is encoded LDR (HDR_RGB_LDR_A) with or without alpha.
        return astc_hdr.encode_astc_hdr(
            blocks,
            block_w=self.block_w,
            block_h=self.block_h,
            quality=int(params.quality),
        )


def create_astc_converter(
    fmt: TextureFormat, type_: TextureType, device=None
) -> Converter | None:
    if not fmt.name.startswith("ASTC_"):
        return None
    if type_ is TextureType.UFloat:
        return AstcHdrConverter(fmt, device)
    return AstcConverter(fmt, device)
