"""BC1-BC7 converters of the port (counterpart of
``cuttlefish_tpu/convert/s3tc.py``).

Channel weighting: sRGB sources use perceptual weights and the colour mask
zeroes ignored channels' error weight, as in the JAX package.  Signed BC4
and BC5 and both kinds of BC6H take the f16 wire (``transfer_dtype``), the
others the u8 wire.
"""

from __future__ import annotations

import numpy as np

from cuttlefish_tpu_torch.convert import Converter, EncodeParams
from cuttlefish_tpu_torch.convert.device import BlockConverter
from cuttlefish_tpu_torch.formats import ColorSpace, TextureFormat, TextureType

_F = TextureFormat
_T = TextureType


def _channel_weights(params: EncodeParams) -> np.ndarray:
    """``cuttlefish_tpu/convert/s3tc.py:_channel_weights``: float32 weights."""
    if params.color_space is ColorSpace.sRGB:
        w = np.array([0.3, 0.59, 0.11], np.float32) * 3.0
    else:
        w = np.ones(3, np.float32)
    mask = np.array(
        [params.color_mask.r, params.color_mask.g, params.color_mask.b], np.float32
    )
    w = w * mask
    if w.sum() == 0:
        w = np.ones(3, np.float32)
    return w


class Bc1Converter(BlockConverter):
    def __init__(self, punch_through: bool, device=None):
        super().__init__(device)
        self._punch = punch_through

    def encode_blocks(self, blocks, params):
        from cuttlefish_tpu_torch.kernels import bc

        return bc.encode_bc1(
            blocks,
            quality=int(params.quality),
            punch_through=self._punch,
            allow_black=not self._punch,
            ch_weights=_channel_weights(params),
        )


class Bc2Converter(BlockConverter):
    def encode_blocks(self, blocks, params):
        from cuttlefish_tpu_torch.kernels import bc

        return bc.encode_bc2(
            blocks, quality=int(params.quality), ch_weights=_channel_weights(params)
        )


class Bc3Converter(BlockConverter):
    def encode_blocks(self, blocks, params):
        from cuttlefish_tpu_torch.kernels import bc

        return bc.encode_bc3(
            blocks, quality=int(params.quality), ch_weights=_channel_weights(params)
        )


class Bc4Converter(BlockConverter):
    def __init__(self, signed: bool, device=None):
        super().__init__(device)
        self._signed = signed
        if signed:
            self.transfer_dtype = "f16"

    def encode_blocks(self, blocks, params):
        from cuttlefish_tpu_torch.kernels import bc

        return bc.encode_bc4(
            blocks[..., 0].contiguous(), quality=int(params.quality), signed=self._signed
        )


class Bc5Converter(BlockConverter):
    def __init__(self, signed: bool, device=None):
        super().__init__(device)
        self._signed = signed
        if signed:
            self.transfer_dtype = "f16"

    def encode_blocks(self, blocks, params):
        from cuttlefish_tpu_torch.kernels import bc

        return bc.encode_bc5(blocks, quality=int(params.quality), signed=self._signed)


class Bc6hConverter(BlockConverter):
    transfer_dtype = "f16"  # half-float HDR domain (lossless wire format)

    def __init__(self, signed: bool, device=None):
        super().__init__(device)
        self._signed = signed

    def encode_blocks(self, blocks, params):
        from cuttlefish_tpu_torch.kernels import bc6h

        return bc6h.encode_bc6h(
            blocks[..., :3].contiguous(), quality=int(params.quality),
            signed=self._signed, metric=params.hdr_metric,
        )


class Bc7Converter(BlockConverter):
    """Perceptual channel weights when the texture is sRGB."""

    def encode_blocks(self, blocks, params):
        from cuttlefish_tpu_torch.kernels import bc7

        return bc7.encode_bc7(
            blocks,
            quality=int(params.quality),
            perceptual=params.color_space is ColorSpace.sRGB,
        )


def create_s3tc_converter(
    fmt: TextureFormat, type_: TextureType, device=None
) -> Converter | None:
    """Factory rows for BC formats (Converter.cpp:173-254)."""
    if fmt is _F.BC1_RGB:
        return Bc1Converter(punch_through=False, device=device)
    if fmt is _F.BC1_RGBA:
        return Bc1Converter(punch_through=True, device=device)
    if fmt is _F.BC2:
        return Bc2Converter(device)
    if fmt is _F.BC3:
        return Bc3Converter(device)
    if fmt is _F.BC4:
        return Bc4Converter(signed=type_ is _T.SNorm, device=device)
    if fmt is _F.BC5:
        return Bc5Converter(signed=type_ is _T.SNorm, device=device)
    if fmt is _F.BC6H:
        return Bc6hConverter(signed=type_ is _T.Float, device=device)
    if fmt is _F.BC7:
        return Bc7Converter(device)
    return None
