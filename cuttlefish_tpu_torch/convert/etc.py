"""ETC1/ETC2/EAC converters of the port (counterpart of
``cuttlefish_tpu/convert/etc.py``).

ETC1, ETC2_R8G8B8, ETC2_R8G8B8A1 and ETC2_R8G8B8A8 take the u8 wire, EAC
R11/RG11 (signed and unsigned) the f16 wire.  Error metric: sRGB sources
weight RGB by Rec.709 x 3, linear sources use the numeric metric; the
colour mask zeroes ignored channels' weight, as in the JAX package.
ETC2_R8G8B8A1's encoder (``kernels/etc.py:encode_etc2_a1``) has no hand
kernel: the JAX package encodes it on its ``jnp`` path only, and the port
runs that path's torch ops on the converter's device.
"""

from __future__ import annotations

import numpy as np

from cuttlefish_tpu_torch.convert import Converter, EncodeParams
from cuttlefish_tpu_torch.convert.device import BlockConverter
from cuttlefish_tpu_torch.formats import ColorSpace, TextureFormat, TextureType

_F = TextureFormat
_T = TextureType


def _rgb_weights(params: EncodeParams) -> np.ndarray:
    """``cuttlefish_tpu/convert/etc.py:_rgb_weights``: float32 weights."""
    if params.color_space is ColorSpace.sRGB:
        w = np.array([0.2126, 0.7152, 0.0722], np.float32) * 3.0
    else:
        w = np.ones(3, np.float32)
    mask = np.array(
        [params.color_mask.r, params.color_mask.g, params.color_mask.b], np.float32
    )
    w = w * mask
    if w.sum() == 0:
        w = np.ones(3, np.float32)
    return w


class EtcRgbConverter(BlockConverter):
    def __init__(self, etc2: bool, device=None):
        super().__init__(device)
        self._etc2 = etc2

    def encode_blocks(self, blocks, params):
        from cuttlefish_tpu_torch.kernels import etc

        return etc.encode_etc_rgb(
            blocks,
            quality=int(params.quality),
            etc2=self._etc2,
            ch_weights=_rgb_weights(params),
        )


class Etc2RgbaConverter(BlockConverter):
    def encode_blocks(self, blocks, params):
        from cuttlefish_tpu_torch.kernels import etc

        return etc.encode_etc2_rgba(
            blocks, quality=int(params.quality), ch_weights=_rgb_weights(params)
        )


class Etc2PunchThroughConverter(BlockConverter):
    """ETC2_R8G8B8A1: texels with alpha < 0.5 become transparent black."""

    def encode_blocks(self, blocks, params):
        from cuttlefish_tpu_torch.kernels import etc

        return etc.encode_etc2_a1(
            blocks, quality=int(params.quality), ch_weights=_rgb_weights(params)
        )


class EacR11Converter(BlockConverter):
    transfer_dtype = "f16"  # 11-bit target domain; u8 wire would quantize

    def __init__(self, signed: bool, channels: int, device=None):
        super().__init__(device)
        self._signed = signed
        self._channels = channels

    def encode_blocks(self, blocks, params):
        from cuttlefish_tpu_torch.kernels import etc

        if self._channels == 1:
            return etc.encode_eac_r11(
                blocks[..., 0].contiguous(), quality=int(params.quality), signed=self._signed
            )
        return etc.encode_eac_rg11(blocks, quality=int(params.quality), signed=self._signed)


def create_etc_converter(
    fmt: TextureFormat, type_: TextureType, device=None
) -> Converter | None:
    """Factory rows for ETC/EAC formats (Converter.cpp:257-306)."""
    if fmt is _F.ETC1:
        return EtcRgbConverter(etc2=False, device=device)
    if fmt is _F.ETC2_R8G8B8:
        return EtcRgbConverter(etc2=True, device=device)
    if fmt is _F.ETC2_R8G8B8A1:
        return Etc2PunchThroughConverter(device)
    if fmt is _F.ETC2_R8G8B8A8:
        return Etc2RgbaConverter(device)
    if fmt is _F.EAC_R11:
        return EacR11Converter(signed=type_ is _T.SNorm, channels=1, device=device)
    if fmt is _F.EAC_R11G11:
        return EacR11Converter(signed=type_ is _T.SNorm, channels=2, device=device)
    return None
