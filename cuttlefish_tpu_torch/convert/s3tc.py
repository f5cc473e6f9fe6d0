"""BC7 converter of the port (counterpart of
``cuttlefish_tpu/convert/s3tc.py:Bc7Converter``)."""

from __future__ import annotations

from cuttlefish_tpu.formats import ColorSpace
from cuttlefish_tpu_torch.convert.device import BlockConverter


class Bc7Converter(BlockConverter):
    """Perceptual channel weights when the texture is sRGB."""

    def encode_blocks(self, blocks, params):
        from cuttlefish_tpu_torch.kernels import bc7

        return bc7.encode_bc7(
            blocks,
            quality=int(params.quality),
            perceptual=params.color_space is ColorSpace.sRGB,
        )
