"""Image layer: decode, pixel formats, and manipulation ops.

TPU-native analog of the reference image layer
(`lib/src/Image.cpp`, `lib/include/cuttlefish/Image.h`):
host-side codecs (PIL + custom HDR) replace FreeImage; pixel storage is
numpy in each format's natural layout; manipulation ops are vectorized and
match the reference's double-precision per-pixel semantics.

Copied from ``cuttlefish_tpu/image/__init__.py`` with its imports pointed at
the port; its logic is unchanged.
"""

from cuttlefish_tpu_torch.image.format import Channel, ImageFormat
from cuttlefish_tpu_torch.image.image import Image, NormalOptions, ResizeFilter, RotateAngle

__all__ = [
    "Channel",
    "Image",
    "ImageFormat",
    "NormalOptions",
    "ResizeFilter",
    "RotateAngle",
]
