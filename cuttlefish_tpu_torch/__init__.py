"""cuttlefish_tpu_torch: the PyTorch/CUDA port of cuttlefish_tpu.

Same public API as ``cuttlefish_tpu``, with a ``Texture`` that takes a
``device``: the CUDA card by default, where the block encoders are
hand-written CUDA kernels (``csrc/``); on a CPU device their plain PyTorch
versions.  The host layers (formats, images, codecs, containers, standard
converters, decoders) are the port's own copies of the JAX package's; this
package imports neither JAX nor ``cuttlefish_tpu``.

    from cuttlefish_tpu_torch import Dimension, Texture, TextureFormat
    tex = Texture(Dimension.Dim2D, 256, 256)               # on the card
    tex = Texture(Dimension.Dim2D, 256, 256, device="cpu")  # plain version

Every format, at every quality: BC1-BC7 (BC6H UFloat and Float
included), ETC1, ETC2 RGB, RGBA8 and punch-through (R8G8B8A1), EAC R11 and
RG11, ASTC LDR and HDR (all 14 2D block sizes), PVRTC1 and PVRTC2 and the
uncompressed formats, and ``Texture.convert_with_mips``, the fused mip
pipeline on the device.  The JAX package encodes ETC2 punch-through, ASTC
HDR and PVRTC with XLA programs and no TPU kernel, and the port runs them
as torch ops on the device.  ``metrics`` scores a texture against its
source.
"""

from cuttlefish_tpu_torch.containers.load import LoadError, load_texture
from cuttlefish_tpu_torch.formats import (
    Alpha,
    ColorMask,
    ColorSpace,
    CubeFace,
    Dimension,
    FileType,
    ImageIndex,
    MipReplacement,
    Quality,
    SaveResult,
    TextureFormat,
    TextureType,
    block_height,
    block_size,
    block_width,
    file_type_for_name,
    has_alpha,
    has_native_srgb,
    is_format_valid,
    max_mipmap_levels,
    min_height,
    min_width,
)
from cuttlefish_tpu_torch.image import Image, ImageFormat, NormalOptions, ResizeFilter, RotateAngle
from cuttlefish_tpu_torch.texture import CustomMipImage, Texture

__version__ = "0.1.0"

__all__ = [
    "Alpha",
    "ColorMask",
    "LoadError",
    "load_texture",
    "ColorSpace",
    "CubeFace",
    "CustomMipImage",
    "Dimension",
    "FileType",
    "Image",
    "ImageFormat",
    "ImageIndex",
    "MipReplacement",
    "NormalOptions",
    "Quality",
    "ResizeFilter",
    "RotateAngle",
    "SaveResult",
    "Texture",
    "TextureFormat",
    "TextureType",
    "block_height",
    "block_size",
    "block_width",
    "file_type_for_name",
    "has_alpha",
    "has_native_srgb",
    "is_format_valid",
    "max_mipmap_levels",
    "min_height",
    "min_width",
]
