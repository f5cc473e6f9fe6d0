"""cuttlefish_tpu_torch: the PyTorch/CUDA port of cuttlefish_tpu.

Same public API as ``cuttlefish_tpu``, with a ``Texture`` that takes a
``device``: on a CUDA device the block encoders are hand-written CUDA
kernels (``csrc/``), on the CPU their plain PyTorch versions.  The host
layers (formats, images, containers, standard converters) are
``cuttlefish_tpu``'s own, reused by import; this package never imports JAX.

    import torch
    from cuttlefish_tpu_torch import Dimension, Texture, TextureFormat
    tex = Texture(Dimension.Dim2D, 256, 256, device=torch.device("cuda"))

Ported so far: BC7 at quality 0-2 (``Quality.Lowest`` .. ``Normal``).
"""

from cuttlefish_tpu.containers.load import LoadError, load_texture
from cuttlefish_tpu.formats import (
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
from cuttlefish_tpu.image import Image, ImageFormat, NormalOptions, ResizeFilter, RotateAngle
from cuttlefish_tpu.texture import CustomMipImage
from cuttlefish_tpu_torch.texture import Texture

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
