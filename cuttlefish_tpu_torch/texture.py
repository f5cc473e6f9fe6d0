"""Texture assembly: the [mip][depth][face] image pyramid and conversion.

Analog of the reference `Texture` class
(`lib/src/Texture.cpp`, `lib/include/cuttlefish/Texture.h`):
holds the mip pyramid of RGBAF images, generates mipmaps (with custom-mip
Once/Continue injection, Texture.cpp:1320-1514, and 3D Z-filtering in linear
space, Texture.cpp:103-227), dispatches block encoding to the port's
converters on a torch device, and serializes to DDS/KTX/PVR containers.

Copied from ``cuttlefish_tpu/texture.py`` with its imports pointed at the
port.  What differs: ``Texture`` takes a ``device`` (the CUDA card unless
the caller names another; a CPU device runs the plain PyTorch versions of
the kernels), ``convert`` and ``convert_with_mips`` (the fused device
mip pipeline) report the kernel launches they made, each public call
is a span of the texture's record (``Texture.spans``, ``profiling``), and
``set_image`` keeps a CUDA texture's faces in page-locked host memory.
"""

from __future__ import annotations

import dataclasses
import functools
import io
import os
import time

import numpy as np
import torch

from cuttlefish_tpu_torch import profiling
from cuttlefish_tpu_torch.color import linear_to_srgb, srgb_to_linear
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
    file_type_for_name,
    has_native_srgb,
    is_format_valid,
    max_mipmap_levels,
)
from cuttlefish_tpu_torch.image import Image, ImageFormat, NormalOptions, ResizeFilter
from cuttlefish_tpu_torch.image.format import to_rgbad
from cuttlefish_tpu_torch.image.resample import resample_weights, resample_weights_z


def _spanned(name: str):
    """Run the method as the root span ``name`` of its texture's record."""

    def wrap(method):
        @functools.wraps(method)
        def call(self, *args, **kwargs):
            with profiling.span(name, self.spans):
                return method(self, *args, **kwargs)

        return call

    return wrap


@dataclasses.dataclass
class CustomMipImage:
    """A user-provided replacement mip image (Texture.h:172-200)."""

    image: Image
    replacement: MipReplacement = MipReplacement.Once


class Texture:
    """A texture assembled from images, convertible and savable.

    Block encoders run on ``device``: ``None`` (the default) is the CUDA
    card, where the hand-written kernels run; a CPU device runs their plain
    PyTorch versions.  A CUDA device without a card raises when an encode
    runs; nothing falls back to the CPU.

    ``spans`` holds the texture's newest spans (``profiling.Record``): each
    public call (``set_image``, ``convert``, ``convert_with_mips``,
    ``save``, ``save_to_bytes``) is a root span, the layers below it its
    children.
    """

    def __init__(
        self,
        dimension: Dimension | None = None,
        width: int = 0,
        height: int = 0,
        depth: int = 0,
        mip_levels: int = 1,
        color_space: ColorSpace = ColorSpace.Linear,
        device=None,
    ):
        self.device = torch.device("cuda" if device is None else device)
        self.spans = profiling.Record()
        self._host_allocs = 0
        self._valid = False
        if dimension is not None:
            self.initialize(dimension, width, height, depth, mip_levels, color_space)

    # -- setup -------------------------------------------------------------

    def initialize(
        self,
        dimension: Dimension,
        width: int,
        height: int,
        depth: int = 0,
        mip_levels: int = 1,
        color_space: ColorSpace = ColorSpace.Linear,
    ) -> bool:
        """Allocate the image pyramid (Texture.cpp:1136-1163)."""
        self._valid = False
        if width == 0 or height == 0 or (dimension is Dimension.Dim3D and depth == 0):
            return False
        self._dimension = dimension
        self._color_space = color_space
        self._width = width
        self._height = height
        self._depth = depth
        self._mip_levels = min(
            max(mip_levels, 1), max_mipmap_levels(dimension, width, height, depth)
        )
        self._faces = 6 if dimension is Dimension.Cube else 1
        # images[mip][depth][face] -> Image | None
        self._images: list[list[list[Image | None]]] = [
            [[None] * self._faces for _ in range(max(self._effective_depth(m), 1))]
            for m in range(self._mip_levels)
        ]
        self._textures: list[list[list[bytes]]] | None = None
        self._format = TextureFormat.Unknown
        self._type = TextureType.UNorm
        self._alpha_type = Alpha.Standard
        self._color_mask = ColorMask()
        self._valid = True
        return True

    def reset(self) -> None:
        """Return to the uninitialized state (Texture.h:576)."""
        self._valid = False
        self._images = []
        self._textures = None
        self._format = TextureFormat.Unknown

    def _effective_depth(self, mip_level: int) -> int:
        if self._dimension is Dimension.Dim3D:
            return max(self._depth >> mip_level, 1)
        return max(self._depth, 1) if self._depth else 1

    # -- accessors ---------------------------------------------------------

    @property
    def is_valid(self) -> bool:
        return self._valid

    def __bool__(self) -> bool:
        return self._valid

    @property
    def dimension(self) -> Dimension:
        return self._dimension if self._valid else Dimension.Dim2D

    @property
    def color_space(self) -> ColorSpace:
        return self._color_space if self._valid else ColorSpace.Linear

    def width(self, mip_level: int = 0) -> int:
        if not self._valid or mip_level >= self._mip_levels:
            return 0
        return max(self._width >> mip_level, 1)

    def height(self, mip_level: int = 0) -> int:
        if not self._valid or mip_level >= self._mip_levels:
            return 0
        return max(self._height >> mip_level, 1)

    def depth(self, mip_level: int = 0) -> int:
        if not self._valid or mip_level >= self._mip_levels:
            return 0
        return self._effective_depth(mip_level)

    @property
    def mip_levels(self) -> int:
        return self._mip_levels if self._valid else 0

    @property
    def faces(self) -> int:
        return self._faces if self._valid else 0

    @property
    def is_array(self) -> bool:
        return self._valid and self._depth > 0 and self._dimension is not Dimension.Dim3D

    @property
    def format(self) -> TextureFormat:
        return self._format if self._valid else TextureFormat.Unknown

    @property
    def type(self) -> TextureType:
        return self._type if self._valid else TextureType.UNorm

    @property
    def alpha_type(self) -> Alpha:
        return self._alpha_type if self._valid else Alpha.Null

    @property
    def color_mask(self) -> ColorMask:
        return self._color_mask if self._valid else ColorMask()

    # -- image management --------------------------------------------------

    @_spanned("texture.set_image")
    def set_image(
        self,
        image: Image,
        face: CubeFace | None = None,
        mip_level: int = 0,
        depth: int = 0,
    ) -> bool:
        """Set one source image (Texture.cpp:1252-1318): converts to RGBAF and
        to the texture's color space.

        The texture keeps a private copy: a later change to the caller's
        array does not reach it.  On a CUDA texture the copy lives in
        page-locked host memory (``_face_memory``)."""
        if not self._valid or mip_level >= self._mip_levels:
            return False
        if depth >= self.depth(mip_level) and not (self._depth == 0 and depth == 0):
            return False
        if image.width != self.width(mip_level) or image.height != self.height(mip_level):
            return False
        if face is None:
            if self._faces != 1:
                return False
            face_idx = 0
        else:
            if self._faces != 6 and face is not CubeFace.PosX:
                return False
            face_idx = int(face) if self._faces == 6 else 0

        if not image:
            return False
        # The face's one private float32 copy, written where it will stay:
        # the same values as ``image.convert(RGBAF)`` and
        # ``change_color_space``, without their intermediate copies.
        face, pinned = self._face_memory((image.height, image.width, 4))
        if image.format is not ImageFormat.RGBAF:
            np.copyto(face, to_rgbad(image.array, image.format))
        elif pinned and image.array.flags.writeable:
            # torch's copy runs on every intra-op thread: 3.4 ms for 64 MB on
            # an H100 machine's host, against 13.3 ms for NumPy's one thread.
            torch.from_numpy(face).copy_(torch.from_numpy(image.array))
        else:
            np.copyto(face, image.array)
        if image.color_space is not self._color_space:
            fn = srgb_to_linear if self._color_space is ColorSpace.Linear else linear_to_srgb
            face[..., :3] = fn(face[..., :3])
        self._images[mip_level][depth][face_idx] = Image.from_array(
            face, ImageFormat.RGBAF, self._color_space
        )
        return True

    def _face_memory(self, shape: tuple) -> tuple[np.ndarray, bool]:
        """Empty float32 memory for one face's copy, and whether it is
        page-locked.

        On a CUDA texture it is a block of torch's caching host allocator:
        the upload of level 0 reads it by direct DMA, and when the texture
        is dropped the block returns to the cache, where the next texture
        of the size takes it already mapped and locked (the allocator
        rounds a block up to a power of two).  New blocks made count in
        ``last_convert_stats["staging"]["host_allocs"]``.  Elsewhere, or
        where pinning fails, it is plain NumPy memory.
        """
        if self.device.type == "cuda":
            try:
                before = torch.cuda.host_memory_stats().get("num_host_alloc", 0)
                face = torch.empty(shape, dtype=torch.float32, pin_memory=True).numpy()
            except RuntimeError:
                pass
            else:
                after = torch.cuda.host_memory_stats().get("num_host_alloc", 0)
                self._host_allocs += after - before
                return face, True
        return np.empty(shape, np.float32), False

    def get_image(
        self, face: CubeFace | None = None, mip_level: int = 0, depth: int = 0
    ) -> Image | None:
        if not self._valid or mip_level >= self._mip_levels:
            return None
        face_idx = int(face) if (face is not None and self._faces == 6) else 0
        try:
            return self._images[mip_level][depth][face_idx]
        except IndexError:
            return None

    def images_complete(self) -> bool:
        """Every [mip][depth][face] slot filled (Texture.cpp:1516-1534)."""
        if not self._valid:
            return False
        return all(
            img is not None and img.valid
            for mips in self._images
            for faces in mips
            for img in faces
        )

    # -- mipmap generation -------------------------------------------------

    def generate_mipmaps(
        self,
        filter: ResizeFilter = ResizeFilter.CatmullRom,
        mip_levels: int = 0xFFFFFFFF,
        custom_mip_images: dict[ImageIndex, CustomMipImage] | None = None,
    ) -> bool:
        """Generate the mip chain (Texture.cpp:1320-1514).

        Custom mips replace generated images: Once resumes the generated chain
        below, Continue feeds the custom image down the chain.
        """
        if not self._valid:
            return False
        custom_mip_images = custom_mip_images or {}
        for faces in self._images[0]:
            for img in faces:
                if img is None or not img.valid:
                    return False
        for custom in custom_mip_images.values():
            if custom.image is None or not custom.image.valid:
                return False

        mip_levels = min(
            max(mip_levels, 1),
            max_mipmap_levels(self._dimension, self._width, self._height, self._depth),
        )
        self._mip_levels = mip_levels
        base = self._images[0]
        self._images = [base] + [
            [
                [None] * self._faces
                for _ in range(max(self._effective_depth(m), 1))
            ]
            for m in range(1, mip_levels)
        ]

        if self._dimension is Dimension.Dim3D:
            return self._generate_mipmaps_3d(filter, mip_levels, custom_mip_images)
        return self._generate_mipmaps_2d(filter, mip_levels, custom_mip_images)

    def _generate_mipmaps_2d(self, filter, mip_levels, custom_mip_images) -> bool:
        depth = max(self._depth, 1) if self._depth else 1
        for d in range(depth):
            for f in range(self._faces):
                prev_image: Image | None = None
                for mip in range(1, mip_levels):
                    mip_w, mip_h = self.width(mip), self.height(mip)
                    key = ImageIndex(CubeFace(f), mip, d)
                    custom = custom_mip_images.get(key)
                    restore_state = (
                        custom is not None and custom.replacement is MipReplacement.Once
                    )
                    cur_mip: Image | None = None
                    if custom is None or restore_state:
                        source = (
                            prev_image
                            if prev_image is not None
                            else self._images[mip - 1][d][f]
                        )
                        cur_mip = source.resize(mip_w, mip_h, filter)
                    prev_image = cur_mip if restore_state else None
                    if custom is not None:
                        mip_img = custom.image.resize(mip_w, mip_h, filter)
                        if mip_img.format is not ImageFormat.RGBAF:
                            mip_img = mip_img.convert(ImageFormat.RGBAF)
                        self._images[mip][d][f] = mip_img
                    else:
                        self._images[mip][d][f] = cur_mip
        return True

    def _generate_mipmaps_3d(self, filter, mip_levels, custom_mip_images) -> bool:
        input_images: list[Image] = []
        for mip in range(1, mip_levels):
            mip_w, mip_h, mip_d = self.width(mip), self.height(mip), self.depth(mip)

            # All depths of a custom level must be provided, consistently.
            custom_mips = False
            replacement = MipReplacement.Once
            for d in range(mip_d):
                found = custom_mip_images.get(ImageIndex(CubeFace.PosX, mip, d))
                if found is None:
                    if custom_mips:
                        return False
                elif d == 0:
                    custom_mips = True
                    replacement = found.replacement
                elif not custom_mips or replacement is not found.replacement:
                    return False

            restore_state = (
                custom_mips
                and replacement is MipReplacement.Once
                and mip < mip_levels - 1
            )
            mip_images: list[Image] = []
            if not custom_mips or restore_state:
                if not input_images:
                    input_images = [
                        self._images[mip - 1][d][0].resize(mip_w, mip_h, filter)
                        for d in range(len(self._images[mip - 1]))
                    ]
                else:
                    input_images = [
                        img.resize(mip_w, mip_h, filter) for img in input_images
                    ]
                mip_images = _generate_mips_3d(
                    input_images, mip_w, mip_h, mip_d, self._color_space, filter
                )

            input_images = list(mip_images) if restore_state else []

            if custom_mips:
                mip_images = []
                for d in range(mip_d):
                    found = custom_mip_images[ImageIndex(CubeFace.PosX, mip, d)]
                    img = found.image.resize(mip_w, mip_h, filter)
                    if img.format is not ImageFormat.RGBAF:
                        img = img.convert(ImageFormat.RGBAF)
                    mip_images.append(img)

            self._images[mip] = [[mip_images[d]] for d in range(mip_d)]
        return True

    # -- conversion --------------------------------------------------------

    @_spanned("texture.convert")
    def convert(
        self,
        fmt: TextureFormat,
        type_: TextureType = TextureType.UNorm,
        quality: Quality = Quality.Normal,
        alpha_type: Alpha = Alpha.Standard,
        color_mask: ColorMask | None = None,
        threads: int = 0,
        hdr_metric: str = "value",
    ) -> bool:
        """Encode every image to the target format (Texture.cpp:1536-1561),
        all surfaces in one encode on ``self.device``.

        ``threads`` is accepted for API parity.  ``hdr_metric`` is BC6H's
        candidate-selection error domain: "value" (linear) or "code"
        (half-bit).  ``last_convert_stats`` adds ``launches`` (kernel name
        -> launches of this convert, only kernels that ran; empty on a CPU
        device) and ``bc7_launches``.
        """
        del threads
        if not self.images_complete() or not is_format_valid(fmt, type_):
            return False
        if self._color_space is ColorSpace.sRGB and not has_native_srgb(fmt, type_):
            return False

        from cuttlefish_tpu_torch.convert import EncodeParams, create_converter
        from cuttlefish_tpu_torch.kernels import launch_counts

        converter = create_converter(fmt, type_, self.device)
        if converter is None:
            return False
        params = EncodeParams(
            quality=quality,
            alpha_type=alpha_type,
            color_mask=color_mask or ColorMask(),
            color_space=self._color_space,
            hdr_metric=hdr_metric,
        )
        self._format = fmt
        self._type = type_
        self._alpha_type = alpha_type
        self._color_mask = color_mask or ColorMask()

        launches0 = launch_counts()
        t0 = time.perf_counter()
        texels = 0
        try:
            # Collect every (mip, depth, face) surface and encode them in
            # one batch (converter.encode_many), as the reference runs one
            # thread pool over all images (Converter.cpp:508-593).
            with profiling.span("convert.prepare"):
                surfaces = []
                shape: list[tuple[int, int]] = []
                for mip in range(self._mip_levels):
                    for d in range(len(self._images[mip])):
                        for f in range(self._faces):
                            surface = self._images[mip][d][f].rgbaf()
                            texels += surface.shape[0] * surface.shape[1]
                            surfaces.append(surface)
                    shape.append((len(self._images[mip]), self._faces))
            with profiling.span("convert.encode"):
                encoded = converter.encode_many(surfaces, params)
            with profiling.span("convert.serialize"):
                textures: list[list[list[bytes]]] = []
                it = iter(encoded)
                for depths, faces in shape:
                    textures.append(
                        [
                            [bytes(next(it)) for _ in range(faces)]
                            for _ in range(depths)
                        ]
                    )
        except Exception:
            self._format = TextureFormat.Unknown
            self._textures = None
            raise
        elapsed = time.perf_counter() - t0
        launches = {
            k: n - launches0[k] for k, n in launch_counts().items() if n != launches0[k]
        }
        self.last_convert_stats = {
            "texels": texels,
            "seconds": elapsed,
            "mtexels_per_sec": texels / elapsed / 1e6 if elapsed > 0 else 0.0,
            "phases": profiling.phases(),
            "launches": launches,
            "bc7_launches": launches.get("bc7", 0),
        }
        self._textures = textures
        return True

    @_spanned("texture.convert_with_mips")
    def convert_with_mips(
        self,
        fmt: TextureFormat,
        type_: TextureType = TextureType.UNorm,
        quality: Quality = Quality.Normal,
        alpha_type: Alpha = Alpha.Standard,
        color_mask: ColorMask | None = None,
        mip_levels: int = 0xFFFFFFFF,
        filter: ResizeFilter = ResizeFilter.CatmullRom,
        normal_map: NormalOptions | None = None,
        normal_height: float = 1.0,
        hdr_metric: str = "value",
    ) -> bool:
        """The fused device mip pipeline (extension beyond the reference
        API, ``cuttlefish_tpu/texture.py:convert_with_mips``): build the
        mip chain on ``self.device`` and encode every level of every
        surface in one encode.

        Only level-0 images need to be set; level 0 travels once as
        float32, the chain, the sRGB round trip and the block tiling run
        on the device (``BlockConverter.encode_pyramid``).
        Quality-equivalent to ``generate_mipmaps() + convert()``, not
        bit-identical (no u8/f16 wire).  Block-compressed formats,
        2D/array/cube, the standard chain only.

        ``normal_map``: a ``NormalOptions`` bitmask; the level-0 images are
        heightfields turned into tangent-space normal maps on the device
        first (``Image.create_normal_map`` + ``set_image``'s colour-space
        round trip).  ``last_convert_stats`` has convert's keys (on a CUDA
        device ``launches["pyramid"]`` counts the pyramid kernel's launches,
        one a level), its ``phases`` the pipeline's (scan, upload, pyramid,
        kernel, fetch, interleave) and ``fused``, the whole, and
        ``staging``: the share of
        level 0's bytes uploaded from page-locked memory (``pinned_share``)
        and the pinned blocks the host allocator made for this texture's
        ``set_image`` calls (``host_allocs``; 0 where a cached block was
        taken back).
        """
        from cuttlefish_tpu_torch.convert import EncodeParams, create_converter
        from cuttlefish_tpu_torch.convert.device import BlockConverter
        from cuttlefish_tpu_torch.formats import block_width
        from cuttlefish_tpu_torch.kernels import launch_counts

        if not self._valid or self._dimension is Dimension.Dim3D:
            return False
        if not is_format_valid(fmt, type_) or block_width(fmt) <= 1:
            return False
        if self._color_space is ColorSpace.sRGB and not has_native_srgb(fmt, type_):
            return False
        depths = max(self._depth, 1) if self._depth else 1
        for d in range(depths):
            for f in range(self._faces):
                if self._images[0][d][f] is None:
                    return False

        converter = create_converter(fmt, type_, self.device)
        if not isinstance(converter, BlockConverter):
            return False
        levels = min(
            max(int(mip_levels), 1),
            max_mipmap_levels(self._dimension, self._width, self._height, self._depth),
        )
        params = EncodeParams(
            quality=quality,
            alpha_type=alpha_type,
            color_mask=color_mask or ColorMask(),
            color_space=self._color_space,
            hdr_metric=hdr_metric,
        )
        surfaces0 = [
            self._images[0][d][f].rgbaf() for d in range(depths) for f in range(self._faces)
        ]

        launches0 = launch_counts()
        t0 = time.perf_counter()
        per_level = converter.encode_pyramid(
            surfaces0,
            levels,
            filter.value,
            self._color_space is ColorSpace.sRGB,
            params,
            normal_opts=(
                None if normal_map is None else (int(normal_map), float(normal_height))
            ),
        )
        # Commit state only after a successful encode.
        self._mip_levels = levels
        self._images = [self._images[0]] + [
            [[None] * self._faces for _ in range(depths)] for _ in range(levels - 1)
        ]
        self._format = fmt
        self._type = type_
        self._alpha_type = alpha_type
        self._color_mask = color_mask or ColorMask()
        textures: list[list[list[bytes]]] = []
        for lvl in range(levels):
            it = iter(per_level[lvl])
            textures.append(
                [[bytes(next(it)) for _ in range(self._faces)] for _ in range(depths)]
            )
        self._textures = textures
        texels = sum(
            max(self._width >> k, 1) * max(self._height >> k, 1) for k in range(levels)
        ) * depths * self._faces
        elapsed = time.perf_counter() - t0
        launches = {
            k: n - launches0[k] for k, n in launch_counts().items() if n != launches0[k]
        }
        self.last_convert_stats = {
            "texels": texels,
            "seconds": elapsed,
            "mtexels_per_sec": texels / elapsed / 1e6 if elapsed > 0 else 0.0,
            "phases": {**profiling.phases(), "fused": elapsed},
            "launches": launches,
            "bc7_launches": launches.get("bc7", 0),
            "staging": {
                "pinned_share": self._pinned_share(surfaces0),
                "host_allocs": self._host_allocs,
            },
        }
        return True

    def _pinned_share(self, surfaces: list[np.ndarray]) -> float:
        """The share of ``surfaces``' bytes in page-locked memory, as the
        driver sees it; 0.0 off a CUDA texture, with no CUDA call."""
        if self.device.type != "cuda":
            return 0.0
        pinned = sum(sf.nbytes for sf in surfaces if torch.from_numpy(sf).is_pinned())
        return pinned / sum(sf.nbytes for sf in surfaces)

    @property
    def converted(self) -> bool:
        return self._valid and self._textures is not None

    def data(
        self, face: CubeFace | None = None, mip_level: int = 0, depth: int = 0
    ) -> bytes | None:
        """Encoded bytes of one surface."""
        if not self.converted:
            return None
        face_idx = int(face) if (face is not None and self._faces == 6) else 0
        try:
            return self._textures[mip_level][depth][face_idx]
        except IndexError:
            return None

    def data_size(
        self, face: CubeFace | None = None, mip_level: int = 0, depth: int = 0
    ) -> int:
        d = self.data(face, mip_level, depth)
        return 0 if d is None else len(d)

    def decode_image(
        self, face: CubeFace | None = None, mip_level: int = 0, depth: int = 0
    ) -> Image | None:
        """Decode one converted surface back to an RGBAF Image.

        Extension beyond the reference (which never decodes): dispatches
        to the spec decoders in ``decode/`` for compressed formats and
        inverts the standard packing for uncompressed ones.  Values are
        the format's natural decode domain (UNorm in [0,1], SNorm in
        [-1,1], Int/UInt raw integers as floats, HDR floats)."""
        data = self.data(face, mip_level, depth)
        if data is None:
            return None
        from cuttlefish_tpu_torch.decode.surface import decode_surface

        arr = decode_surface(
            data, self._format, self._type,
            self.width(mip_level), self.height(mip_level),
        )
        return Image.from_array(arr, ImageFormat.RGBAF, self._color_space)

    # -- save --------------------------------------------------------------

    @_spanned("texture.save")
    def save(
        self,
        target,
        file_type: FileType = FileType.Auto,
        supercompression: str = "none",
    ) -> SaveResult:
        """Save to a file path or binary stream (Texture.cpp:1638-1683).

        ``supercompression`` applies to KTX2 only ("none", "zstd", "zlib");
        any other file type returns Unsupported when it is not "none".
        """
        if not self.converted:
            return SaveResult.Invalid
        if isinstance(target, (str, os.PathLike)):
            if file_type is FileType.Auto:
                file_type = file_type_for_name(str(target))
            try:
                stream = open(target, "wb")
            except OSError:
                return SaveResult.WriteError
            with stream:
                return self._save_stream(stream, file_type, supercompression)
        return self._save_stream(target, file_type, supercompression)

    @_spanned("texture.save")
    def save_to_bytes(
        self, file_type: FileType, supercompression: str = "none"
    ) -> tuple[SaveResult, bytes]:
        stream = io.BytesIO()
        result = self._save_stream(stream, file_type, supercompression)
        return result, stream.getvalue()

    def _save_stream(
        self, stream, file_type: FileType, supercompression: str = "none"
    ) -> SaveResult:
        from cuttlefish_tpu_torch.containers import dds, ktx, ktx2, pvr

        if file_type is FileType.KTX2:
            with profiling.span("containers.ktx2"):
                return ktx2.save_ktx2(self, stream, supercompression)
        if supercompression != "none":
            return SaveResult.Unsupported
        if file_type is FileType.DDS:
            with profiling.span("containers.dds"):
                return dds.save_dds(self, stream)
        if file_type is FileType.KTX:
            with profiling.span("containers.ktx"):
                return ktx.save_ktx(self, stream)
        if file_type is FileType.PVR:
            with profiling.span("containers.pvr"):
                return pvr.save_pvr(self, stream)
        return SaveResult.UnknownFormat

    # -- static helpers mirrored from formats ------------------------------

    @staticmethod
    def adjust_image_value_range(
        image: Image, type_: TextureType, orig_format: ImageFormat | None = None
    ) -> Image:
        """Remap UNorm-source values for SNorm/UInt/Int targets
        (Texture.cpp:959-1086).  Returns the adjusted image (possibly
        converted to a float format); non-UNorm sources pass through.
        """
        if not image.valid:
            return image
        if orig_format is None or orig_format is ImageFormat.Invalid:
            orig_format = image.format
        if type_ not in (TextureType.SNorm, TextureType.UInt, TextureType.Int):
            return image

        unorm_sources = {
            ImageFormat.Gray8, ImageFormat.Gray16, ImageFormat.RGB5,
            ImageFormat.RGB565, ImageFormat.RGB8, ImageFormat.RGB16,
            ImageFormat.RGBA8, ImageFormat.RGBA16,
        }
        if orig_format not in unorm_sources:
            return image

        fmt = image.format
        # Promote to the matching float format.
        if fmt in (ImageFormat.Gray8, ImageFormat.Gray16, ImageFormat.Double):
            image = image.convert(ImageFormat.Float)
        elif fmt in (
            ImageFormat.RGB5, ImageFormat.RGB565, ImageFormat.RGB8,
            ImageFormat.RGB16, ImageFormat.Complex,
        ):
            image = image.convert(ImageFormat.RGBF)
        elif fmt in (ImageFormat.RGBA8, ImageFormat.RGBA16):
            image = image.convert(ImageFormat.RGBAF)
        elif fmt not in (ImageFormat.RGBF, ImageFormat.RGBAF, ImageFormat.Float):
            return image

        arr = image.array.astype(np.float64)
        if type_ is TextureType.SNorm:
            arr = arr * 2.0 - 1.0
        else:
            bit_scale = {
                ImageFormat.Gray8: (255.0, -128.0),
                ImageFormat.RGB8: (255.0, -128.0),
                ImageFormat.RGBA8: (255.0, -128.0),
                ImageFormat.Gray16: (65535.0, -32768.0),
                ImageFormat.RGB16: (65535.0, -32768.0),
                ImageFormat.RGBA16: (65535.0, -32768.0),
            }
            if orig_format in bit_scale:
                mult, int_off = bit_scale[orig_format]
                offset = int_off if type_ is TextureType.Int else 0.0
                arr = np.round(arr * mult + offset)
            elif orig_format is ImageFormat.RGB5:
                offset = -16.0 if type_ is TextureType.Int else 0.0
                arr = np.round(arr * 31.0 + offset)
            elif orig_format is ImageFormat.RGB565:
                mult = np.array([31.0, 63.0, 31.0])
                off = (
                    np.array([-16.0, -32.0, -16.0])
                    if type_ is TextureType.Int
                    else np.zeros(3)
                )
                arr = np.round(arr * mult + off)
            else:
                return image
        return Image.from_array(
            arr.astype(image.array.dtype), image.format, image.color_space
        )


def _generate_mips_3d(
    prev_level: list[Image],
    width: int,
    height: int,
    depth: int,
    color_space: ColorSpace,
    filter: ResizeFilter,
) -> list[Image]:
    """Filter XY-resized slices across Z in linear space (Texture.cpp:103-227).

    Box keeps box weights; all other filters use tent weights across Z.
    """
    stack = np.stack([img.rgbaf().astype(np.float64) for img in prev_level])
    if color_space is ColorSpace.sRGB:
        stack[..., :3] = srgb_to_linear(stack[..., :3])
    name = "box" if filter is ResizeFilter.Box else "linear"
    weights = resample_weights_z(len(prev_level), depth, name)
    result = np.tensordot(weights, stack, axes=(1, 0))
    if color_space is ColorSpace.sRGB:
        result[..., :3] = linear_to_srgb(np.maximum(result[..., :3], 0.0))
    return [
        Image.from_array(result[d].astype(np.float32), ImageFormat.RGBAF, color_space)
        for d in range(depth)
    ]
