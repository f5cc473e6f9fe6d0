"""Texture of the port: ``cuttlefish_tpu.texture.Texture`` on a torch device.

Only ``convert`` is replaced (the base class's reaches the JAX converters)
and ``convert_with_mips`` (the fused device mip pipeline, not ported yet).
Images, mipmaps and saving are the base class's, unchanged.
"""

from __future__ import annotations

import time

import torch

from cuttlefish_tpu import profiling
from cuttlefish_tpu.formats import (
    Alpha,
    ColorMask,
    ColorSpace,
    Dimension,
    Quality,
    TextureFormat,
    TextureType,
    has_native_srgb,
    is_format_valid,
)
from cuttlefish_tpu.texture import Texture as _BaseTexture


class Texture(_BaseTexture):
    """A texture whose block encoders run on ``device`` (a CPU device runs
    the plain PyTorch versions, a CUDA device the hand kernels)."""

    def __init__(
        self,
        dimension: Dimension | None = None,
        width: int = 0,
        height: int = 0,
        depth: int = 0,
        mip_levels: int = 1,
        color_space: ColorSpace = ColorSpace.Linear,
        device="cpu",
    ):
        self.device = torch.device(device)
        super().__init__(dimension, width, height, depth, mip_levels, color_space)

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
        """Encode every image to the target format, all surfaces in one
        encode (``cuttlefish_tpu/texture.py:Texture.convert``).

        ``last_convert_stats`` adds ``bc7_launches``: the BC7 kernel
        launches this convert made (0 on a CPU device).
        """
        del threads
        if not self.images_complete() or not is_format_valid(fmt, type_):
            return False
        if self._color_space is ColorSpace.sRGB and not has_native_srgb(fmt, type_):
            return False

        from cuttlefish_tpu_torch.convert import EncodeParams, create_converter
        from cuttlefish_tpu_torch.kernels import bc7_cuda

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

        launches0 = bc7_cuda.launches
        t0 = time.perf_counter()
        texels = 0
        profiling.reset_phases()
        try:
            with profiling.phase("prepare"):
                surfaces = []
                shape: list[tuple[int, int]] = []
                for mip in range(self._mip_levels):
                    for d in range(len(self._images[mip])):
                        for f in range(self._faces):
                            surface = self._images[mip][d][f].rgbaf()
                            texels += surface.shape[0] * surface.shape[1]
                            surfaces.append(surface)
                    shape.append((len(self._images[mip]), self._faces))
            with profiling.phase("encode"):
                encoded = converter.encode_many(surfaces, params)
            with profiling.phase("serialize"):
                textures: list[list[list[bytes]]] = []
                it = iter(encoded)
                for depths, faces in shape:
                    textures.append(
                        [[bytes(next(it)) for _ in range(faces)] for _ in range(depths)]
                    )
        except Exception:
            self._format = TextureFormat.Unknown
            self._textures = None
            raise
        elapsed = time.perf_counter() - t0
        self.last_convert_stats = {
            "texels": texels,
            "seconds": elapsed,
            "mtexels_per_sec": texels / elapsed / 1e6 if elapsed > 0 else 0.0,
            "phases": dict(profiling.last_phases),
            "bc7_launches": bc7_cuda.launches - launches0,
        }
        self._textures = textures
        return True

    def convert_with_mips(self, *args, **kwargs) -> bool:
        raise NotImplementedError(
            "convert_with_mips (the fused device mip pipeline) is not in the "
            "PyTorch port yet: ROADMAP queue 1, item 7"
        )
