"""The system under test: ``cuttlefish_tpu_torch`` driven through its
public entry points, as an asset tool drives it, for one configuration.

One texture is ``Texture(...)``, ``set_image`` for each face,
``convert_with_mips`` and ``save_to_bytes``.  Each call runs inside a
``torch.profiler.record_function`` range of the benchmark's own, so that
a traced run can tell what the host was doing while the card idled, and
its host-clock span is kept with the program's phases
(``last_convert_stats["phases"]``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

SPANS = ("texture", "convert", "save")


class System:
    def __init__(self, config: dict, faces: int, size: int, device):
        from cuttlefish_tpu_torch.formats import (
            ColorSpace,
            Dimension,
            FileType,
            Quality,
            TextureFormat,
            TextureType,
        )
        from cuttlefish_tpu_torch.image import ImageFormat, ResizeFilter

        self.device = torch.device(device)
        self.fmt = TextureFormat[config["format"]]
        self.type = TextureType[config["type"]]
        self.quality = Quality[config["quality"]]
        self.color_space = ColorSpace[config["color_space"]]
        self.filter = ResizeFilter(config["filter"])
        self.container = FileType[config["container"]]
        self.hdr_metric = config.get("hdr_metric", "value")
        self.dim = Dimension.Cube if faces == 6 else Dimension.Dim2D
        self.faces = faces
        self.size = size
        self._rgbaf = ImageFormat.RGBAF

    def images(self, surfaces: np.ndarray) -> list:
        """[faces, H, W, 4] float32 -> the faces as RGBAF ``Image``s in
        the texture's colour space."""
        from cuttlefish_tpu_torch.image import Image

        return [Image.from_array(s, self._rgbaf, self.color_space) for s in surfaces]

    def encode(self, images: list) -> tuple[bytes, dict, dict]:
        """One texture -> (DDS bytes, spans in seconds, the program's
        phases).  Raises if a call reports failure."""
        from cuttlefish_tpu_torch.formats import CubeFace, SaveResult
        from cuttlefish_tpu_torch.texture import Texture

        rf = torch.profiler.record_function
        t0 = time.perf_counter()
        with rf("portbench.texture"):
            tex = Texture(self.dim, self.size, self.size, 0, 1, self.color_space, device=self.device)
            for f, img in enumerate(images):
                face = CubeFace(f) if self.faces == 6 else None
                if not tex.set_image(img, face):
                    raise RuntimeError(f"set_image refused face {f}")
        t1 = time.perf_counter()
        with rf("portbench.convert"):
            ok = tex.convert_with_mips(
                self.fmt, self.type, self.quality, filter=self.filter, hdr_metric=self.hdr_metric
            )
        if not ok:
            raise RuntimeError("convert_with_mips returned False")
        t2 = time.perf_counter()
        with rf("portbench.save"):
            result, data = tex.save_to_bytes(self.container)
        t3 = time.perf_counter()
        if result is not SaveResult.Success:
            raise RuntimeError(f"save_to_bytes: {result}")
        spans = {"texture": t1 - t0, "convert": t2 - t1, "save": t3 - t2}
        return data, spans, dict(tex.last_convert_stats["phases"])
