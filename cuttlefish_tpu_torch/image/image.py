"""The Image class: load, convert, and manipulate single 2D images.

Behavior mirrors the reference `Image` class
(`lib/include/cuttlefish/Image.h:124-458`,
`lib/src/Image.cpp`): coordinate (0, 0) is the upper-left (storage here is
top-down numpy, so no FreeImage scanline flipping), conversions go through
double-precision RGBA, grayscale/resize/premultiply happen in linear space
when the image is sRGB, and normal maps use central differences with optional
X/Y wrapping (Image.cpp:1783-1880).

Copied from ``cuttlefish_tpu/image/image.py`` with its imports pointed at
the port; its logic is unchanged.
"""

from __future__ import annotations

import enum

import numpy as np

from cuttlefish_tpu_torch.color import (
    linear_to_srgb,
    srgb_to_linear,
    to_grayscale,
)
from cuttlefish_tpu_torch.formats import ColorSpace
from cuttlefish_tpu_torch.image import codecs
from cuttlefish_tpu_torch.image.format import (
    GRAYSCALE_FORMATS,
    Channel,
    ImageFormat,
    empty_storage,
    from_rgbad,
    storage_channels,
    storage_dtype,
    storage_shape,
    to_rgbad,
)
from cuttlefish_tpu_torch.image.resample import resize_2d


class ResizeFilter(enum.Enum):
    """Resize filters (Image.h:79-89)."""

    Box = "box"
    Linear = "linear"
    Cubic = "cubic"
    CatmullRom = "catmullrom"
    BSpline = "bspline"


class RotateAngle(enum.Enum):
    """Rotation angles, clockwise positive with (0,0) upper-left (Image.h:91-102)."""

    CW90 = 0
    CW180 = 1
    CW270 = 2
    CCW90 = 3
    CCW180 = 4
    CCW270 = 5


class NormalOptions(enum.IntFlag):
    """Normal-map generation options (Image.h:116-123)."""

    Default = 0x0
    KeepSign = 0x1
    WrapX = 0x2
    WrapY = 0x4


class Image:
    """A single 2D image in one of 18 pixel formats."""

    def __init__(self, source=None, color_space: ColorSpace = ColorSpace.Linear):
        self._data: np.ndarray | None = None
        self._format = ImageFormat.Invalid
        self._color_space = color_space
        if source is not None:
            self.load(source, color_space)

    # -- creation ----------------------------------------------------------

    def load(self, source, color_space: ColorSpace = ColorSpace.Linear) -> bool:
        """Load from path / bytes / stream; invalid image on failure."""
        try:
            data, fmt = codecs.load(source)
        except (OSError, ValueError, NotImplementedError):
            # ValueError covers DecodeError / LoadError / malformed-stream
            # struct errors; NotImplementedError covers decode-scope limits
            # on foreign container features.  A bad input file is an
            # invalid image, never a traceback (the reference's FreeImage
            # ingest has the same contract, Image.cpp:870-922).
            self._data = None
            self._format = ImageFormat.Invalid
            return False
        self._data = np.ascontiguousarray(data)
        self._format = fmt
        self._color_space = color_space
        return True

    def save(self, file_name) -> bool:
        """Save in the current storage format; codec picked by extension
        (PNG/TGA/BMP/HDR/PFM/EXR native or via PIL).  Mirrors
        `Image::save` (`lib/src/Image.cpp:924-958`):
        returns False for invalid images or format/file-type combos the
        codec cannot represent."""
        if self._data is None:
            return False
        return codecs.save(self._data, self._format, str(file_name))

    def initialize(
        self,
        fmt: ImageFormat,
        width: int,
        height: int,
        color_space: ColorSpace = ColorSpace.Linear,
    ) -> bool:
        if fmt is ImageFormat.Invalid or width <= 0 or height <= 0:
            return False
        self._data = empty_storage(fmt, width, height)
        self._format = fmt
        self._color_space = color_space
        return True

    @classmethod
    def from_array(
        cls,
        data: np.ndarray,
        fmt: ImageFormat,
        color_space: ColorSpace = ColorSpace.Linear,
    ) -> "Image":
        """Wrap a top-down storage array (zero-copy when layout matches)."""
        img = cls()
        expected = storage_shape(fmt, data.shape[1], data.shape[0])
        arr = np.ascontiguousarray(data, storage_dtype(fmt))
        if arr.shape != expected:
            raise ValueError(f"bad shape {arr.shape} for {fmt}, want {expected}")
        img._data = arr
        img._format = fmt
        img._color_space = color_space
        return img

    def reset(self) -> None:
        self._data = None
        self._format = ImageFormat.Invalid

    # -- accessors ---------------------------------------------------------

    @property
    def valid(self) -> bool:
        return self._data is not None

    def __bool__(self) -> bool:
        return self.valid

    @property
    def format(self) -> ImageFormat:
        return self._format

    @property
    def color_space(self) -> ColorSpace:
        return self._color_space

    @property
    def width(self) -> int:
        return 0 if self._data is None else self._data.shape[1]

    @property
    def height(self) -> int:
        return 0 if self._data is None else self._data.shape[0]

    @property
    def array(self) -> np.ndarray:
        """Top-down storage array (shared, do not mutate shape)."""
        if self._data is None:
            raise ValueError("invalid image")
        return self._data

    # -- pixel-layout introspection (Image.h:282-352) ---------------------

    @property
    def bits_per_pixel(self) -> int:
        from cuttlefish_tpu_torch.image.format import bits_per_pixel

        return 0 if self._data is None else bits_per_pixel(self._format)

    def _mask_shift(self, channel: int) -> tuple[int, int]:
        from cuttlefish_tpu_torch.image.format import channel_mask_shift

        if self._data is None:
            return (0, 0)
        return channel_mask_shift(self._format, channel)

    @property
    def red_mask(self) -> int:
        return self._mask_shift(0)[0]

    @property
    def red_shift(self) -> int:
        return self._mask_shift(0)[1]

    @property
    def green_mask(self) -> int:
        return self._mask_shift(1)[0]

    @property
    def green_shift(self) -> int:
        return self._mask_shift(1)[1]

    @property
    def blue_mask(self) -> int:
        return self._mask_shift(2)[0]

    @property
    def blue_shift(self) -> int:
        return self._mask_shift(2)[1]

    @property
    def alpha_mask(self) -> int:
        return self._mask_shift(3)[0]

    @property
    def alpha_shift(self) -> int:
        return self._mask_shift(3)[1]

    def scanline(self, y: int) -> np.ndarray:
        """Row y of the storage array (shared view; Image.h:349-352 —
        already top-down here, no bottom-up flip needed)."""
        if self._data is None or not 0 <= y < self.height:
            raise ValueError("invalid scanline")
        return self._data[y]

    def rgbad(self) -> np.ndarray:
        """Whole image as (H, W, 4) float64 RGBA (getPixel semantics)."""
        return to_rgbad(self.array, self._format)

    def rgbaf(self) -> np.ndarray:
        """Whole image as (H, W, 4) float32 RGBA — the encoder input surface."""
        if self._format is ImageFormat.RGBAF:
            return self._data
        return to_rgbad(self.array, self._format).astype(np.float32)

    def get_pixel(self, x: int, y: int) -> tuple[float, float, float, float]:
        if self._data is None or not (0 <= x < self.width and 0 <= y < self.height):
            return (0.0, 0.0, 0.0, 0.0)
        # Convert just this pixel (a 1x1 surface), not the whole image.
        px = to_rgbad(self._data[y : y + 1, x : x + 1], self._format)
        return tuple(px[0, 0])

    def set_pixel(self, x: int, y: int, color) -> bool:
        if self._data is None:
            return False
        if not (0 <= x < self.width and 0 <= y < self.height):
            return False
        # Convert just this pixel (a 1x1 surface), not the whole image.
        rgba = np.asarray(color, np.float64).reshape(1, 1, 4)
        px = from_rgbad(rgba, self._format, grayscale_convert=True)
        self._data[y : y + 1, x : x + 1] = px
        return True

    def clone(self) -> "Image":
        img = Image()
        img._data = None if self._data is None else self._data.copy()
        img._format = self._format
        img._color_space = self._color_space
        return img

    # -- conversion --------------------------------------------------------

    def convert(self, dst_format: ImageFormat) -> "Image":
        """Convert to another pixel format (Image.cpp:1130-1322).

        HDR float values are preserved when converting between float formats;
        grayscale targets apply Rec.709, computed in linear space when the
        image is sRGB; Complex never converts to grayscale.
        """
        out = Image()
        if self._data is None or dst_format is ImageFormat.Invalid:
            return out
        if dst_format is self._format:
            return self.clone()

        rgba = self.rgbad()
        src_gray = self._format in GRAYSCALE_FORMATS
        dst_gray = dst_format in GRAYSCALE_FORMATS
        convert_grayscale = dst_gray and not src_gray and self._format is not ImageFormat.Complex

        if convert_grayscale and self._color_space is ColorSpace.sRGB:
            # Grayscale conversion happens in linear space (Image.cpp:1290-1303).
            lin = srgb_to_linear(rgba[..., :3])
            gray = linear_to_srgb(to_grayscale(lin[..., 0], lin[..., 1], lin[..., 2]))
            rgba = rgba.copy()
            rgba[..., 0] = rgba[..., 1] = rgba[..., 2] = gray
            data = from_rgbad(rgba, dst_format, grayscale_convert=False)
        else:
            data = from_rgbad(rgba, dst_format, grayscale_convert=convert_grayscale)

        out._data = data
        out._format = dst_format
        out._color_space = self._color_space
        return out

    # -- manipulation ------------------------------------------------------

    def resize(self, width: int, height: int, filter: ResizeFilter = ResizeFilter.CatmullRom) -> "Image":
        """Resize in linear space (Image.cpp:1324-1511)."""
        out = Image()
        if self._data is None or width <= 0 or height <= 0:
            return out
        if width == self.width and height == self.height:
            return self.clone()

        if self._color_space is not ColorSpace.Linear:
            img = self.clone()
            img.change_color_space(ColorSpace.Linear)
            img = img.resize(width, height, filter)
            img.change_color_space(self._color_space)
            return img

        # RGBAF is already the resample input layout — skip the float64
        # getPixel round-trip (the hot path: every mip level of every
        # texture goes through here).
        if self._format is ImageFormat.RGBAF:
            out._data = np.ascontiguousarray(
                resize_2d(self._data, width, height, filter.value),
                dtype=np.float32,
            )
        else:
            rgba = self.rgbad()
            resized = resize_2d(rgba, width, height, filter.value)
            out._data = from_rgbad(resized, self._format, grayscale_convert=False)
        out._format = self._format
        out._color_space = self._color_space
        return out

    def rotate(self, angle: RotateAngle) -> "Image":
        """Rotate by a multiple of 90 degrees (Image.cpp:1513-1603)."""
        out = Image()
        if self._data is None:
            return out
        if angle in (RotateAngle.CW90, RotateAngle.CCW270):
            data = np.rot90(self._data, k=-1, axes=(0, 1))
        elif angle in (RotateAngle.CW180, RotateAngle.CCW180):
            data = np.rot90(self._data, k=2, axes=(0, 1))
        else:
            data = np.rot90(self._data, k=1, axes=(0, 1))
        out._data = np.ascontiguousarray(data)
        out._format = self._format
        out._color_space = self._color_space
        return out

    def flip_horizontal(self) -> bool:
        """Mirror left-right."""
        if self._data is None:
            return False
        self._data = np.ascontiguousarray(self._data[:, ::-1])
        return True

    def flip_vertical(self) -> bool:
        """Mirror top-bottom."""
        if self._data is None:
            return False
        self._data = np.ascontiguousarray(self._data[::-1])
        return True

    def pre_multiply_alpha(self) -> bool:
        """Multiply RGB by alpha, in linear space (Image.cpp:1621-1665).

        Only RGBA formats carry alpha; others are a no-op, like the reference.
        """
        if self._data is None:
            return False
        if self._format not in (ImageFormat.RGBA8, ImageFormat.RGBA16, ImageFormat.RGBAF):
            return True
        rgba = self.rgbad()
        rgb = rgba[..., :3]
        if self._color_space is ColorSpace.sRGB:
            rgb = linear_to_srgb(srgb_to_linear(rgb) * rgba[..., 3:])
        else:
            rgb = rgb * rgba[..., 3:]
        rgba[..., :3] = rgb
        self._data = from_rgbad(rgba, self._format, grayscale_convert=False)
        return True

    def change_color_space(self, color_space: ColorSpace) -> bool:
        """Apply the sRGB transfer function to RGB channels (Image.cpp:1667-1712)."""
        if self._data is None:
            return False
        if color_space is self._color_space:
            return True
        fn = srgb_to_linear if color_space is ColorSpace.Linear else linear_to_srgb
        if self._format is ImageFormat.RGBAF:
            # Hot path (every sRGB texture's set_image/mip chain): transform
            # the float32 storage directly, no float64 round-trip.
            data = self._data.copy()
            data[..., :3] = fn(data[..., :3])
            self._data = data
        else:
            rgba = self.rgbad()
            rgba[..., :3] = fn(rgba[..., :3])
            self._data = from_rgbad(rgba, self._format, grayscale_convert=False)
        self._color_space = color_space
        return True

    def grayscale(self) -> bool:
        """Rec.709 grayscale in place, computed in linear space (Image.cpp:1714-1746)."""
        if self._data is None:
            return False
        rgba = self.rgbad()
        rgb = rgba[..., :3]
        if self._color_space is ColorSpace.sRGB:
            rgb = srgb_to_linear(rgb)
        gray = to_grayscale(rgb[..., 0], rgb[..., 1], rgb[..., 2])
        if self._color_space is ColorSpace.sRGB:
            gray = linear_to_srgb(gray)
        rgba[..., 0] = rgba[..., 1] = rgba[..., 2] = gray
        self._data = from_rgbad(rgba, self._format, grayscale_convert=False)
        return True

    def swizzle(
        self, red: Channel, green: Channel, blue: Channel, alpha: Channel
    ) -> bool:
        """Reorder channels; Channel.Null reads 0 (1 for alpha) (Image.cpp:1748-1781)."""
        if self._data is None:
            return False
        rgba = self.rgbad()
        out = np.empty_like(rgba)
        for i, ch in enumerate((red, green, blue, alpha)):
            if ch is Channel.Null:
                out[..., i] = 1.0 if i == 3 else 0.0
            else:
                out[..., i] = rgba[..., int(ch)]
        self._data = from_rgbad(out, self._format, grayscale_convert=False)
        return True

    def create_normal_map(
        self,
        options: NormalOptions = NormalOptions.Default,
        height: float = 1.0,
        dst_format: ImageFormat = ImageFormat.RGBF,
    ) -> "Image":
        """Heightfield -> tangent-space normal map (Image.cpp:1783-1880).

        Central differences on the red channel; edges use one-sided
        differences (distance 1) unless wrapping is enabled.
        """
        out = Image()
        if self._data is None:
            return out
        if not out.initialize(dst_format, self.width, self.height, self._color_space):
            return out

        h = self.rgbad()[..., 0]
        hh, ww = h.shape

        if options & NormalOptions.WrapY:
            above = np.roll(h, 1, axis=0)
            below = np.roll(h, -1, axis=0)
            dist_y = np.full((hh, 1), 2.0)
        else:
            above = np.vstack([h[:1], h[:-1]])
            below = np.vstack([h[1:], h[-1:]])
            dist_y = np.full((hh, 1), 2.0)
            if hh > 1:
                dist_y[0] = dist_y[-1] = 1.0
            else:
                dist_y[0] = 1.0
        # Reference reads scanline0 = the row below (bottom-up y-1) and
        # scanline2 = the row above, so dy = (south - north).
        dy = (below - above) * height / dist_y

        if options & NormalOptions.WrapX:
            left = np.roll(h, 1, axis=1)
            right = np.roll(h, -1, axis=1)
            dist_x = np.full((1, ww), 2.0)
        else:
            left = np.hstack([h[:, :1], h[:, :-1]])
            right = np.hstack([h[:, 1:], h[:, -1:]])
            dist_x = np.full((1, ww), 2.0)
            if ww > 1:
                dist_x[0, 0] = dist_x[0, -1] = 1.0
            else:
                dist_x[0, 0] = 1.0
        dx = (left - right) * height / dist_x

        length = np.sqrt(dx * dx + dy * dy + 1.0)
        normal = np.stack(
            [dx / length, dy / length, 1.0 / length, np.ones_like(dx)], axis=-1
        )
        if not options & NormalOptions.KeepSign:
            normal[..., :3] = normal[..., :3] * 0.5 + 0.5
        out._data = from_rgbad(normal, dst_format, grayscale_convert=True)
        return out
