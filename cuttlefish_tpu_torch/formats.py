"""Texture format enums and static metadata.

Semantics match the reference's static tables
(`lib/src/Texture.cpp:318-957` and
`lib/include/cuttlefish/Texture.h:46-230`): format x type
validity, block dimensions/sizes, minimum sizes, native-sRGB support, alpha
presence, and mipmap-level math.  All formats are always compiled in (the
reference gates S3TC/ETC/ASTC/PVRTC behind CMake flags; here the flags are
runtime booleans that default to on, used only by parity tests).

Copied from ``cuttlefish_tpu/formats.py`` with its imports pointed at
the port; its logic is unchanged.
"""

from __future__ import annotations

import dataclasses
import enum
import os

# Feature gates mirroring CUTTLEFISH_BUILD_{S3TC,ETC,ASTC,PVRTC}.  Always on in
# this build; kept as env-overridable flags so the validity matrix can reproduce
# a reference build with encoders disabled.
HAS_S3TC = os.environ.get("CUTTLEFISH_TPU_NO_S3TC", "") == ""
HAS_ETC = os.environ.get("CUTTLEFISH_TPU_NO_ETC", "") == ""
HAS_ASTC = os.environ.get("CUTTLEFISH_TPU_NO_ASTC", "") == ""
HAS_PVRTC = os.environ.get("CUTTLEFISH_TPU_NO_PVRTC", "") == ""


class ColorSpace(enum.Enum):
    """Color space of image/texture data (Color.h:40-47)."""

    Linear = 0
    sRGB = 1


class Dimension(enum.Enum):
    """Texture dimensionality (Texture.h:46-54)."""

    Dim1D = 0
    Dim2D = 1
    Dim3D = 2
    Cube = 3


class TextureFormat(enum.IntEnum):
    """Output texture formats (Texture.h:56-130)."""

    Unknown = 0
    # Standard formats.
    R4G4 = enum.auto()
    R4G4B4A4 = enum.auto()
    B4G4R4A4 = enum.auto()
    A4R4G4B4 = enum.auto()
    R5G6B5 = enum.auto()
    B5G6R5 = enum.auto()
    R5G5B5A1 = enum.auto()
    B5G5R5A1 = enum.auto()
    A1R5G5B5 = enum.auto()
    R8 = enum.auto()
    R8G8 = enum.auto()
    R8G8B8 = enum.auto()
    B8G8R8 = enum.auto()
    R8G8B8A8 = enum.auto()
    B8G8R8A8 = enum.auto()
    A8B8G8R8 = enum.auto()
    A2R10G10B10 = enum.auto()
    A2B10G10R10 = enum.auto()
    R16 = enum.auto()
    R16G16 = enum.auto()
    R16G16B16 = enum.auto()
    R16G16B16A16 = enum.auto()
    R32 = enum.auto()
    R32G32 = enum.auto()
    R32G32B32 = enum.auto()
    R32G32B32A32 = enum.auto()
    # Special formats.
    B10G11R11_UFloat = enum.auto()
    E5B9G9R9_UFloat = enum.auto()
    # Compressed formats.
    BC1_RGB = enum.auto()
    BC1_RGBA = enum.auto()
    BC2 = enum.auto()
    BC3 = enum.auto()
    BC4 = enum.auto()
    BC5 = enum.auto()
    BC6H = enum.auto()
    BC7 = enum.auto()
    ETC1 = enum.auto()
    ETC2_R8G8B8 = enum.auto()
    ETC2_R8G8B8A1 = enum.auto()
    ETC2_R8G8B8A8 = enum.auto()
    EAC_R11 = enum.auto()
    EAC_R11G11 = enum.auto()
    ASTC_4x4 = enum.auto()
    ASTC_5x4 = enum.auto()
    ASTC_5x5 = enum.auto()
    ASTC_6x5 = enum.auto()
    ASTC_6x6 = enum.auto()
    ASTC_8x5 = enum.auto()
    ASTC_8x6 = enum.auto()
    ASTC_8x8 = enum.auto()
    ASTC_10x5 = enum.auto()
    ASTC_10x6 = enum.auto()
    ASTC_10x8 = enum.auto()
    ASTC_10x10 = enum.auto()
    ASTC_12x10 = enum.auto()
    ASTC_12x12 = enum.auto()
    PVRTC1_RGB_2BPP = enum.auto()
    PVRTC1_RGBA_2BPP = enum.auto()
    PVRTC1_RGB_4BPP = enum.auto()
    PVRTC1_RGBA_4BPP = enum.auto()
    PVRTC2_RGBA_2BPP = enum.auto()
    PVRTC2_RGBA_4BPP = enum.auto()


class TextureType(enum.IntEnum):
    """Channel data interpretation (Texture.h:133-144)."""

    UNorm = 0
    SNorm = 1
    UInt = 2
    Int = 3
    UFloat = 4
    Float = 5


class CubeFace(enum.IntEnum):
    """Cube map faces (Texture.h:146-157)."""

    PosX = 0
    NegX = 1
    PosY = 2
    NegY = 3
    PosZ = 4
    NegZ = 5


class Alpha(enum.Enum):
    """Alpha interpretation (Texture.h:159-169)."""

    Null = 0  # "None" in the reference; renamed (Python keyword).
    Standard = 1
    PreMultiplied = 2
    Encoded = 3


# Alias matching reference spelling for CLI/text use.
Alpha.NONE = Alpha.Null


class MipReplacement(enum.Enum):
    """Custom-mip continuation semantics (Texture.h:171-178)."""

    Once = 0
    Continue = 1


class Quality(enum.IntEnum):
    """Compression quality ladder (Texture.h:180-192)."""

    Lowest = 0
    Low = 1
    Normal = 2
    High = 3
    Highest = 4


class FileType(enum.Enum):
    """Container file types (Texture.h:194-202)."""

    Auto = 0
    DDS = 1
    KTX = 2
    PVR = 3
    # Extension beyond the reference (which writes KTX1 only): KTX 2.0,
    # the container modern Vulkan/glTF pipelines expect.
    KTX2 = 4


class SaveResult(enum.Enum):
    """Result of saving a texture file (Texture.h:204-213)."""

    Success = 0
    Invalid = 1
    UnknownFormat = 2
    Unsupported = 3
    WriteError = 4


@dataclasses.dataclass
class ColorMask:
    """Per-channel enable mask (Texture.h:215-240)."""

    r: bool = True
    g: bool = True
    b: bool = True
    a: bool = True


@dataclasses.dataclass(frozen=True)
class ImageIndex:
    """Index of one image within a texture (Texture.h:242-300)."""

    cube_face: CubeFace = CubeFace.PosX
    mip_level: int = 0
    depth: int = 0


# ---------------------------------------------------------------------------
# Static metadata tables (Texture.cpp:529-937).
# (block_width, block_height, block_size_bytes, min_width, min_height)
# ---------------------------------------------------------------------------

_F = TextureFormat

_BLOCK_INFO: dict[TextureFormat, tuple[int, int, int, int, int]] = {
    _F.Unknown: (0, 0, 0, 0, 0),
    _F.R4G4: (1, 1, 1, 1, 1),
    _F.R4G4B4A4: (1, 1, 2, 1, 1),
    _F.B4G4R4A4: (1, 1, 2, 1, 1),
    _F.A4R4G4B4: (1, 1, 2, 1, 1),
    _F.R5G6B5: (1, 1, 2, 1, 1),
    _F.B5G6R5: (1, 1, 2, 1, 1),
    _F.R5G5B5A1: (1, 1, 2, 1, 1),
    _F.B5G5R5A1: (1, 1, 2, 1, 1),
    _F.A1R5G5B5: (1, 1, 2, 1, 1),
    _F.R8: (1, 1, 1, 1, 1),
    _F.R8G8: (1, 1, 2, 1, 1),
    _F.R8G8B8: (1, 1, 3, 1, 1),
    _F.B8G8R8: (1, 1, 3, 1, 1),
    _F.R8G8B8A8: (1, 1, 4, 1, 1),
    _F.B8G8R8A8: (1, 1, 4, 1, 1),
    _F.A8B8G8R8: (1, 1, 4, 1, 1),
    _F.A2R10G10B10: (1, 1, 4, 1, 1),
    _F.A2B10G10R10: (1, 1, 4, 1, 1),
    _F.R16: (1, 1, 2, 1, 1),
    _F.R16G16: (1, 1, 4, 1, 1),
    _F.R16G16B16: (1, 1, 6, 1, 1),
    _F.R16G16B16A16: (1, 1, 8, 1, 1),
    _F.R32: (1, 1, 4, 1, 1),
    _F.R32G32: (1, 1, 8, 1, 1),
    _F.R32G32B32: (1, 1, 12, 1, 1),
    _F.R32G32B32A32: (1, 1, 16, 1, 1),
    _F.B10G11R11_UFloat: (1, 1, 4, 1, 1),
    _F.E5B9G9R9_UFloat: (1, 1, 4, 1, 1),
    _F.BC1_RGB: (4, 4, 8, 4, 4),
    _F.BC1_RGBA: (4, 4, 8, 4, 4),
    _F.BC2: (4, 4, 16, 4, 4),
    _F.BC3: (4, 4, 16, 4, 4),
    _F.BC4: (4, 4, 8, 4, 4),
    _F.BC5: (4, 4, 16, 4, 4),
    _F.BC6H: (4, 4, 16, 4, 4),
    _F.BC7: (4, 4, 16, 4, 4),
    _F.ETC1: (4, 4, 8, 4, 4),
    _F.ETC2_R8G8B8: (4, 4, 8, 4, 4),
    _F.ETC2_R8G8B8A1: (4, 4, 8, 4, 4),
    _F.ETC2_R8G8B8A8: (4, 4, 16, 4, 4),
    _F.EAC_R11: (4, 4, 8, 4, 4),
    _F.EAC_R11G11: (4, 4, 16, 4, 4),
    _F.ASTC_4x4: (4, 4, 16, 4, 4),
    _F.ASTC_5x4: (5, 4, 16, 5, 4),
    _F.ASTC_5x5: (5, 5, 16, 5, 5),
    _F.ASTC_6x5: (6, 5, 16, 6, 5),
    _F.ASTC_6x6: (6, 6, 16, 6, 6),
    _F.ASTC_8x5: (8, 5, 16, 8, 5),
    _F.ASTC_8x6: (8, 6, 16, 8, 6),
    _F.ASTC_8x8: (8, 8, 16, 8, 8),
    _F.ASTC_10x5: (10, 5, 16, 10, 5),
    _F.ASTC_10x6: (10, 6, 16, 10, 6),
    _F.ASTC_10x8: (10, 8, 16, 10, 8),
    _F.ASTC_10x10: (10, 10, 16, 10, 10),
    _F.ASTC_12x10: (12, 10, 16, 12, 10),
    _F.ASTC_12x12: (12, 12, 16, 12, 12),
    _F.PVRTC1_RGB_2BPP: (8, 4, 8, 16, 8),
    _F.PVRTC1_RGBA_2BPP: (8, 4, 8, 16, 8),
    _F.PVRTC1_RGB_4BPP: (4, 4, 8, 8, 8),
    _F.PVRTC1_RGBA_4BPP: (4, 4, 8, 8, 8),
    _F.PVRTC2_RGBA_2BPP: (8, 4, 8, 16, 8),
    _F.PVRTC2_RGBA_4BPP: (4, 4, 8, 8, 8),
}

_T = TextureType

# Format -> set of valid types (unconditional part of Texture.cpp:318-401).
_VALID_TYPES: dict[TextureFormat, frozenset[TextureType]] = {
    _F.Unknown: frozenset(),
    **{
        f: frozenset({_T.UNorm})
        for f in (
            _F.R4G4, _F.R4G4B4A4, _F.B4G4R4A4, _F.A4R4G4B4, _F.R5G6B5,
            _F.B5G6R5, _F.R5G5B5A1, _F.B5G5R5A1, _F.A1R5G5B5, _F.B8G8R8,
            _F.B8G8R8A8, _F.A8B8G8R8,
        )
    },
    **{
        f: frozenset({_T.UNorm, _T.SNorm, _T.UInt, _T.Int})
        for f in (_F.R8, _F.R8G8, _F.R8G8B8, _F.R8G8B8A8)
    },
    **{f: frozenset({_T.UNorm, _T.UInt}) for f in (_F.A2R10G10B10, _F.A2B10G10R10)},
    **{
        f: frozenset({_T.UNorm, _T.SNorm, _T.UInt, _T.Int, _T.Float})
        for f in (_F.R16, _F.R16G16, _F.R16G16B16, _F.R16G16B16A16)
    },
    **{
        f: frozenset({_T.UInt, _T.Int, _T.Float})
        for f in (_F.R32, _F.R32G32, _F.R32G32B32, _F.R32G32B32A32)
    },
    _F.B10G11R11_UFloat: frozenset({_T.UFloat}),
    _F.E5B9G9R9_UFloat: frozenset({_T.UFloat}),
}


def _compressed_valid_types(fmt: TextureFormat) -> frozenset[TextureType]:
    if fmt in (_F.BC1_RGB, _F.BC1_RGBA, _F.BC2, _F.BC3, _F.BC7):
        return frozenset({_T.UNorm}) if HAS_S3TC else frozenset()
    if fmt in (_F.BC4, _F.BC5):
        return frozenset({_T.UNorm, _T.SNorm}) if HAS_S3TC else frozenset()
    if fmt is _F.BC6H:
        return frozenset({_T.UFloat, _T.Float}) if HAS_S3TC else frozenset()
    if fmt in (_F.ETC1, _F.ETC2_R8G8B8, _F.ETC2_R8G8B8A1, _F.ETC2_R8G8B8A8):
        return frozenset({_T.UNorm}) if HAS_ETC else frozenset()
    if fmt in (_F.EAC_R11, _F.EAC_R11G11):
        return frozenset({_T.UNorm, _T.SNorm}) if HAS_ETC else frozenset()
    if fmt.name.startswith("ASTC_"):
        return frozenset({_T.UNorm, _T.UFloat}) if HAS_ASTC else frozenset()
    if fmt.name.startswith("PVRTC"):
        return frozenset({_T.UNorm}) if HAS_PVRTC else frozenset()
    return frozenset()


for _fmt in TextureFormat:
    if _fmt not in _VALID_TYPES:
        _VALID_TYPES[_fmt] = _compressed_valid_types(_fmt)

_ASTC_FORMATS = frozenset(f for f in TextureFormat if f.name.startswith("ASTC_"))
_PVRTC_FORMATS = frozenset(f for f in TextureFormat if f.name.startswith("PVRTC"))

# Formats with a native sRGB variant (Texture.cpp:421-465).
_NATIVE_SRGB = frozenset({
    _F.R8G8B8, _F.B8G8R8, _F.R8G8B8A8, _F.B8G8R8A8, _F.A8B8G8R8,
    _F.BC1_RGB, _F.BC1_RGBA, _F.BC2, _F.BC3, _F.BC7,
    _F.ETC2_R8G8B8, _F.ETC2_R8G8B8A1, _F.ETC2_R8G8B8A8,
}) | _ASTC_FORMATS | _PVRTC_FORMATS

# Formats carrying an alpha channel (Texture.cpp:467-512).
_HAS_ALPHA = frozenset({
    _F.R4G4B4A4, _F.B4G4R4A4, _F.R5G5B5A1, _F.B5G5R5A1, _F.A1R5G5B5,
    _F.R8G8B8A8, _F.B8G8R8A8, _F.A8B8G8R8, _F.A2R10G10B10, _F.A2B10G10R10,
    _F.R16G16B16A16, _F.R32G32B32A32,
    _F.BC1_RGBA, _F.BC2, _F.BC3, _F.BC7,
    _F.ETC2_R8G8B8A1, _F.ETC2_R8G8B8A8,
    _F.PVRTC1_RGBA_2BPP, _F.PVRTC1_RGBA_4BPP,
    _F.PVRTC2_RGBA_2BPP, _F.PVRTC2_RGBA_4BPP,
}) | _ASTC_FORMATS


def is_format_valid(
    fmt: TextureFormat, type_: TextureType, file_type: FileType | None = None
) -> bool:
    """Whether (format, type[, container]) is a supported combination."""
    if type_ not in _VALID_TYPES.get(fmt, frozenset()):
        return False
    if file_type is None:
        return True
    # Container-specific validity lives with the writers.
    from cuttlefish_tpu_torch.containers import dds, ktx, ktx2, pvr

    if file_type is FileType.DDS:
        return dds.is_valid_for_dds(fmt, type_)
    if file_type is FileType.KTX:
        return ktx.is_valid_for_ktx(fmt, type_)
    if file_type is FileType.KTX2:
        return ktx2.is_valid_for_ktx2(fmt, type_)
    if file_type is FileType.PVR:
        return pvr.is_valid_for_pvr(fmt, type_)
    return False


def valid_types(fmt: TextureFormat) -> frozenset[TextureType]:
    return _VALID_TYPES.get(fmt, frozenset())


def has_native_srgb(fmt: TextureFormat, type_: TextureType) -> bool:
    return fmt in _NATIVE_SRGB and type_ is TextureType.UNorm


def has_alpha(fmt: TextureFormat) -> bool:
    return fmt in _HAS_ALPHA


def block_width(fmt: TextureFormat) -> int:
    return _BLOCK_INFO[fmt][0]


def block_height(fmt: TextureFormat) -> int:
    return _BLOCK_INFO[fmt][1]


def block_size(fmt: TextureFormat) -> int:
    """Bytes per encoded block."""
    return _BLOCK_INFO[fmt][2]


def min_width(fmt: TextureFormat) -> int:
    return _BLOCK_INFO[fmt][3]


def min_height(fmt: TextureFormat) -> int:
    return _BLOCK_INFO[fmt][4]


def max_mipmap_levels(
    dimension: Dimension, width: int, height: int, depth: int = 1
) -> int:
    """Mip levels down to 1x1 (Texture.cpp:514-527, 32-clz math)."""
    levels = max(width.bit_length(), height.bit_length())
    if dimension is Dimension.Dim3D:
        levels = max(levels, depth.bit_length())
    return levels


def file_type_for_name(file_name: str) -> FileType:
    """Container type from extension, case-insensitive (Texture.cpp:939-957)."""
    lower = file_name.lower()
    if lower.endswith(".dds"):
        return FileType.DDS
    if lower.endswith(".ktx2"):
        return FileType.KTX2
    if lower.endswith(".ktx"):
        return FileType.KTX
    if lower.endswith(".pvr"):
        return FileType.PVR
    return FileType.Auto
