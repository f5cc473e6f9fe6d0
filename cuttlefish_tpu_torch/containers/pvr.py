"""PVR v3 writer.

Byte-layout matches the reference (`lib/src/SavePvr.cpp`):
'PVR\\x03' magic, premultiplied flag 0x2, 64-bit pixel format (generic
channel-layout or special enum), colorspace/channel-type words, dims, custom
'CTFS' metadata entries ('BC1A'/'BC1\\0', 'ARRY', 'DIM1') each with a 4-byte
dummy payload, then data mip -> depth -> face.

Copied from ``cuttlefish_tpu/containers/pvr.py`` with its imports pointed at
the port; its logic is unchanged.
"""

from __future__ import annotations

import struct

from cuttlefish_tpu_torch.formats import (
    Alpha,
    ColorSpace,
    CubeFace,
    Dimension,
    SaveResult,
    TextureFormat,
    TextureType,
)

_F = TextureFormat
_T = TextureType


def _generic(c0, b0, c1=0, b1=0, c2=0, b2=0, c3=0, b3=0) -> int:
    """PVR generic pixel format: channel chars in low 32 bits, bit counts high
    (SavePvr.cpp:23-28)."""

    def ch(c):
        return ord(c) if isinstance(c, str) else c

    return (
        ch(c0)
        | (ch(c1) << 8)
        | (ch(c2) << 16)
        | (ch(c3) << 24)
        | (b0 << 32)
        | (b1 << 40)
        | (b2 << 48)
        | (b3 << 56)
    )


# PvrSpecialFormat enum values (SavePvr.cpp:52-107).
_SPECIAL = {
    name: i
    for i, name in enumerate(
        [
            "PVRTC_2bppRGB", "PVRTC_2bppRGBA", "PVRTC_4bppRGB", "PVRTC_4bppRGBA",
            "PVRTC2_2bpp", "PVRTC2_4bpp", "ETC1", "DXT1", "DXT2", "DXT3",
            "DXT4", "DXT5", "BC4", "BC5", "BC6", "BC7", "UYVY", "YUY2",
            "BW1bpp", "R9G9B9E5_UFloat", "R8G8B8G8", "G8R8G8B8", "ETC2_RGB",
            "ETC2_RGBA", "ETC2_RGB_A1", "EAC_R11", "EAC_RG11",
            "ASTC_4x4", "ASTC_5x4", "ASTC_5x5", "ASTC_6x5", "ASTC_6x6",
            "ASTC_8x5", "ASTC_8x6", "ASTC_8x8", "ASTC_10x5", "ASTC_10x6",
            "ASTC_10x8", "ASTC_10x10", "ASTC_12x10", "ASTC_12x12",
        ]
    )
}

# PvrChannelType enum (SavePvr.cpp:32-50).
_CT = {
    "UByteN": 0, "SByteN": 1, "UByte": 2, "SByte": 3,
    "UShortN": 4, "SShortN": 5, "UShort": 6, "SShort": 7,
    "UIntN": 8, "SIntN": 9, "UInt": 10, "SInt": 11,
    "Float": 12, "UFloat": 13,
}

_BYTE_FORMATS = frozenset({
    _F.R4G4, _F.R8, _F.R8G8, _F.R8G8B8, _F.B8G8R8, _F.R8G8B8A8,
    _F.B8G8R8A8, _F.A8B8G8R8,
})
_SHORT_FORMATS = frozenset({
    _F.R4G4B4A4, _F.B4G4R4A4, _F.A4R4G4B4, _F.R5G6B5, _F.B5G6R5,
    _F.R5G5B5A1, _F.B5G5R5A1, _F.A1R5G5B5, _F.R16, _F.R16G16,
    _F.R16G16B16, _F.R16G16B16A16,
})
_INT_FORMATS = frozenset({
    _F.A2R10G10B10, _F.A2B10G10R10, _F.R32, _F.R32G32, _F.R32G32B32,
    _F.R32G32B32A32,
})


def get_channel_type(fmt: TextureFormat, type_: TextureType) -> int:
    """PVR channel type word (SavePvr.cpp:109-268)."""
    if type_ is _T.UFloat:
        return _CT["UFloat"]
    if type_ is _T.Float:
        return _CT["Float"]
    norm = type_ in (_T.UNorm, _T.SNorm)
    signed = type_ in (_T.SNorm, _T.Int)
    if fmt in _BYTE_FORMATS or fmt in (_F.BC4, _F.BC5):
        if fmt in (_F.BC4, _F.BC5) and not norm:
            return _CT["UByte"]
        base = "Byte"
    elif fmt in _SHORT_FORMATS or (norm and fmt in (_F.EAC_R11, _F.EAC_R11G11)):
        base = "Short"
    elif fmt in _INT_FORMATS:
        base = "Int"
    else:
        # Compressed default branches (UByteN / SByteN / UByte).
        if not norm:
            return _CT["UByte"]
        return _CT["SByteN" if signed else "UByteN"]
    name = ("S" if signed else "U") + base + ("N" if norm else "")
    return _CT[name]


def get_pixel_format(fmt: TextureFormat, alpha_type: Alpha) -> int | None:
    """64-bit PVR pixel format word (SavePvr.cpp:270-477)."""
    generic = {
        _F.R4G4: ("r", 4, "g", 4),
        _F.R4G4B4A4: ("r", 4, "g", 4, "b", 4, "a", 4),
        _F.B4G4R4A4: ("b", 4, "g", 4, "r", 4, "a", 4),
        _F.A4R4G4B4: ("a", 4, "r", 4, "g", 4, "b", 4),
        _F.R5G6B5: ("r", 5, "g", 6, "b", 5),
        _F.B5G6R5: ("b", 5, "g", 6, "r", 5),
        _F.R5G5B5A1: ("r", 5, "g", 5, "b", 5, "a", 1),
        _F.B5G5R5A1: ("b", 5, "g", 5, "r", 5, "a", 1),
        _F.A1R5G5B5: ("a", 1, "r", 5, "g", 5, "b", 5),
        _F.R8: ("r", 8),
        _F.R8G8: ("r", 8, "g", 8),
        _F.R8G8B8: ("r", 8, "g", 8, "b", 8),
        _F.B8G8R8: ("b", 8, "g", 8, "r", 8),
        _F.R8G8B8A8: ("r", 8, "g", 8, "b", 8, "a", 8),
        _F.B8G8R8A8: ("b", 8, "g", 8, "r", 8, "a", 8),
        _F.A8B8G8R8: ("a", 8, "b", 8, "g", 8, "r", 8),
        _F.A2R10G10B10: ("a", 2, "r", 10, "g", 10, "b", 10),
        _F.A2B10G10R10: ("a", 2, "b", 10, "g", 10, "r", 10),
        _F.R16: ("r", 16),
        _F.R16G16: ("r", 16, "g", 16),
        _F.R16G16B16: ("r", 16, "g", 16, "b", 16),
        _F.R16G16B16A16: ("r", 16, "g", 16, "b", 16, "a", 16),
        _F.R32: ("r", 32),
        _F.R32G32: ("r", 32, "g", 32),
        _F.R32G32B32: ("r", 32, "g", 32, "b", 32),
        _F.R32G32B32A32: ("r", 32, "g", 32, "b", 32, "a", 32),
        _F.B10G11R11_UFloat: ("b", 10, "g", 11, "r", 11),
    }
    if fmt in generic:
        args = generic[fmt]
        pairs = list(args) + [0] * (8 - len(args))
        return _generic(
            pairs[0], pairs[1], pairs[2], pairs[3],
            pairs[4], pairs[5], pairs[6], pairs[7],
        )

    special = {
        _F.E5B9G9R9_UFloat: "R9G9B9E5_UFloat",
        _F.BC1_RGB: "DXT1",
        _F.BC1_RGBA: "DXT1",
        _F.BC2: "DXT2" if alpha_type is Alpha.PreMultiplied else "DXT3",
        _F.BC3: "DXT4" if alpha_type is Alpha.PreMultiplied else "DXT5",
        _F.BC4: "BC4",
        _F.BC5: "BC5",
        _F.BC6H: "BC6",
        _F.BC7: "BC7",
        _F.ETC1: "ETC1",
        _F.ETC2_R8G8B8: "ETC2_RGB",
        _F.ETC2_R8G8B8A1: "ETC2_RGB_A1",
        _F.ETC2_R8G8B8A8: "ETC2_RGBA",
        _F.EAC_R11: "EAC_R11",
        _F.EAC_R11G11: "EAC_RG11",
        _F.PVRTC1_RGB_2BPP: "PVRTC_2bppRGB",
        _F.PVRTC1_RGBA_2BPP: "PVRTC_2bppRGBA",
        _F.PVRTC1_RGB_4BPP: "PVRTC_4bppRGB",
        _F.PVRTC1_RGBA_4BPP: "PVRTC_4bppRGBA",
        _F.PVRTC2_RGBA_2BPP: "PVRTC2_2bpp",
        _F.PVRTC2_RGBA_4BPP: "PVRTC2_4bpp",
    }
    if fmt in special:
        return _SPECIAL[special[fmt]]
    if fmt.name.startswith("ASTC_"):
        return _SPECIAL[fmt.name]
    return None


def is_valid_for_pvr(fmt: TextureFormat, type_: TextureType) -> bool:
    del type_
    return get_pixel_format(fmt, Alpha.Standard) is not None


def save_pvr(texture, stream) -> SaveResult:
    """Serialize a converted Texture to PVR v3 (SavePvr.cpp:478-600)."""
    pixel_format = get_pixel_format(texture.format, texture.alpha_type)
    if pixel_format is None:
        return SaveResult.Unsupported

    dim = texture.dimension
    flags = 0x2 if texture.alpha_type is Alpha.PreMultiplied else 0
    color_space = 1 if texture.color_space is ColorSpace.sRGB else 0
    channel_type = get_channel_type(texture.format, texture.type)

    try:
        stream.write(b"PVR\x03")
        stream.write(struct.pack("<I", flags))
        stream.write(struct.pack("<Q", pixel_format))
        stream.write(
            struct.pack(
                "<8I",
                color_space,
                channel_type,
                texture.height(),
                texture.width(),
                texture.depth() if dim is Dimension.Dim3D else 1,
                texture.depth() if texture.is_array else 1,
                texture.faces,
                texture.mip_levels,
            )
        )

        bc1 = texture.format in (_F.BC1_RGB, _F.BC1_RGBA)
        entries = []
        if bc1:
            code = b"BC1A" if texture.format is _F.BC1_RGBA else b"BC1\x00"
            entries.append(code)
        if texture.is_array:
            entries.append(b"ARRY")
        if dim is Dimension.Dim1D:
            entries.append(b"DIM1")
        stream.write(struct.pack("<I", 16 * len(entries)))
        for code in entries:
            stream.write(b"CTFS")
            stream.write(code)
            stream.write(struct.pack("<II", 4, 0))

        for level in range(texture.mip_levels):
            for d in range(texture.depth(level)):
                for face in range(texture.faces):
                    data = texture.data(CubeFace(face), level, d)
                    if data is None:
                        return SaveResult.Invalid
                    stream.write(data)
    except OSError:
        return SaveResult.WriteError
    return SaveResult.Success
