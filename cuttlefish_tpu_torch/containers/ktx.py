"""KTX 1 writer.

Byte-layout matches the reference (`lib/src/SaveKtx.cpp`):
12-byte magic, endianness 0x04030201, FormatInfo GL enums
(SaveKtx.cpp:200-1181), dims (height 0 for 1D, depth 0 unless 3D), 0 key-value
bytes, then per-mip imageSize followed by data mip -> depth -> face with
4-byte scanline padding for uncompressed formats (SaveKtx.cpp:1222-1287).

Copied from ``cuttlefish_tpu/containers/ktx.py`` with its imports pointed at
the port; its logic is unchanged.
"""

from __future__ import annotations

import struct

from cuttlefish_tpu_torch.formats import (
    ColorSpace,
    CubeFace,
    Dimension,
    SaveResult,
    TextureFormat,
    TextureType,
    block_size,
    block_width,
)

_F = TextureFormat
_T = TextureType

MAGIC = b"\xabKTX 11\xbb\r\n\x1a\n"
ENDIANNESS = 0x04030201

# GL enums (SaveKtx.cpp:23-180).
GL = {
    "BYTE": 0x1400, "UNSIGNED_BYTE": 0x1401, "SHORT": 0x1402,
    "UNSIGNED_SHORT": 0x1403, "INT": 0x1404, "UNSIGNED_INT": 0x1405,
    "FLOAT": 0x1406, "HALF_FLOAT": 0x140B, "RED": 0x1903, "LUMINANCE": 0x1909,
    "LUMINANCE_ALPHA": 0x190A, "RGB": 0x1907, "RGBA": 0x1908,
    "UNSIGNED_INT_8_8_8_8": 0x8035, "BGR": 0x80E0, "BGRA": 0x80E1,
    "RGBA4": 0x8056, "RGB5_A1": 0x8057, "RGB16": 0x8054, "RGBA16": 0x805B,
    "RGB8": 0x8051, "RGBA8": 0x8058, "RGB10_A2": 0x8059,
    "UNSIGNED_SHORT_4_4_4_4": 0x8033, "UNSIGNED_SHORT_5_5_5_1": 0x8034,
    "RG": 0x8227, "RG_INTEGER": 0x8228, "R8": 0x8229, "R16": 0x822A,
    "RG8": 0x822B, "RG16": 0x822C, "R16F": 0x822D, "R32F": 0x822E,
    "RG16F": 0x822F, "RG32F": 0x8230, "R8I": 0x8231, "R8UI": 0x8232,
    "R16I": 0x8233, "R16UI": 0x8234, "R32I": 0x8235, "R32UI": 0x8236,
    "RG8I": 0x8237, "RG8UI": 0x8238, "RG16I": 0x8239, "RG16UI": 0x823A,
    "RG32I": 0x823B, "RG32UI": 0x823C, "UNSIGNED_SHORT_5_6_5": 0x8363,
    "UNSIGNED_SHORT_5_6_5_REV": 0x8364, "UNSIGNED_SHORT_1_5_5_5_REV": 0x8366,
    "UNSIGNED_INT_8_8_8_8_REV": 0x8367, "UNSIGNED_INT_2_10_10_10_REV": 0x8368,
    "COMPRESSED_RGB_S3TC_DXT1": 0x83F0, "COMPRESSED_RGBA_S3TC_DXT1": 0x83F1,
    "COMPRESSED_RGBA_S3TC_DXT3": 0x83F2, "COMPRESSED_RGBA_S3TC_DXT5": 0x83F3,
    "RGBA32F": 0x8814, "RGB32F": 0x8815, "RGBA16F": 0x881A, "RGB16F": 0x881B,
    "COMPRESSED_SRGB_PVRTC_2BPPV1": 0x8A54, "COMPRESSED_SRGB_PVRTC_4BPPV1": 0x8A55,
    "COMPRESSED_SRGB_ALPHA_PVRTC_2BPPV1": 0x8A56,
    "COMPRESSED_SRGB_ALPHA_PVRTC_4BPPV1": 0x8A57,
    "COMPRESSED_RGB_PVRTC_4BPPV1": 0x8C00, "COMPRESSED_RGB_PVRTC_2BPPV1": 0x8C01,
    "COMPRESSED_RGBA_PVRTC_4BPPV1": 0x8C02, "COMPRESSED_RGBA_PVRTC_2BPPV1": 0x8C03,
    "R11F_G11F_B10F": 0x8C3A, "UNSIGNED_INT_10F_11F_11F_REV": 0x8C3B,
    "RGB9_E5": 0x8C3D, "UNSIGNED_INT_5_9_9_9_REV": 0x8C3E, "SRGB8": 0x8C41,
    "SRGB8_ALPHA8": 0x8C43, "COMPRESSED_SRGB_S3TC_DXT1": 0x8C4C,
    "COMPRESSED_SRGB_ALPHA_S3TC_DXT1": 0x8C4D,
    "COMPRESSED_SRGB_ALPHA_S3TC_DXT3": 0x8C4E,
    "COMPRESSED_SRGB_ALPHA_S3TC_DXT5": 0x8C4F, "RGB565": 0x8D62,
    "ETC1_RGB8_OES": 0x8D64, "RGBA32UI": 0x8D70, "RGB32UI": 0x8D71,
    "RGBA16UI": 0x8D76, "RGB16UI": 0x8D77, "RGBA8UI": 0x8D7C, "RGB8UI": 0x8D7D,
    "RGBA32I": 0x8D82, "RGB32I": 0x8D83, "RGBA16I": 0x8D88, "RGB16I": 0x8D89,
    "RGBA8I": 0x8D8E, "RGB8I": 0x8D8F, "RED_INTEGER": 0x8D94,
    "RGB_INTEGER": 0x8D98, "RGBA_INTEGER": 0x8D99, "BGR_INTEGER": 0x8D9A,
    "BGRA_INTEGER": 0x8D9B, "COMPRESSED_RED_RGTC1": 0x8DBB,
    "COMPRESSED_SIGNED_RED_RGTC1": 0x8DBC, "COMPRESSED_RG_RGTC2": 0x8DBD,
    "COMPRESSED_SIGNED_RG_RGTC2": 0x8DBE, "COMPRESSED_RGBA_BPTC_UNORM": 0x8E8C,
    "COMPRESSED_SRGB_ALPHA_BPTC_UNORM": 0x8E8D,
    "COMPRESSED_RGB_BPTC_SIGNED_FLOAT": 0x8E8E,
    "COMPRESSED_RGB_BPTC_UNSIGNED_FLOAT": 0x8E8F, "R8_SNORM": 0x8F94,
    "RG8_SNORM": 0x8F95, "RGB8_SNORM": 0x8F96, "RGBA8_SNORM": 0x8F97,
    "R16_SNORM": 0x8F98, "RG16_SNORM": 0x8F99, "RGB16_SNORM": 0x8F9A,
    "RGBA16_SNORM": 0x8F9B, "RGB10_A2UI": 0x906F,
    "COMPRESSED_RGBA_PVRTC_2BPPV2": 0x9137, "COMPRESSED_RGBA_PVRTC_4BPPV2": 0x9138,
    "COMPRESSED_R11_EAC": 0x9270, "COMPRESSED_SIGNED_R11_EAC": 0x9271,
    "COMPRESSED_RG11_EAC": 0x9272, "COMPRESSED_SIGNED_RG11_EAC": 0x9273,
    "COMPRESSED_RGB8_ETC2": 0x9274, "COMPRESSED_SRGB8_ETC2": 0x9275,
    "COMPRESSED_RGB8_PUNCHTHROUGH_ALPHA1_ETC2": 0x9276,
    "COMPRESSED_SRGB8_PUNCHTHROUGH_ALPHA1_ETC2": 0x9277,
    "COMPRESSED_RGBA8_ETC2_EAC": 0x9278, "COMPRESSED_SRGB8_ALPHA8_ETC2_EAC": 0x9279,
    "COMPRESSED_SRGB_ALPHA_PVRTC_2BPPV2": 0x93F0,
    "COMPRESSED_SRGB_ALPHA_PVRTC_4BPPV2": 0x93F1,
}
# ASTC enums are contiguous from 4x4 (0x93B0 LDR, 0x93D0 sRGB).
_ASTC_ORDER = [
    "4x4", "5x4", "5x5", "6x5", "6x6", "8x5", "8x6", "8x8",
    "10x5", "10x6", "10x8", "10x10", "12x10", "12x12",
]
for _i, _n in enumerate(_ASTC_ORDER):
    GL[f"COMPRESSED_RGBA_ASTC_{_n}"] = 0x93B0 + _i
    GL[f"COMPRESSED_SRGB8_ALPHA8_ASTC_{_n}"] = 0x93D0 + _i


def get_format_info(
    fmt: TextureFormat, type_: TextureType, color_space: ColorSpace
) -> tuple[int, int, int, int, int] | None:
    """(glType, glTypeSize, glFormat, glInternalFormat, glBaseInternalFormat)
    or None (SaveKtx.cpp:200-1181)."""
    srgb = color_space is ColorSpace.sRGB

    # (type, typeSize, format, internal by TextureType, base)
    packed16 = {
        _F.R4G4B4A4: ("UNSIGNED_SHORT_4_4_4_4", "RGBA", "RGBA4", "RGBA"),
        _F.B4G4R4A4: ("UNSIGNED_SHORT_4_4_4_4", "BGRA", "RGBA4", "BGRA"),
        _F.R5G6B5: ("UNSIGNED_SHORT_5_6_5", "RGB", "RGB565", "RGB"),
        _F.B5G6R5: ("UNSIGNED_SHORT_5_6_5_REV", "RGB", "RGB565", "RGB"),
        _F.R5G5B5A1: ("UNSIGNED_SHORT_5_5_5_1", "RGBA", "RGB5_A1", "RGBA"),
        _F.B5G5R5A1: ("UNSIGNED_SHORT_5_5_5_1", "BGRA", "RGB5_A1", "BGRA"),
        _F.A1R5G5B5: ("UNSIGNED_SHORT_1_5_5_5_REV", "BGRA", "RGB5_A1", "BGRA"),
    }
    if fmt in packed16:
        gtype, gformat, internal, base = packed16[fmt]
        if type_ is not _T.UNorm:
            return None
        return (GL[gtype], 2, GL[gformat], GL[internal], GL[base])

    if fmt is _F.R8:
        if type_ in (_T.UNorm, _T.SNorm, _T.UInt, _T.Int):
            internal = {_T.UNorm: "R8", _T.SNorm: "R8_SNORM", _T.UInt: "R8UI", _T.Int: "R8I"}[type_]
            gtype = "UNSIGNED_BYTE" if type_ in (_T.UNorm, _T.UInt) else "BYTE"
            return (GL[gtype], 1, GL["RED"], GL[internal], GL["LUMINANCE"])
        return None
    if fmt is _F.R8G8:
        if type_ in (_T.UNorm, _T.SNorm, _T.UInt, _T.Int):
            internal = {_T.UNorm: "RG8", _T.SNorm: "RG8_SNORM", _T.UInt: "RG8UI", _T.Int: "RG8I"}[type_]
            # Reference sets glType GL_UNSIGNED_BYTE for all R8G8 variants.
            return (GL["UNSIGNED_BYTE"], 1, GL["RG"], GL[internal], GL["LUMINANCE_ALPHA"])
        return None
    if fmt is _F.R8G8B8:
        if type_ in (_T.UNorm, _T.SNorm, _T.UInt, _T.Int):
            internal = {
                _T.UNorm: "SRGB8" if srgb else "RGB8",
                _T.SNorm: "RGB8_SNORM", _T.UInt: "RGB8UI", _T.Int: "RGB8I",
            }[type_]
            gtype = "UNSIGNED_BYTE" if type_ in (_T.UNorm, _T.UInt) else "BYTE"
            return (GL[gtype], 1, GL["RGB"], GL[internal], GL["RGB"])
        return None
    if fmt is _F.R8G8B8A8:
        if type_ in (_T.UNorm, _T.SNorm, _T.UInt, _T.Int):
            internal = {
                _T.UNorm: "SRGB8_ALPHA8" if srgb else "RGBA8",
                _T.SNorm: "RGBA8_SNORM", _T.UInt: "RGBA8UI", _T.Int: "RGBA8I",
            }[type_]
            gtype = "UNSIGNED_BYTE" if type_ in (_T.UNorm, _T.UInt) else "BYTE"
            gfmt = "RGBA_INTEGER" if type_ in (_T.UInt, _T.Int) else "RGBA"
            return (GL[gtype], 1, GL[gfmt], GL[internal], GL["RGBA"])
        return None
    if fmt is _F.B8G8R8A8:
        if type_ in (_T.UNorm, _T.SNorm, _T.UInt, _T.Int):
            internal = {
                _T.UNorm: "SRGB8_ALPHA8" if srgb else "RGBA8",
                _T.SNorm: "RGBA8_SNORM", _T.UInt: "RGBA8UI", _T.Int: "RGBA8I",
            }[type_]
            # Reference leaves glFormat BGRA except UInt -> BGRA_INTEGER, and
            # Int keeps the previously-set BGRA (SaveKtx.cpp B8G8R8A8 case).
            gfmt = "BGRA_INTEGER" if type_ is _T.UInt else "BGRA"
            return (GL["UNSIGNED_INT_8_8_8_8"], 4, GL[gfmt], GL[internal], GL["BGRA"])
        return None
    if fmt is _F.A8B8G8R8:
        if type_ in (_T.UNorm, _T.SNorm, _T.UInt, _T.Int):
            internal = {
                _T.UNorm: "SRGB8_ALPHA8" if srgb else "RGBA8",
                _T.SNorm: "RGBA8_SNORM", _T.UInt: "RGBA8UI", _T.Int: "RGBA8I",
            }[type_]
            gfmt = "RGBA_INTEGER" if type_ in (_T.UInt, _T.Int) else "RGBA"
            return (GL["UNSIGNED_INT_8_8_8_8_REV"], 4, GL[gfmt], GL[internal], GL["RGBA"])
        return None
    if fmt in (_F.A2R10G10B10, _F.A2B10G10R10):
        base = "BGRA" if fmt is _F.A2R10G10B10 else "RGBA"
        if type_ is _T.UNorm:
            return (GL["UNSIGNED_INT_2_10_10_10_REV"], 4, GL[base], GL["RGB10_A2"], GL[base])
        if type_ is _T.UInt:
            gfmt = base + "_INTEGER"
            return (GL["UNSIGNED_INT_2_10_10_10_REV"], 4, GL[gfmt], GL["RGB10_A2UI"], GL[base])
        return None

    wide = {
        _F.R16: ("R16", "RED", "LUMINANCE", 2),
        _F.R16G16: ("RG16", "RG", "LUMINANCE_ALPHA", 2),
        _F.R16G16B16: ("RGB16", "RGB", "RGB", 2),
        _F.R16G16B16A16: ("RGBA16", "RGBA", "RGBA", 2),
    }
    if fmt in wide:
        name, gfmt, base, size = wide[fmt]
        internal = {
            _T.UNorm: name, _T.SNorm: name + "_SNORM",
            _T.UInt: name + "UI", _T.Int: name + "I", _T.Float: name + "F",
        }.get(type_)
        if internal is None:
            return None
        gtype = {
            _T.UNorm: "UNSIGNED_SHORT", _T.SNorm: "SHORT",
            _T.UInt: "UNSIGNED_SHORT", _T.Int: "SHORT", _T.Float: "HALF_FLOAT",
        }[type_]
        return (GL[gtype], size, GL[gfmt], GL[internal], GL[base])

    wide32 = {
        _F.R32: ("R32", "RED", "LUMINANCE"),
        _F.R32G32: ("RG32", "RG", "LUMINANCE_ALPHA"),
        _F.R32G32B32: ("RGB32", "RGB", "RGB"),
        _F.R32G32B32A32: ("RGBA32", "RGBA", "RGBA"),
    }
    if fmt in wide32:
        name, gfmt, base = wide32[fmt]
        internal = {_T.UInt: name + "UI", _T.Int: name + "I", _T.Float: name + "F"}.get(type_)
        if internal is None:
            return None
        gtype = {_T.UInt: "UNSIGNED_INT", _T.Int: "INT", _T.Float: "FLOAT"}[type_]
        return (GL[gtype], 4, GL[gfmt], GL[internal], GL[base])

    if fmt is _F.B10G11R11_UFloat:
        if type_ is _T.UFloat:
            return (GL["UNSIGNED_INT_10F_11F_11F_REV"], 4, GL["RGB"], GL["R11F_G11F_B10F"], GL["RGB"])
        return None
    if fmt is _F.E5B9G9R9_UFloat:
        if type_ is _T.UFloat:
            return (GL["UNSIGNED_INT_5_9_9_9_REV"], 4, GL["RGB"], GL["RGB9_E5"], GL["RGB"])
        return None

    # Compressed: glType=0, glTypeSize=1, glFormat=0.
    def compressed(internal_linear, internal_srgb, base):
        internal = internal_srgb if srgb else internal_linear
        return (0, 1, 0, GL[internal], GL[base])

    comp = {
        _F.BC1_RGB: ("COMPRESSED_RGB_S3TC_DXT1", "COMPRESSED_SRGB_S3TC_DXT1", "RGB", {_T.UNorm}),
        _F.BC1_RGBA: ("COMPRESSED_RGBA_S3TC_DXT1", "COMPRESSED_SRGB_ALPHA_S3TC_DXT1", "RGBA", {_T.UNorm}),
        _F.BC2: ("COMPRESSED_RGBA_S3TC_DXT3", "COMPRESSED_SRGB_ALPHA_S3TC_DXT3", "RGBA", {_T.UNorm}),
        _F.BC3: ("COMPRESSED_RGBA_S3TC_DXT5", "COMPRESSED_SRGB_ALPHA_S3TC_DXT5", "RGBA", {_T.UNorm}),
        _F.BC7: ("COMPRESSED_RGBA_BPTC_UNORM", "COMPRESSED_SRGB_ALPHA_BPTC_UNORM", "RGBA", {_T.UNorm}),
        _F.ETC1: ("ETC1_RGB8_OES", "ETC1_RGB8_OES", "RGB", {_T.UNorm}),
        _F.ETC2_R8G8B8: ("COMPRESSED_RGB8_ETC2", "COMPRESSED_SRGB8_ETC2", "RGB", {_T.UNorm}),
        _F.ETC2_R8G8B8A1: (
            "COMPRESSED_RGB8_PUNCHTHROUGH_ALPHA1_ETC2",
            "COMPRESSED_SRGB8_PUNCHTHROUGH_ALPHA1_ETC2", "RGBA", {_T.UNorm}),
        _F.ETC2_R8G8B8A8: ("COMPRESSED_RGBA8_ETC2_EAC", "COMPRESSED_SRGB8_ALPHA8_ETC2_EAC", "RGBA", {_T.UNorm}),
        _F.PVRTC1_RGB_2BPP: ("COMPRESSED_RGB_PVRTC_2BPPV1", "COMPRESSED_SRGB_PVRTC_2BPPV1", "RGB", {_T.UNorm}),
        _F.PVRTC1_RGBA_2BPP: ("COMPRESSED_RGBA_PVRTC_2BPPV1", "COMPRESSED_SRGB_ALPHA_PVRTC_2BPPV1", "RGBA", {_T.UNorm}),
        _F.PVRTC1_RGB_4BPP: ("COMPRESSED_RGB_PVRTC_4BPPV1", "COMPRESSED_SRGB_PVRTC_4BPPV1", "RGB", {_T.UNorm}),
        _F.PVRTC1_RGBA_4BPP: ("COMPRESSED_RGBA_PVRTC_4BPPV1", "COMPRESSED_SRGB_ALPHA_PVRTC_4BPPV1", "RGBA", {_T.UNorm}),
        _F.PVRTC2_RGBA_2BPP: ("COMPRESSED_RGBA_PVRTC_2BPPV2", "COMPRESSED_SRGB_ALPHA_PVRTC_2BPPV2", "RGBA", {_T.UNorm}),
        _F.PVRTC2_RGBA_4BPP: ("COMPRESSED_RGBA_PVRTC_4BPPV2", "COMPRESSED_SRGB_ALPHA_PVRTC_4BPPV2", "RGBA", {_T.UNorm}),
        _F.BC4: ("COMPRESSED_RED_RGTC1", None, "RED", {_T.UNorm, _T.SNorm}),
        _F.BC5: ("COMPRESSED_RG_RGTC2", None, "RG", {_T.UNorm, _T.SNorm}),
        _F.BC6H: ("COMPRESSED_RGB_BPTC_UNSIGNED_FLOAT", None, "RGB", {_T.UFloat, _T.Float}),
        _F.EAC_R11: ("COMPRESSED_R11_EAC", None, "RED", {_T.UNorm, _T.SNorm}),
        _F.EAC_R11G11: ("COMPRESSED_RG11_EAC", None, "RG", {_T.UNorm, _T.SNorm}),
    }
    if fmt in comp:
        internal_linear, internal_srgb, base, types = comp[fmt]
        if type_ not in types:
            return None
        if fmt is _F.BC4:
            name = "COMPRESSED_RED_RGTC1" if type_ is _T.UNorm else "COMPRESSED_SIGNED_RED_RGTC1"
        elif fmt is _F.BC5:
            name = "COMPRESSED_RG_RGTC2" if type_ is _T.UNorm else "COMPRESSED_SIGNED_RG_RGTC2"
        elif fmt is _F.BC6H:
            name = (
                "COMPRESSED_RGB_BPTC_UNSIGNED_FLOAT"
                if type_ is _T.UFloat
                else "COMPRESSED_RGB_BPTC_SIGNED_FLOAT"
            )
        elif fmt is _F.EAC_R11:
            name = "COMPRESSED_R11_EAC" if type_ is _T.UNorm else "COMPRESSED_SIGNED_R11_EAC"
        elif fmt is _F.EAC_R11G11:
            name = "COMPRESSED_RG11_EAC" if type_ is _T.UNorm else "COMPRESSED_SIGNED_RG11_EAC"
        else:
            name = internal_srgb if srgb else internal_linear
        return (0, 1, 0, GL[name], GL[base])

    if fmt.name.startswith("ASTC_"):
        if type_ not in (_T.UNorm, _T.UFloat):
            return None
        block = fmt.name[5:]
        name = f"COMPRESSED_SRGB8_ALPHA8_ASTC_{block}" if srgb else f"COMPRESSED_RGBA_ASTC_{block}"
        return (0, 1, 0, GL[name], GL["RGBA"])

    return None


def is_valid_for_ktx(fmt: TextureFormat, type_: TextureType) -> bool:
    return get_format_info(fmt, type_, ColorSpace.Linear) is not None


def save_ktx(texture, stream) -> SaveResult:
    """Serialize a converted Texture to KTX 1 (SaveKtx.cpp:1189-1290)."""
    info = get_format_info(texture.format, texture.type, texture.color_space)
    if info is None:
        return SaveResult.Unsupported

    dim = texture.dimension
    try:
        stream.write(MAGIC)
        stream.write(struct.pack("<I", ENDIANNESS))
        stream.write(struct.pack("<5I", *info))
        stream.write(
            struct.pack(
                "<7I",
                texture.width(),
                0 if dim is Dimension.Dim1D else texture.height(),
                texture.depth() if dim is Dimension.Dim3D else 0,
                texture.depth() if texture.is_array else 0,
                texture.faces,
                texture.mip_levels,
                0,  # bytesOfKeyValueData
            )
        )

        compressed = block_width(texture.format) > 1
        fmt_size = block_size(texture.format)
        for level in range(texture.mip_levels):
            if compressed:
                image_size = texture.data_size(CubeFace.PosX, level) * texture.depth(level)
            else:
                row = (texture.width(level) * fmt_size + 3) // 4 * 4
                image_size = row * texture.height(level) * texture.depth(level)
            if texture.is_array:
                image_size *= texture.faces
            stream.write(struct.pack("<I", image_size))

            for d in range(texture.depth(level)):
                for face in range(texture.faces):
                    data = texture.data(CubeFace(face), level, d)
                    if data is None:
                        return SaveResult.Invalid
                    if compressed:
                        stream.write(data)
                    else:
                        row_size = texture.width(level) * fmt_size
                        padding = (4 - row_size % 4) % 4
                        if padding == 0:
                            stream.write(data)
                        else:
                            pad = b"\x00" * padding
                            for y in range(texture.height(level)):
                                stream.write(data[y * row_size : (y + 1) * row_size])
                                stream.write(pad)
    except OSError:
        return SaveResult.WriteError
    return SaveResult.Success
