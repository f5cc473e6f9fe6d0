"""KTX 2.0 writer.

The reference writes KTX1 only (`lib/src/SaveKtx.cpp`); this
is a capability extension: KTX2 is the container modern engines expect for
BC7/ASTC content (glTF, Vulkan loaders).  Layout per the Khronos KTX 2.0
spec: 12-byte identifier, header (vkFormat/typeSize/dims/counts/
supercompression), index (DFD/KVD/SGD offsets), level index (one
byteOffset/byteLength/uncompressedByteLength triple per mip), then the Data
Format Descriptor (Khronos Data Format Spec 1.3 basic block), key/value
data, and level images ordered smallest mip first, each level aligned to
lcm(texelBlockByteSize, 4), images tightly packed (no KTX1-style row
padding) in layer -> face -> z-slice order.

Supercompression: scheme 0 (none, default), scheme 2 (Zstandard, the
ecosystem default — what ``toktx --zcmp`` emits), or scheme 3 (ZLIB).
Each level's payload is compressed independently, the level index carries
compressed byteLength plus uncompressedByteLength, and level data loses
its alignment requirement per spec.  With scheme 0 the encoded block
payloads are identical to the KTX1/DDS ones.

Self-validated: `tests/test_ktx2.py` re-parses the header, level index,
DFD, and KVD from the raw bytes per spec and checks alignment, offsets,
and data round-trip.  ETC1 payloads are written as
VK_FORMAT_ETC2_R8G8B8_UNORM_BLOCK (ETC2 is a bitstream superset of ETC1;
KTX2/Vulkan has no ETC1 format).

Copied from ``cuttlefish_tpu/containers/ktx2.py`` with its imports pointed at
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
    block_height,
    block_size,
    block_width,
)

_F = TextureFormat
_T = TextureType

IDENTIFIER = b"\xabKTX 20\xbb\r\n\x1a\n"

# -- VkFormat values (Vulkan core enums + IMG PVRTC extension) --------------

# 7-entry series base values: UNORM, SNORM, USCALED, SSCALED, UINT, SINT, SRGB
_VK_R8 = 9
_VK_R8G8 = 16
_VK_R8G8B8 = 23
_VK_B8G8R8 = 30
_VK_R8G8B8A8 = 37
_VK_B8G8R8A8 = 44
_VK_A8B8G8R8 = 51  # _PACK32
# 6-entry series: UNORM, SNORM, USCALED, SSCALED, UINT, SINT
_VK_A2R10G10B10 = 58  # _PACK32
_VK_A2B10G10R10 = 64  # _PACK32
# 7-entry 16-bit series: UNORM, SNORM, USCALED, SSCALED, UINT, SINT, SFLOAT
_VK_R16 = 70
_VK_R16G16 = 77
_VK_R16G16B16 = 84
_VK_R16G16B16A16 = 91
# 3-entry 32-bit series: UINT, SINT, SFLOAT
_VK_R32 = 98
_VK_R32G32 = 101
_VK_R32G32B32 = 104
_VK_R32G32B32A32 = 107

_SERIES8 = {_T.UNorm: 0, _T.SNorm: 1, _T.UInt: 4, _T.Int: 5}  # +6 = SRGB
_SERIES16 = {_T.UNorm: 0, _T.SNorm: 1, _T.UInt: 4, _T.Int: 5, _T.Float: 6}
_SERIES32 = {_T.UInt: 0, _T.Int: 1, _T.Float: 2}

# (vkformat base or value, typeSize)
_PACKED16 = {
    _F.R4G4B4A4: 2,
    _F.B4G4R4A4: 3,
    _F.R5G6B5: 4,
    _F.B5G6R5: 5,
    _F.R5G5B5A1: 6,
    _F.B5G5R5A1: 7,
    _F.A1R5G5B5: 8,
}

# ASTC block-size order matches both the VkFormat and GL enum sequences.
_ASTC_ORDER = [
    (4, 4), (5, 4), (5, 5), (6, 5), (6, 6), (8, 5), (8, 6), (8, 8),
    (10, 5), (10, 6), (10, 8), (10, 10), (12, 10), (12, 12),
]
_VK_ASTC_BASE = 157  # VK_FORMAT_ASTC_4x4_UNORM_BLOCK; sRGB = +1, next size +2

_VK_PVRTC = {  # VK_IMG_format_pvrtc; sRGB variants +4
    _F.PVRTC1_RGB_2BPP: 1000054000,
    _F.PVRTC1_RGBA_2BPP: 1000054000,
    _F.PVRTC1_RGB_4BPP: 1000054001,
    _F.PVRTC1_RGBA_4BPP: 1000054001,
    _F.PVRTC2_RGBA_2BPP: 1000054002,
    _F.PVRTC2_RGBA_4BPP: 1000054003,
}


def get_vk_format(
    fmt: TextureFormat, type_: TextureType, color_space: ColorSpace
) -> tuple[int, int] | None:
    """(vkFormat, typeSize) or None if the combination has no KTX2 mapping."""
    srgb = color_space is ColorSpace.sRGB

    if fmt is _F.R4G4:
        return (1, 1) if type_ is _T.UNorm and not srgb else None
    if fmt is _F.A4R4G4B4:
        # VK_FORMAT_A4R4G4B4_UNORM_PACK16 (VK_EXT_4444_formats / 1.3 core)
        return (1000340000, 2) if type_ is _T.UNorm and not srgb else None
    if fmt in _PACKED16:
        return (_PACKED16[fmt], 2) if type_ is _T.UNorm and not srgb else None

    series8 = {
        _F.R8: _VK_R8, _F.R8G8: _VK_R8G8, _F.R8G8B8: _VK_R8G8B8,
        _F.B8G8R8: _VK_B8G8R8, _F.R8G8B8A8: _VK_R8G8B8A8,
        _F.B8G8R8A8: _VK_B8G8R8A8,
    }
    if fmt in series8:
        if srgb:
            return (series8[fmt] + 6, 1) if type_ is _T.UNorm else None
        off = _SERIES8.get(type_)
        return (series8[fmt] + off, 1) if off is not None else None
    if fmt is _F.A8B8G8R8:
        if srgb:
            return (_VK_A8B8G8R8 + 6, 4) if type_ is _T.UNorm else None
        off = _SERIES8.get(type_)
        return (_VK_A8B8G8R8 + off, 4) if off is not None else None
    if fmt in (_F.A2R10G10B10, _F.A2B10G10R10):
        base = _VK_A2R10G10B10 if fmt is _F.A2R10G10B10 else _VK_A2B10G10R10
        off = {_T.UNorm: 0, _T.UInt: 4}.get(type_)
        return (base + off, 4) if off is not None and not srgb else None

    series16 = {
        _F.R16: _VK_R16, _F.R16G16: _VK_R16G16,
        _F.R16G16B16: _VK_R16G16B16, _F.R16G16B16A16: _VK_R16G16B16A16,
    }
    if fmt in series16:
        off = _SERIES16.get(type_)
        return (series16[fmt] + off, 2) if off is not None and not srgb else None
    series32 = {
        _F.R32: _VK_R32, _F.R32G32: _VK_R32G32,
        _F.R32G32B32: _VK_R32G32B32, _F.R32G32B32A32: _VK_R32G32B32A32,
    }
    if fmt in series32:
        off = _SERIES32.get(type_)
        return (series32[fmt] + off, 4) if off is not None and not srgb else None

    if fmt is _F.B10G11R11_UFloat:
        return (122, 4) if type_ is _T.UFloat and not srgb else None
    if fmt is _F.E5B9G9R9_UFloat:
        return (123, 4) if type_ is _T.UFloat and not srgb else None

    # Compressed (typeSize always 1).
    comp_unorm = {
        _F.BC1_RGB: 131, _F.BC1_RGBA: 133, _F.BC2: 135, _F.BC3: 137,
        _F.BC7: 145, _F.ETC1: 147, _F.ETC2_R8G8B8: 147,
        _F.ETC2_R8G8B8A1: 149, _F.ETC2_R8G8B8A8: 151,
    }
    if fmt in comp_unorm:
        if type_ is not _T.UNorm:
            return None
        return (comp_unorm[fmt] + (1 if srgb else 0), 1)
    if fmt is _F.BC4:
        return {_T.UNorm: (139, 1), _T.SNorm: (140, 1)}.get(type_) if not srgb else None
    if fmt is _F.BC5:
        return {_T.UNorm: (141, 1), _T.SNorm: (142, 1)}.get(type_) if not srgb else None
    if fmt is _F.BC6H:
        return {_T.UFloat: (143, 1), _T.Float: (144, 1)}.get(type_) if not srgb else None
    if fmt is _F.EAC_R11:
        return {_T.UNorm: (153, 1), _T.SNorm: (154, 1)}.get(type_) if not srgb else None
    if fmt is _F.EAC_R11G11:
        return {_T.UNorm: (155, 1), _T.SNorm: (156, 1)}.get(type_) if not srgb else None
    if fmt.name.startswith("ASTC_"):
        if type_ not in (_T.UNorm, _T.UFloat):
            return None
        if type_ is _T.UFloat and srgb:
            return None
        bw, bh = block_width(fmt), block_height(fmt)
        idx = _ASTC_ORDER.index((bw, bh))
        # HDR (UFloat) content uses the same UNORM_BLOCK vkFormat; the DFD
        # transfer/sample flags carry the HDR interpretation (matching
        # toktx's --astc handling of pre-KHR_texture_astc_hdr Vulkan).
        return (_VK_ASTC_BASE + 2 * idx + (1 if srgb else 0), 1)
    if fmt in _VK_PVRTC:
        if type_ is not _T.UNorm:
            return None
        return (_VK_PVRTC[fmt] + (4 if srgb else 0), 1)
    return None


# -- Data Format Descriptor (Khronos Data Format Specification 1.3) ---------

_KDF_MODEL_RGBSDA = 1
_KDF_MODEL = {
    "BC1": 128, "BC2": 129, "BC3": 130, "BC4": 131, "BC5": 132,
    "BC6H": 133, "BC7": 134, "ETC1": 160, "ETC2": 161, "ASTC": 162,
    "PVRTC1": 164, "PVRTC2": 165,
}
_KDF_PRIMARIES_BT709 = 1
_KDF_TRANSFER_LINEAR = 1
_KDF_TRANSFER_SRGB = 2
# sample channelType qualifier flags
_Q_LINEAR = 0x10
_Q_EXPONENT = 0x20
_Q_SIGNED = 0x40
_Q_FLOAT = 0x80
_CH_ALPHA = 15

_F32_ONE = 0x3F800000
_F32_MINUS_ONE = 0xBF800000


def _sample(bit_offset, bit_len, channel, flags=0, lower=0, upper=0xFFFFFFFF):
    return struct.pack(
        "<HBB4BII",
        bit_offset, bit_len - 1, channel | flags,
        0, 0, 0, 0,  # samplePosition0-3
        lower & 0xFFFFFFFF, upper & 0xFFFFFFFF,
    )


def _unorm_sample(bit_offset, bits, channel, srgb=False):
    flags = _Q_LINEAR if (srgb and channel == _CH_ALPHA) else 0
    return _sample(bit_offset, bits, channel, flags, 0, (1 << bits) - 1)


def _snorm_sample(bit_offset, bits, channel):
    top = (1 << (bits - 1)) - 1
    return _sample(bit_offset, bits, channel, _Q_SIGNED, -top, top)


def _float_sample(bit_offset, bits, channel, signed=True):
    flags = _Q_FLOAT | (_Q_SIGNED if signed else 0)
    lower = _F32_MINUS_ONE if signed else 0
    return _sample(bit_offset, bits, channel, flags, lower, _F32_ONE)


def _int_sample(bit_offset, bits, channel, signed):
    if signed:
        top = (1 << (bits - 1)) - 1
        return _sample(bit_offset, bits, channel, _Q_SIGNED, -top, top)
    return _sample(bit_offset, bits, channel, 0, 0, (1 << bits) - 1)


def _channel_samples(layout, type_, srgb):
    """Samples for an uncompressed channel layout: [(channel, offset, bits)]."""
    out = []
    for channel, offset, bits in layout:
        if type_ is _T.UNorm:
            out.append(_unorm_sample(offset, bits, channel, srgb))
        elif type_ is _T.SNorm:
            out.append(_snorm_sample(offset, bits, channel))
        elif type_ in (_T.UInt, _T.Int):
            out.append(_int_sample(offset, bits, channel, type_ is _T.Int))
        else:  # Float/UFloat
            out.append(_float_sample(offset, bits, channel, type_ is _T.Float))
    return out


_R, _G, _B, _A = 0, 1, 2, _CH_ALPHA

# Uncompressed layouts: (channel, bitOffset, bitLength) low-bit-first within
# the packed word / byte sequence.
_LAYOUTS = {
    _F.R4G4: [(_G, 0, 4), (_R, 4, 4)],
    _F.R4G4B4A4: [(_A, 0, 4), (_B, 4, 4), (_G, 8, 4), (_R, 12, 4)],
    _F.B4G4R4A4: [(_A, 0, 4), (_R, 4, 4), (_G, 8, 4), (_B, 12, 4)],
    _F.A4R4G4B4: [(_B, 0, 4), (_G, 4, 4), (_R, 8, 4), (_A, 12, 4)],
    _F.R5G6B5: [(_B, 0, 5), (_G, 5, 6), (_R, 11, 5)],
    _F.B5G6R5: [(_R, 0, 5), (_G, 5, 6), (_B, 11, 5)],
    _F.R5G5B5A1: [(_A, 0, 1), (_B, 1, 5), (_G, 6, 5), (_R, 11, 5)],
    _F.B5G5R5A1: [(_A, 0, 1), (_R, 1, 5), (_G, 6, 5), (_B, 11, 5)],
    _F.A1R5G5B5: [(_B, 0, 5), (_G, 5, 5), (_R, 10, 5), (_A, 15, 1)],
    _F.R8: [(_R, 0, 8)],
    _F.R8G8: [(_R, 0, 8), (_G, 8, 8)],
    _F.R8G8B8: [(_R, 0, 8), (_G, 8, 8), (_B, 16, 8)],
    _F.B8G8R8: [(_B, 0, 8), (_G, 8, 8), (_R, 16, 8)],
    _F.R8G8B8A8: [(_R, 0, 8), (_G, 8, 8), (_B, 16, 8), (_A, 24, 8)],
    _F.B8G8R8A8: [(_B, 0, 8), (_G, 8, 8), (_R, 16, 8), (_A, 24, 8)],
    _F.A8B8G8R8: [(_R, 0, 8), (_G, 8, 8), (_B, 16, 8), (_A, 24, 8)],
    _F.A2R10G10B10: [(_B, 0, 10), (_G, 10, 10), (_R, 20, 10), (_A, 30, 2)],
    _F.A2B10G10R10: [(_R, 0, 10), (_G, 10, 10), (_B, 20, 10), (_A, 30, 2)],
    _F.R16: [(_R, 0, 16)],
    _F.R16G16: [(_R, 0, 16), (_G, 16, 16)],
    _F.R16G16B16: [(_R, 0, 16), (_G, 16, 16), (_B, 32, 16)],
    _F.R16G16B16A16: [(_R, 0, 16), (_G, 16, 16), (_B, 32, 16), (_A, 48, 16)],
    _F.R32: [(_R, 0, 32)],
    _F.R32G32: [(_R, 0, 32), (_G, 32, 32)],
    _F.R32G32B32: [(_R, 0, 32), (_G, 32, 32), (_B, 64, 32)],
    _F.R32G32B32A32: [(_R, 0, 32), (_G, 32, 32), (_B, 64, 32), (_A, 96, 32)],
}


def build_dfd(
    fmt: TextureFormat,
    type_: TextureType,
    color_space: ColorSpace,
    premultiplied: bool,
) -> bytes:
    """Basic (vendor 0, type 0) descriptor block for the format."""
    srgb = color_space is ColorSpace.sRGB
    transfer = _KDF_TRANSFER_SRGB if srgb else _KDF_TRANSFER_LINEAR
    flags = 1 if premultiplied else 0
    bw, bh, bsize = block_width(fmt), block_height(fmt), block_size(fmt)
    nbits = bsize * 8

    if fmt in _LAYOUTS:
        model = _KDF_MODEL_RGBSDA
        samples = _channel_samples(_LAYOUTS[fmt], type_, srgb)
    elif fmt is _F.B10G11R11_UFloat:
        model = _KDF_MODEL_RGBSDA
        samples = [
            _float_sample(0, 11, _R, signed=False),
            _float_sample(11, 11, _G, signed=False),
            _float_sample(22, 10, _B, signed=False),
        ]
    elif fmt is _F.E5B9G9R9_UFloat:
        model = _KDF_MODEL_RGBSDA
        # Shared-exponent: each color sample pairs with an exponent sample
        # (KDF 1.3 shared-exponent description of E5B9G9R9).
        samples = []
        for ch, off in ((_R, 0), (_G, 9), (_B, 18)):
            samples.append(_sample(off, 9, ch, _Q_FLOAT, 0, 8448))
            samples.append(
                _sample(27, 5, ch, _Q_FLOAT | _Q_EXPONENT, 15, 31)
            )
    else:
        name = fmt.name
        signed = type_ in (_T.SNorm, _T.Int, _T.Float)
        if name.startswith("BC1"):
            model = _KDF_MODEL["BC1"]
            samples = [_unorm_sample(0, 64, 0, srgb)]
        elif name in ("BC2", "BC3"):
            model = _KDF_MODEL[name]
            samples = [
                _unorm_sample(0, 64, _CH_ALPHA, srgb),
                _unorm_sample(64, 64, 0, srgb),
            ]
        elif name == "BC4":
            model = _KDF_MODEL["BC4"]
            samples = [
                _snorm_sample(0, 64, 0) if signed else _unorm_sample(0, 64, 0)
            ]
        elif name == "BC5":
            model = _KDF_MODEL["BC5"]
            mk = _snorm_sample if signed else _unorm_sample
            samples = [mk(0, 64, 0), mk(64, 64, 1)]
        elif name == "BC6H":
            model = _KDF_MODEL["BC6H"]
            samples = [_float_sample(0, 128, 0, signed=type_ is _T.Float)]
        elif name == "BC7":
            model = _KDF_MODEL["BC7"]
            samples = [_unorm_sample(0, 128, 0, srgb)]
        elif name == "ETC1" or name == "ETC2_R8G8B8":
            model = _KDF_MODEL["ETC2"]
            samples = [_unorm_sample(0, 64, 2, srgb)]  # ETC2 color channel
        elif name == "ETC2_R8G8B8A1":
            model = _KDF_MODEL["ETC2"]
            samples = [
                _unorm_sample(0, 64, 2, srgb),
                _unorm_sample(0, 64, _CH_ALPHA, srgb),
            ]
        elif name == "ETC2_R8G8B8A8":
            model = _KDF_MODEL["ETC2"]
            samples = [
                _unorm_sample(0, 64, _CH_ALPHA, srgb),
                _unorm_sample(64, 64, 2, srgb),
            ]
        elif name == "EAC_R11":
            model = _KDF_MODEL["ETC2"]
            samples = [
                _snorm_sample(0, 64, 0) if signed else _unorm_sample(0, 64, 0)
            ]
        elif name == "EAC_R11G11":
            model = _KDF_MODEL["ETC2"]
            mk = _snorm_sample if signed else _unorm_sample
            samples = [mk(0, 64, 0), mk(64, 64, 1)]
        elif name.startswith("ASTC_"):
            model = _KDF_MODEL["ASTC"]
            if type_ is _T.UFloat:
                samples = [_float_sample(0, 128, 0, signed=False)]
            else:
                samples = [_unorm_sample(0, 128, 0, srgb)]
        elif name.startswith("PVRTC1"):
            model = _KDF_MODEL["PVRTC1"]
            samples = [_unorm_sample(0, nbits, 0, srgb)]
        elif name.startswith("PVRTC2"):
            model = _KDF_MODEL["PVRTC2"]
            samples = [_unorm_sample(0, nbits, 0, srgb)]
        else:  # pragma: no cover - every format is handled above
            raise ValueError(f"no DFD model for {name}")

    block_size_bytes = 24 + 16 * len(samples)
    header = struct.pack(
        "<IHH4B4B8B",
        0,  # vendorId 0 (Khronos), descriptorType 0 (basic)
        2,  # versionNumber
        block_size_bytes,
        model,
        _KDF_PRIMARIES_BT709,
        transfer,
        flags,
        bw - 1, bh - 1, 0, 0,  # texelBlockDimension0-3
        bsize, 0, 0, 0, 0, 0, 0, 0,  # bytesPlane0-7
    )
    block = header + b"".join(samples)
    return struct.pack("<I", 4 + len(block)) + block


def _kvd_bytes(pairs: dict[str, bytes]) -> bytes:
    out = b""
    for key in sorted(pairs):
        kv = key.encode() + b"\x00" + pairs[key]
        out += struct.pack("<I", len(kv)) + kv
        out += b"\x00" * ((4 - len(kv) % 4) % 4)
    return out


def is_valid_for_ktx2(fmt: TextureFormat, type_: TextureType) -> bool:
    return get_vk_format(fmt, type_, ColorSpace.Linear) is not None


def save_ktx2(texture, stream, supercompression: str = "none") -> SaveResult:
    """Serialize a converted Texture to KTX 2.0.

    ``supercompression``: "none" (scheme 0), "zstd" (scheme 2 — the
    ecosystem default, requires the ``zstandard`` module), or "zlib"
    (scheme 3).  Each level's payload is compressed independently per
    KTX2 spec §5.3; the level index carries both compressed and
    uncompressed byte lengths.
    """
    if supercompression not in ("none", "zlib", "zstd"):
        return SaveResult.Unsupported
    compress = None
    if supercompression == "zlib":
        import zlib

        compress = lambda b: zlib.compress(b, 9)  # noqa: E731
    elif supercompression == "zstd":
        try:
            import zstandard
        except ImportError:
            return SaveResult.Unsupported
        cctx = zstandard.ZstdCompressor(level=9)
        compress = cctx.compress
    vk = get_vk_format(texture.format, texture.type, texture.color_space)
    if vk is None:
        return SaveResult.Unsupported
    vkformat, type_size = vk

    dim = texture.dimension
    fmt = texture.format
    levels = texture.mip_levels
    faces = texture.faces
    layers = texture.depth() if texture.is_array else 0

    dfd = build_dfd(
        fmt, texture.type, texture.color_space,
        texture.alpha_type is Alpha.PreMultiplied,
    )
    orientation = {
        Dimension.Dim1D: b"r",
        Dimension.Dim2D: b"rd",
        Dimension.Cube: b"rd",
        Dimension.Dim3D: b"rdi",
    }[dim] + b"\x00"
    kvd = _kvd_bytes(
        {
            "KTXorientation": orientation,
            "KTXwriter": b"cuttlefish_tpu\x00",
        }
    )

    header_size = 80
    index_size = levels * 24
    dfd_offset = header_size + index_size
    kvd_offset = dfd_offset + len(dfd)
    data_start = kvd_offset + len(kvd)

    # Level payloads (tightly packed; KTX2 has no row padding).
    def level_bytes(level: int) -> bytes | None:
        parts = []
        nlayers = max(layers, 1)
        if dim is Dimension.Dim3D:
            zs = texture.depth(level)
        else:
            zs = 1
        for layer in range(nlayers):
            for face in range(faces):
                for z in range(zs):
                    d = layer if texture.is_array else z
                    data = texture.data(CubeFace(face), level, d)
                    if data is None:
                        return None
                    parts.append(data)
        return b"".join(parts)

    payloads = []
    raw_sizes = []
    for level in range(levels):
        b = level_bytes(level)
        if b is None:
            return SaveResult.Invalid
        raw_sizes.append(len(b))
        if compress is not None:
            b = compress(b)
        payloads.append(b)

    # Alignment: lcm(texelBlockByteSize, 4) for supercompressionScheme 0;
    # supercompressed level data has no alignment requirement.
    if compress is not None:
        lcm = 1
    else:
        bsize = block_size(fmt)
        lcm = bsize
        while lcm % 4:
            lcm += bsize

    offsets = [0] * levels
    # File stores levels largest-index (smallest mip) first; byteOffsets in
    # the level index still refer to absolute file positions.
    pos = data_start
    order = list(range(levels - 1, -1, -1))
    padded: list[tuple[int, bytes]] = []
    for level in order:
        pad = (lcm - pos % lcm) % lcm
        pos += pad
        offsets[level] = pos
        padded.append((pad, payloads[level]))
        pos += len(payloads[level])

    try:
        stream.write(IDENTIFIER)
        stream.write(
            struct.pack(
                "<9I",
                vkformat,
                type_size,
                texture.width(),
                0 if dim is Dimension.Dim1D else texture.height(),
                texture.depth() if dim is Dimension.Dim3D else 0,
                layers,
                faces,
                levels,
                {"none": 0, "zstd": 2, "zlib": 3}[supercompression],
            )
        )
        stream.write(
            struct.pack(
                "<4I2Q",
                dfd_offset, len(dfd), kvd_offset, len(kvd), 0, 0,
            )
        )
        for level in range(levels):
            stream.write(
                struct.pack(
                    "<3Q",
                    offsets[level], len(payloads[level]), raw_sizes[level],
                )
            )
        stream.write(dfd)
        stream.write(kvd)
        for pad, payload in padded:
            if pad:
                stream.write(b"\x00" * pad)
            stream.write(payload)
    except OSError:
        return SaveResult.WriteError
    return SaveResult.Success
