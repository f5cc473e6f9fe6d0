"""DDS writer (always with the DX10 extension header).

Byte-layout matches the reference (`lib/src/SaveDds.cpp`):
magic + 124-byte header + 20-byte DXT10 header (148 bytes total), fourCC
'DX10', pitch by block math, data ordered element -> face -> mip -> volume
(SaveDds.cpp:657-680).

Copied from ``cuttlefish_tpu/containers/dds.py`` with its imports pointed at
the port; its logic is unchanged.
"""

from __future__ import annotations

import struct

from cuttlefish_tpu_torch.formats import (
    Alpha,
    ColorSpace,
    Dimension,
    SaveResult,
    TextureFormat,
    TextureType,
    block_size,
    block_width,
    has_alpha,
)

_F = TextureFormat
_T = TextureType

MAGIC = 0x20534444  # 'DDS '

# Header flags (SaveDds.cpp:28-40).
_FLAGS_REQUIRED = 0x1 | 0x2 | 0x4 | 0x1000
_FLAGS_PITCH = 0x8
_FLAGS_MIPMAP_COUNT = 0x20000
_FLAGS_DEPTH = 0x800000
_FORMAT_FOURCC = 0x4
_CAPS_COMPLEX = 0x8
_CAPS_MIPMAP = 0x400000
_CAPS_TEXTURE = 0x1000
_CAPS2_CUBE_ALL = 0x200 | 0x400 | 0x800 | 0x1000 | 0x2000 | 0x4000 | 0x8000
_CAPS2_VOLUME = 0x200000
_DIM_1D, _DIM_2D, _DIM_3D = 2, 3, 4
_MISC_CUBEMAP = 0x4

# DXGI_FORMAT values (SaveDds.cpp:70-191).
_DXGI = {
    "R32G32B32A32_FLOAT": 2, "R32G32B32A32_UINT": 3, "R32G32B32A32_SINT": 4,
    "R32G32B32_FLOAT": 6, "R32G32B32_UINT": 7, "R32G32B32_SINT": 8,
    "R16G16B16A16_FLOAT": 10, "R16G16B16A16_UNORM": 11, "R16G16B16A16_UINT": 12,
    "R16G16B16A16_SNORM": 13, "R16G16B16A16_SINT": 14,
    "R32G32_FLOAT": 16, "R32G32_UINT": 17, "R32G32_SINT": 18,
    "R10G10B10A2_UNORM": 24, "R10G10B10A2_UINT": 25, "R11G11B10_FLOAT": 26,
    "R8G8B8A8_UNORM": 28, "R8G8B8A8_UNORM_SRGB": 29, "R8G8B8A8_UINT": 30,
    "R8G8B8A8_SNORM": 31, "R8G8B8A8_SINT": 32,
    "R16G16_FLOAT": 34, "R16G16_UNORM": 35, "R16G16_UINT": 36,
    "R16G16_SNORM": 37, "R16G16_SINT": 38,
    "R32_FLOAT": 41, "R32_UINT": 42, "R32_SINT": 43,
    "R8G8_UNORM": 49, "R8G8_UINT": 50, "R8G8_SNORM": 51, "R8G8_SINT": 52,
    "R16_FLOAT": 54, "R16_UNORM": 56, "R16_UINT": 57, "R16_SNORM": 58,
    "R16_SINT": 59,
    "R8_UNORM": 61, "R8_UINT": 62, "R8_SNORM": 63, "R8_SINT": 64,
    "R9G9B9E5_SHAREDEXP": 67,
    "BC1_UNORM": 71, "BC1_UNORM_SRGB": 72, "BC2_UNORM": 74, "BC2_UNORM_SRGB": 75,
    "BC3_UNORM": 77, "BC3_UNORM_SRGB": 78, "BC4_UNORM": 80, "BC4_SNORM": 81,
    "BC5_UNORM": 83, "BC5_SNORM": 84, "B5G6R5_UNORM": 85, "B5G5R5A1_UNORM": 86,
    "B8G8R8A8_UNORM": 87, "B8G8R8A8_UNORM_SRGB": 91,
    "BC6H_UF16": 95, "BC6H_SF16": 96, "BC7_UNORM": 98, "BC7_UNORM_SRGB": 99,
    "IA44": 112, "B4G4R4A4_UNORM": 115,
}


def get_dds_format(fmt: TextureFormat, type_: TextureType, color_space: ColorSpace) -> int:
    """Texture (format, type, colorspace) -> DXGI format, 0 = unsupported
    (SaveDds.cpp:255-551)."""
    srgb = color_space is ColorSpace.sRGB

    uni = {_T.UNorm: "UNORM", _T.SNorm: "SNORM", _T.UInt: "UINT", _T.Int: "SINT"}
    unif = {**uni, _T.Float: "FLOAT"}
    intf = {_T.UInt: "UINT", _T.Int: "SINT", _T.Float: "FLOAT"}

    def channel_fmt(prefix: str, types: dict[TextureType, str], srgb_ok=False):
        name = types.get(type_)
        if name is None:
            return 0
        full = f"{prefix}_{name}"
        if srgb_ok and srgb and type_ is _T.UNorm:
            full += "_SRGB"
        return _DXGI.get(full, 0)

    if fmt is _F.R4G4:
        return _DXGI["IA44"] if type_ is _T.UNorm else 0
    if fmt is _F.A4R4G4B4:
        return _DXGI["B4G4R4A4_UNORM"] if type_ is _T.UNorm else 0
    if fmt is _F.R5G6B5:
        return _DXGI["B5G6R5_UNORM"] if type_ is _T.UNorm else 0
    if fmt is _F.A1R5G5B5:
        return _DXGI["B5G5R5A1_UNORM"] if type_ is _T.UNorm else 0
    if fmt is _F.R8:
        return channel_fmt("R8", uni)
    if fmt is _F.R8G8:
        return channel_fmt("R8G8", uni)
    if fmt is _F.R8G8B8A8:
        return channel_fmt("R8G8B8A8", uni, srgb_ok=True)
    if fmt is _F.B8G8R8A8:
        if type_ is _T.UNorm:
            return _DXGI["B8G8R8A8_UNORM_SRGB" if srgb else "B8G8R8A8_UNORM"]
        return 0
    if fmt is _F.A2B10G10R10:
        return channel_fmt("R10G10B10A2", {_T.UNorm: "UNORM", _T.UInt: "UINT"})
    if fmt is _F.R16:
        return channel_fmt("R16", unif)
    if fmt is _F.R16G16:
        return channel_fmt("R16G16", unif)
    if fmt is _F.R16G16B16A16:
        return channel_fmt("R16G16B16A16", unif)
    if fmt is _F.R32:
        return channel_fmt("R32", intf)
    if fmt is _F.R32G32:
        return channel_fmt("R32G32", intf)
    if fmt is _F.R32G32B32:
        return channel_fmt("R32G32B32", intf)
    if fmt is _F.R32G32B32A32:
        return channel_fmt("R32G32B32A32", intf)
    if fmt is _F.B10G11R11_UFloat:
        return _DXGI["R11G11B10_FLOAT"] if type_ is _T.UFloat else 0
    if fmt is _F.E5B9G9R9_UFloat:
        return _DXGI["R9G9B9E5_SHAREDEXP"] if type_ is _T.UFloat else 0
    if fmt in (_F.BC1_RGB, _F.BC1_RGBA):
        if type_ is _T.UNorm:
            return _DXGI["BC1_UNORM_SRGB" if srgb else "BC1_UNORM"]
        return 0
    if fmt is _F.BC2:
        if type_ is _T.UNorm:
            return _DXGI["BC2_UNORM_SRGB" if srgb else "BC2_UNORM"]
        return 0
    if fmt is _F.BC3:
        if type_ is _T.UNorm:
            return _DXGI["BC3_UNORM_SRGB" if srgb else "BC3_UNORM"]
        return 0
    if fmt is _F.BC4:
        return channel_fmt("BC4", {_T.UNorm: "UNORM", _T.SNorm: "SNORM"})
    if fmt is _F.BC5:
        return channel_fmt("BC5", {_T.UNorm: "UNORM", _T.SNorm: "SNORM"})
    if fmt is _F.BC6H:
        if type_ is _T.UFloat:
            return _DXGI["BC6H_UF16"]
        if type_ is _T.Float:
            return _DXGI["BC6H_SF16"]
        return 0
    if fmt is _F.BC7:
        if type_ is _T.UNorm:
            return _DXGI["BC7_UNORM_SRGB" if srgb else "BC7_UNORM"]
        return 0
    return 0


def is_valid_for_dds(fmt: TextureFormat, type_: TextureType) -> bool:
    return get_dds_format(fmt, type_, ColorSpace.Linear) != 0


def save_dds(texture, stream) -> SaveResult:
    """Serialize a converted Texture to DDS (SaveDds.cpp:565-683)."""
    dds_format = get_dds_format(texture.format, texture.type, texture.color_space)
    if dds_format == 0:
        return SaveResult.Unsupported

    dim = texture.dimension
    mip_count = texture.mip_levels
    flags = _FLAGS_REQUIRED | _FLAGS_MIPMAP_COUNT | _FLAGS_PITCH
    if dim is Dimension.Dim3D:
        flags |= _FLAGS_DEPTH
    bw = block_width(texture.format)
    pitch = (texture.width() + bw - 1) // bw * block_size(texture.format)

    caps = _CAPS_TEXTURE
    if mip_count > 1:
        caps |= _CAPS_MIPMAP
    if mip_count > 1 or dim is Dimension.Dim3D or texture.is_array:
        caps |= _CAPS_COMPLEX
    caps2 = 0
    if dim is Dimension.Cube:
        caps2 = _CAPS2_CUBE_ALL
    elif dim is Dimension.Dim3D:
        caps2 = _CAPS2_VOLUME

    header = struct.pack(
        "<7I11I8I5I",
        124,  # header size
        flags,
        texture.height(),
        texture.width(),
        pitch,
        texture.depth() if dim is Dimension.Dim3D else 0,
        mip_count,
        *([0] * 11),  # reserved1
        32,  # ddspf.size
        _FORMAT_FOURCC,
        int.from_bytes(b"DX10", "little"),
        0, 0, 0, 0, 0,  # bit count / masks
        caps, caps2, 0, 0, 0,
    )

    resource_dim = {
        Dimension.Dim1D: _DIM_1D,
        Dimension.Dim2D: _DIM_2D,
        Dimension.Dim3D: _DIM_3D,
        Dimension.Cube: _DIM_2D,
    }[dim]
    misc_flag = _MISC_CUBEMAP if dim is Dimension.Cube else 0
    array_size = 1 if dim is Dimension.Dim3D else max(texture.depth(), 1)
    if has_alpha(texture.format):
        misc_flags2 = {
            Alpha.Null: 3,  # opaque
            Alpha.Standard: 1,
            Alpha.PreMultiplied: 2,
            Alpha.Encoded: 4,
        }[texture.alpha_type]
    else:
        misc_flags2 = 3
    dxt10 = struct.pack(
        "<5I", dds_format, resource_dim, misc_flag, array_size, misc_flags2
    )

    try:
        stream.write(struct.pack("<I", MAGIC))
        stream.write(header)
        stream.write(dxt10)
        elements = max(texture.depth(), 1) if texture.is_array else 1
        from cuttlefish_tpu_torch.formats import CubeFace

        for element in range(elements):
            for face in range(texture.faces):
                for level in range(mip_count):
                    volumes = texture.depth(level) if dim is Dimension.Dim3D else 1
                    for volume in range(volumes):
                        # depth index is the volume slice for 3D textures and
                        # the array element for arrays (never both; DDS has
                        # no volume arrays, SaveDds.cpp:657-680).
                        index = volume if dim is Dimension.Dim3D else element
                        data = texture.data(CubeFace(face), level, index)
                        if not data:
                            return SaveResult.Invalid
                        stream.write(data)
    except OSError:
        return SaveResult.WriteError
    return SaveResult.Success
