"""Container readers: DDS / KTX / KTX2 / PVR -> Texture.

The inverse of this package's writers, an extension beyond the reference
(Cuttlefish only saves containers; `Texture::save`, Texture.cpp:1638-1683).
Loading enables transcode pipelines (load a DDS, re-encode to ASTC),
inspection, and container round-trip tests.

Format identification inverts the writers' own mapping functions by
enumeration (every (format, type, colorspace) combo is passed through
get_dds_format / get_format_info / get_vk_format / get_pixel_format and
the results reversed), so reader and writer can never disagree on a
mapping.  Data ordering mirrors each writer exactly: DDS element->face->
mip->volume, KTX/PVR mip->depth->face (KTX with 4-byte row padding for
uncompressed), KTX2 by level index.

Copied from ``cuttlefish_tpu/containers/load.py`` with its imports pointed at
the port; its logic is unchanged.
"""

from __future__ import annotations

import functools
import io
import os
import struct

from cuttlefish_tpu_torch.formats import (
    Alpha,
    ColorSpace,
    CubeFace,
    Dimension,
    FileType,
    TextureFormat,
    TextureType,
    block_height,
    block_size,
    block_width,
    is_format_valid,
)

_F = TextureFormat
_T = TextureType

# Type preference when several map to the same container format word.
_TYPE_ORDER = (
    _T.UNorm, _T.SNorm, _T.UInt, _T.Int, _T.Float, _T.UFloat,
)


def _all_combos():
    for fmt in _F:
        if fmt is _F.Unknown:
            continue
        for type_ in _TYPE_ORDER:
            if not is_format_valid(fmt, type_):
                continue
            for cs in (ColorSpace.Linear, ColorSpace.sRGB):
                yield fmt, type_, cs


class LoadError(ValueError):
    """Raised for malformed or unsupported container data."""


def _surface_bytes(fmt: _F, w: int, h: int) -> int:
    bw, bh = block_width(fmt), block_height(fmt)
    if fmt.name.startswith("PVRTC"):
        bpp2 = "2BPP" in fmt.name
        min_w, min_h = (16, 8) if bpp2 else (8, 8)
        w, h = max(w, min_w), max(h, min_h)
    return (-(-w // bw)) * (-(-h // bh)) * block_size(fmt)


def _read(stream, n: int) -> bytes:
    data = stream.read(n)
    if len(data) != n:
        raise LoadError("unexpected end of container data")
    return data


def _make_texture(dimension, width, height, depth, mips, faces, fmt, type_,
                  color_space, alpha, surfaces):
    """Assemble a Texture whose encoded data came from a container.

    `surfaces` maps (mip, depth_or_element, face) -> bytes.
    """
    from cuttlefish_tpu_torch.texture import Texture

    tex = Texture(
        dimension, width, height, depth=depth, mip_levels=mips,
        color_space=color_space,
    )
    if not tex.is_valid or tex.mip_levels != mips or tex.faces != faces:
        raise LoadError("inconsistent container dimensions")
    tex._format = fmt
    tex._type = type_
    tex._alpha_type = alpha
    textures = []
    for mip in range(mips):
        depths = tex.depth(mip) if dimension is Dimension.Dim3D else max(depth, 1)
        textures.append(
            [
                [surfaces[(mip, d, f)] for f in range(faces)]
                for d in range(depths)
            ]
        )
    tex._textures = textures
    return tex


# ---------------------------------------------------------------------------
# DDS
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _dxgi_reverse():
    from cuttlefish_tpu_torch.containers.dds import get_dds_format

    rev = {}
    for fmt, type_, cs in _all_combos():
        dxgi = get_dds_format(fmt, type_, cs)
        if dxgi and dxgi not in rev:
            rev[dxgi] = (fmt, type_, cs)
    return rev


# Legacy (non-DX10) fourCC map for DDS files from other tools.
_LEGACY_FOURCC = {
    b"DXT1": (_F.BC1_RGBA, _T.UNorm, Alpha.Standard),
    b"DXT2": (_F.BC2, _T.UNorm, Alpha.PreMultiplied),
    b"DXT3": (_F.BC2, _T.UNorm, Alpha.Standard),
    b"DXT4": (_F.BC3, _T.UNorm, Alpha.PreMultiplied),
    b"DXT5": (_F.BC3, _T.UNorm, Alpha.Standard),
    b"ATI1": (_F.BC4, _T.UNorm, Alpha.Standard),
    b"BC4U": (_F.BC4, _T.UNorm, Alpha.Standard),
    b"BC4S": (_F.BC4, _T.SNorm, Alpha.Standard),
    b"ATI2": (_F.BC5, _T.UNorm, Alpha.Standard),
    b"BC5U": (_F.BC5, _T.UNorm, Alpha.Standard),
    b"BC5S": (_F.BC5, _T.SNorm, Alpha.Standard),
}


def load_dds(stream):
    """Parse a DDS stream -> Texture (inverse of dds.save_dds)."""
    if _read(stream, 4) != b"DDS ":
        raise LoadError("not a DDS file")
    header = _read(stream, 124)
    (size, _flags, height, width, _pitch, depth3d, mip_count) = struct.unpack(
        "<7I", header[:28]
    )
    if size != 124:
        raise LoadError("bad DDS header size")
    pf = struct.unpack("<8I", header[72:104])
    pf_flags, fourcc = pf[1], header[80:84]
    caps2 = struct.unpack("<I", header[108:112])[0]
    mip_count = max(mip_count, 1)

    alpha = Alpha.Standard
    if pf_flags & 0x4 and fourcc == b"DX10":
        dxgi, resource_dim, misc_flag, array_size, misc2 = struct.unpack(
            "<5I", _read(stream, 20)
        )
        entry = _dxgi_reverse().get(dxgi)
        if entry is None:
            raise LoadError(f"unsupported DXGI format {dxgi}")
        fmt, type_, cs = entry
        cube = bool(misc_flag & 0x4)
        if resource_dim == 4:
            dimension = Dimension.Dim3D
        elif resource_dim == 2:
            dimension = Dimension.Dim1D
        else:
            dimension = Dimension.Cube if cube else Dimension.Dim2D
        alpha = {1: Alpha.Standard, 2: Alpha.PreMultiplied, 4: Alpha.Encoded,
                 3: Alpha.Standard, 0: Alpha.Standard}.get(
            misc2 & 0x7, Alpha.Standard
        )
    elif pf_flags & 0x4 and fourcc in _LEGACY_FOURCC:
        fmt, type_, alpha = _LEGACY_FOURCC[fourcc]
        cs = ColorSpace.Linear
        array_size = 1
        dimension = (
            Dimension.Dim3D if caps2 & 0x200000
            else Dimension.Cube if caps2 & 0x200 else Dimension.Dim2D
        )
    else:
        raise LoadError("unsupported DDS pixel format (no DX10/known fourCC)")

    faces = 6 if dimension is Dimension.Cube else 1
    depth = depth3d if dimension is Dimension.Dim3D else (
        array_size if array_size > 1 else 0
    )
    elements = array_size if dimension is not Dimension.Dim3D else 1

    surfaces = {}
    for element in range(max(elements, 1)):
        for face in range(faces):
            for level in range(mip_count):
                w = max(width >> level, 1)
                h = max(height >> level, 1)
                volumes = (
                    max(depth3d >> level, 1)
                    if dimension is Dimension.Dim3D
                    else 1
                )
                for volume in range(volumes):
                    index = volume if dimension is Dimension.Dim3D else element
                    surfaces[(level, index, face)] = _read(
                        stream, _surface_bytes(fmt, w, h)
                    )
    return _make_texture(
        dimension, width, height, depth, mip_count, faces, fmt, type_, cs,
        alpha, surfaces,
    )


# ---------------------------------------------------------------------------
# KTX
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _ktx_reverse():
    from cuttlefish_tpu_torch.containers.ktx import get_format_info

    rev = {}
    for fmt, type_, cs in _all_combos():
        info = get_format_info(fmt, type_, cs)
        if info is not None and info not in rev:
            rev[info] = (fmt, type_, cs)
    return rev


def load_ktx(stream):
    """Parse a KTX 1 stream -> Texture (inverse of ktx.save_ktx)."""
    from cuttlefish_tpu_torch.containers.ktx import ENDIANNESS, MAGIC

    if _read(stream, 12) != MAGIC:
        raise LoadError("not a KTX file")
    if struct.unpack("<I", _read(stream, 4))[0] != ENDIANNESS:
        raise LoadError("KTX endianness swap not supported")
    info = struct.unpack("<5I", _read(stream, 20))
    (width, height0, depth0, array_elems, faces, mips, kv_len) = struct.unpack(
        "<7I", _read(stream, 28)
    )
    _read(stream, kv_len)
    entry = _ktx_reverse().get(info)
    if entry is None:
        raise LoadError(f"unsupported KTX format info {info}")
    fmt, type_, cs = entry

    height = max(height0, 1)
    if faces == 6:
        dimension = Dimension.Cube
    elif depth0 > 0:
        dimension = Dimension.Dim3D
    elif height0 == 0:
        dimension = Dimension.Dim1D
    else:
        dimension = Dimension.Dim2D
    depth = depth0 if dimension is Dimension.Dim3D else array_elems
    mips = max(mips, 1)

    compressed = block_width(fmt) > 1
    psize = block_size(fmt)
    surfaces = {}
    for level in range(mips):
        w = max(width >> level, 1)
        h = max(height >> level, 1)
        depths = (
            max(depth0 >> level, 1)
            if dimension is Dimension.Dim3D
            else max(array_elems, 1)
        )
        _read(stream, 4)  # imageSize (recomputed from block math)
        for d in range(depths):
            for face in range(faces):
                if compressed:
                    surfaces[(level, d, face)] = _read(
                        stream, _surface_bytes(fmt, w, h)
                    )
                else:
                    row = w * psize
                    padded = (row + 3) // 4 * 4
                    raw = _read(stream, padded * h)
                    surfaces[(level, d, face)] = b"".join(
                        raw[y * padded : y * padded + row] for y in range(h)
                    )
    return _make_texture(
        dimension, width, height, depth, mips, faces, fmt, type_, cs,
        Alpha.Standard, surfaces,
    )


# ---------------------------------------------------------------------------
# KTX2
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _vk_reverse():
    from cuttlefish_tpu_torch.containers.ktx2 import get_vk_format

    rev = {}
    for fmt, type_, cs in _all_combos():
        vk = get_vk_format(fmt, type_, cs)
        if vk is not None and vk[0] not in rev:
            rev[vk[0]] = (fmt, type_, cs)
    return rev


def load_ktx2(stream):
    """Parse a KTX 2.0 stream -> Texture (inverse of ktx2.save_ktx2),
    including Zstd (scheme 2) / ZLIB (scheme 3) supercompression."""
    from cuttlefish_tpu_torch.containers.ktx2 import IDENTIFIER

    blob = stream.read()
    if blob[:12] != IDENTIFIER:
        raise LoadError("not a KTX2 file")
    (vkformat, _tsize, width, height0, depth0, layers, faces, levels,
     scheme) = struct.unpack("<9I", blob[12:48])
    levels = max(levels, 1)
    index = [
        struct.unpack("<3Q", blob[80 + 24 * lv : 104 + 24 * lv])
        for lv in range(levels)
    ]
    entry = _vk_reverse().get(vkformat)
    if entry is None:
        raise LoadError(f"unsupported vkFormat {vkformat}")
    fmt, type_, cs = entry

    if scheme == 0:
        decompress = lambda b, _raw: b  # noqa: E731
    elif scheme == 2:
        try:
            import zstandard
        except ImportError as e:
            raise LoadError("zstandard module required for scheme 2") from e
        dctx = zstandard.ZstdDecompressor()
        decompress = lambda b, raw: dctx.decompress(b, max_output_size=raw)  # noqa: E731
    elif scheme == 3:
        import zlib

        decompress = lambda b, _raw: zlib.decompress(b)  # noqa: E731
    else:
        raise LoadError(f"unsupported supercompression scheme {scheme}")

    height = max(height0, 1)
    if faces == 6:
        dimension = Dimension.Cube
    elif depth0 > 0:
        dimension = Dimension.Dim3D
    elif height0 == 0:
        dimension = Dimension.Dim1D
    else:
        dimension = Dimension.Dim2D
    depth = depth0 if dimension is Dimension.Dim3D else layers

    surfaces = {}
    for level in range(levels):
        off, clen, raw_len = index[level]
        payload = decompress(blob[off : off + clen], raw_len)
        if len(payload) != raw_len:
            raise LoadError("KTX2 level payload length mismatch")
        w = max(width >> level, 1)
        h = max(height >> level, 1)
        ssize = _surface_bytes(fmt, w, h)
        pos = 0
        nlayers = max(layers, 1)
        zs = max(depth0 >> level, 1) if dimension is Dimension.Dim3D else 1
        for layer in range(nlayers):
            for face in range(faces):
                for z in range(zs):
                    d = layer if (layers and dimension is not Dimension.Dim3D) else z
                    surfaces[(level, d, face)] = payload[pos : pos + ssize]
                    pos += ssize
    return _make_texture(
        dimension, width, height, depth, levels, faces, fmt, type_, cs,
        Alpha.Standard, surfaces,
    )


# ---------------------------------------------------------------------------
# PVR
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _pvr_reverse():
    """pixel-format word -> list of candidate TextureFormats (+ alpha)."""
    from cuttlefish_tpu_torch.containers.pvr import get_pixel_format

    rev: dict = {}
    for fmt in _F:
        if fmt is _F.Unknown:
            continue
        for alpha in (Alpha.Standard, Alpha.PreMultiplied):
            word = get_pixel_format(fmt, alpha)
            if word is not None:
                rev.setdefault(word, []).append((fmt, alpha))
    return rev


def load_pvr(stream):
    """Parse a PVR v3 stream -> Texture (inverse of pvr.save_pvr)."""
    from cuttlefish_tpu_torch.containers.pvr import get_channel_type

    if _read(stream, 4) != b"PVR\x03":
        raise LoadError("not a PVR v3 file")
    flags = struct.unpack("<I", _read(stream, 4))[0]
    pixel_format = struct.unpack("<Q", _read(stream, 8))[0]
    (cs_word, channel_type, height, width, depth3d, num_surfaces, faces,
     mips) = struct.unpack("<8I", _read(stream, 32))
    meta_len = struct.unpack("<I", _read(stream, 4))[0]
    meta = _read(stream, meta_len)

    codes = set()
    pos = 0
    while pos + 12 <= len(meta):
        four, key, dlen = meta[pos : pos + 4], meta[pos + 4 : pos + 8], (
            struct.unpack("<I", meta[pos + 8 : pos + 12])[0]
        )
        if four == b"CTFS":
            codes.add(key)
        pos += 12 + dlen

    candidates = _pvr_reverse().get(pixel_format)
    if not candidates:
        raise LoadError(f"unsupported PVR pixel format {pixel_format:#x}")
    premult = bool(flags & 0x2)
    fmt, alpha = candidates[0]
    for cand in candidates:
        if (cand[1] is Alpha.PreMultiplied) == premult:
            fmt, alpha = cand
            break
    # BC1 RGB vs RGBA is disambiguated by the writer's CTFS metadata.
    if fmt in (_F.BC1_RGB, _F.BC1_RGBA):
        fmt = _F.BC1_RGBA if b"BC1A" in codes else _F.BC1_RGB
    if premult:
        alpha = Alpha.PreMultiplied
    # Channel type word -> TextureType (first preference-order match).
    type_ = None
    for t in _TYPE_ORDER:
        if is_format_valid(fmt, t) and get_channel_type(fmt, t) == channel_type:
            type_ = t
            break
    if type_ is None:
        raise LoadError(f"unsupported PVR channel type {channel_type}")
    cs = ColorSpace.sRGB if cs_word == 1 else ColorSpace.Linear

    if b"DIM1" in codes:
        dimension = Dimension.Dim1D
    elif faces == 6:
        dimension = Dimension.Cube
    elif depth3d > 1:
        dimension = Dimension.Dim3D
    else:
        dimension = Dimension.Dim2D
    is_array = b"ARRY" in codes or num_surfaces > 1
    depth = depth3d if dimension is Dimension.Dim3D else (
        num_surfaces if is_array else 0
    )

    surfaces = {}
    for level in range(max(mips, 1)):
        w = max(width >> level, 1)
        h = max(height >> level, 1)
        depths = (
            max(depth3d >> level, 1)
            if dimension is Dimension.Dim3D
            else max(num_surfaces, 1)
        )
        for d in range(depths):
            for face in range(faces):
                surfaces[(level, d, face)] = _read(
                    stream, _surface_bytes(fmt, w, h)
                )
    return _make_texture(
        dimension, width, height, depth, max(mips, 1), faces, fmt, type_, cs,
        alpha, surfaces,
    )


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

_LOADERS = {
    FileType.DDS: load_dds,
    FileType.KTX: load_ktx,
    FileType.KTX2: load_ktx2,
    FileType.PVR: load_pvr,
}

_MAGIC_SNIFF = (
    (b"DDS ", FileType.DDS),
    (b"\xabKTX 20\xbb", FileType.KTX2),
    (b"\xabKTX 11\xbb", FileType.KTX),
    (b"PVR\x03", FileType.PVR),
)


def load_texture(source, file_type: FileType = FileType.Auto):
    """Load a DDS/KTX/KTX2/PVR container from a path, stream, or bytes.

    Returns a converted Texture (encoded surfaces populated; use
    ``Texture.decode_image`` to get texels back, or ``save`` to rewrap).
    """
    if isinstance(source, (bytes, bytearray, memoryview)):
        return load_texture(io.BytesIO(bytes(source)), file_type)
    if isinstance(source, (str, os.PathLike)):
        with open(source, "rb") as f:
            return load_texture(f, file_type)
    if file_type is FileType.Auto:
        head = source.read(8)
        source = _Prefixed(head, source)
        for magic, ft in _MAGIC_SNIFF:
            if head.startswith(magic):
                file_type = ft
                break
        else:
            raise LoadError("unrecognized container magic")
    loader = _LOADERS.get(file_type)
    if loader is None:
        raise LoadError(f"unsupported file type {file_type}")
    return loader(source)


class _Prefixed:
    """Minimal read-only stream that replays sniffed header bytes."""

    def __init__(self, head: bytes, stream):
        self._head = head
        self._stream = stream
        self._pos = 0

    def read(self, n: int = -1) -> bytes:
        out = b""
        if self._pos < len(self._head):
            if n < 0:
                out = self._head[self._pos :]
                self._pos = len(self._head)
            else:
                out = self._head[self._pos : self._pos + n]
                self._pos += len(out)
                n -= len(out)
                if n == 0:
                    return out
        rest = self._stream.read(n) if n != 0 else b""
        return out + rest
