"""Decode one encoded surface back to RGBA float32 texels.

The inverse of the converter layer for every texture format the framework
emits: block-compressed families dispatch to the spec decoders in this
package; uncompressed formats invert convert/standard.py's bit packing.
Used by the container loaders (containers/load.py) for transcode
pipelines and by round-trip tests.  The reference has no decode path at
all (it only writes containers), so this is an extension.

Copied from ``cuttlefish_tpu/decode/surface.py`` with its imports pointed at
the port.
"""

from __future__ import annotations

import numpy as np

from cuttlefish_tpu_torch.formats import (
    TextureFormat,
    TextureType,
    block_height,
    block_size,
    block_width,
)
from cuttlefish_tpu_torch.packfloat import (
    half_bits_to_f32,
    unpack_b10g11r11,
    unpack_rgb9e5,
)

_F = TextureFormat
_T = TextureType


def _blocks_to_surface(texels: np.ndarray, width, height, bw, bh, pw, ph):
    """[Nblocks, bh*bw, C] block texels -> [height, width, C] (crops the
    block padding; pw/ph are the padded dims the blocks tile)."""
    nby, nbx = ph // bh, pw // bw
    c = texels.shape[-1]
    surf = (
        texels.reshape(nby, nbx, bh, bw, c)
        .transpose(0, 2, 1, 3, 4)
        .reshape(ph, pw, c)
    )
    return surf[:height, :width]


def _rgba(*chans):
    """Stack channel arrays (broadcast scalars) into [...,4] float32."""
    shape = None
    for ch in chans:
        if isinstance(ch, np.ndarray):
            shape = ch.shape
            break
    out = [
        np.broadcast_to(np.float32(ch), shape)
        if not isinstance(ch, np.ndarray)
        else ch.astype(np.float32)
        for ch in chans
    ]
    return np.stack(out, axis=-1)


def _decode_blocks(data: np.ndarray, fmt: _F, type_: _T) -> np.ndarray:
    """Encoded block bytes -> [N, bh*bw, 4] float32 texels."""
    from cuttlefish_tpu_torch import decode as D

    signed = type_ in (_T.SNorm, _T.Float, _T.Int)
    if fmt is _F.BC1_RGB:
        return D.decode_bc1(data, opaque=True).astype(np.float32) / 255.0
    if fmt is _F.BC1_RGBA:
        return D.decode_bc1(data).astype(np.float32) / 255.0
    if fmt is _F.BC2:
        return D.decode_bc2(data).astype(np.float32) / 255.0
    if fmt is _F.BC3:
        return D.decode_bc3(data).astype(np.float32) / 255.0
    if fmt is _F.BC4:
        r = D.decode_bc4(data, signed=signed).astype(np.float32)
        return _rgba(r, 0.0, 0.0, 1.0)
    if fmt is _F.BC5:
        rg = D.decode_bc5(data, signed=signed).astype(np.float32)
        return _rgba(rg[..., 0], rg[..., 1], 0.0, 1.0)
    if fmt is _F.BC6H:
        rgb = D.decode_bc6h_f32(data, signed=type_ is _T.Float)
        return _rgba(rgb[..., 0], rgb[..., 1], rgb[..., 2], 1.0)
    if fmt is _F.BC7:
        return D.decode_bc7(data).astype(np.float32) / 255.0
    if fmt in (_F.ETC1, _F.ETC2_R8G8B8):
        rgb = D.decode_etc_rgb(data, etc2=fmt is _F.ETC2_R8G8B8).astype(
            np.float32
        ) / 255.0
        return _rgba(rgb[..., 0], rgb[..., 1], rgb[..., 2], 1.0)
    if fmt is _F.ETC2_R8G8B8A1:
        return D.decode_etc2_a1(data).astype(np.float32) / 255.0
    if fmt is _F.ETC2_R8G8B8A8:
        return D.decode_etc2_rgba(data).astype(np.float32) / 255.0
    if fmt is _F.EAC_R11:
        r = D.decode_eac_r11(data, signed=signed).astype(np.float32)
        return _rgba(r, 0.0, 0.0, 1.0)
    if fmt is _F.EAC_R11G11:
        rg = D.decode_eac_rg11(data, signed=signed).astype(np.float32)
        return _rgba(rg[..., 0], rg[..., 1], 0.0, 1.0)
    if fmt.name.startswith("ASTC_"):
        bw, bh = (int(x) for x in fmt.name[5:].split("x"))
        if type_ is _T.UFloat:
            from cuttlefish_tpu_torch.decode.astc import decode_astc_hdr

            half = decode_astc_hdr(data, bw, bh)
            return half_bits_to_f32(half).astype(np.float32)
        return D.decode_astc(data, bw, bh).astype(np.float32) / 255.0
    raise NotImplementedError(f"no block decoder for {fmt!r}")


def _unpack_bits16(words, layout):
    """Inverse of convert/standard.py:_packed16/_packed32 layouts."""
    out = np.ones(words.shape + (4,), np.float32)
    for ch, bits, shift in layout:
        maxval = (1 << bits) - 1
        out[..., ch] = ((words >> shift) & maxval).astype(np.float32) / maxval
    return out


# (channel, bits, shift) layouts — transcribed from convert/standard.py.
_PACKED16 = {
    _F.R4G4B4A4: [(3, 4, 0), (2, 4, 4), (1, 4, 8), (0, 4, 12)],
    _F.B4G4R4A4: [(3, 4, 0), (0, 4, 4), (1, 4, 8), (2, 4, 12)],
    _F.A4R4G4B4: [(2, 4, 0), (1, 4, 4), (0, 4, 8), (3, 4, 12)],
    _F.R5G6B5: [(2, 5, 0), (1, 6, 5), (0, 5, 11)],
    _F.B5G6R5: [(0, 5, 0), (1, 6, 5), (2, 5, 11)],
    _F.R5G5B5A1: [(3, 1, 0), (2, 5, 1), (1, 5, 6), (0, 5, 11)],
    _F.B5G5R5A1: [(3, 1, 0), (0, 5, 1), (1, 5, 6), (2, 5, 11)],
    _F.A1R5G5B5: [(2, 5, 0), (1, 5, 5), (0, 5, 10), (3, 1, 15)],
}

_BYTE_ORDERS = {
    _F.B8G8R8: (2, 1, 0),
    _F.B8G8R8A8: (2, 1, 0, 3),
    _F.A8B8G8R8: (3, 2, 1, 0),
}

_PLAIN = {
    _F.R8: (1, np.uint8, np.int8),
    _F.R8G8: (2, np.uint8, np.int8),
    _F.R8G8B8: (3, np.uint8, np.int8),
    _F.R8G8B8A8: (4, np.uint8, np.int8),
    _F.R16: (1, np.uint16, np.int16),
    _F.R16G16: (2, np.uint16, np.int16),
    _F.R16G16B16: (3, np.uint16, np.int16),
    _F.R16G16B16A16: (4, np.uint16, np.int16),
    _F.R32: (1, np.uint32, np.int32),
    _F.R32G32: (2, np.uint32, np.int32),
    _F.R32G32B32: (3, np.uint32, np.int32),
    _F.R32G32B32A32: (4, np.uint32, np.int32),
}


def _fill_rgba(vals: np.ndarray) -> np.ndarray:
    """[N,C] channel values -> [N,4] (missing G/B = 0, A = 1)."""
    n, c = vals.shape
    out = np.zeros((n, 4), np.float32)
    out[:, :c] = vals
    if c < 4:
        out[:, 3] = 1.0
    return out


def _decode_standard(
    data: np.ndarray, fmt: _F, type_: _T, npixels: int
) -> np.ndarray:
    """Encoded uncompressed pixels -> [N,4] float32 (inverse of
    create_standard_converter's packing; UInt/Int return raw integer
    values as floats, matching the converters' input domain)."""

    def words(dtype):
        return np.frombuffer(
            data.tobytes(), np.dtype(dtype).newbyteorder("<"), count=npixels
        )

    if fmt is _F.R4G4:
        b = words(np.uint8)
        return _fill_rgba(
            np.stack([(b >> 4) & 15, b & 15], -1).astype(np.float32) / 15.0
        )
    if fmt in _PACKED16:
        return _unpack_bits16(words(np.uint16), _PACKED16[fmt]).reshape(-1, 4)
    if fmt in (_F.A2R10G10B10, _F.A2B10G10R10):
        first = 2 if fmt is _F.A2R10G10B10 else 0
        last = 0 if fmt is _F.A2R10G10B10 else 2
        w = words(np.uint32)
        chans = np.zeros((npixels, 4), np.float32)
        chans[:, first] = (w & 1023).astype(np.float32)
        chans[:, 1] = ((w >> 10) & 1023).astype(np.float32)
        chans[:, last] = ((w >> 20) & 1023).astype(np.float32)
        chans[:, 3] = ((w >> 30) & 3).astype(np.float32)
        if type_ is _T.UNorm:
            chans[:, :3] /= 1023.0
            chans[:, 3] /= 3.0
        return chans
    if fmt is _F.B10G11R11_UFloat:
        return _fill_rgba(unpack_b10g11r11(words(np.uint32)))
    if fmt is _F.E5B9G9R9_UFloat:
        return _fill_rgba(unpack_rgb9e5(words(np.uint32)))
    if fmt in _BYTE_ORDERS:
        order = _BYTE_ORDERS[fmt]
        raw = np.frombuffer(
            data.tobytes(), np.uint8, count=npixels * len(order)
        ).reshape(npixels, len(order)).astype(np.float32) / 255.0
        out = np.zeros((npixels, 4), np.float32)
        out[:, 3] = 1.0
        for pos, ch in enumerate(order):
            out[:, ch] = raw[:, pos]
        return out
    if fmt in _PLAIN:
        channels, udtype, sdtype = _PLAIN[fmt]

        def vals(dtype):
            return np.frombuffer(
                data.tobytes(),
                np.dtype(dtype).newbyteorder("<"),
                count=npixels * channels,
            ).reshape(npixels, channels)

        if type_ is _T.UNorm:
            v = vals(udtype).astype(np.float32) / np.iinfo(udtype).max
        elif type_ is _T.SNorm:
            v = np.maximum(
                vals(sdtype).astype(np.float32) / np.iinfo(sdtype).max, -1.0
            )
        elif type_ is _T.UInt:
            v = vals(udtype).astype(np.float32)
        elif type_ is _T.Int:
            v = vals(sdtype).astype(np.float32)
        elif type_ is _T.Float and udtype is np.uint16:
            v = half_bits_to_f32(vals(np.uint16)).astype(np.float32)
        else:
            v = vals(np.float32)
        return _fill_rgba(v)
    raise NotImplementedError(f"no standard decoder for {fmt!r}")


def decode_surface(
    data,
    fmt: TextureFormat,
    type_: TextureType,
    width: int,
    height: int,
) -> np.ndarray:
    """Encoded surface bytes -> [height, width, 4] float32 RGBA texels.

    Values are in the format's natural decode domain: UNorm/UFloat/Float
    in [0,1]/HDR floats, SNorm in [-1,1], UInt/Int raw integer values.
    sRGB storage is NOT linearized (the caller owns colorspace).
    """
    data = np.frombuffer(bytes(data), np.uint8)
    bw, bh = block_width(fmt), block_height(fmt)
    if fmt.name.startswith("PVRTC"):
        from cuttlefish_tpu_torch.decode.pvrtc import decode_pvrtc1, decode_pvrtc2
        from cuttlefish_tpu_torch.kernels.pvrtc_tables import morton_order

        bpp2 = "2BPP" in fmt.name
        min_w, min_h = (16, 8) if bpp2 else (8, 8)
        pw, ph = max(width, min_w), max(height, min_h)
        perm = morton_order(pw // bw, ph // bh)
        stored = data.reshape(-1, 8)
        raster = np.empty_like(stored)
        raster[perm] = stored  # inverse of convert/pvrtc.py's words[perm]
        dec = (decode_pvrtc2 if fmt.name.startswith("PVRTC2") else decode_pvrtc1)(
            raster.reshape(-1), pw, ph, bpp2=bpp2
        )
        return dec[:height, :width]
    if bw > 1:
        pw = -(-width // bw) * bw
        ph = -(-height // bh) * bh
        texels = _decode_blocks(data.reshape(-1, block_size(fmt)), fmt, type_)
        return _blocks_to_surface(texels, width, height, bw, bh, pw, ph)
    return _decode_standard(data, fmt, type_, width * height).reshape(
        height, width, 4
    )
