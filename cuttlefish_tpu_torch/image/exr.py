"""Minimal OpenEXR scanline codec (pure Python + numpy + zlib).

The reference reads/writes EXR through FreeImage (`Image.cpp:870-958`);
this covers the interchange subset HDR pipelines actually produce:

- decode: single-part scanline images, compression NONE / ZIPS / ZIP,
  channel types HALF and FLOAT, channel sets {R,G,B[,A]} or a single
  luminance channel, increasing line order, xSampling == ySampling == 1.
- encode: NONE-compressed scanline RGB(A) FLOAT or HALF.

ZIP/ZIPS post-processing (delta predictor + two-way byte interleave)
follows the OpenEXR file-format description ("Technical Introduction to
OpenEXR", zip reconstruction); tiled, deep, multi-part, PIZ/PXR24/B44/DWA
files raise DecodeError.

Copied from ``cuttlefish_tpu/image/exr.py`` with its imports pointed at
the port; its logic is unchanged.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

MAGIC = b"\x76\x2f\x31\x01"

_PT_UINT, _PT_HALF, _PT_FLOAT = 0, 1, 2
_SCANLINES_PER_BLOCK = {0: 1, 1: 1, 2: 1, 3: 16}


class ExrError(ValueError):
    pass


def _read_cstr(data: bytes, pos: int) -> tuple[bytes, int]:
    end = data.index(b"\x00", pos)
    return data[pos:end], end + 1


def _parse_channels(value: bytes):
    """chlist -> list of (name, pixel_type) in file (alphabetical) order."""
    chans = []
    pos = 0
    while value[pos] != 0:
        name, pos = _read_cstr(value, pos)
        ptype, _plin = struct.unpack_from("<iB", value, pos)
        xs, ys = struct.unpack_from("<ii", value, pos + 8)
        pos += 16
        if xs != 1 or ys != 1:
            raise ExrError("subsampled channels not supported")
        chans.append((name.decode("latin-1"), ptype))
    return chans


def _unzip_block(data: bytes, raw_size: int) -> bytes:
    """Inverse of EXR's zip preprocessing: inflate, undo the delta
    predictor, then interleave the two halves back together."""
    if len(data) >= raw_size:
        return data[:raw_size]
    buf = zlib.decompress(data)
    # Predictor: d[i] = d[i-1] + d[i] - 128 (sequential; vectorize as a
    # cumulative sum of (d[i] - 128) offsets on top of d[0], mod 256).
    deltas = np.frombuffer(buf, np.uint8).astype(np.int64)
    deltas[1:] -= 128
    decoded = np.cumsum(deltas).astype(np.uint8)
    n = raw_size
    out = np.empty(n, np.uint8)
    half = (n + 1) // 2
    out[0::2] = decoded[:half]
    out[1::2] = decoded[half:n]
    return out.tobytes()


def _zip_block(raw: bytes) -> bytes:
    """EXR zip preprocessing + deflate (used by the ZIPS writer path and
    round-trip tests): de-interleave into halves, delta-encode, compress."""
    arr = np.frombuffer(raw, np.uint8)
    n = arr.size
    half = (n + 1) // 2
    split = np.empty(n, np.uint8)
    split[:half] = arr[0::2]
    split[half:] = arr[1::2]
    enc = split.astype(np.int64)
    enc[1:] = np.diff(split.astype(np.int64)) + 128
    comp = zlib.compress(enc.astype(np.uint8).tobytes(), 6)
    return comp if len(comp) < n else raw


def decode_exr(data: bytes) -> tuple[np.ndarray, str]:
    """EXR bytes -> (float32 array [H,W] or [H,W,3|4], kind) where kind is
    "gray", "rgb" or "rgba"."""
    if not data.startswith(MAGIC):
        raise ExrError("not an EXR file")
    (version,) = struct.unpack_from("<i", data, 4)
    if version & 0x200:
        raise ExrError("tiled EXR not supported")
    if version & 0x800 or version & 0x1000:
        raise ExrError("deep/multi-part EXR not supported")

    pos = 8
    channels = None
    compression = None
    dw = None
    line_order = 0
    while data[pos] != 0:
        name, pos = _read_cstr(data, pos)
        _atype, pos = _read_cstr(data, pos)
        (size,) = struct.unpack_from("<i", data, pos)
        pos += 4
        value = data[pos : pos + size]
        pos += size
        if name == b"channels":
            channels = _parse_channels(value)
        elif name == b"compression":
            compression = value[0]
        elif name == b"dataWindow":
            dw = struct.unpack("<4i", value)
        elif name == b"lineOrder":
            line_order = value[0]
    pos += 1  # header terminator

    if channels is None or compression is None or dw is None:
        raise ExrError("missing required EXR attributes")
    if compression not in _SCANLINES_PER_BLOCK:
        raise ExrError(f"unsupported EXR compression {compression}")
    for _name, ptype in channels:
        if ptype == _PT_UINT:
            raise ExrError("UINT channels not supported")

    xmin, ymin, xmax, ymax = dw
    width, height = xmax - xmin + 1, ymax - ymin + 1
    spb = _SCANLINES_PER_BLOCK[compression]
    nblocks = (height + spb - 1) // spb
    offsets = struct.unpack_from(f"<{nblocks}Q", data, pos)

    dtypes = {ch: (np.float16 if pt == _PT_HALF else np.float32) for ch, pt in channels}
    planes = {ch: np.zeros((height, width), np.float32) for ch, _ in channels}
    row_bytes = sum(width * np.dtype(dtypes[ch]).itemsize for ch, _ in channels)

    for off in offsets:
        y, dsize = struct.unpack_from("<ii", data, off)
        block = data[off + 8 : off + 8 + dsize]
        y0 = y - ymin
        nrows = min(spb, height - y0)
        raw_size = row_bytes * nrows
        if compression in (2, 3):
            raw = _unzip_block(block, raw_size)
        else:
            raw = block[:raw_size]
        bp = 0
        for r in range(nrows):
            yy = y0 + r if line_order == 0 else height - 1 - (y0 + r)
            for ch, _pt in channels:
                dt = np.dtype(dtypes[ch])
                count = width * dt.itemsize
                planes[ch][yy] = np.frombuffer(
                    raw[bp : bp + count], dt
                ).astype(np.float32)
                bp += count

    names = [c for c, _ in channels]
    if set(names) >= {"R", "G", "B"}:
        chans = [planes["R"], planes["G"], planes["B"]]
        if "A" in names:
            chans.append(planes["A"])
            return np.stack(chans, axis=-1), "rgba"
        return np.stack(chans, axis=-1), "rgb"
    if len(names) == 1:
        return planes[names[0]], "gray"
    raise ExrError(f"unsupported channel set {names}")


def encode_exr(arr: np.ndarray, half: bool = True) -> bytes:
    """float array [H,W], [H,W,3] or [H,W,4] -> NONE-compressed scanline
    EXR bytes (HALF by default, FLOAT with half=False)."""
    arr = np.asarray(arr, np.float32)
    if arr.ndim == 2:
        names = ["Y"]
        planes = [arr]
    elif arr.ndim == 3 and arr.shape[2] in (3, 4):
        names = ["R", "G", "B"] + (["A"] if arr.shape[2] == 4 else [])
        planes = [arr[..., i] for i in range(arr.shape[2])]
    else:
        raise ExrError(f"bad EXR array shape {arr.shape}")
    height, width = planes[0].shape
    order = sorted(range(len(names)), key=lambda i: names[i])
    dt = np.float16 if half else np.float32
    ptype = _PT_HALF if half else _PT_FLOAT

    def attr(name: bytes, atype: bytes, value: bytes) -> bytes:
        return name + b"\x00" + atype + b"\x00" + struct.pack("<i", len(value)) + value

    chlist = b""
    for i in order:
        chlist += names[i].encode() + b"\x00"
        chlist += struct.pack("<iB3xii", ptype, 0, 1, 1)
    chlist += b"\x00"
    box = struct.pack("<4i", 0, 0, width - 1, height - 1)
    header = (
        attr(b"channels", b"chlist", chlist)
        + attr(b"compression", b"compression", b"\x00")
        + attr(b"dataWindow", b"box2i", box)
        + attr(b"displayWindow", b"box2i", box)
        + attr(b"lineOrder", b"lineOrder", b"\x00")
        + attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
        + attr(b"screenWindowCenter", b"v2f", struct.pack("<2f", 0.0, 0.0))
        + attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
        + b"\x00"
    )
    head = MAGIC + struct.pack("<i", 2) + header
    table_pos = len(head)
    data_start = table_pos + 8 * height
    row_bytes = width * np.dtype(dt).itemsize * len(names)
    offsets = [data_start + y * (8 + row_bytes) for y in range(height)]
    chunks = [head, struct.pack(f"<{height}Q", *offsets)]
    for y in range(height):
        row = b"".join(planes[i][y].astype(dt).tobytes() for i in order)
        chunks.append(struct.pack("<ii", y, len(row)) + row)
    return b"".join(chunks)
