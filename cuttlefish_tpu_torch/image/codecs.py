"""Host-side image file codecs (the FreeImage role).

Decode/encode for the file formats the pipeline ingests.  PIL covers the
LDR formats (PNG/JPEG/BMP/TGA/TIFF/WebP/...); a built-in codec handles
Radiance HDR (.hdr) for HDR input, and PFM for float images.  Mirrors the
reference's FreeImage usage (`lib/src/Image.cpp:870-972`):
type sniffing from content, palette images promoted to RGB(A), scanlines
normalized to top-down.

Copied from ``cuttlefish_tpu/image/codecs.py`` with its imports pointed at
the port; its logic is unchanged.
"""

from __future__ import annotations

import io
import os
import struct

import numpy as np

from cuttlefish_tpu_torch.image.format import ImageFormat

try:
    import PIL.Image as _pil

    _HAVE_PIL = True
except ImportError:  # pragma: no cover - PIL is expected in this image
    _HAVE_PIL = False


class DecodeError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Radiance HDR (.hdr / .pic) — RGBE shared-exponent format.
# ---------------------------------------------------------------------------


def _rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    rgbe = rgbe.astype(np.float64)
    exp = rgbe[..., 3]
    scale = np.where(exp == 0, 0.0, np.ldexp(1.0, (exp - 136).astype(np.int64)))
    return (rgbe[..., :3] + 0.5) * scale[..., None] * np.where(exp == 0, 0, 1)[..., None]


def _float_to_rgbe(rgb: np.ndarray) -> np.ndarray:
    maxc = np.max(rgb, axis=-1)
    out = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    nz = maxc >= 1e-32
    mant, exp = np.frexp(np.where(nz, maxc, 1.0))
    scale = np.where(nz, mant * 256.0 / np.where(nz, maxc, 1.0), 0.0)
    quant = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    out[..., :3] = np.where(nz[..., None], quant, 0)
    out[..., 3] = np.where(nz, exp + 128, 0).astype(np.uint8)
    return out


def decode_hdr(data: bytes) -> np.ndarray:
    """Radiance RGBE -> (H, W, 3) float32 (new-style RLE supported)."""
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise DecodeError("not a Radiance HDR file")
    pos = data.index(b"\n\n") if b"\n\n" in data else -1
    if pos < 0:
        raise DecodeError("malformed HDR header")
    header_end = pos + 2
    dims_end = data.index(b"\n", header_end)
    dims = data[header_end:dims_end].split()
    if len(dims) != 4 or dims[0] != b"-Y" or dims[2] != b"+X":
        raise DecodeError("unsupported HDR scanline orientation")
    height, width = int(dims[1]), int(dims[3])
    buf = memoryview(data)[dims_end + 1 :]
    rgbe = np.zeros((height, width, 4), np.uint8)
    off = 0
    for y in range(height):
        if (
            width >= 8
            and width < 32768
            and off + 4 <= len(buf)
            and buf[off] == 2
            and buf[off + 1] == 2
        ):
            # New-style RLE: per-channel runs.
            off += 4
            for c in range(4):
                x = 0
                while x < width:
                    count = buf[off]
                    off += 1
                    if count > 128:  # run
                        rgbe[y, x : x + count - 128, c] = buf[off]
                        off += 1
                        x += count - 128
                    else:  # literal
                        rgbe[y, x : x + count, c] = np.frombuffer(
                            buf[off : off + count], np.uint8
                        )
                        off += count
                        x += count
        else:
            row = np.frombuffer(buf[off : off + width * 4], np.uint8)
            rgbe[y] = row.reshape(width, 4)
            off += width * 4
    return _rgbe_to_float(rgbe).astype(np.float32)


def encode_hdr(rgb: np.ndarray) -> bytes:
    """(H, W, 3) float -> Radiance RGBE bytes (uncompressed scanlines)."""
    h, w = rgb.shape[:2]
    rgbe = _float_to_rgbe(np.asarray(rgb, np.float64))
    header = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode()
    return header + rgbe.tobytes()


# ---------------------------------------------------------------------------
# PFM (portable float map) — simple float32 interchange.
# ---------------------------------------------------------------------------


def decode_pfm(data: bytes) -> tuple[np.ndarray, ImageFormat]:
    parts = data.split(maxsplit=4)
    kind = parts[0]
    if kind not in (b"PF", b"Pf"):
        raise DecodeError("not a PFM file")
    width, height = int(parts[1]), int(parts[2])
    scale = float(parts[3])
    # Pixel data starts right after the scale token's single whitespace.
    header_len = len(data) - len(parts[4]) if len(parts) > 4 else len(data)
    channels = 3 if kind == b"PF" else 1
    count = width * height * channels
    dt = np.dtype(np.float32).newbyteorder("<" if scale < 0 else ">")
    pixels = np.frombuffer(data, dt, count, offset=header_len).astype(np.float32)
    shape = (height, width, 3) if channels == 3 else (height, width)
    arr = pixels.reshape(shape)[::-1]  # PFM is bottom-up
    return np.ascontiguousarray(arr), (
        ImageFormat.RGBF if channels == 3 else ImageFormat.Float
    )


def encode_pfm(data: np.ndarray) -> bytes:
    if data.ndim == 3:
        header = f"PF\n{data.shape[1]} {data.shape[0]}\n-1.0\n"
    else:
        header = f"Pf\n{data.shape[1]} {data.shape[0]}\n-1.0\n"
    return header.encode() + np.ascontiguousarray(
        data[::-1].astype("<f4")
    ).tobytes()


def _native_to_format(arr: np.ndarray, depth: int) -> tuple[np.ndarray, ImageFormat]:
    """Map the native codec's (array, bit depth) to our storage formats."""
    channels = 1 if arr.ndim == 2 else arr.shape[2]
    if depth == 16:
        if channels == 1:
            return arr, ImageFormat.UInt16
        # Multi-channel 16-bit: promote to float RGBA-ish storage.
        return (arr.astype(np.float32) / 65535.0), (
            ImageFormat.RGBF if channels == 3 else ImageFormat.RGBAF
        )
    fmt = {
        1: ImageFormat.Gray8,
        2: ImageFormat.RGBA8,  # gray+alpha promoted below
        3: ImageFormat.RGB8,
        4: ImageFormat.RGBA8,
    }[channels]
    if channels == 2:  # gray+alpha -> RGBA like FreeImage's promotion
        g = arr[..., 0]
        arr = np.stack([g, g, g, arr[..., 1]], axis=-1)
    return arr, fmt


# ---------------------------------------------------------------------------
# PIL bridge.
# ---------------------------------------------------------------------------

_PIL_MODE_TO_FORMAT = {
    "L": ImageFormat.Gray8,
    "RGB": ImageFormat.RGB8,
    "RGBA": ImageFormat.RGBA8,
    "I;16": ImageFormat.UInt16,
    "I;16B": ImageFormat.UInt16,
    "I;16L": ImageFormat.UInt16,
    "I": ImageFormat.Int32,
    "F": ImageFormat.Float,
}


def _from_pil(img) -> tuple[np.ndarray, ImageFormat]:
    # Palette/exotic modes are promoted like FreeImage's palette->24/32-bit
    # conversion (Image.cpp:710-740).
    if img.mode == "P":
        has_alpha = "transparency" in img.info
        img = img.convert("RGBA" if has_alpha else "RGB")
    elif img.mode == "LA":
        img = img.convert("RGBA")
    elif img.mode == "1":
        img = img.convert("L")
    elif img.mode in ("CMYK", "YCbCr", "HSV"):
        img = img.convert("RGB")
    fmt = _PIL_MODE_TO_FORMAT.get(img.mode)
    if fmt is None:
        img = img.convert("RGBA")
        fmt = ImageFormat.RGBA8
    arr = np.asarray(img)
    if fmt is ImageFormat.UInt16:
        arr = arr.astype(np.uint16)
    return arr, fmt



# ---------------------------------------------------------------------------
# ICO / PSD (the remaining common FreeImage formats; WEBP stays PIL-only).
# ---------------------------------------------------------------------------


def decode_ico(data: bytes) -> tuple[np.ndarray, ImageFormat]:
    """ICO container -> the largest icon entry as RGBA8.

    Entries are PNG (delegated to the PNG path) or BMP DIBs
    (BITMAPINFOHEADER with doubled height and a 1-bit AND mask);
    1/4/8-bit palette, 24-bit, and 32-bit DIBs are supported.
    """
    if len(data) < 6 or data[:4] != b"\x00\x00\x01\x00":
        raise DecodeError("not an ICO file")
    count = struct.unpack_from("<H", data, 4)[0]
    if count == 0:
        raise DecodeError("empty ICO")
    best = None
    for i in range(count):
        off = 6 + 16 * i
        if off + 16 > len(data):
            raise DecodeError("truncated ICO directory")
        w, h, _colors, _r, _planes, bpp, size, doff = struct.unpack_from(
            "<BBBBHHII", data, off
        )
        w = w or 256
        h = h or 256
        key = (w * h, bpp)
        if best is None or key > best[0]:
            best = (key, size, doff)
    _, size, doff = best
    if doff + size > len(data):
        raise DecodeError("truncated ICO entry")
    entry = data[doff : doff + size]
    if entry.startswith(b"\x89PNG\r\n\x1a\n"):
        arr, fmt = load(entry)
        return arr, fmt
    # BMP DIB
    if len(entry) < 40:
        raise DecodeError("truncated ICO DIB")
    (hsz, bw, bh2, _planes, bpp, comp) = struct.unpack_from(
        "<IiihHI", entry, 0
    )
    if hsz != 40 or comp != 0:
        raise DecodeError("unsupported ICO DIB")
    bh = bh2 // 2  # height counts the XOR + AND masks
    if bw <= 0 or bh <= 0:
        raise DecodeError("bad ICO DIB dims")

    def row_stride(bits):
        return ((bw * bits + 31) // 32) * 4

    pos = hsz
    palette = None
    if bpp <= 8:
        ncolors = 1 << bpp
        palette = np.frombuffer(
            entry, np.uint8, ncolors * 4, pos
        ).reshape(ncolors, 4)[:, [2, 1, 0]]
        pos += ncolors * 4
    xor_stride = row_stride(bpp)
    xor = entry[pos : pos + xor_stride * bh]
    pos += xor_stride * bh
    and_stride = row_stride(1)
    andm = entry[pos : pos + and_stride * bh]

    out = np.zeros((bh, bw, 4), np.uint8)
    for y in range(bh):
        dy = bh - 1 - y  # bottom-up
        row = xor[y * xor_stride : (y + 1) * xor_stride]
        if bpp == 32:
            px = np.frombuffer(row, np.uint8, bw * 4).reshape(bw, 4)
            out[dy, :, 0] = px[:, 2]
            out[dy, :, 1] = px[:, 1]
            out[dy, :, 2] = px[:, 0]
            out[dy, :, 3] = px[:, 3]
        elif bpp == 24:
            px = np.frombuffer(row, np.uint8, bw * 3).reshape(bw, 3)
            out[dy, :, :3] = px[:, [2, 1, 0]]
            out[dy, :, 3] = 255
        elif bpp == 8:
            idx = np.frombuffer(row, np.uint8, bw)
            out[dy, :, :3] = palette[idx]
            out[dy, :, 3] = 255
        elif bpp == 4:
            b = np.frombuffer(row, np.uint8, (bw + 1) // 2)
            idx = np.empty(bw, np.uint8)
            idx[0::2] = b[: (bw + 1) // 2] >> 4
            idx[1::2] = b[: bw // 2] & 0xF
            out[dy, :, :3] = palette[idx]
            out[dy, :, 3] = 255
        elif bpp == 1:
            bits = np.unpackbits(
                np.frombuffer(row, np.uint8, (bw + 7) // 8)
            )[:bw]
            out[dy, :, :3] = palette[bits]
            out[dy, :, 3] = 255
        else:
            raise DecodeError(f"unsupported ICO bpp {bpp}")
        if bpp != 32 and andm:
            arow = andm[y * and_stride : (y + 1) * and_stride]
            mask = np.unpackbits(
                np.frombuffer(arow, np.uint8, (bw + 7) // 8)
            )[:bw]
            out[dy, :, 3] = np.where(mask == 1, 0, out[dy, :, 3])
    return out, ImageFormat.RGBA8


def decode_psd(data: bytes) -> tuple[np.ndarray, ImageFormat]:
    """PSD flattened composite -> array (8/16-bit gray/RGB/RGBA).

    Parses the '8BPS' v1 header, skips the color-mode/resources/layers
    sections, and reads the merged image data (compression 0 = raw or
    1 = PackBits-per-scanline with a row-length table); channels beyond
    the mode's are alpha.
    """
    if len(data) < 26 or data[:4] != b"8BPS":
        raise DecodeError("not a PSD file")
    version, = struct.unpack_from(">H", data, 4)
    if version != 1:
        raise DecodeError("unsupported PSD version")
    channels, height, width, depth, mode = struct.unpack_from(
        ">HIIHH", data, 12
    )
    if depth not in (8, 16) or mode not in (1, 3):
        raise DecodeError("unsupported PSD depth/mode")
    if channels < 1 or channels > 8:
        raise DecodeError("bad PSD channel count")
    pos = 26
    for _ in range(3):  # color mode data, resources, layers
        if pos + 4 > len(data):
            raise DecodeError("truncated PSD")
        ln, = struct.unpack_from(">I", data, pos)
        pos += 4 + ln
    if pos + 2 > len(data):
        raise DecodeError("truncated PSD")
    comp, = struct.unpack_from(">H", data, pos)
    pos += 2
    bpp = depth // 8
    planes = []
    if comp == 0:
        need = channels * height * width * bpp
        if pos + need > len(data):
            raise DecodeError("truncated PSD raw data")
        dt = np.dtype(">u2") if depth == 16 else np.uint8
        for ch in range(channels):
            plane = np.frombuffer(
                data, dt, height * width, pos + ch * height * width * bpp
            ).reshape(height, width)
            planes.append(plane.astype(plane.dtype.newbyteorder("=")))
    elif comp == 1:
        nrows = channels * height
        lens = np.frombuffer(data, ">u2", nrows, pos).astype(np.int64)
        pos += nrows * 2
        raw = bytearray()
        want_row = width * bpp
        for ri in range(nrows):
            end = pos + int(lens[ri])
            row = bytearray()
            i = pos
            while i < end and len(row) < want_row:
                c = data[i]
                i += 1
                if c < 128:
                    row += data[i : i + c + 1]
                    i += c + 1
                elif c > 128:
                    row += data[i : i + 1] * (257 - c)
                    i += 1
            if len(row) < want_row:
                row += b"\x00" * (want_row - len(row))
            raw += row[:want_row]
            pos = end
        dt = np.dtype(">u2") if depth == 16 else np.uint8
        arr = np.frombuffer(bytes(raw), dt).reshape(channels, height, width)
        planes = [
            arr[ch].astype(arr.dtype.newbyteorder("=")) for ch in range(channels)
        ]
    else:
        raise DecodeError("unsupported PSD compression")

    base = 1 if mode == 1 else 3
    nch = base + (1 if channels > base else 0)
    stacked = np.stack(planes[:nch], axis=-1)
    if nch == 1:
        stacked = stacked[..., 0]
    if depth == 16:
        if stacked.ndim == 2:
            return stacked.astype(np.uint16), ImageFormat.UInt16
        return (
            stacked.astype(np.float32) / 65535.0,
            ImageFormat.RGBF if nch == 3 else ImageFormat.RGBAF,
        )
    fmt = {
        1: ImageFormat.Gray8,
        3: ImageFormat.RGB8,
        4: ImageFormat.RGBA8,
    }[nch if stacked.ndim == 3 else 1]
    return stacked.astype(np.uint8), fmt


def load(source) -> tuple[np.ndarray, ImageFormat]:
    """Load from path / bytes / file-like; sniffs type from content.

    Returns (top-down storage array, format).
    """
    if isinstance(source, (str, os.PathLike)):
        with open(source, "rb") as f:
            data = f.read()
    elif isinstance(source, (bytes, bytearray, memoryview)):
        data = bytes(source)
    else:
        data = source.read()

    if data[:4] in (b"DDS ", b"PVR\x03") or data.startswith(b"\xabKTX"):
        # Texture containers as image inputs (FreeImage reads DDS/KTX too,
        # Image.cpp:870-880): load + spec-decode the level-0 surface.
        # Foreign files may exercise features outside the decode scope
        # (HDR CEM submodes, exotic formats) — those must surface as a
        # DecodeError (-> invalid image / CLI exit 2), never a traceback.
        from cuttlefish_tpu_torch.containers.load import load_texture

        try:
            tex = load_texture(data)
            img = tex.decode_image()
        except (ValueError, NotImplementedError) as e:
            raise DecodeError(str(e)) from e
        if img is None:
            raise DecodeError("container has no decodable level-0 surface")
        return img.array, ImageFormat.RGBAF
    if data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE"):
        return decode_hdr(data), ImageFormat.RGBF
    if data[:2] in (b"PF", b"Pf") and data[2:3] in (b"\n", b" ", b"\r"):
        return decode_pfm(data)
    if data.startswith(b"\x76\x2f\x31\x01"):
        from cuttlefish_tpu_torch.image import exr

        try:
            arr, kind = exr.decode_exr(data)
        except exr.ExrError as e:
            raise DecodeError(str(e)) from e
        fmt = {
            "gray": ImageFormat.Float,
            "rgb": ImageFormat.RGBF,
            "rgba": ImageFormat.RGBAF,
        }[kind]
        return arr.astype(np.float32), fmt
    # Native C++ codec first (the FreeImage-analog layer); PIL covers the
    # long tail (JPEG, TIFF, ...) and any native-path failure.
    if data.startswith(b"\x89PNG\r\n\x1a\n"):
        try:
            from cuttlefish_tpu_torch import native

            if native.available():
                arr, depth = native.png_decode(data)
                return _native_to_format(arr, depth)
        except Exception:
            pass
    if data.startswith(b"\xff\xd8\xff"):
        # Baseline JPEG via the native decoder; progressive/12-bit streams
        # raise and fall through to PIL.
        try:
            from cuttlefish_tpu_torch import native

            if native.available():
                arr = native.jpeg_decode(data)
                return _native_to_format(arr, 8)
        except Exception:
            pass
    if data.startswith(b"GIF87a") or data.startswith(b"GIF89a"):
        try:
            from cuttlefish_tpu_torch import native

            if native.available():
                arr = native.gif_decode(data)
                return _native_to_format(arr, 8)
        except Exception:
            pass
    if data.startswith(b"\x00\x00\x01\x00") and len(data) >= 6:
        try:
            return decode_ico(data)
        except DecodeError:
            pass  # fall through to PIL
    if data.startswith(b"8BPS"):
        try:
            return decode_psd(data)
        except DecodeError:
            pass  # fall through to PIL
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        # Lossless (VP8L) WebP decodes built-in; lossy VP8 raises and
        # falls through to PIL.
        from cuttlefish_tpu_torch.image import webp as _webp

        try:
            arr = _webp.decode_webp_lossless(data)
            return arr, ImageFormat.RGBA8
        except _webp.WebpError:
            pass
    if data.startswith(b"II*\x00") or data.startswith(b"MM\x00*"):
        # Baseline strip TIFF natively; tiles/planar/JPEG-in-TIFF raise
        # and fall through to PIL.
        try:
            from cuttlefish_tpu_torch import native

            if native.available():
                arr, depth = native.tiff_decode(data)
                return _native_to_format(arr, depth)
        except Exception:
            pass
    if not _HAVE_PIL:
        # Dependency boundary (mirrors the reference's FreeImage ~30-format
        # surface, README.md:21-36): PNG/JPEG/GIF/TIFF/TGA/BMP/HDR/PFM/EXR
        # and the DDS/KTX/KTX2/PVR containers decode natively; everything
        # else (WEBP/PSD/ICO/...) requires the optional Pillow dependency
        # (`pip install cuttlefish-tpu[codecs]`).
        raise DecodeError(
            "unrecognized or non-built-in image format; built-in codecs "
            "cover PNG/JPEG/GIF/TIFF/TGA/BMP/ICO/PSD/WebP-lossless/HDR/"
            "PFM/EXR + DDS/KTX/KTX2/PVR — install the optional Pillow "
            "dependency (cuttlefish-tpu[codecs]) for lossy WebP and "
            "exotica"
        )
    try:
        img = _pil.open(io.BytesIO(data))
        img.load()
    except Exception as exc:
        raise DecodeError(str(exc)) from exc
    return _from_pil(img)


_FORMAT_TO_PIL_MODE = {
    ImageFormat.Gray8: "L",
    ImageFormat.RGB8: "RGB",
    ImageFormat.RGBA8: "RGBA",
    ImageFormat.UInt16: "I;16",
    ImageFormat.Int32: "I",
    ImageFormat.Float: "F",
}


def save(data: np.ndarray, fmt: ImageFormat, file_name: str) -> bool:
    """Save storage array to a file; format chosen by extension."""
    ext = os.path.splitext(file_name)[1].lower()
    try:
        if ext in (".hdr", ".pic"):
            if data.ndim != 3 or data.shape[2] != 3:
                return False
            with open(file_name, "wb") as f:
                f.write(encode_hdr(np.asarray(data, np.float64)))
            return True
        if ext == ".pfm":
            with open(file_name, "wb") as f:
                f.write(encode_pfm(np.asarray(data, np.float32)))
            return True
        if ext == ".exr":
            from cuttlefish_tpu_torch.image import exr

            if data.ndim == 3 and data.shape[2] not in (3, 4):
                return False
            with open(file_name, "wb") as f:
                f.write(exr.encode_exr(np.asarray(data, np.float32)))
            return True
        if not _HAVE_PIL:
            return False
        mode = _FORMAT_TO_PIL_MODE.get(fmt)
        if mode is None:
            return False
        _pil.fromarray(np.asarray(data), mode=mode).save(file_name)
        return True
    except Exception:
        return False
