"""Native C++ host runtime of the port: image codecs and block tiling.

Copied from ``cuttlefish_tpu/native/__init__.py`` with the codec sources
only (``src/codec.cpp``, ``src/jpeg.cpp``, ``src/extracodecs.cpp``): PNG,
JPEG, GIF, TIFF and TGA, and the block tiler.  The JAX package's CPU block
encoders (its bench baselines) are left out.  The library is built with
``g++`` at first use into the port's git-ignored build directory
(``kernels/_build.py:build_dir``, under ``native/``) and loaded through
ctypes; when the toolchain is missing, ``available()`` is False and the
image layer takes its other decoders.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCES = ("codec.cpp", "jpeg.cpp", "extracodecs.cpp")

_lib = None
_load_error: str | None = None


def _build_and_load():
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return
    try:
        from cuttlefish_tpu_torch.kernels._build import build_dir

        src_dir = os.path.join(_DIR, "src")
        cpps = [os.path.join(src_dir, name) for name in _SOURCES]
        h = hashlib.sha256()
        for src in cpps:
            with open(src, "rb") as f:
                h.update(f.read())
        out_dir = os.path.join(str(build_dir()), "native")
        os.makedirs(out_dir, exist_ok=True)
        so_path = os.path.join(out_dir, f"libcodecs_{h.hexdigest()[:16]}.so")
        if not os.path.exists(so_path):
            with tempfile.TemporaryDirectory(dir=out_dir) as td:
                tmp = os.path.join(td, "libcodecs.so")
                subprocess.run(
                    [
                        "g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                        *cpps, "-lz", "-pthread", "-o", tmp,
                    ],
                    check=True,
                    capture_output=True,
                )
                os.replace(tmp, so_path)
        lib = ctypes.CDLL(so_path)
        _configure(lib)
        _lib = lib
    except Exception as exc:  # pragma: no cover - toolchain-dependent
        _load_error = str(exc)


def _configure(lib):
    c = ctypes
    u8p = c.POINTER(c.c_uint8)
    lib.ctpu_free.argtypes = [c.c_void_p]
    lib.ctpu_png_decode.argtypes = [
        u8p, c.c_size_t, c.POINTER(u8p),
        c.POINTER(c.c_uint32), c.POINTER(c.c_uint32),
        c.POINTER(c.c_uint32), c.POINTER(c.c_uint32),
    ]
    lib.ctpu_png_encode.argtypes = [
        u8p, c.c_uint32, c.c_uint32, c.c_uint32, c.c_uint32,
        c.POINTER(u8p), c.POINTER(c.c_size_t),
    ]
    lib.ctpu_tga_decode.argtypes = [
        u8p, c.c_size_t, c.POINTER(u8p),
        c.POINTER(c.c_uint32), c.POINTER(c.c_uint32), c.POINTER(c.c_uint32),
    ]
    lib.ctpu_tga_encode.argtypes = [
        u8p, c.c_uint32, c.c_uint32, c.c_uint32,
        c.POINTER(u8p), c.POINTER(c.c_size_t),
    ]
    lib.ctpu_jpeg_decode.argtypes = [
        u8p, c.c_size_t, c.POINTER(u8p),
        c.POINTER(c.c_uint32), c.POINTER(c.c_uint32), c.POINTER(c.c_uint32),
    ]
    lib.ctpu_gif_decode.argtypes = [
        u8p, c.c_size_t, c.POINTER(u8p),
        c.POINTER(c.c_uint32), c.POINTER(c.c_uint32), c.POINTER(c.c_uint32),
    ]
    lib.ctpu_tiff_decode.argtypes = [
        u8p, c.c_size_t, c.POINTER(u8p),
        c.POINTER(c.c_uint32), c.POINTER(c.c_uint32),
        c.POINTER(c.c_uint32), c.POINTER(c.c_uint32),
    ]
    lib.ctpu_extract_blocks.argtypes = [
        c.POINTER(c.c_float), c.c_int, c.c_int, c.c_int, c.c_int, c.c_int,
        c.POINTER(c.c_float),
    ]


def available() -> bool:
    _build_and_load()
    return _lib is not None


def load_error() -> str | None:
    _build_and_load()
    return _load_error


def png_decode(data: bytes):
    """bytes -> (array [h,w,c] or [h,w], bit_depth).  Raises on failure."""
    import numpy as np

    _build_and_load()
    if _lib is None:
        raise RuntimeError(f"native codec unavailable: {_load_error}")
    c = ctypes
    buf = (c.c_uint8 * len(data)).from_buffer_copy(data)
    out = c.POINTER(c.c_uint8)()
    w = c.c_uint32()
    h = c.c_uint32()
    ch = c.c_uint32()
    depth = c.c_uint32()
    rc = _lib.ctpu_png_decode(
        buf, len(data), c.byref(out), c.byref(w), c.byref(h), c.byref(ch),
        c.byref(depth),
    )
    if rc != 0:
        raise ValueError(f"PNG decode failed (code {rc})")
    try:
        nbytes = w.value * h.value * ch.value * (depth.value // 8)
        raw = c.cast(out, c.POINTER(c.c_uint8 * nbytes)).contents
        arr = np.frombuffer(
            bytes(raw), dtype=np.uint16 if depth.value == 16 else np.uint8
        ).reshape(h.value, w.value, ch.value)
    finally:
        _lib.ctpu_free(out)
    if ch.value == 1:
        arr = arr[:, :, 0]
    return arr.copy(), depth.value


def jpeg_decode(data: bytes):
    """Baseline JPEG bytes -> uint8 array [h,w] (gray) or [h,w,3] (RGB).

    Raises ValueError on unsupported streams (progressive, 12-bit, ...);
    callers fall back to PIL (`image/codecs.py:load`).
    """
    import numpy as np

    _build_and_load()
    if _lib is None:
        raise RuntimeError(f"native codec unavailable: {_load_error}")
    c = ctypes
    buf = (c.c_uint8 * len(data)).from_buffer_copy(data)
    out = c.POINTER(c.c_uint8)()
    w = c.c_uint32()
    h = c.c_uint32()
    ch = c.c_uint32()
    rc = _lib.ctpu_jpeg_decode(
        buf, len(data), c.byref(out), c.byref(w), c.byref(h), c.byref(ch)
    )
    if rc != 1:
        raise ValueError("JPEG decode failed (unsupported or corrupt)")
    try:
        nbytes = w.value * h.value * ch.value
        raw = c.cast(out, c.POINTER(c.c_uint8 * nbytes)).contents
        arr = np.frombuffer(bytes(raw), dtype=np.uint8).reshape(
            h.value, w.value, ch.value
        )
    finally:
        _lib.ctpu_free(out)
    if ch.value == 1:
        arr = arr[:, :, 0]
    return arr.copy()


def gif_decode(data: bytes):
    """GIF bytes -> uint8 array [h,w,3] (opaque) or [h,w,4] (transparent).

    First frame composed onto the logical screen; see
    native/src/extracodecs.cpp.  Raises ValueError on failure (callers
    fall back to PIL).
    """
    import numpy as np

    _build_and_load()
    if _lib is None:
        raise RuntimeError(f"native codec unavailable: {_load_error}")
    c = ctypes
    buf = (c.c_uint8 * len(data)).from_buffer_copy(data)
    out = c.POINTER(c.c_uint8)()
    w = c.c_uint32()
    h = c.c_uint32()
    ch = c.c_uint32()
    rc = _lib.ctpu_gif_decode(
        buf, len(data), c.byref(out), c.byref(w), c.byref(h), c.byref(ch)
    )
    if rc != 0:
        raise ValueError(f"GIF decode failed (code {rc})")
    try:
        nbytes = w.value * h.value * ch.value
        raw = c.cast(out, c.POINTER(c.c_uint8 * nbytes)).contents
        arr = np.frombuffer(bytes(raw), np.uint8).reshape(
            h.value, w.value, ch.value
        )
    finally:
        _lib.ctpu_free(out)
    return arr.copy()


def tiff_decode(data: bytes):
    """Baseline TIFF bytes -> (array, depth).  Array is [h,w] (gray) or
    [h,w,c] uint8/uint16; depth 8 or 16.

    Strip-organized, compression none/PackBits/LZW (+ horizontal
    predictor), gray/palette/RGB/RGBA; see native/src/extracodecs.cpp.
    Raises ValueError on unsupported streams (tiles, JPEG-in-TIFF,
    planar) — callers fall back to PIL.
    """
    import numpy as np

    _build_and_load()
    if _lib is None:
        raise RuntimeError(f"native codec unavailable: {_load_error}")
    c = ctypes
    buf = (c.c_uint8 * len(data)).from_buffer_copy(data)
    out = c.POINTER(c.c_uint8)()
    w = c.c_uint32()
    h = c.c_uint32()
    ch = c.c_uint32()
    depth = c.c_uint32()
    rc = _lib.ctpu_tiff_decode(
        buf, len(data), c.byref(out), c.byref(w), c.byref(h), c.byref(ch),
        c.byref(depth),
    )
    if rc != 0:
        raise ValueError(f"TIFF decode failed (code {rc})")
    try:
        nbytes = w.value * h.value * ch.value * (depth.value // 8)
        raw = c.cast(out, c.POINTER(c.c_uint8 * nbytes)).contents
        arr = np.frombuffer(
            bytes(raw), np.uint16 if depth.value == 16 else np.uint8
        ).reshape(h.value, w.value, ch.value)
    finally:
        _lib.ctpu_free(out)
    if ch.value == 1:
        arr = arr[:, :, 0]
    return arr.copy(), depth.value


def png_encode(arr) -> bytes:
    import numpy as np

    _build_and_load()
    if _lib is None:
        raise RuntimeError(f"native codec unavailable: {_load_error}")
    arr = np.asarray(arr)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, ch = arr.shape
    depth = 16 if arr.dtype == np.uint16 else 8
    data = np.ascontiguousarray(arr).tobytes()
    c = ctypes
    buf = (c.c_uint8 * len(data)).from_buffer_copy(data)
    out = c.POINTER(c.c_uint8)()
    size = c.c_size_t()
    rc = _lib.ctpu_png_encode(
        buf, w, h, ch, depth, c.byref(out), c.byref(size)
    )
    if rc != 0:
        raise ValueError(f"PNG encode failed (code {rc})")
    try:
        raw = c.cast(out, c.POINTER(c.c_uint8 * size.value)).contents
        return bytes(raw)
    finally:
        _lib.ctpu_free(out)


def tga_decode(data: bytes):
    import numpy as np

    _build_and_load()
    if _lib is None:
        raise RuntimeError(f"native codec unavailable: {_load_error}")
    c = ctypes
    buf = (c.c_uint8 * len(data)).from_buffer_copy(data)
    out = c.POINTER(c.c_uint8)()
    w = c.c_uint32()
    h = c.c_uint32()
    ch = c.c_uint32()
    rc = _lib.ctpu_tga_decode(
        buf, len(data), c.byref(out), c.byref(w), c.byref(h), c.byref(ch)
    )
    if rc != 0:
        raise ValueError(f"TGA decode failed (code {rc})")
    try:
        nbytes = w.value * h.value * ch.value
        raw = c.cast(out, c.POINTER(c.c_uint8 * nbytes)).contents
        arr = np.frombuffer(bytes(raw), np.uint8).reshape(
            h.value, w.value, ch.value
        )
    finally:
        _lib.ctpu_free(out)
    if ch.value == 1:
        arr = arr[:, :, 0]
    return arr.copy()


def tga_encode(arr) -> bytes:
    import numpy as np

    _build_and_load()
    if _lib is None:
        raise RuntimeError(f"native codec unavailable: {_load_error}")
    arr = np.asarray(arr, np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, ch = arr.shape
    data = np.ascontiguousarray(arr).tobytes()
    c = ctypes
    buf = (c.c_uint8 * len(data)).from_buffer_copy(data)
    out = c.POINTER(c.c_uint8)()
    size = c.c_size_t()
    rc = _lib.ctpu_tga_encode(buf, w, h, ch, c.byref(out), c.byref(size))
    if rc != 0:
        raise ValueError(f"TGA encode failed (code {rc})")
    try:
        raw = c.cast(out, c.POINTER(c.c_uint8 * size.value)).contents
        return bytes(raw)
    finally:
        _lib.ctpu_free(out)


def extract_blocks(surface, block_w: int, block_h: int):
    """C++ block tiler; same contract as convert.blocks.extract_blocks."""
    import numpy as np

    _build_and_load()
    if _lib is None:
        raise RuntimeError(f"native codec unavailable: {_load_error}")
    surface = np.ascontiguousarray(surface, np.float32)
    h, w, ch = surface.shape
    nbx = -(-w // block_w)
    nby = -(-h // block_h)
    out = np.empty((nby * nbx, block_h * block_w, ch), np.float32)
    c = ctypes
    _lib.ctpu_extract_blocks(
        surface.ctypes.data_as(c.POINTER(c.c_float)), h, w, ch,
        block_w, block_h, out.ctypes.data_as(c.POINTER(c.c_float)),
    )
    return out, nbx, nby
