"""Native C++ host runtime of the port: image codecs, block tiling and the
CPU block encoders.

Copied from ``cuttlefish_tpu/native/__init__.py``.  Two libraries, each
built with ``g++`` (the JAX package's flags) into the port's git-ignored
build directory (``kernels/_build.py:build_dir``, under ``native/``),
named by a digest of the sources it compiles, and loaded through ctypes:

- the codecs (``src/codec.cpp``, ``src/jpeg.cpp``, ``src/extracodecs.cpp``):
  PNG, JPEG, GIF, TIFF and TGA, and the block tiler.  Built at the first
  codec call; when the toolchain is missing, ``available()`` is False and
  the image layer takes its other decoders.
- the CPU block encoders, the north star the port's encoders are held to
  (``src/{bc1,bc6h,bc7,etc2,astc}_cpu.cpp`` with ``bc6h_tables.inc`` and
  ``astc_color_tables.inc``): the ten ``*_encode_cpu`` functions, numpy in
  and numpy out, ``threads=0`` meaning every core.  Built at the first
  encoder call, so loading an image does not wait for them; a failed build
  raises ``RuntimeError`` at that call, carrying the compiler's error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCES = ("codec.cpp", "jpeg.cpp", "extracodecs.cpp")
_ENCODER_SOURCES = ("bc1_cpu.cpp", "bc6h_cpu.cpp", "bc7_cpu.cpp", "etc2_cpu.cpp", "astc_cpu.cpp")
_ENCODER_TABLES = ("bc6h_tables.inc", "astc_color_tables.inc")
# The JAX package's flags: no -O3, -march or -ffast-math, which could
# contract or reorder float operations and change the words.
_GXX = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17"]
_GXX_LIBS = ["-lz", "-pthread"]

_lib = None
_load_error: str | None = None
_enc_lib = None
_enc_error: str | None = None


def _build(stem: str, names, hashed_only=()) -> str:
    """Compile ``names`` (sources under ``src/``) into ``<stem>_<digest>.so``
    in the build directory, unless it is there: one ``g++ -c`` a source,
    all started together, then one link, each with the same flags.  The
    digest covers every file of ``names`` and ``hashed_only`` (the headers
    they include).  A file lock keeps processes that start together from
    building twice.  -> the library's path."""
    import fcntl

    from cuttlefish_tpu_torch.kernels._build import build_dir

    src_dir = os.path.join(_DIR, "src")
    cpps = [os.path.join(src_dir, name) for name in names]
    h = hashlib.sha256()
    for src in cpps + [os.path.join(src_dir, name) for name in hashed_only]:
        with open(src, "rb") as f:
            h.update(f.read())
    out_dir = os.path.join(str(build_dir()), "native")
    os.makedirs(out_dir, exist_ok=True)
    so_path = os.path.join(out_dir, f"{stem}_{h.hexdigest()[:16]}.so")
    with open(os.path.join(out_dir, f"{stem}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(so_path):
            with tempfile.TemporaryDirectory(dir=out_dir) as td:
                objs = [os.path.join(td, f"{i}.o") for i in range(len(cpps))]
                procs = [subprocess.Popen([*_GXX, "-c", cpp, "-o", obj], stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE)
                         for cpp, obj in zip(cpps, objs)]
                # Every compile ends before the first failure raises, so none
                # writes into the directory while it is removed.
                results = [(proc, *proc.communicate()) for proc in procs]
                for proc, out, err in results:
                    if proc.returncode:
                        raise subprocess.CalledProcessError(proc.returncode, proc.args, out, err)
                tmp = os.path.join(td, f"{stem}.so")
                subprocess.run([*_GXX, *objs, *_GXX_LIBS, "-o", tmp],
                               check=True, capture_output=True)
                os.replace(tmp, so_path)
    return so_path


def _build_and_load():
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return
    try:
        lib = ctypes.CDLL(_build("libcodecs", _SOURCES))
        _configure(lib)
        _lib = lib
    except Exception as exc:  # pragma: no cover - toolchain-dependent
        _load_error = str(exc)


def _build_and_load_encoders():
    """Build (at the first encoder call) and load the CPU encoders; on
    failure keep the compiler's error for the wrappers to raise."""
    global _enc_lib, _enc_error
    if _enc_lib is not None or _enc_error is not None:
        return
    try:
        lib = ctypes.CDLL(_build("libcpuenc", _ENCODER_SOURCES, _ENCODER_TABLES))
        _configure_encoders(lib)
        _enc_lib = lib
    except subprocess.CalledProcessError as exc:
        _enc_error = f"{exc}: {exc.stderr.decode(errors='replace')}"
    except Exception as exc:  # pragma: no cover - toolchain-dependent
        _enc_error = str(exc)


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


def _configure_encoders(lib):
    c = ctypes
    u8p = c.POINTER(c.c_uint8)
    lib.ctpu_bc7_encode.argtypes = [
        c.POINTER(c.c_float), c.c_int, c.c_int, c.c_int, c.POINTER(c.c_uint32),
    ]
    lib.ctpu_astc4x4_encode.argtypes = [
        c.POINTER(c.c_float), c.c_int, c.c_int, c.c_int, u8p,
    ]
    lib.ctpu_astc_sized_encode.argtypes = [
        c.POINTER(c.c_float), c.c_int, c.c_int, c.c_int, c.c_int, c.c_int,
        u8p,
    ]
    lib.ctpu_astc_hdr_encode.argtypes = [
        c.POINTER(c.c_float), c.c_int, c.c_int, c.c_int, c.c_int, u8p,
    ]
    lib.ctpu_etc2_rgb_encode.argtypes = [
        c.POINTER(c.c_float), c.c_int, c.c_int, c.c_int, c.c_int, u8p,
    ]
    lib.ctpu_eac_a8_encode.argtypes = [
        c.POINTER(c.c_float), c.c_int, c.c_int, c.c_int, u8p,
    ]
    lib.ctpu_eac_r11_encode.argtypes = [
        c.POINTER(c.c_float), c.c_int, c.c_int, c.c_int, u8p,
    ]
    lib.ctpu_bc1_encode.argtypes = [
        c.POINTER(c.c_float), c.c_int, c.c_int, c.c_int, u8p,
    ]
    lib.ctpu_bc4_encode.argtypes = [
        c.POINTER(c.c_float), c.c_int, c.c_int, c.c_int, c.c_int, u8p,
    ]
    lib.ctpu_bc6h_encode.argtypes = [
        c.POINTER(c.c_float), c.c_int, c.c_int, c.c_int, u8p,
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


def bc7_encode_cpu(blocks, quality: int = 2, threads: int = 0):
    """CPU BC7 encode (the bench's baseline, the north star of BC7).

    blocks: [N,16,4] float32 in [0,1] -> [N,4] uint32 words.  Runs a
    std::thread pool over chunks of blocks (src/bc7_cpu.cpp).
    """
    import ctypes as c

    import numpy as np

    _build_and_load_encoders()
    if _enc_lib is None:
        raise RuntimeError(f"native CPU encoders unavailable: {_enc_error}")
    blocks = np.ascontiguousarray(blocks, np.float32)
    n = blocks.shape[0]
    out = np.zeros((n, 4), np.uint32)
    _enc_lib.ctpu_bc7_encode(
        blocks.ctypes.data_as(c.POINTER(c.c_float)), n, int(quality),
        int(threads), out.ctypes.data_as(c.POINTER(c.c_uint32)),
    )
    return out


def astc4x4_encode_cpu(blocks, quality: int = 2, threads: int = 0):
    """CPU ASTC 4x4 encode (astcenc-"fast"-class quality baseline).

    blocks: [N,16,4] float32 in [0,1] -> [N,16] uint8 ASTC blocks.  See
    src/astc_cpu.cpp; the north-star PSNR bar of ASTC.
    """
    import ctypes as c

    import numpy as np

    _build_and_load_encoders()
    if _enc_lib is None:
        raise RuntimeError(f"native CPU encoders unavailable: {_enc_error}")
    blocks = np.ascontiguousarray(blocks, np.float32)
    n = blocks.shape[0]
    out = np.zeros((n, 16), np.uint8)
    _enc_lib.ctpu_astc4x4_encode(
        blocks.ctypes.data_as(c.POINTER(c.c_float)), n, int(quality),
        int(threads), out.ctypes.data_as(c.POINTER(c.c_uint8)),
    )
    return out


def etc2_rgb_encode_cpu(blocks, quality: int = 2, etc2: bool = True,
                        threads: int = 0):
    """CPU ETC1/ETC2 RGB encode (etc2comp-"basic"-class quality baseline).

    blocks: [N,16,4] float32 in [0,1] -> [N,8] uint8 big-endian blocks.
    """
    import ctypes as c

    import numpy as np

    _build_and_load_encoders()
    if _enc_lib is None:
        raise RuntimeError(f"native CPU encoders unavailable: {_enc_error}")
    blocks = np.ascontiguousarray(blocks, np.float32)
    n = blocks.shape[0]
    out = np.zeros((n, 8), np.uint8)
    _enc_lib.ctpu_etc2_rgb_encode(
        blocks.ctypes.data_as(c.POINTER(c.c_float)), n, int(quality),
        1 if etc2 else 0, int(threads),
        out.ctypes.data_as(c.POINTER(c.c_uint8)),
    )
    return out


def eac_a8_encode_cpu(blocks, quality: int = 2, threads: int = 0):
    """CPU EAC A8 encode over the alpha channel of [N,16,4] blocks."""
    import ctypes as c

    import numpy as np

    _build_and_load_encoders()
    if _enc_lib is None:
        raise RuntimeError(f"native CPU encoders unavailable: {_enc_error}")
    blocks = np.ascontiguousarray(blocks, np.float32)
    n = blocks.shape[0]
    out = np.zeros((n, 8), np.uint8)
    _enc_lib.ctpu_eac_a8_encode(
        blocks.ctypes.data_as(c.POINTER(c.c_float)), n, int(quality),
        int(threads), out.ctypes.data_as(c.POINTER(c.c_uint8)),
    )
    return out


def bc1_encode_cpu(blocks, quality: int = 2, threads: int = 0):
    """CPU BC1 encode (rgbcx-class quality baseline).

    blocks: [N,16,4] float32 in [0,1] -> [N,8] uint8 BC1 blocks.  See
    src/bc1_cpu.cpp; the north-star PSNR bar of the S3TC colour family.
    """
    import ctypes as c

    import numpy as np

    _build_and_load_encoders()
    if _enc_lib is None:
        raise RuntimeError(f"native CPU encoders unavailable: {_enc_error}")
    blocks = np.ascontiguousarray(blocks, np.float32)
    n = blocks.shape[0]
    out = np.zeros((n, 8), np.uint8)
    _enc_lib.ctpu_bc1_encode(
        blocks.ctypes.data_as(c.POINTER(c.c_float)), n, int(quality),
        int(threads), out.ctypes.data_as(c.POINTER(c.c_uint8)),
    )
    return out


def bc4_encode_cpu(blocks, quality: int = 2, channel: int = 0,
                   threads: int = 0):
    """CPU BC4 encode over one channel of [N,16,4] blocks -> [N,8]."""
    import ctypes as c

    import numpy as np

    _build_and_load_encoders()
    if _enc_lib is None:
        raise RuntimeError(f"native CPU encoders unavailable: {_enc_error}")
    blocks = np.ascontiguousarray(blocks, np.float32)
    n = blocks.shape[0]
    out = np.zeros((n, 8), np.uint8)
    _enc_lib.ctpu_bc4_encode(
        blocks.ctypes.data_as(c.POINTER(c.c_float)), n, int(quality),
        int(channel), int(threads),
        out.ctypes.data_as(c.POINTER(c.c_uint8)),
    )
    return out


def bc6h_encode_cpu(blocks, quality: int = 2, threads: int = 0):
    """CPU BC6H (unsigned) encode: ispc-veryfast-class mode-11 baseline.

    blocks: [N,16,3] float32 HDR RGB (non-negative) -> [N,16] uint8
    BC6H blocks.  See src/bc6h_cpu.cpp; the north-star bar of BC6H.
    """
    import ctypes as c

    import numpy as np

    _build_and_load_encoders()
    if _enc_lib is None:
        raise RuntimeError(f"native CPU encoders unavailable: {_enc_error}")
    blocks = np.ascontiguousarray(blocks[..., :3], np.float32)
    n = blocks.shape[0]
    out = np.zeros((n, 16), np.uint8)
    _enc_lib.ctpu_bc6h_encode(
        blocks.ctypes.data_as(c.POINTER(c.c_float)), n, int(quality),
        int(threads), out.ctypes.data_as(c.POINTER(c.c_uint8)),
    )
    return out


def eac_r11_encode_cpu(vals, quality: int = 2, threads: int = 0):
    """CPU EAC R11 (unsigned) encode: [N,16] float 0..1 -> [N,8] blocks."""
    import ctypes as c

    import numpy as np

    _build_and_load_encoders()
    if _enc_lib is None:
        raise RuntimeError(f"native CPU encoders unavailable: {_enc_error}")
    vals = np.ascontiguousarray(vals, np.float32)
    n = vals.shape[0]
    out = np.zeros((n, 8), np.uint8)
    _enc_lib.ctpu_eac_r11_encode(
        vals.ctypes.data_as(c.POINTER(c.c_float)), n, int(quality),
        int(threads), out.ctypes.data_as(c.POINTER(c.c_uint8)),
    )
    return out


def astc_hdr_encode_cpu(blocks, quality: int = 2, alpha_ldr: bool = True,
                        threads: int = 0):
    """CPU ASTC 4x4 HDR encode (CEM 11 direct / CEM 14) — the
    astcenc-fast-class bar for the HDR profiles.

    blocks: [N,16,4] float32, RGB HDR (>= 0), A in [0,1] -> [N,16]
    uint8 ASTC blocks.  See src/astc_cpu.cpp encode_block_hdr.
    """
    import ctypes as c

    import numpy as np

    _build_and_load_encoders()
    if _enc_lib is None:
        raise RuntimeError(f"native CPU encoders unavailable: {_enc_error}")
    blocks = np.ascontiguousarray(blocks, np.float32)
    n = blocks.shape[0]
    out = np.zeros((n, 16), np.uint8)
    _enc_lib.ctpu_astc_hdr_encode(
        blocks.ctypes.data_as(c.POINTER(c.c_float)), n, int(quality),
        int(bool(alpha_ldr)), int(threads),
        out.ctypes.data_as(c.POINTER(c.c_uint8)),
    )
    return out


def astc_sized_encode_cpu(blocks, block_w: int, block_h: int,
                          quality: int = 2, threads: int = 0):
    """CPU ASTC NxM encode (6x6/8x8 quality baselines; decimated weight
    grids via the spec bilinear infill — see astc_cpu.cpp's generalized
    section).  blocks: [N, bw*bh, 4] float32 0..1 -> [N,16] uint8."""
    import ctypes as c

    import numpy as np

    _build_and_load_encoders()
    if _enc_lib is None:
        raise RuntimeError(f"native CPU encoders unavailable: {_enc_error}")
    blocks = np.ascontiguousarray(blocks, np.float32)
    n = blocks.shape[0]
    out = np.zeros((n, 16), np.uint8)
    _enc_lib.ctpu_astc_sized_encode(
        blocks.ctypes.data_as(c.POINTER(c.c_float)), n, int(block_w),
        int(block_h), int(quality), int(threads),
        out.ctypes.data_as(c.POINTER(c.c_uint8)),
    )
    return out
