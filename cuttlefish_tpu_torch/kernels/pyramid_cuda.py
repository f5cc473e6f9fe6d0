"""ctypes wrapper of the hand-written mip-pyramid kernel (``csrc/pyramid.cu``).

``build_level`` launches the kernel once: one level of every surface and
its blocks (``convert/device.py:pyramid_blocks_levels`` calls it a level).
``launches`` counts kernel launches; it moves only where the kernel is
launched.  The library is built on first use (``kernels/_build.py``).
"""

from __future__ import annotations

import ctypes

import torch

from cuttlefish_tpu_torch.kernels import _build

launches = 0

_bound = False

# The arguments of csrc/pyramid.cu's entries (``level_args``), before the
# card's stream.
ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int,
]


def reset_launches() -> None:
    global launches
    launches = 0


def _lib() -> ctypes.CDLL:
    global _bound
    lib = _build.load("pyramid")
    if not _bound:
        lib.pyramid_level_launch.argtypes = [*ARGTYPES, ctypes.c_void_p]
        lib.pyramid_level_launch.restype = ctypes.c_int
        _bound = True
    return lib


def _check(t: torch.Tensor, shape: tuple, device: torch.device, what: str) -> None:
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != shape:
        raise ValueError(
            f"pyramid kernel: {what} must be float32 {shape} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"pyramid kernel: {what} must be contiguous and 16-byte aligned")


def level_args(
    src: torch.Tensor,
    lin: torch.Tensor | None,
    blocks: torch.Tensor,
    first: int,
    out_hw: tuple[int, int],
    taps,
    block_w: int,
    block_h: int,
    srgb: bool,
) -> tuple:
    """Check one level's tensors and return the entries' arguments:
    ``src`` [S,h_in,w_in,4] float32, ``lin`` [S,h,w,4] or None, ``blocks``
    [N, block_h*block_w, 4] with room for this level's blocks from
    ``first``; ``taps`` None (level 0: ``out_hw`` is ``src``'s size) or the
    rows' and columns' (index [h|w, K] int32, weight [h|w, K] float32)."""
    device = src.device
    if src.dim() != 4:
        raise ValueError(f"pyramid kernel: src must be [S,H,W,4], got {tuple(src.shape)}")
    s, h_in, w_in, _ = src.shape
    h, w = out_hw
    if not (1 <= block_w <= 12 and 1 <= block_h <= 12):
        raise ValueError(f"pyramid kernel: bad block size {block_w}x{block_h}")
    _check(src, (s, h_in, w_in, 4), device, "src")
    if lin is not None:
        _check(lin, (s, h, w, 4), device, "lin")
    count = s * (-(-h // block_h)) * (-(-w // block_w))
    _check(blocks, (blocks.shape[0], block_h * block_w, 4), device, "blocks")
    if first < 0 or first + count > blocks.shape[0]:
        raise ValueError(f"pyramid kernel: {count} blocks from {first} exceed {blocks.shape[0]}")
    if taps is None:
        if (h, w) != (h_in, w_in):
            raise ValueError("pyramid kernel: level 0 keeps its size")
        th = tw = (0, 0, 0)
    else:
        th, tw = (_taps_args(t, n, device, name)
                  for t, n, name in zip(taps, (h, w), ("rows", "columns")))
    return (
        src.data_ptr(), 0 if lin is None else lin.data_ptr(), blocks.data_ptr(), first,
        s, h_in, w_in, h, w, *th, *tw, block_w, block_h, int(srgb),
    )


def _taps_args(taps, n: int, device: torch.device, name: str) -> tuple[int, int, int]:
    idx, wt = taps
    k = idx.shape[1] if idx.dim() == 2 else 0
    if (idx.dtype != torch.int32 or wt.dtype != torch.float32 or idx.device != device
            or wt.device != device or tuple(idx.shape) != (n, k) or tuple(wt.shape) != (n, k)
            or k == 0 or not (idx.is_contiguous() and wt.is_contiguous())):
        raise ValueError(f"pyramid kernel: bad {name} taps")
    return idx.data_ptr(), wt.data_ptr(), k


def build_level(src, lin, blocks, first, out_hw, taps, block_w, block_h, srgb) -> None:
    """One launch on CUDA tensors (``level_args``); not synchronised."""
    global launches
    if src.device.type != "cuda":
        raise ValueError(f"pyramid kernel: tensors must be on a CUDA device, not {src.device}")
    args = level_args(src, lin, blocks, first, out_hw, taps, block_w, block_h, srgb)
    lib = _lib()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        rc = lib.pyramid_level_launch(*args, stream)
    if rc != 0:
        raise RuntimeError(f"pyramid kernel launch failed: cudaError {rc}")
    launches += 1
