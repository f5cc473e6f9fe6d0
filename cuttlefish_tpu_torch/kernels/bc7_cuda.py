"""ctypes wrapper of the hand-written BC7 kernel (``csrc/bc7_encode.cu``).

``launches`` counts kernel launches; it moves only where the kernel is
launched.  The library is built on first use (``kernels/_build.py``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from cuttlefish_tpu_torch.kernels import _build

launches = 0

_tables_set: set = set()
_bound = False


def reset_launches() -> None:
    global launches
    launches = 0


def _lib() -> ctypes.CDLL:
    global _bound
    lib = _build.load("bc7_encode")
    if not _bound:
        lib.bc7_set_tables.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.bc7_set_tables.restype = ctypes.c_int
        lib.bc7_encode_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_void_p,
        ]
        lib.bc7_encode_launch.restype = ctypes.c_int
        _bound = True
    return lib


def _set_tables(lib, consts, device: torch.device) -> None:
    """Copy the partition masks and anchors into the device's constant
    memory, once per device."""
    if device.index in _tables_set:
        return
    masks = np.ascontiguousarray(consts.masks, np.uint16)
    anchors = np.ascontiguousarray(consts.anchors, np.int32)
    with torch.cuda.device(device):
        rc = lib.bc7_set_tables(masks.ctypes.data, anchors.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"bc7_set_tables failed: cudaError {rc}")
    _tables_set.add(device.index)


def check_blocks(blocks: torch.Tensor, channels: int, what: str) -> None:
    """Raise unless blocks is a contiguous float32 [N,16,channels] CUDA
    tensor with fewer than 2**31 blocks."""
    if blocks.device.type != "cuda":
        raise ValueError(f"{what} kernel needs a CUDA tensor, got {blocks.device}")
    if blocks.dtype != torch.float32:
        raise TypeError(f"{what} kernel needs float32 blocks, got {blocks.dtype}")
    if blocks.dim() != 3 or tuple(blocks.shape[1:]) != (16, channels):
        raise ValueError(
            f"{what} kernel needs [N,16,{channels}] blocks, got {tuple(blocks.shape)}"
        )
    if not blocks.is_contiguous():
        raise ValueError(f"{what} kernel needs contiguous blocks")
    if blocks.shape[0] >= 2**31:
        raise ValueError(f"{what} kernel takes fewer than 2**31 blocks")


def encode_bc7_cuda(blocks: torch.Tensor, quality: int, consts) -> torch.Tensor:
    """[N,16,4] float32 CUDA blocks (0..1) -> [N,4] uint32 BC7 words."""
    global launches
    check_blocks(blocks, 4, "BC7")
    if quality not in (0, 1, 2):
        raise ValueError(f"BC7 kernel covers quality 0-2, got {quality}")
    n = blocks.shape[0]
    device = blocks.device
    out = torch.empty((n, 4), dtype=torch.uint32, device=device)
    if n == 0:
        return out
    lib = _lib()
    _set_tables(lib, consts, device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.bc7_encode_launch(
            blocks.data_ptr(), out.data_ptr(), n, quality, *consts.chw, stream
        )
    if rc != 0:
        raise RuntimeError(f"BC7 kernel launch failed: cudaError {rc}")
    launches += 1
    return out
