"""ctypes wrapper of the hand-written BC7 quality 3-4 kernel
(``csrc/bc7_hq_encode.cu``).

``launches`` counts kernel launches; it moves only where the kernel is
launched.  The library is built on first use (``kernels/_build.py``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from cuttlefish_tpu_torch.kernels import _build
from cuttlefish_tpu_torch.kernels.bc7_cuda import check_blocks

launches = 0

_tables_set: set = set()
_bound = False


def reset_launches() -> None:
    global launches
    launches = 0


def _lib() -> ctypes.CDLL:
    global _bound
    lib = _build.load("bc7_hq_encode")
    if not _bound:
        lib.bc7_hq_set_tables.argtypes = [ctypes.c_void_p] * 4
        lib.bc7_hq_set_tables.restype = ctypes.c_int
        lib.bc7_hq_encode_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_void_p,
        ]
        lib.bc7_hq_encode_launch.restype = ctypes.c_int
        _bound = True
    return lib


def shared_bytes() -> int:
    """Dynamic shared memory a CTA of the kernel takes (4 warps of 32
    blocks: their texels and phase results)."""
    fn = _lib().bc7_hq_shared_bytes
    fn.restype = ctypes.c_int
    return fn()


def _set_tables(lib, consts, device: torch.device) -> None:
    """Copy the 2- and 3-subset partition masks and anchors into the
    device's constant memory, once per device."""
    if device.index in _tables_set:
        return
    arrays = [
        np.ascontiguousarray(consts.masks, np.uint16),
        np.ascontiguousarray(consts.anchors, np.int32),
        np.ascontiguousarray(consts.masks3, np.uint16),  # [64,3]
        np.ascontiguousarray(consts.anchors3, np.int32),  # [64,2]
    ]
    with torch.cuda.device(device):
        rc = lib.bc7_hq_set_tables(*(a.ctypes.data for a in arrays))
    if rc != 0:
        raise RuntimeError(f"bc7_hq_set_tables failed: cudaError {rc}")
    _tables_set.add(device.index)


def encode_bc7_hq_cuda(blocks: torch.Tensor, quality: int, consts) -> torch.Tensor:
    """[N,16,4] float32 CUDA blocks (0..1) -> [N,4] uint32 BC7 words at
    quality 3 or 4."""
    global launches
    check_blocks(blocks, 4, "BC7")
    if quality not in (3, 4):
        raise ValueError(f"BC7 high-quality kernel covers quality 3-4, got {quality}")
    n = blocks.shape[0]
    device = blocks.device
    out = torch.empty((n, 4), dtype=torch.uint32, device=device)
    if n == 0:
        return out
    if blocks.data_ptr() % 16:
        blocks = blocks.clone()  # the kernel reads 16 bytes a load
    lib = _lib()
    _set_tables(lib, consts, device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.bc7_hq_encode_launch(
            blocks.data_ptr(), out.data_ptr(), n, quality, *consts.chw, stream
        )
    if rc != 0:
        raise RuntimeError(f"BC7 high-quality kernel launch failed: cudaError {rc}")
    launches += 1
    return out
