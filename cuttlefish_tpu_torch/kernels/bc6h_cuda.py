"""ctypes wrapper of the hand-written BC6H kernel (``csrc/bc6h_encode.cu``).

The kernel reads the [N,16,3] float32 texels and makes their half-bit
proxy itself (the plain version's ``bc6h._to_proxy``, in integer
arithmetic).  ``launches`` counts kernel launches; it moves only where the
kernel is launched.  The library is built on first use
(``kernels/_build.py``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from cuttlefish_tpu_torch.kernels import _build
from cuttlefish_tpu_torch.kernels.bc6h import layout_table
from cuttlefish_tpu_torch.kernels.bc7 import _texel_bits
from cuttlefish_tpu_torch.kernels.bc7_cuda import check_blocks
from cuttlefish_tpu_torch.kernels.bc7_tables import ANCHOR2, PARTITION2

launches = 0

_tables_set: set = set()
_bound = False


def reset_launches() -> None:
    global launches
    launches = 0


def _lib() -> ctypes.CDLL:
    global _bound
    lib = _build.load("bc6h_encode")
    if not _bound:
        lib.bc6h_set_tables.argtypes = [ctypes.c_void_p] * 4
        lib.bc6h_set_tables.restype = ctypes.c_int
        lib.bc6h_encode_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.bc6h_encode_launch.restype = ctypes.c_int
        _bound = True
    return lib


def _set_tables(lib, device: torch.device) -> None:
    """Copy the 32 partition masks and anchors and the two-region mode and
    layout tables into the device's constant memory, once per device."""
    if device.index in _tables_set:
        return
    modes, layout = layout_table()
    arrays = [
        np.ascontiguousarray(_texel_bits(PARTITION2[:32]), np.uint16),
        np.ascontiguousarray(ANCHOR2[:32], np.int32),
        np.ascontiguousarray(modes, np.int32),
        np.ascontiguousarray(layout, np.int32),
    ]
    with torch.cuda.device(device):
        rc = lib.bc6h_set_tables(*(a.ctypes.data for a in arrays))
    if rc != 0:
        raise RuntimeError(f"bc6h_set_tables failed: cudaError {rc}")
    _tables_set.add(device.index)


def encode_bc6h_cuda(
    blocks: torch.Tensor, quality: int, signed: bool, metric: str
) -> torch.Tensor:
    """[N,16,3] float32 CUDA RGB blocks -> [N,4] uint32 BC6H words."""
    global launches
    check_blocks(blocks, 3, "BC6H")
    if quality not in range(5) or metric not in ("value", "code"):
        raise ValueError(f"BC6H kernel: bad quality {quality} or metric {metric!r}")
    n = blocks.shape[0]
    device = blocks.device
    out = torch.empty((n, 4), dtype=torch.uint32, device=device)
    if n == 0:
        return out
    lib = _lib()
    _set_tables(lib, device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.bc6h_encode_launch(
            blocks.data_ptr(), out.data_ptr(), n, quality, int(signed),
            int(metric == "code"), stream,
        )
    if rc != 0:
        raise RuntimeError(f"BC6H kernel launch failed: cudaError {rc}")
    launches += 1
    return out
