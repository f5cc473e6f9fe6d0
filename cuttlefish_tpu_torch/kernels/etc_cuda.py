"""ctypes wrapper of the hand-written ETC1/ETC2/EAC kernels
(``csrc/etc_encode.cu``).

Each entry checks device, dtype, shape and contiguity, allocates its output
with ``torch.empty``, launches on the current stream and raises on a
non-zero launch status, through ``bc_cuda.check_input`` and
``bc_cuda.launch``.  ``launches`` counts launches per entry; a count
moves only where its kernel is launched.  The library is built on first
use (``kernels/_build.py``).
"""

from __future__ import annotations

import ctypes

import torch

from cuttlefish_tpu_torch.kernels import _build
from cuttlefish_tpu_torch.kernels.bc_cuda import check_input, launch

launches = {"etc_rgb": 0, "etc2_rgba": 0, "eac_alpha": 0, "eac_r11": 0, "eac_rg11": 0}

_bound = False

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _lib() -> ctypes.CDLL:
    global _bound
    lib = _build.load("etc_encode")
    if not _bound:
        lib.etc_rgb_encode_launch.argtypes = [_P, _P, _I, _I, _I, _I, _F, _F, _F, _P]
        lib.etc2_rgba_encode_launch.argtypes = [_P, _P, _I, _I, _F, _F, _F, _P]
        lib.eac_alpha_encode_launch.argtypes = [_P, _P, _I, _I, _P]
        lib.eac_r11_encode_launch.argtypes = [_P, _P, _I, _I, _I, _P]
        lib.eac_rg11_encode_launch.argtypes = [_P, _P, _I, _I, _I, _I, _P]
        for name in launches:
            getattr(lib, f"{name}_encode_launch").restype = ctypes.c_int
        _bound = True
    return lib


def _launch(name: str, x: torch.Tensor, nwords: int, *args) -> torch.Tensor:
    return launch(_lib, launches, name, f"{name}_encode_launch", x, nwords, *args)


def encode_etc_rgb_cuda(blocks, quality: int, etc2: bool, chw):
    """[N,16,C] float32 CUDA blocks (C >= 3; red, green, blue) -> [N,2]
    uint32 ETC1 (or ETC2) RGB words."""
    check_input(blocks, "etc_rgb", (16, None), quality)
    if blocks.shape[2] < 3:
        raise ValueError(f"etc_rgb kernel needs at least 3 channels, got {blocks.shape[2]}")
    return _launch("etc_rgb", blocks, 2, blocks.shape[2], quality, int(etc2), *map(float, chw))


def encode_etc2_rgba_cuda(blocks, quality: int, chw):
    """[N,16,4] float32 CUDA blocks -> [N,4] uint32: EAC alpha words, then
    ETC2 RGB words."""
    check_input(blocks, "etc2_rgba", (16, 4), quality)
    return _launch("etc2_rgba", blocks, 4, quality, *map(float, chw))


def encode_eac_alpha_cuda(vals, quality: int):
    """[N,16] float32 CUDA values (0..1) -> [N,2] uint32 EAC alpha words."""
    check_input(vals, "eac_alpha", (16,), quality)
    return _launch("eac_alpha", vals, 2, quality)


def encode_eac_r11_cuda(vals, quality: int, signed: bool):
    """[N,16] float32 CUDA values ([0,1], or [-1,1] signed) -> [N,2] uint32
    EAC R11 words."""
    check_input(vals, "eac_r11", (16,), quality)
    return _launch("eac_r11", vals, 2, quality, int(signed))


def encode_eac_rg11_cuda(blocks, quality: int, signed: bool):
    """[N,16,C] float32 CUDA blocks (C >= 2; red, green) -> [N,4] uint32:
    R11 words, then G11 words."""
    check_input(blocks, "eac_rg11", (16, None), quality)
    if blocks.shape[2] < 2:
        raise ValueError(f"eac_rg11 kernel needs at least 2 channels, got {blocks.shape[2]}")
    return _launch("eac_rg11", blocks, 4, blocks.shape[2], quality, int(signed))
