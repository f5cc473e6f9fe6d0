"""ctypes wrapper of the hand-written BC1-BC5 kernels (``csrc/bc_encode.cu``).

Each entry checks device, dtype, shape and contiguity (``check_input``),
allocates its output with ``torch.empty``, launches on the current stream
and raises on a non-zero launch status (``launch``; the ETC/EAC wrapper
uses both too).  ``launches`` counts launches per entry; a count moves only
where its kernel is launched.  The library is built on first use
(``kernels/_build.py``).
"""

from __future__ import annotations

import ctypes

import torch

from cuttlefish_tpu_torch.kernels import _build

launches = {"bc1": 0, "bc2": 0, "bc3": 0, "bc4": 0, "bc5": 0}

_bound = False

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _lib() -> ctypes.CDLL:
    global _bound
    lib = _build.load("bc_encode")
    if not _bound:
        lib.bc1_encode_launch.argtypes = [_P, _P, _I, _I, _I, _I, _F, _F, _F, _P]
        lib.bc2_encode_launch.argtypes = [_P, _P, _I, _I, _F, _F, _F, _P]
        lib.bc3_encode_launch.argtypes = [_P, _P, _I, _I, _F, _F, _F, _P]
        lib.bc4_encode_launch.argtypes = [_P, _P, _I, _I, _I, _P]
        lib.bc5_encode_launch.argtypes = [_P, _P, _I, _I, _I, _I, _P]
        for fn in ("bc1", "bc2", "bc3", "bc4", "bc5"):
            getattr(lib, f"{fn}_encode_launch").restype = ctypes.c_int
        _bound = True
    return lib


def check_input(x: torch.Tensor, name: str, tail: tuple, quality: int) -> None:
    """Raise unless x is a contiguous float32 CUDA tensor [N, *tail] (None
    in tail: any size) with N < 2**31, and quality is 0-4."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} kernel needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} kernel needs float32 input, got {x.dtype}")
    if x.dim() != 1 + len(tail) or any(
        want is not None and got != want for got, want in zip(x.shape[1:], tail)
    ):
        raise ValueError(f"{name} kernel needs [N,{','.join(map(str, tail))}], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} kernel needs contiguous input")
    if not 0 <= quality <= 4:
        raise ValueError(f"{name} kernel covers quality 0-4, got {quality}")
    if x.shape[0] >= 2**31:
        raise ValueError(f"{name} kernel takes fewer than 2**31 blocks")


def launch(load_lib, counts: dict, name: str, fn: str, x: torch.Tensor, nwords: int,
           *args) -> torch.Tensor:
    """[N, nwords] uint32 words of launcher ``fn`` of the library
    ``load_lib()`` on x (N = 0: no launch); counts[name] moves by one.  The
    kernels read 16-byte vectors: a view that starts off a 16-byte boundary
    is copied first."""
    n = x.shape[0]
    if x.data_ptr() % 16:
        x = x.clone()
    out = torch.empty((n, nwords), dtype=torch.uint32, device=x.device)
    if n == 0:
        return out
    lib = load_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, fn)(x.data_ptr(), out.data_ptr(), n, *args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    counts[name] += 1
    return out


def _launch(name: str, x: torch.Tensor, nwords: int, fn: str, *args) -> torch.Tensor:
    return launch(_lib, launches, name, fn, x, nwords, *args)


def encode_bc1_cuda(blocks, quality: int, punch_through: bool, allow_black: bool, chw):
    """[N,16,4] float32 CUDA blocks -> [N,2] uint32 BC1 words."""
    check_input(blocks, "bc1", (16, 4), quality)
    return _launch(
        "bc1", blocks, 2, "bc1_encode_launch",
        quality, int(punch_through), int(allow_black), *map(float, chw),
    )


def encode_bc2_cuda(blocks, quality: int, chw):
    """[N,16,4] float32 CUDA blocks -> [N,4] uint32 BC2 words."""
    check_input(blocks, "bc2", (16, 4), quality)
    return _launch("bc2", blocks, 4, "bc2_encode_launch", quality, *map(float, chw))


def encode_bc3_cuda(blocks, quality: int, chw):
    """[N,16,4] float32 CUDA blocks -> [N,4] uint32 BC3 words."""
    check_input(blocks, "bc3", (16, 4), quality)
    return _launch("bc3", blocks, 4, "bc3_encode_launch", quality, *map(float, chw))


def encode_bc4_cuda(vals, quality: int, signed: bool):
    """[N,16] float32 CUDA values -> [N,2] uint32 BC4 words."""
    check_input(vals, "bc4", (16,), quality)
    return _launch("bc4", vals, 2, "bc4_encode_launch", quality, int(signed))


def encode_bc5_cuda(blocks, quality: int, signed: bool):
    """[N,16,C] float32 CUDA blocks (C >= 2; red, green) -> [N,4] uint32."""
    check_input(blocks, "bc5", (16, None), quality)
    if blocks.shape[2] < 2:
        raise ValueError(f"bc5 kernel needs at least 2 channels, got {blocks.shape[2]}")
    return _launch(
        "bc5", blocks, 4, "bc5_encode_launch", blocks.shape[2], quality, int(signed)
    )
