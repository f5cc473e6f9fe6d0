"""Build the hand-written CUDA kernels from the package's own sources.

``nvcc`` compiles ``csrc/*.cu`` into one shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds).  The library goes into a build directory keyed by a hash of the
sources and flags, at first use; nothing GPU-side happens at import.

The build directory is ``cuttlefish_tpu_torch/_build`` unless
``CUTTLEFISH_TORCH_BUILD_DIR`` names another.  ``nvcc`` is taken from
``CUDA_HOME``/``CUDA_PATH``, then ``PATH``, then ``/usr/local/cuda``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"

# --fmad=false: no a*b+c contraction, so the kernel rounds where the plain
# PyTorch version rounds.  No fast-math: division and sqrtf stay IEEE.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_info: dict = {}


def build_dir() -> Path:
    return Path(os.environ.get("CUTTLEFISH_TORCH_BUILD_DIR") or _PKG / "_build")


def _nvcc() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        home = os.environ.get(var)
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def load() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out_dir = build_dir() / _digest()
        so = out_dir / "libcuttlefish_kernels.so"
        t0 = time.perf_counter()
        built = False
        if not so.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            tmp = out_dir / f"tmp-{os.getpid()}.so"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            (out_dir / "build.log").write_text(
                " ".join(cmd) + "\n" + proc.stdout + proc.stderr
            )
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}"
                )
            os.replace(tmp, so)
            built = True
        _lib = ctypes.CDLL(str(so))
        log = out_dir / "build.log"
        build_info.update(
            path=str(so),
            built=built,
            seconds=time.perf_counter() - t0,
            log=log.read_text() if log.exists() else "",
        )
        return _lib
