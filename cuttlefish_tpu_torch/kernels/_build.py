"""Build the hand-written CUDA kernels from the package's own sources.

``nvcc`` compiles each ``csrc/<name>.cu`` (with the ``csrc/*.cuh`` headers
it includes) into its own shared library with a plain C interface, loaded
with ``ctypes`` (no PyTorch headers, so a build takes seconds).  The first
``load`` builds every source that is not built yet, one ``nvcc`` per
source, all started together.  A library goes into a build directory keyed
by a hash of its source, the headers and the flags; nothing GPU-side
happens at import.

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
_libs: dict[str, ctypes.CDLL] = {}
# source name -> {"path", "built", "seconds", "log"}
build_info: dict[str, dict] = {}


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


def _digest(src: Path) -> str:
    """Hash of the flags, the source and every shared header of csrc/."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _target(src: Path) -> Path:
    return build_dir() / _digest(src) / f"lib{src.stem}.so"


def _start(src: Path, nvcc: str) -> tuple[subprocess.Popen, Path, list[str]]:
    so = _target(src)
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.parent / f"tmp-{os.getpid()}.so"
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
    )
    return proc, tmp, cmd


def _build_missing() -> None:
    """One nvcc per unbuilt source, all running at once."""
    pending = [s for s in _sources() if not _target(s).exists()]
    if not pending:
        return
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = [(src, *_start(src, nvcc)) for src in pending]
    errors = []
    for src, proc, tmp, cmd in jobs:
        out, err = proc.communicate()
        so = _target(src)
        (so.parent / "build.log").write_text(" ".join(cmd) + "\n" + out + err)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc {src.name} failed ({proc.returncode}):\n{err[-4000:]}")
            continue
        os.replace(tmp, so)
        build_info[src.stem] = {"built": True, "seconds": time.perf_counter() - t0}
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """Build (once per source hash) and load the library of csrc/<name>.cu."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = CSRC / f"{name}.cu"
        if not src.exists():
            raise FileNotFoundError(f"no kernel source {src}")
        _build_missing()
        so = _target(src)
        lib = ctypes.CDLL(str(so))
        log = so.parent / "build.log"
        info = build_info.setdefault(name, {"built": False, "seconds": 0.0})
        info.update(path=str(so), log=log.read_text() if log.exists() else "")
        _libs[name] = lib
        return lib
