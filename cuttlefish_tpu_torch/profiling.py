"""Profiling hooks of the port.

Two mechanisms:

- `trace()` wraps a region in `torch.profiler.profile` (CPU and, where
  there is one, the CUDA device) when a trace directory is configured
  (``CUTTLEFISH_TRACE_DIR`` env var or `set_trace_dir`), and writes a
  Chrome trace ``<dir>/<name>.json`` when the region ends.  With no
  directory configured it is a no-op, so `Texture.convert` can always run
  under it.
- `phase()` records wall-clock per named phase into `last_phases`
  (prepare / encode / serialize inside `Texture.convert`), the cheap
  always-on analog the bench harness and tests read.

Copied from ``cuttlefish_tpu/profiling.py``; `trace()` uses
``torch.profiler`` where the JAX package used ``jax.profiler.trace``.
"""

from __future__ import annotations

import contextlib
import os
import time

_trace_dir: str | None = None
last_phases: dict[str, float] = {}


def set_trace_dir(path: str | None) -> None:
    """Enable (or disable with None) profiler traces of converts."""
    global _trace_dir
    _trace_dir = path


def _active_dir() -> str | None:
    return _trace_dir or os.environ.get("CUTTLEFISH_TRACE_DIR") or None


@contextlib.contextmanager
def trace(name: str = "convert"):
    """torch.profiler around the block when a trace dir is set; the Chrome
    trace goes to ``<dir>/<name>.json``."""
    d = _active_dir()
    if not d:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(d, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(d, f"{name}.json"))


@contextlib.contextmanager
def phase(name: str):
    """Accumulate wall-clock seconds for `name` into `last_phases`."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        last_phases[name] = last_phases.get(name, 0.0) + (
            time.perf_counter() - t0
        )


def reset_phases() -> None:
    last_phases.clear()
