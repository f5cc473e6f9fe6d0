"""Kernel rooflines from frozen work.

A configuration's ``rooflines`` names, for each kernel on its path, the
operations and bytes one block needs, counted once and frozen (with where
the count came from), and the kernel's name on the device.  The least time
a card could take for a block is the larger of its operations over the
float32 rate outside the tensor cores and its bytes over the memory
bandwidth (NVIDIA H100 SXM data sheet); the share is that least time for
every block of the traced textures over the kernel's device time in the
trace.
The benchmark never recounts, so the yardstick stays the same work
whatever computes it.
"""

from __future__ import annotations

PEAK_FLOPS = 67e12  # float32, outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3


def block_time(spec: dict) -> float:
    """Least seconds one block can take on the card."""
    return max(spec["ops_per_block"] / PEAK_FLOPS, spec["bytes_per_block"] / PEAK_BYTES)


def share(run, kernel: str) -> float | None:
    """Percent of the roofline of the configuration's kernel over the
    traced textures; None where the configuration has no such kernel, the
    run was not traced, or the trace shows the kernel never ran."""
    spec = run.config.get("rooflines", {}).get(kernel)
    if spec is None or run.trace is None or run.traced is None:
        return None
    seconds = run.trace.device_time(spec["device_name"])
    if seconds <= 0:
        return None
    return 100.0 * block_time(spec) * run.blocks * len(run.traced.done) / seconds


def whole_share(run) -> float | None:
    """Percent of the float32 peak that the frozen operations of every
    texture of the window make of the window's time."""
    specs = run.config.get("rooflines", {})
    if not specs or not run.done:
        return None
    ops = sum(s["ops_per_block"] for s in specs.values()) * run.blocks * len(run.done)
    return 100.0 * ops / PEAK_FLOPS / run.window.seconds
