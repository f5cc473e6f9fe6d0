"""Means per texture of host-clock spans and of the program's phases,
for the per-layer metric readers."""

from __future__ import annotations


def mean_ms(run, per_texture) -> float | None:
    done = run.done
    if not done:
        return None
    return sum(per_texture(r) for r in done) / len(done) * 1e3


def phase_ms(run, *phases: str) -> float | None:
    """Mean of the named phases' sum; None where the program reported
    none of them."""
    done = run.done
    if not done or not any(p in r.phases for r in done for p in phases):
        return None
    return mean_ms(run, lambda r: sum(r.phases.get(p, 0.0) for p in phases))
