"""The fused pipeline's ``kernel`` phase per texture: the format's
hand-written kernel on every level's blocks, ending in a synchronise."""

from harness.layers import phase_ms


def read(run):
    return phase_ms(run, "kernel")
