"""The fused pipeline's ``upload`` phase per texture: level 0 to the card
as float32, ending in a synchronise."""

from harness.layers import phase_ms


def read(run):
    return phase_ms(run, "upload")
