"""The fused pipeline's ``pyramid`` phase per texture (``pyramid_blocks``:
the sRGB round trip, each level's resample, the tiling), ending in a
synchronise."""

from harness.layers import phase_ms


def read(run):
    return phase_ms(run, "pyramid")
