"""The fused pipeline's ``fetch`` and ``interleave`` phases per texture:
the words to the host and into each level's raster-order bytes."""

from harness.layers import phase_ms


def read(run):
    return phase_ms(run, "fetch", "interleave")
