"""``save_to_bytes(DDS)`` per texture: the container's head and the
levels and faces written into memory."""

from harness.layers import mean_ms


def read(run):
    return mean_ms(run, lambda r: r.spans["save"])
