"""The whole texture's share of the card's float32 peak: the frozen
operations of every kernel the configuration names (``rooflines``), for
every texture completed in the window, over the window's seconds and the
peak."""

from harness.roofline import whole_share


def read(run):
    return whole_share(run)
