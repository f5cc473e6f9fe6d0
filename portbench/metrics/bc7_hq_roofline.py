"""``csrc/bc7_hq_encode.cu``'s share of its roofline: the frozen work of
the window's blocks (the configuration's ``rooflines.bc7_hq``) at the
card's published peaks, over the kernel's device time in the trace."""

from harness.roofline import share


def read(run):
    return share(run, "bc7_hq")
