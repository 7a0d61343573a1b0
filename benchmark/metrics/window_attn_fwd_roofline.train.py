"""The window-attention forward kernels' least time at the 24 sites of
every traced micro-step over their traced time, %
(`swin_readers.roofline`)."""

import swin_readers


def read(run):
    return swin_readers.roofline(run, "fwd")
