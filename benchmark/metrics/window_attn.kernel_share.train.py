"""The window-attention kernels' traced time, forward and backward, over
the traced busy time, % (`swin_readers.kernel_share`)."""

import swin_readers


def read(run):
    return swin_readers.kernel_share(run)
