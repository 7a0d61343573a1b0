"""The relative-attention kernels' traced time, forward and backward, over
the traced busy time, % (`attn_readers.kernel_share`)."""

import attn_readers


def read(run):
    return attn_readers.kernel_share(run, attn_readers.REL_ATTN)
