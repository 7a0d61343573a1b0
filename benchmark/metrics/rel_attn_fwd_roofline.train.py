"""The relative-attention forward kernel's least time at the 24 sites of
every traced micro-step over its traced time, %
(`attn_readers.roofline`)."""

import attn_readers


def read(run):
    return attn_readers.roofline(run, attn_readers.REL_ATTN, "fwd")
