"""`quad_gather`'s least time (counts.py) over its traced device time, %."""

import readers


def read(run):
    return readers.decode_gather_roofline(run, "batches")
