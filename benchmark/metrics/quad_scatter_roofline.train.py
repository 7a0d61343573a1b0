"""`quad_scatter`'s least time (counts.py) over its traced device time, %."""

import readers


def read(run):
    return readers.train_roofline(run, "quad_scatter")
