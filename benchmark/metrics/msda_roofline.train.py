"""The whole-op MSDA calls' least time (counts.py) over the traced time of
their forward and backward kernels, %."""

import readers


def read(run):
    return readers.msda_roofline(run)
