"""The decode's layer-step kernel's least time (bytes, a floor) over its
traced device time in the traced batches, % (`decode_readers.roofline`)."""

import decode_readers


def read(run):
    return decode_readers.roofline(run, "batches")
