"""Device operations in the traced part over the requests it served."""

import readers


def read(run):
    return readers.kernels_per(run, "requests")
