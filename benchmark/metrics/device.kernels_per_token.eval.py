"""Device operations in the traced part over the decode steps it ran."""

import readers


def read(run):
    return readers.kernels_per(run, "steps")
