"""Share of the traced wall in which no device operation ran, %."""

import readers


def read(run):
    return readers.idle_share(run)
