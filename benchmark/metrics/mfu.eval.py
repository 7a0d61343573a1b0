"""Model FLOPs of the work the window completed over its wall x the bf16 dense
peak, %."""

import readers


def read(run):
    return readers.mfu(run)
