"""The union of the program's device spans (copy-in, prologue and chunk
replays, copy-out) over the window's wall, in %: the device's busy share
with no profiler attached."""

import program


def read(run):
    return program.device_share(run)
