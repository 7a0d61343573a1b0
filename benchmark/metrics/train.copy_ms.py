"""The prefetch thread's copy of a micro-batch to the device
(`prefetch.copy`, `data.prefetch.to_device`), ms an update in the
window."""

import program


def read(run):
    return program.per(program.host_ms(run, "window", ("prefetch.copy",)),
                       run.units.get("updates"))
