"""The training loop's wait on the prefetch queue (`prefetch.wait`), ms an
update in the window."""

import program


def read(run):
    return program.per(program.host_ms(run, "window", ("prefetch.wait",)),
                       run.units.get("updates"))
