"""The CUDA-graph captures with their warm-ups (`graphs.capture`), summed
over set-up, in s (0 where nothing is captured, as on the CPU)."""

import program


def read(run):
    ms = program.host_ms(run, "setup", ("graphs.capture",))
    return None if ms is None else ms * 1e-3
