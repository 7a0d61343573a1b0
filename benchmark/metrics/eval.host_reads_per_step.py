"""The host's reads of "has every sample finished?" per token body run,
over the run's decodes (the program's counters `decode.host_reads` and
`decode.steps`): one a token at `models.cape.DECODE_CHUNK` 1, but a
decode's last."""

import program


def read(run):
    return program.per(program.counter("decode.host_reads"),
                       program.counter("decode.steps"))
