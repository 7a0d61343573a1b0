"""`evaluate_cape`'s host scoring (`eval.score`: extraction and PCK), ms a
batch in the window."""

import program


def read(run):
    roots = program.spans(run, "window", ("eval.batch",))
    return program.per(program.host_ms(run, "window", ("eval.score",)),
                       roots and len(roots))
