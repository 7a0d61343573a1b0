"""The host's own work of a request inside `predict`: crop and resize
(`serve.prepare`), stack and pad (`serve.batch`), keypoint extraction and
pixel mapping (`serve.extract`), ms a request in the window."""

import program


def read(run):
    roots = program.spans(run, "window", ("serve.predict",))
    return program.per(program.host_ms(
        run, "window", ("serve.prepare", "serve.batch", "serve.extract")),
        roots and len(roots))
