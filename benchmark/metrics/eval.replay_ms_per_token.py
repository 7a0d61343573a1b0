"""Device time of the token-body chunk replays (`decode.chunk`) over the
token bodies run (`decode.steps`), ms a token in the window."""

import program


def read(run):
    got = program.spans(run, "window", ("decode.chunk",))
    return program.per(None if got is None else
                       sum(s["device_ms"] for s in got),
                       program.window_count(run, "decode.steps"))
