"""The decode of a request (`eval.evaluate.decode` -> `graphs.decode`: prologue
and token bodies), synchronised, ms a request."""

import readers


def read(run):
    return readers.span_ms_per(run, "serve.decode", "requests")
