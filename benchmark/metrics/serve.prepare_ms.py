"""Host crop and resize (`CAPEPredictor._prepare`), ms a request."""

import readers


def read(run):
    return readers.span_ms_per(run, "serve.prepare", "requests")
