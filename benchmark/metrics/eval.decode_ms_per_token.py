"""The synchronised decode span over the decode steps it ran, ms a step."""

import readers


def read(run):
    return readers.span_ms_per(run, "eval.decode", "steps")
