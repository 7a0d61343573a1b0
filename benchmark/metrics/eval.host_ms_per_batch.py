"""An `evaluate_cape` call's wall minus its decode span: the host's
scoring and the call's own work, ms a batch."""

import readers


def read(run):
    batch = readers.span_ms_per(run, "eval.batch", "batches")
    decode = readers.span_ms_per(run, "eval.decode", "batches")
    return None if batch is None or decode is None else batch - decode
