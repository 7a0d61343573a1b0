"""The program's own spans and counters in the benchmark (`program.py`,
`spans.py`, their readers in `metrics/`), on the CPU at the tiny size:
each cell run with the program's spans on reads every metric of
`program_metrics.json` it lists, and the counter metrics, finite; the
idle gaps are named by the innermost span of either kind."""

import math
import os
import time

import pytest

import common
import spans
import tiny

SPEC = common.spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
PROGRAM = common.load_json(os.path.join(common.HERE, spans.PROGRAM_METRICS))


def test_program_metrics_are_per_layer_entries():
    keys = {"name", "unit", "better", "source", "layer", "moves",
            "workloads"}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in PROGRAM:
        assert set(m) == keys and m["source"] == "program_span"
        assert m["name"] not in {p["name"] for p in SPEC["per_layer"]}
        assert callable(common.metric_reader(m["name"]))
        for cell in m["workloads"]:
            assert cell in CELLS
            assert cell in e2e[m["moves"]].get("workloads", [cell])


@pytest.mark.bench_dry
@pytest.mark.parametrize("cell", CELLS)
def test_cell_reads_its_program_metrics_at_tiny_size(cell):
    result, line = spans.execute(cell, 2 ** 31 + 5, 0.01, False, "cpu",
                                 time.perf_counter(), files=tiny.files(cell))
    assert result["correct"], result["checks"]
    want = {m["name"] for m in PROGRAM if cell in m["workloads"]}
    want |= {m["name"] for m in SPEC["per_layer"]
             if m["name"] in spans.COUNTER_METRICS
             and cell in m.get("workloads", [cell])}
    assert set(line["program"]) == want
    for name, v in line["program"].items():
        assert math.isfinite(v), (name, v)
    assert set(line["spans"]) == {"setup", "window"}
    window = line["spans"]["window"]
    root = {"cape-geo.serve-b8": "serve.predict",
            "cape-geo.train-update": "train.micro_step",
            "cape-legacy.eval-kpt": "eval.batch"}[cell]
    assert window[root][0] >= 1
    if cell == "cape-geo.train-update":
        assert line["program"]["setup.capture_s"] == 0.0   # eager on the CPU
        assert window["prefetch.wait"][0] >= 1
        assert window["prefetch.copy"][0] >= 1
    else:
        # one device span a token body at a chunk of 1
        assert window["decode.chunk"][0] >= window["decode"][0] >= 1


def test_gaps_are_named_by_the_innermost_span():
    dev = [("k", 0.0, 10.0), ("k", 20.0, 30.0), ("k", 50.0, 60.0)]
    host = [("serve.decode", 5.0, 68.0), ("decode.host_read", 12.0, 18.0),
            ("decode", 8.0, 65.0)]
    got = dict(spans.name_gaps(dev, host, 0.0, 80.0))
    assert got == pytest.approx({"decode.host_read": 10e-6,
                                 "decode": 20e-6, "host": 20e-6})
