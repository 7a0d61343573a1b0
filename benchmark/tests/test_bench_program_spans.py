"""The program's own spans and counters in the benchmark (`program.py`,
their readers in `metrics/`), read by `run.py`'s path (`harness.execute`)
on the CPU at the tiny size: a traced run turns the program's tracing on
before set-up and reads every span and counter metric its cell lists,
finite; an untraced run leaves tracing off; the traced part's idle gaps
are named by the innermost span of either kind on the launching thread,
and the spans' device annotations are not device work."""

import math
import time

import pytest

import common
import harness
import tiny
import trace

SPEC = common.spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
#: the metrics read from the program's spans
SPAN_METRICS = ("serve.host_ms", "device.span_share.serve",
                "device.span_share.eval", "eval.replay_ms_per_token",
                "eval.score_ms_per_batch", "train.feed_wait_ms",
                "train.copy_ms", "setup.capture_s")


def test_program_metrics_are_per_layer_entries():
    per_layer = {m["name"]: m for m in SPEC["per_layer"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for name in SPAN_METRICS:
        m = per_layer[name]
        assert m["source"] == "program_span"
        assert callable(common.metric_reader(name))
        for cell in m["workloads"]:
            assert cell in CELLS
            assert cell in e2e[m["moves"]].get("workloads", [cell])


def _kept_runs(monkeypatch):
    """Each run `harness.execute` sets up, with whether the program's
    tracing was on when its window started (`run.tracing`)."""
    from cape_tpu_torch import trace as program_trace
    runs, real = [], common.kind_driver

    class Kept:
        def __init__(self, drv):
            self._drv = drv

        def __getattr__(self, name):
            return getattr(self._drv, name)

        def setup(self, run):
            runs.append(run)
            self._drv.setup(run)

        def window(self, run):
            run.tracing = program_trace.enabled()
            return self._drv.window(run)

    monkeypatch.setattr(common, "kind_driver", lambda kind: Kept(real(kind)))
    return runs


def _summary(taken):
    """Each span name's count."""
    out = {}
    for s in taken["spans"]:
        out[s["name"]] = out.get(s["name"], 0) + 1
    return out


@pytest.mark.bench_dry
@pytest.mark.parametrize("cell", CELLS)
def test_cell_reads_its_program_metrics_at_tiny_size(monkeypatch, cell):
    from cape_tpu_torch import trace as program_trace
    runs = _kept_runs(monkeypatch)
    r = harness.execute(cell, 2 ** 31 + 5, 0.01, True, "cpu",
                        time.perf_counter(), files=tiny.files(cell))
    assert r["correct"], r["checks"]
    (run,) = runs
    assert run.tracing and not program_trace.enabled()
    want = {m["name"] for m in SPEC["per_layer"]
            if m["source"] in ("program_span", "program_counter")
            and cell in m.get("workloads", [cell])}
    assert want <= set(r["metrics"])
    for name in want:
        assert math.isfinite(r["metrics"][name]["value"]), name
    # no profiled part on the CPU
    assert set(run.program) == {"setup", "window"}
    window = _summary(run.program["window"])
    root = {"cape-geo.serve-b8": "serve.predict",
            "cape-geo.train-update": "train.micro_step",
            "cape-legacy.eval-kpt": "eval.batch"}[cell]
    assert window[root] >= 1
    if cell == "cape-geo.train-update":
        assert r["metrics"]["setup.capture_s"]["value"] == 0.0  # eager
        assert window["prefetch.wait"] >= 1
        assert window["prefetch.copy"] >= 1
    else:
        # one device span a token body at a chunk of 1
        assert window["decode.chunk"] >= window["decode"] >= 1


@pytest.mark.bench_dry
def test_untraced_run_leaves_tracing_off(monkeypatch):
    runs = _kept_runs(monkeypatch)
    r = harness.execute("cape-legacy.eval-kpt", 2 ** 31 + 6, 0.01, False,
                        "cpu", time.perf_counter(),
                        files=tiny.files("cape-legacy.eval-kpt"))
    assert r["correct"], r["checks"]
    (run,) = runs
    assert not run.tracing
    assert run.program == {"setup": None, "window": None}


def test_gaps_are_named_by_the_innermost_span():
    dev = [("k", 0.0, 10.0), ("k", 20.0, 30.0), ("k", 50.0, 60.0)]
    host = [("serve.decode", 5.0, 68.0), ("decode.host_read", 12.0, 18.0),
            ("decode", 8.0, 65.0)]
    got = dict(trace.name_gaps(dev, host, 0.0, 80.0))
    assert got == pytest.approx({"decode.host_read": 10e-6,
                                 "decode": 20e-6, "host": 20e-6})


def test_reduce_leaves_annotations_out_and_names_on_the_launcher():
    """Device annotations of `bench.*` and `cape.*` spans are no device
    work; a span of another thread (the prefetch producer's) names no
    gap."""
    launcher, producer = 1, 2
    events = [
        ("bench.window", False, 0.0, 100.0, launcher),
        ("cape.decode", False, 5.0, 85.0, launcher),
        ("cape.decode.host_read", False, 40.0, 60.0, launcher),
        ("cape.prefetch.copy", False, 10.0, 30.0, producer),
        ("cape.decode", True, 5.0, 85.0, launcher),     # annotation
        ("bench.window", True, 0.0, 100.0, launcher),   # annotation
        ("gemm", True, 0.0, 20.0, 0),
        ("gemm", True, 30.0, 40.0, 0),
        ("add", True, 60.0, 90.0, 0),
    ]
    got = trace.reduce_events(events, 1e-4)
    assert [e[0] for e in got["events"]] == ["gemm", "gemm", "add"]
    assert got["busy_s"] == pytest.approx(60e-6)
    assert got["window_s"] == pytest.approx(100e-6)
    assert dict(got["idle_gaps"]) == pytest.approx(
        {"decode": 10e-6, "decode.host_read": 20e-6, "host": 10e-6})
    assert dict(got["device_ops"]) == pytest.approx({"gemm": 30e-6,
                                                     "add": 30e-6})
