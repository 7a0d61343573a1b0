"""A dry run of the harness on the CPU: every cell of `BENCHMARK.json`
finds its configuration, traffic, limits and metric files by name; each
generator makes its pools at the tiny size; each cell runs whole at that
size (a window of one unit, the check against the reference) and comes
out correct; each metric reader reads its run or returns nothing."""

import math
import os
import time

import numpy as np
import pytest

import common
import harness
import tiny

SPEC = common.spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_every_entry_finds_its_files():
    for w in SPEC["workloads"]:
        f = common.cell_files(w["name"])
        drv = common.kind_driver(f["traffic"]["kind"])
        for fn in ("pools", "work", "setup", "window", "traced_units",
                   "release", "check"):
            assert callable(getattr(drv, fn)), (w["name"], fn)
        assert isinstance(f["traffic"]["tiny"], dict)
        assert f["limits"]
        assert {m["name"] for m in f["end_to_end"]} >= {"setup_s"}
        assert f["per_layer"]
    for c in SPEC["configs"]:
        f = common.load_json(os.path.join(common.ROOT, c["file"]))
        assert f["reduced"] == c["reduced"]
    for m in SPEC["per_layer"]:
        assert callable(common.metric_reader(m["name"]))


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.shape == b.shape and bool((a == b).all())
    return a == b


@pytest.mark.parametrize("cell", CELLS)
def test_generator_is_seeded_and_keeps_the_work(cell):
    f = tiny.files(cell)
    t, c = f["traffic"], f["config"]["cape"]
    drv = common.kind_driver(t["kind"])
    a, b, other = (drv.pools(t, c, s) for s in (2 ** 31 + 9, 2 ** 31 + 9,
                                                2 ** 31 + 10))
    assert _same(a, b)
    assert not _same(a, other)
    assert drv.work(a) == drv.work(other)


@pytest.mark.bench_dry
@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_whole_at_tiny_size(cell, traced):
    r = harness.execute(cell, 2 ** 31 + 3, 0.01, traced, "cpu",
                        time.perf_counter(), files=tiny.files(cell))
    assert r["correct"], r["checks"]
    f = common.cell_files(cell)
    want = f["per_layer"] if traced else f["end_to_end"]
    for m in want:
        if m["name"] in r["metrics"]:
            v = r["metrics"][m["name"]]
            assert math.isfinite(v["value"]) and v["unit"] == m["unit"]
    if not traced:
        assert set(r["metrics"]) == {m["name"] for m in want}
    else:       # spans read on the CPU; device metrics need the card
        spans = {m["name"] for m in want if m["source"] == "program_span"}
        assert spans <= set(r["metrics"])
    assert list(r)[-1] == "checks" and r["attempted"] > 0
