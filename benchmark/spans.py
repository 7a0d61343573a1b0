"""One run of a cell with the program's own spans on: where the window's
time goes inside `predict`, `evaluate_cape`, the decode's replays, the
step program and the prefetch queue (`cape_tpu_torch.trace`).

    python3 benchmark/spans.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The run of `run.py`, with besides: tracing on from before set-up; the
spans taken at the window's start and end (`run.program`, what
`program.py` and its readers read) and after the profiled part; with
`--trace 1` the profiler's trace keeps the program's `cape.*` events of the
thread that launches work, and names each idle gap of the device by the
innermost span of either kind (`bench.*` or `cape.*`). `run.py`'s result
line comes first; the last line of standard output is this run's: the
metrics of `program_metrics.json` and of the program's counters that the
cell reads, the named gaps, and each span's count and summed host and
device ms in set-up, the window and the profiled part.
"""

from __future__ import annotations

import run as bench_run     # first: its import time is the run's start

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
from collections import defaultdict  # noqa: E402
from typing import Dict, List, Tuple  # noqa: E402

import torch  # noqa: E402

PROGRAM_METRICS = "program_metrics.json"
COUNTER_METRICS = ("graphs.captures", "eval.host_reads_per_step")


def name_gaps(dev: List[Tuple], spans: List[Tuple], start: float,
              end: float) -> List[Tuple[str, float]]:
    """The device's idle seconds between `start` and `end` (profiler
    microseconds) by the innermost host span (name, start, end) around
    each gap's middle, `host` outside every span; the ten largest."""
    from trace import gaps
    idle = defaultdict(float)
    for a, b in gaps(dev, start, end):
        mid = (a + b) / 2
        inner = [h for h in spans if h[1] <= mid <= h[2]]
        name = min(inner, key=lambda h: h[2] - h[1])[0] if inner else "host"
        idle[name] += (b - a) * 1e-6
    return sorted(idle.items(), key=lambda x: -x[1])[:10]


def profile(fn, device) -> Dict:
    """`trace.profile` with the program's spans: the profiled part's
    `take()` (`program`), and the idle gaps named by the innermost span of
    either kind (`bench.*`, or `cape.*` on the thread that launches work).
    It has its own profiler session because `trace.profile` drops the
    `cape.*` host events and would count their device annotations as
    device work; the reduction is `trace`'s `busy_us` and `gaps`."""
    from torch.profiler import ProfilerActivity

    from cape_tpu_torch import trace as program_trace
    from trace import busy_us
    torch.cuda.synchronize(device)
    program_trace.take()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("bench.window"):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize(device)
            wall_s = time.perf_counter() - t
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.events():
        named = e.name.startswith(("bench.", "cape."))
        r = (float(e.time_range.start), float(e.time_range.end))
        if e.device_type != cuda and named:
            host.append((e.name.split(".", 1)[1], *r, e.thread))
        elif e.device_type == cuda and not named:
            dev.append((e.name, *r))
    (w0, w1, launcher), = [h[1:] for h in host if h[0] == "window"]
    inner = [h[:3] for h in host if h[0] != "window" and h[3] == launcher]
    ops = defaultdict(float)
    for n, s, e in dev:
        ops[n] += (e - s) * 1e-6
    return {"events": dev, "busy_s": busy_us(dev) * 1e-6,
            "window_s": (w1 - w0) * 1e-6, "wall_s": wall_s,
            "device_ops": sorted(ops.items(), key=lambda x: -x[1])[:10],
            "idle_gaps": name_gaps(dev, inner, w0, w1),
            "program": program_trace.take()}


class Spanned:
    """A kind's driver with the program's spans taken at the window's
    start and end; `runs` keeps each run it set up."""

    def __init__(self, drv, runs: list):
        self._drv, self._runs = drv, runs

    def __getattr__(self, name):
        return getattr(self._drv, name)

    def setup(self, run) -> None:
        run.program = {}
        self._runs.append(run)
        self._drv.setup(run)

    def window(self, run):
        from cape_tpu_torch import trace as program_trace
        run.program["setup"] = program_trace.take()
        out = self._drv.window(run)
        run.sync()
        run.program["window"] = program_trace.take()
        return out


def summary(taken: Dict) -> Dict[str, List[float]]:
    """Each span name's [count, host ms, device ms]."""
    out = defaultdict(lambda: [0, 0.0, 0.0])
    for s in taken["spans"]:
        row = out[s["name"]]
        row[0] += 1
        row[1] += (s["end_ns"] - s["start_ns"]) * 1e-6
        row[2] += s.get("device_ms", 0.0)
    return dict(sorted(out.items()))


def read_program(run, cell: str) -> Dict[str, float]:
    """The cell's program metrics that read a number."""
    import common
    spec = common.load_json(os.path.join(common.HERE, PROGRAM_METRICS))
    names = [m["name"] for m in spec if cell in m["workloads"]]
    names += [m["name"] for m in common.spec()["per_layer"]
              if m["name"] in COUNTER_METRICS
              and cell in m.get("workloads", [cell])]
    out = {}
    for name in names:
        v = common.metric_reader(name)(run)
        if v is not None:
            out[name] = v
    return out


def execute(cell: str, seed: int, seconds: float, traced: bool, device,
            t_start: float, files=None) -> Tuple[Dict, Dict]:
    """`harness.execute` with the program's spans on; returns its result
    and this run's line."""
    import common
    import harness
    import trace as device_trace
    from cape_tpu_torch import trace as program_trace

    runs: list = []
    kind_driver, profile_before = common.kind_driver, device_trace.profile
    common.kind_driver = lambda kind: Spanned(kind_driver(kind), runs)
    device_trace.profile = profile
    program_trace.enable()
    try:
        result = harness.execute(cell, seed, seconds, traced, device,
                                 t_start, files=files)
    finally:
        program_trace.enable(False)
        common.kind_driver, device_trace.profile = (kind_driver,
                                                    profile_before)
    (r,) = runs
    parts = dict(r.program)
    if r.trace is not None:
        parts["traced"] = r.trace["program"]
    line = {"workload": cell, "seed": seed,
            "program": read_program(r, cell),
            "spans": {k: summary(v) for k, v in parts.items()},
            "counters": program_trace.counters()}
    if r.trace is not None:
        line["idle_gaps"] = r.trace["idle_gaps"]
    return result, line


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench_run._environment()
    import common
    cell = common.cell_files(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["cell"]["chips"]:
        print(f"needs {cell['cell']['chips']} CUDA card(s)", file=sys.stderr)
        return 2
    result, line = execute(args.workload, args.seed % (2 ** 62),
                           args.seconds, bool(args.trace), "cuda:0",
                           bench_run.T_START, files=cell)
    bad = bench_run.loaded_forbidden()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    result.pop("readings")
    print(json.dumps(result), flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
