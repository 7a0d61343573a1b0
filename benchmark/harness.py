"""One run of one cell: set-up, the measured window, the traced part (with
`--trace 1`), the correctness check, and the result line. A traced run
records the program's own spans from before set-up on; an untraced one,
whose end-to-end metrics are the cell's, leaves them off.

A cell's driver (`kinds/<kind>.py`, named by its traffic mix) provides
`setup(run)`, `window(run)`, `traced_units(run)` and `check(run)`; this file
owns the clock, the memory reading, the trace and the assembly of the
numbers. `Run` is what the driver and every metric reader see.
"""

from __future__ import annotations

import gc
import math
import sys
import time
from typing import Dict, Optional

import torch

import check as checks
import common
import trace as device_trace


class Run:
    def __init__(self, files: Dict, seed: int, seconds: float, traced: bool,
                 device, control: bool = False):
        self.cell = files["cell"]
        self.config = files["config"]
        self.c = dict(files["config"]["cape"])
        self.t = files["traffic"]
        self.limits = files["limits"]
        self.seed, self.seconds, self.traced = seed, seconds, traced
        self.device = torch.device(device)
        self.control = control
        self.spans = common.Spans()
        self.units = {}          # what the window completed
        self.work = {}           # the model work of it (counts.py)
        self.trace: Optional[Dict] = None
        #: the program's spans and counters (`trace.take()`, None in an
        #: untraced run) at the window's start (`setup`), at its end
        #: (`window`) and after the profiled part (`traced`)
        self.program: Dict = {}
        self.traced_work = {}    # what the traced part completed
        self.weights = None
        self.state: Dict = {}

    def log(self, *a) -> None:
        print(*a, file=sys.stderr, flush=True)

    def mark(self, what: str) -> None:
        """Log the seconds since the process started, at a set-up step."""
        t = time.perf_counter() - self.t_start
        self.log(f"set-up: {what} at {t:.3f} s")

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # the program, built the same way by every driver
    def port_config(self):
        from cape_tpu_torch.config import CAPEConfig
        return CAPEConfig.from_json(common.json.dumps(self.c))

    def make_weights(self, shapes):
        """The benchmark's weights for parameters of these names and shapes
        (the reference's `load_state_dict` holds it to the same layout)."""
        init = dict(self.config["assumed"]["init"])
        init.update(self.t.get("init", {}))
        self.weights = common.make_weights(shapes, self.c, init,
                                           self.seed % (2 ** 63),
                                           self.device)
        return self.weights

    def port_model(self, cfg):
        from cape_tpu_torch.models.cape import CAPE
        model = CAPE(cfg, device=self.device)
        self.mark("program's model built")
        shapes = {k: v.shape for k, v in model.state_dict().items()}
        model.load_state_dict(self.make_weights(shapes), strict=True)
        self.mark("weights made and loaded")
        return model


def _program_trace():
    """The program's spans and counters (`cape_tpu_torch.trace`), or None
    for a program without them."""
    try:
        from cape_tpu_torch import trace
    except ImportError:
        return None
    return trace


def execute(cell_name: str, seed: int, seconds: float, traced: bool,
            device, t_start: float, control: bool = False,
            files: Optional[Dict] = None) -> Dict:
    files = files or common.cell_files(cell_name)
    run = Run(files, seed, seconds, traced, device, control)
    run.t_start = t_start
    run.mark("harness")
    drv = common.kind_driver(run.t["kind"])
    program = _program_trace() if traced else None
    take = program.take if program else lambda: None
    if program:
        program.enable()
    try:
        drv.setup(run)
        run.sync()
        setup_s = time.perf_counter() - t_start
        run.mark("window starts")
        run.program["setup"] = take()
        e2e = drv.window(run)
        run.sync()
        run.program["window"] = take()
        peak = (torch.cuda.max_memory_allocated(run.device)
                if run.device.type == "cuda" else 0)
        if traced and run.device.type == "cuda":
            window_spans, run.spans = run.spans, common.Spans()
            run.trace = device_trace.profile(lambda: drv.traced_units(run),
                                             run.device)
            run.program["traced"] = take()
            run.spans = window_spans
    finally:
        if program:
            program.enable(False)
    drv.release(run)
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    with checks.exact_fp32():
        readings = drv.check(run)
    verdict = checks.verdict(readings, run.limits)
    e2e["setup_s"] = setup_s
    names = [m["name"] for m in (files["per_layer"] if traced
                                 else files["end_to_end"])]
    metrics = {}
    units = {m["name"]: m["unit"] for m in files["per_layer"]
             + files["end_to_end"]}
    for name in names:
        value = e2e.get(name) if not traced or name == "setup_s" else \
            common.metric_reader(name)(run)
        if value is not None and math.isfinite(value):
            metrics[name] = {"value": value, "unit": units[name]}
    dev = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(run.device)
                    if run.device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    card = common.power_limit() if run.device.type == "cuda" else None
    if card:
        dev["power_limit"] = card.split(",")[-1].strip()
    result = {"correct": verdict["correct"],
              "attempted": run.units.get("attempted", 0),
              "failed": run.units.get("failed", 0),
              "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["checks"] = verdict["checks"]
    result["readings"] = {k: v for k, v in readings.items()
                          if isinstance(v, (int, float))}
    if control:
        result["control"] = {k: readings[k] for k in ("control",
                                                      "half_batch")
                             if k in readings}
        result["control_verdicts"] = {
            k: checks.verdict(v, run.limits, present=True)
            for k, v in result["control"].items()}
        result["readings"] = {k: v for k, v in readings.items()
                              if k not in result["control"]}
    result["checks"] = result.pop("checks")       # the last key
    return result
