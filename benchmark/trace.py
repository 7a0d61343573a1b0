"""The device trace of a traced run, reduced: `torch.profiler` over a fixed
number of the cell's units after the window, its device events as
(name, start, end), the union of their intervals (busy time), and the idle
gaps named by the benchmark span (`bench.<name>`) the host was in.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch


def busy_us(events: List[Tuple[str, float, float]]) -> float:
    """Union of the events' intervals, in microseconds."""
    busy, cs, ce = 0.0, None, None
    for _, s, e in sorted(events, key=lambda x: x[1]):
        if ce is None or s > ce:
            if ce is not None:
                busy += ce - cs
            cs, ce = s, e
        else:
            ce = max(ce, e)
    if ce is not None:
        busy += ce - cs
    return busy


def gaps(events, start: float, end: float) -> List[Tuple[float, float]]:
    """The idle intervals of the device between `start` and `end`."""
    out, at = [], start
    for _, s, e in sorted(events, key=lambda x: x[1]):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if end > at:
        out.append((at, end))
    return out


def profile(fn: Callable[[], None], device) -> Dict:
    """Run `fn` under the profiler; return the reduced trace."""
    from torch.profiler import ProfilerActivity
    torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("bench.window"):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize(device)
            wall_s = time.perf_counter() - t
    dev, host = [], []
    for e in prof.events():
        r = e.time_range
        if e.name.startswith("bench.") and \
                e.device_type == torch.autograd.DeviceType.CUDA:
            continue                     # the spans' own device annotations
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((e.name, float(r.start), float(r.end)))
        elif e.name.startswith("bench."):
            host.append((e.name[len("bench."):], float(r.start),
                         float(r.end)))
    window = [h for h in host if h[0] == "window"]
    w0, w1 = (window[0][1], window[0][2]) if window else (
        min(s for _, s, _ in dev), max(e for _, _, e in dev))
    spans = [h for h in host if h[0] != "window"]
    idle = defaultdict(float)
    for a, b in gaps(dev, w0, w1):
        mid = (a + b) / 2
        inner = [h for h in spans if h[1] <= mid <= h[2]]
        name = min(inner, key=lambda h: h[2] - h[1])[0] if inner else "host"
        idle[name] += (b - a) * 1e-6
    ops = defaultdict(float)
    for n, s, e in dev:
        ops[n] += (e - s) * 1e-6
    return {"events": dev, "busy_s": busy_us(dev) * 1e-6,
            "window_s": (w1 - w0) * 1e-6, "wall_s": wall_s,
            "device_ops": sorted(ops.items(), key=lambda x: -x[1])[:10],
            "idle_gaps": sorted(idle.items(), key=lambda x: -x[1])[:10]}


def kernel_time_s(trace: Dict, name: str) -> Tuple[int, float]:
    """(count, seconds) of the device events whose name holds `name`."""
    hit = [e - s for n, s, e in trace["events"] if name in n]
    return len(hit), sum(hit) * 1e-6
