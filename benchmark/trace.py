"""The device trace of a traced run, reduced: `torch.profiler` over a fixed
number of the cell's units after the window, its device events as
(name, start, end), the union of their intervals (busy time), and the idle
gaps named by the innermost span the launching thread was in: the
benchmark's (`bench.<name>`) or the program's (`cape.<name>`, recorded
while the program's tracing is on).
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Tuple

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


def name_gaps(dev: List[Tuple], spans: List[Tuple], start: float,
              end: float) -> List[Tuple[str, float]]:
    """The device's idle seconds between `start` and `end` (profiler
    microseconds) by the innermost host span (name, start, end) around
    each gap's middle, `host` outside every span; the ten largest."""
    idle = defaultdict(float)
    for a, b in gaps(dev, start, end):
        mid = (a + b) / 2
        inner = [h for h in spans if h[1] <= mid <= h[2]]
        name = min(inner, key=lambda h: h[2] - h[1])[0] if inner else "host"
        idle[name] += (b - a) * 1e-6
    return sorted(idle.items(), key=lambda x: -x[1])[:10]


def reduce_events(events: Iterable[Tuple[str, bool, float, float, int]],
                  wall_s: float) -> Dict:
    """The trace of (name, on the device, start, end, thread) events: the
    device's operations, leaving out the device annotations of the spans
    (`bench.*`, `cape.*`); and their idle gaps named by the innermost span
    of either kind on the thread that launches the work (the one of the
    `bench.window` span around the traced part)."""
    dev, host = [], []
    for name, on_device, s, e, thread in events:
        named = name.startswith(("bench.", "cape."))
        if on_device and not named:
            dev.append((name, s, e))
        elif not on_device and named:
            host.append((name.split(".", 1)[1], s, e, thread))
    window = [h for h in host if h[0] == "window"]
    if window:
        w0, w1, launcher = window[0][1:]
    else:
        w0, w1, launcher = min(s for _, s, _ in dev), \
            max(e for _, _, e in dev), None
    spans = [h[:3] for h in host if h[0] != "window" and h[3] == launcher]
    ops = defaultdict(float)
    for n, s, e in dev:
        ops[n] += (e - s) * 1e-6
    return {"events": dev, "busy_s": busy_us(dev) * 1e-6,
            "window_s": (w1 - w0) * 1e-6, "wall_s": wall_s,
            "device_ops": sorted(ops.items(), key=lambda x: -x[1])[:10],
            "idle_gaps": name_gaps(dev, spans, w0, w1)}


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
    cuda = torch.autograd.DeviceType.CUDA
    return reduce_events(((e.name, e.device_type == cuda,
                           float(e.time_range.start),
                           float(e.time_range.end), e.thread)
                          for e in prof.events()), wall_s)


def kernel_time_s(trace: Dict, name: str) -> Tuple[int, float]:
    """(count, seconds) of the device events whose name holds `name`."""
    hit = [e - s for n, s, e in trace["events"] if name in n]
    return len(hit), sum(hit) * 1e-6
