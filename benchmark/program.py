"""What the readers of the program's own spans and counters share
(`cape_tpu_torch.trace`, recorded inside the port).

Counters count in every run. Spans are recorded only in a traced run,
where `harness.execute` turns tracing on before set-up; `run.program` then
holds three `trace.take()` results: `setup` (taken at the window's start),
`window` (at its end) and, after the profiled part on the card, `traced`.
A reader returns None where its run has nothing to read: an untraced run,
or a program without `trace` (an older checkout), where those are None.
"""

from __future__ import annotations

from typing import Iterable, List, Optional


def counter(name: str) -> Optional[int]:
    """The program's counter since the process started (`run.py` runs one
    cell a process), or None where the program has no counters."""
    try:
        from cape_tpu_torch import trace
    except ImportError:
        return None
    return trace.counters().get(name, 0)


def taken(run, part: str) -> Optional[dict]:
    return run.program.get(part)


def spans(run, part: str, names: Iterable[str]) -> Optional[List[dict]]:
    t = taken(run, part)
    names = set(names)
    return None if t is None else [s for s in t["spans"]
                                   if s["name"] in names]


def host_ms(run, part: str, names: Iterable[str]) -> Optional[float]:
    """The spans' summed host time, in ms."""
    got = spans(run, part, names)
    return None if got is None else sum(
        s["end_ns"] - s["start_ns"] for s in got) * 1e-6


def window_ns(run) -> Optional[int]:
    """The window's wall on the host clock, between its two takes."""
    a, b = taken(run, "setup"), taken(run, "window")
    return None if a is None or b is None else b["at_ns"] - a["at_ns"]


def window_count(run, name: str) -> Optional[int]:
    """A counter's growth over the window."""
    a, b = taken(run, "setup"), taken(run, "window")
    if a is None or b is None:
        return None
    return b["counters"].get(name, 0) - a["counters"].get(name, 0)


def device_share(run) -> Optional[float]:
    """The union of the window's device spans over its wall, in %."""
    from trace import busy_us        # the union of intervals, any unit
    t, wall = taken(run, "window"), window_ns(run)
    if t is None or not wall:
        return None
    return 100.0 * busy_us([(s["name"], s["device_start_ns"],
                             s["device_end_ns"]) for s in t["spans"]
                            if "device_ms" in s]) / wall


def per(total: Optional[float], n) -> Optional[float]:
    return None if total is None or not n else total / n
