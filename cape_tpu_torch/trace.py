"""The port's own spans and counters: where a request, a batch or a
micro-step spends its time, recorded inside the program.

A span is one stretch of the program's work on one thread: its name, the
thread, start and end (`time.perf_counter_ns`), the span it sits in and
the request it belongs to. A root span (`span(name, root=True)`:
`serve.predict`, `eval.batch`, `train.micro_step`) opens a new request id;
the spans inside it on the same thread inherit it (a thread-local stack).
A device span (`device_span`) is a span that also times its block on the
device: a pair of CUDA events on the current stream, resolved by `take()`;
on the CPU it takes the host clock, since eager CPU ops are synchronous.
No span synchronises the device, and none records an event inside a CUDA
graph capture.

Tracing is off until `enable()`. Off, `span` and `device_span` return one
shared no-op context manager and record nothing. On, spans stay in memory
until `take()` returns and clears them; while a `torch.profiler` is live,
each span also opens `record_function("cape." + name)`, so that it lands
in the profiler's trace on the profiler's clock. `take()` also returns the
anchor `time.time_ns() - time.perf_counter_ns()`, which maps the recorded
spans onto that clock (Unix nanoseconds).

Counters (`count`, read by `counters()`) are plain integer adds, on or
off:

- `graphs.captures`: CUDA graphs captured (`graphs._Graph`);
- `decode.steps`: token bodies run, on either decode route;
- `decode.host_reads`: the host's reads of "has every sample finished?",
  one after every token body but the last;
- `msda.whole_op`: MSDA calls that took the whole-op autograd function
  (`ops.msda.ms_deform_attn`); a captured step counts its sites once, at
  the capture;
- `swin.window_attn`: Swin window-attention calls that took the kernel
  route (`ops.window_attn.window_attention` on CUDA tensors); counted
  like `msda.whole_op`;
- `decode.layer_step`: decoder-layer decode steps that took the kernel
  (`ops.decode_step.layer_step` on CUDA tensors); counted like
  `msda.whole_op`.

One device span sits in the model: `backbone`, around the backbone's call
in `CAPE.encode_image`. It opens only where the stream is not being
captured (a device span cannot be recorded there), so it times eager
forwards (the CPU, an eager training route, the validation loss) and
none inside the captured decode or micro-step.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, List, Optional

import torch

_NOOP = contextlib.nullcontext()
_on = False
_lock = threading.Lock()
_spans: List["_Span"] = []
_counts: Dict[str, int] = {}
_ids = itertools.count(1)
_local = threading.local()


def enable(on: bool = True) -> None:
    """Turn span recording on (or off). Counters count either way."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def count(name: str, n: int = 1) -> None:
    _counts[name] = _counts.get(name, 0) + n


def counters() -> Dict[str, int]:
    """Every counter's value since the process started."""
    return dict(_counts)


def span(name: str, root: bool = False):
    """A context manager that records the block as the span `name`; with
    `root`, the span opens a new request."""
    if not _on:
        return _NOOP
    return _Span(name, root, None)


def device_span(name: str, device):
    """`span(name)` that also times the block on `device`'s current
    stream (the host clock on a CPU device)."""
    if not _on:
        return _NOOP
    return _Span(name, False, torch.device(device))


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


class _Span:
    __slots__ = ("name", "root", "device", "thread", "start", "end", "id",
                 "parent", "request", "stream", "events", "_rf")

    def __init__(self, name: str, root: bool,
                 device: Optional[torch.device]):
        self.name, self.root, self.device = name, root, device
        self.end = None
        self.events = None
        self._rf = None

    def __enter__(self):
        stack = _stack()
        up = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = None if up is None else up.id
        self.request = self.id if self.root else (
            None if up is None else up.request)
        self.thread = threading.get_ident()
        stack.append(self)
        if torch.autograd._profiler_enabled():
            self._rf = torch.profiler.record_function("cape." + self.name)
            self._rf.__enter__()
        if self.device is not None and self.device.type == "cuda":
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"device span {self.name!r} opened "
                                   "inside a CUDA graph capture")
            # one stream lookup for both events; the end event is made at
            # the exit, once the block's work is enqueued
            self.stream = torch.cuda.current_stream(self.device)
            self.events = [torch.cuda.Event(enable_timing=True)]
            self.events[0].record(self.stream)
        with _lock:
            _spans.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.events is not None:
            self.events.append(torch.cuda.Event(enable_timing=True))
            self.events[1].record(self.stream)
        if self._rf is not None:
            self._rf.__exit__(*exc)
        _stack().pop()
        self.end = end           # last: a set end marks the span closed
        return False


def take() -> Dict:
    """The spans finished since the last `take()` (spans still open stay
    for the next one), with the counters, the anchor and the host clock
    now (`at_ns`).

    Each span is a dict: `name`, `thread`, `start_ns`, `end_ns`, `id`,
    `parent` (the id of the span it sits in, or None), `request` (None
    outside every root span). A device span adds `device_ms`, its block's
    time on the device, and `device_start_ns` / `device_end_ns`: its place
    on the device's timeline, shifted so that the first CUDA device span
    of this take starts where its host span starts (only the distances
    between device spans are measured). Waits for the device events it
    resolves."""
    global _spans
    with _lock:           # one reading of each end decides taken or kept
        ends = [(s, s.end) for s in _spans]
        _spans = [s for s, end in ends if end is None]
    out, base = [], None
    for s, end in ends:
        if end is None:
            continue
        rec = {"name": s.name, "thread": s.thread, "start_ns": s.start,
               "end_ns": end, "id": s.id, "parent": s.parent,
               "request": s.request}
        if s.events is not None:
            s.events[1].synchronize()
            if base is None:
                base = s
            ms = s.events[0].elapsed_time(s.events[1])
            at = base.start + round(
                base.events[0].elapsed_time(s.events[0]) * 1e6)
            rec.update(device_ms=ms, device_start_ns=at,
                       device_end_ns=at + round(ms * 1e6))
        elif s.device is not None:
            rec.update(device_ms=(end - s.start) * 1e-6,
                       device_start_ns=s.start, device_end_ns=end)
        out.append(rec)
    return {"spans": out, "counters": counters(),
            "anchor_ns": time.time_ns() - time.perf_counter_ns(),
            "at_ns": time.perf_counter_ns()}
