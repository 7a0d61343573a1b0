"""What the window-attention metric readers (`metrics/window_attn*.py`)
share: the kernels of `ops.window_attn` in a traced training run of a
backbone whose module (`reference/backbones/`) counts its sites
(`window_attn(c, images)`: each site's forward and backward bytes and
FLOPs, in block order)."""

from __future__ import annotations

from typing import Optional

import counts
import program
from reference import backbones
from trace import kernel_time_s

#: the kernels of each pass, by the names the device trace gives them
KERNELS = {"fwd": ("window_attn_fwd_kernel",),
           "bwd": ("window_attn_bwd_kernel", "window_attn_bias_grad_kernel")}


def _sites(run):
    fn = getattr(backbones.module(run.c["backbone"]), "window_attn", None)
    if fn is None:
        return None
    return fn(run.c, run.t["episodes"] * run.t["queries"])


def launched(run, part: str):
    """[(count, seconds)] of the pass's kernels over the traced part, or
    None unless each ran once at every site of every traced micro-step
    and the program's counter `swin.window_attn` shows the kernel route
    took the sites (the same multiple of the sites since set-up)."""
    if not run.trace or "updates" not in run.traced_work:
        return None
    sites = _sites(run)
    micro = run.traced_work["updates"] * run.c["accumulation_steps"]
    routed = program.counter("swin.window_attn")
    if not sites or not micro or not routed or routed % len(sites):
        return None
    got = [kernel_time_s(run.trace, k) for k in KERNELS[part]]
    if any(n != micro * len(sites) for n, _ in got):
        return None
    return got


def roofline(run, part: str) -> Optional[float]:
    """The pass's least time at every site of the traced micro-steps
    (bytes against the HBM's bandwidth, FLOPs against the bf16 peak,
    whichever is longer) over its kernels' traced time, %."""
    got = launched(run, part)
    if got is None:
        return None
    b, f = (0, 1) if part == "fwd" else (2, 3)
    micro = run.traced_work["updates"] * run.c["accumulation_steps"]
    bound = micro * sum(counts.least_s(s[b], s[f], counts.PEAK_BF16_FLOPS)
                        for s in _sites(run))
    secs = sum(s for _, s in got)
    return 100.0 * bound / secs if secs > 0 else None


def kernel_share(run) -> Optional[float]:
    """Both passes' kernels' traced time over the traced busy time, %."""
    parts = [launched(run, p) for p in KERNELS]
    if any(p is None for p in parts) or run.trace["busy_s"] <= 0:
        return None
    return 100.0 * sum(s for p in parts for _, s in p) / run.trace["busy_s"]
