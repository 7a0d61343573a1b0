"""What the readers of an attention op's kernels share, for any backbone
whose module (`reference/backbones/`) counts the op's sites: a function
`<sites>(c, images)` that gives each site's forward and backward bytes and
FLOPs, in block order. An `Attention` names the op's kernels by pass, the
program's counter of the calls that took the kernel route, and that
function; a metric reader passes one to `roofline` or `kernel_share`."""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import counts
import program
from reference import backbones
from trace import kernel_time_s


class Attention(NamedTuple):
    #: the kernels of each pass ("fwd", "bwd"), as the device trace names them
    kernels: Dict[str, Tuple[str, ...]]
    #: the program's counter of calls that took the kernel route
    counter: str
    #: the backbone module's function that counts the sites
    sites: str


#: ViTDet's attention with decomposed relative-position bias (`ops.rel_attn`)
REL_ATTN = Attention(
    {"fwd": ("rel_attn_fwd_kernel",),
     "bwd": ("rel_attn_bwd_kernel", "rel_attn_table_grad_kernel")},
    "vitdet.rel_attn", "rel_attn")


def _sites(run, a: Attention):
    fn = getattr(backbones.module(run.c["backbone"]), a.sites, None)
    if fn is None:
        return None
    return fn(run.c, run.t["episodes"] * run.t["queries"])


def launched(run, a: Attention, part: str):
    """[(count, seconds)] of the pass's kernels over the traced part, or
    None unless each ran once at every site of every traced micro-step
    and the program's counter shows the kernel route took the sites (the
    same multiple of the sites since set-up)."""
    if not run.trace or "updates" not in run.traced_work:
        return None
    sites = _sites(run, a)
    micro = run.traced_work["updates"] * run.c["accumulation_steps"]
    routed = program.counter(a.counter)
    if not sites or not micro or not routed or routed % len(sites):
        return None
    got = [kernel_time_s(run.trace, k) for k in a.kernels[part]]
    if any(n != micro * len(sites) for n, _ in got):
        return None
    return got


def roofline(run, a: Attention, part: str) -> Optional[float]:
    """The pass's least time at every site of the traced micro-steps
    (bytes against the HBM's bandwidth, FLOPs against the bf16 peak,
    whichever is longer) over its kernels' traced time, %."""
    got = launched(run, a, part)
    if got is None:
        return None
    b, f = (0, 1) if part == "fwd" else (2, 3)
    micro = run.traced_work["updates"] * run.c["accumulation_steps"]
    bound = micro * sum(counts.least_s(s[b], s[f], counts.PEAK_BF16_FLOPS)
                        for s in _sites(run, a))
    secs = sum(s for _, s in got)
    return 100.0 * bound / secs if secs > 0 else None


def kernel_share(run, a: Attention) -> Optional[float]:
    """Both passes' kernels' traced time over the traced busy time, %."""
    parts = [launched(run, a, p) for p in a.kernels]
    if any(p is None for p in parts) or run.trace["busy_s"] <= 0:
        return None
    return 100.0 * sum(s for p in parts for _, s in p) / run.trace["busy_s"]
