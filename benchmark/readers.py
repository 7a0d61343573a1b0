"""What the per-layer metric readers (`metrics/<name>.py`) share. A reader
returns None where its run has nothing to read; the harness then leaves the
metric out of the result line."""

from __future__ import annotations

from typing import Optional

import counts
from trace import kernel_time_s


def span_ms_per(run, span: str, per: str) -> Optional[float]:
    """The summed span over the window's count of `per`, in ms."""
    t = run.spans.t.get(span)
    n = run.units.get(per)
    return sum(t) / n * 1e3 if t and n else None


def idle_share(run) -> Optional[float]:
    tr = run.trace
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def kernels_per(run, per: str) -> Optional[float]:
    tr, n = run.trace, run.traced_work.get(per)
    return len(tr["events"]) / n if tr and n else None


def mfu(run) -> Optional[float]:
    wall, flops = run.units.get("wall_s"), run.work.get("flops")
    if not wall or not flops:
        return None
    return 100.0 * flops / (wall * counts.PEAK_BF16_FLOPS)


def _share(bound_s: float, kernel_s: float) -> Optional[float]:
    return 100.0 * bound_s / kernel_s if kernel_s > 0 and bound_s > 0 \
        else None


def decode_gather_roofline(run, per: str) -> Optional[float]:
    """Serving and evaluation: each traced batch's encoder gathers, then
    one gather a decoder layer a token (the rest of the count)."""
    if not run.trace:
        return None
    c, images = run.c, run.t["batch"]
    n, secs = kernel_time_s(run.trace, "quad_gather_kernel")
    batches = run.traced_work.get(per, 0)
    enc = c["enc_layers"] * c["num_feature_levels"]
    tokens = n - enc * batches
    if batches == 0 or tokens < 0 or tokens % c["dec_layers"]:
        return None
    bound = batches * counts.encoder_gather_s(c, images) + \
        tokens * counts.token_gather_s(c, images)
    return _share(bound, secs)


def msda_roofline(run) -> Optional[float]:
    """Training: every micro-step's whole-op MSDA calls, forward
    (`msda_forward_kernel`) and backward (`msda_backward_kernel`), one of
    each at every encoder and teacher-forced decoder site."""
    if not run.trace:
        return None
    c = run.c
    images = run.t["episodes"] * run.t["queries"]
    micro = run.traced_work.get("updates", 0) * c["accumulation_steps"]
    sites = c["enc_layers"] + c["dec_layers"]
    launched = [kernel_time_s(run.trace, k) for k in (
        "msda_forward_kernel", "msda_backward_kernel")]
    if micro == 0 or any(n != micro * sites for n, _ in launched):
        return None
    return _share(micro * counts.train_msda_s(c, images),
                  sum(s for _, s in launched))
