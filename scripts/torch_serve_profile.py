#!/usr/bin/env python3
"""Where a flagship serving request of the PyTorch port spends its time.

Run on a CUDA card from the repository root:

    python3 scripts/torch_serve_profile.py [--requests 3] [--out output/torch_profile]

Builds the flagship `CAPEConfig()` model (bf16, 512 px, random weights from
a seed) behind `CAPEPredictor(batch_size=8)`, answers one warm-up request,
then:

1. times each stage of `predict` (host preprocessing, `encode_image`,
   `encode_support`, `decode_static`, the decode steps, the rest) with a
   device synchronisation around each stage, over `--requests` requests;
2. times one request as served (no added syncs), then profiles the same
   request with `torch.profiler`: the device's busy time (the union of
   kernel intervals), the idle share against the served wall time, and
   the kernels by total device time. The Chrome trace goes to
   `<out>/torch_serve_trace.json`.

The MSDA formulation is the port's own selection: set `CAPE_MSDA_GATHER`
(`fused`, `fusedq`, ...) and `CAPE_DECODE_PREQUAD=0` in the environment to
profile another one; the selection that ran is printed.

Imports nothing of JAX. Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import functools
import os
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (shared request generator and prototype)
from cape_tpu_torch import CAPE, CAPEConfig, CAPEPredictor  # noqa: E402
from cape_tpu_torch.ops.gather import default_gather_impl  # noqa: E402


def selection_line() -> str:
    """The MSDA selection the port reads from the environment."""
    return (f"selection: CAPE_MSDA_GATHER={default_gather_impl()}, "
            f"CAPE_MSDA_TINY={os.environ.get('CAPE_MSDA_TINY', '') or '-'}, "
            f"CAPE_DECODE_PREQUAD="
            f"{os.environ.get('CAPE_DECODE_PREQUAD', '1')}")


def _timed(stages, name, fn):
    @functools.wraps(fn)
    def run(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        stages[name] += (time.perf_counter() - t0) * 1e3
        return out
    return run


def _busy_ms(events) -> float:
    """Union of the device kernel intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3  # us -> ms


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--out", default="output/torch_profile")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    print(chip_smoke.card_identity(), flush=True)
    print(selection_line(), flush=True)
    cfg = CAPEConfig()
    model = CAPE(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    pred = CAPEPredictor(cfg, model, batch_size=8)
    proto = np.asarray(chip_smoke.PROTO_17, np.float32)
    reqs = chip_smoke._requests(np, args.requests + 2, 8)
    kw = dict(skeleton=chip_smoke.SKELETON_17)
    imgs, boxes = reqs[0]
    pred.predict(imgs, proto, bboxes=boxes, **kw)          # warm-up
    torch.cuda.synchronize()

    # -- 1. stages, synchronised ------------------------------------------
    stages = defaultdict(float)
    for name in ("encode_image", "encode_support", "decode_static",
                 "decode_step"):
        setattr(model, name, _timed(stages, name, getattr(model, name)))
    pred._prepare = _timed(stages, "host _prepare", pred._prepare)
    walls, steps = [], []
    for imgs, boxes in reqs[1:1 + args.requests]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pred.predict(imgs, proto, bboxes=boxes, **kw)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        steps.append(max(r["length"] for r in res))
    total = sum(walls)
    print(f"requests: {len(walls)}, wall ms {[round(w, 3) for w in walls]}, "
          f"decode steps {steps}", flush=True)
    for name, ms in sorted(stages.items(), key=lambda kv: -kv[1]):
        print(f"  {name:16s} {ms / len(walls):10.3f} ms/request "
              f"({100 * ms / total:5.1f}%)", flush=True)
    rest = total - sum(stages.values())
    print(f"  {'rest':16s} {rest / len(walls):10.3f} ms/request "
          f"({100 * rest / total:5.1f}%)", flush=True)
    for name in ("encode_image", "encode_support", "decode_static",
                 "decode_step"):
        delattr(model, name)
    del pred._prepare

    # -- 2. one request as served, then one under the profiler --------------
    from torch.profiler import ProfilerActivity, profile

    imgs, boxes = reqs[-1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred.predict(imgs, proto, bboxes=boxes, **kw)
    torch.cuda.synchronize()
    served = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred.predict(imgs, proto, bboxes=boxes, **kw)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busy_ms(kernels)
    print(f"request as served: wall {served:.3f} ms; under the profiler: "
          f"wall {wall:.3f} ms, device busy {busy:.3f} ms, {len(kernels)} "
          f"device events; idle share {100 * (1 - busy / served):.1f}% of the "
          f"served wall ({100 * (1 - busy / wall):.1f}% of the profiled one)",
          flush=True)
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += (e.time_range.end - e.time_range.start) / 1e3
        by_name[e.name][1] += 1
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]:
        print(f"  {ms:9.3f} ms {n:6d}x  {name[:110]}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.out, "torch_serve_trace.json"))
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                    "--format=csv,noheader"], check=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
