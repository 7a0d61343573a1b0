#!/usr/bin/env python3
"""Where a flagship training step of the PyTorch port spends its time.

Run on a CUDA card from the repository root:

    python3 scripts/torch_train_profile.py [--cycles 2] [--out output/torch_profile]

Builds the flagship `CAPEConfig()` model (bf16, 512 px, dropout 0.1,
random weights from a seed) and its train state, runs one warm-up
accumulation cycle (`accumulation_steps` micro-steps of 4 query images,
ending in a real AdamW update), then:

1. times `--cycles` cycles as trained (a sync after each micro-step);
2. profiles one more cycle with `torch.profiler`: the device's busy time
   (the union of kernel intervals), the idle share against the wall time,
   the kernels by total device time, and the share of the port's own
   kernels. The Chrome trace goes to `<out>/torch_train_trace.json`.

The MSDA formulation is the port's own selection: set `CAPE_MSDA_GATHER`
(`fused`, `fusedq`, ...) in the environment to profile another one; the
selection that ran is printed.

Imports nothing of JAX. Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import chip_smoke  # noqa: E402  (shared batch generator)
from cape_tpu_torch import CAPE, CAPEConfig  # noqa: E402
from cape_tpu_torch.train import (create_train_state,  # noqa: E402
                                  make_train_step)
from torch_serve_profile import _busy_ms, selection_line  # noqa: E402

#: kernel-name fragments of the port's hand-written kernels; a name counts
#: for the first fragment it holds (quadfused_* before fused_*)
OWN = ("quad_gather_kernel", "quad_scatter_kernel", "msda_forward_kernel",
       "quadfused_fwd_kernel", "quadfused_bwd_kernel", "fused_fwd_kernel",
       "fused_bwd_kernel")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cycles", type=int, default=2)
    ap.add_argument("--out", default="output/torch_profile")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    print(chip_smoke.card_identity(), flush=True)
    print(selection_line(), flush=True)
    cfg = CAPEConfig()
    spe = cfg.episodes_per_epoch // cfg.batch_size
    model = CAPE(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    state = create_train_state(cfg, model, spe)
    step = make_train_step(model, cfg, spe)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(0)
    k = cfg.accumulation_steps
    batches = [chip_smoke._train_batch(np, cfg, rng) for _ in range(k)]

    def cycle(sync: bool):
        times = []
        for b in batches:
            t0 = time.perf_counter()
            step(state, b, gen)
            if sync:
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        return times

    cycle(sync=True)                                        # warm-up
    for c in range(args.cycles):
        times = cycle(sync=True)
        print(f"cycle {c + 1}: ms per micro-step "
              f"{[round(t, 3) for t in times]} (the last includes the "
              f"update), {sum(times):.3f} ms per update", flush=True)

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cycle(sync=False)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busy_ms(kernels)
    print(f"one cycle ({k} micro-steps) under the profiler: wall "
          f"{wall:.3f} ms, device busy {busy:.3f} ms, {len(kernels)} device "
          f"events, idle share {100 * (1 - busy / wall):.1f}%", flush=True)
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += (e.time_range.end - e.time_range.start) / 1e3
        by_name[e.name][1] += 1
    own = {f: [0.0, 0] for f in OWN}
    for name, (ms, n) in by_name.items():
        f = next((f for f in OWN if f in name), None)
        if f is not None:
            own[f][0] += ms
            own[f][1] += n
    for f, (ms, n) in own.items():
        print(f"  port kernel {f}: {ms:.3f} ms over {n} launches "
              f"({100 * ms / busy:.1f}% of device busy)", flush=True)
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]:
        print(f"  {ms:9.3f} ms {n:6d}x  {name[:110]}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.out, "torch_train_trace.json"))
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                    "--format=csv,noheader"], check=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
