#!/usr/bin/env python3
"""Time the backwards of the two fused level samples (`fused_bwd`,
`quadfused_bwd`) on the card at the training path's shapes.

Run from the root of a checkout on a machine with one CUDA card:
`python3 <path to>/torch_sample_bwd_sweep.py [--splits]`. The port is
imported from the working directory, so the same script times another
checkout of it (an older one included) when run from that checkout's
root. At 32 slabs (4 images x 8 heads), Dh = 32, bf16, the encoder's four
levels (N = 21,760) and the teacher-forced decoder's level 0 (N = 800),
with `chip_smoke.py`'s two index sets (uniform, and drawn as the model
draws them), each call is checked against its plain version (one bf16
ulp, 2^-23 of the summed magnitudes) and timed with
`chip_smoke.device_ms` (the call captured 20 times into a CUDA graph and
replayed). One JSON line per shape and index set: the port's own plan's
time, and with `--splits` the time under every `split` (groups of lanes
a row) of `ops.msda_fused.sample_bwd_plan` in its place. It is how the
plan's split was chosen; nothing on the port's paths calls it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--splits", action="store_true",
                    help="also time every split of the plan")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_sample_bwd_sweep: CUDA is not available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from cape_tpu_torch.models.cape import level_shapes
    from cape_tpu_torch.ops import msda_fused as mf

    card = cs.card_identity()
    print(card, flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    shapes = level_shapes(512, 4)
    own = getattr(mf, "sample_bwd_plan", None)
    for label, _, kind, gq in cs._row_cases(torch, g, shapes, 4, 8, 4,
                                            False):
        if label.startswith("decoder") and label != "decoder level 0":
            continue
        Hl, Wl = shapes[int(label[-1])]
        N = gq.shape[1]
        for quad in (False, True):
            slab, _, w4, dout = cs._sample_inputs(
                torch, g, 32, Hl, Wl, N, 32, torch.bfloat16, quad,
                awkward=False)
            gi = gq if quad else (gq - (Wl + 1)).contiguous()
            lvl = () if quad else (Wl,)
            bwd = mf.quadfused_level_sample_bwd if quad \
                else mf.fused_level_sample_bwd
            plain = mf.quadfused_level_sample_bwd_plain if quad \
                else mf.fused_level_sample_bwd_plain
            want = plain(slab, gi, w4, *lvl, dout)
            mass = plain(slab, gi, w4.abs(), *lvl, dout.abs())[0].float()

            def timed():
                got = bwd(slab, gi, w4, *lvl, dout)
                torch.cuda.synchronize()
                for x, ref, extra in ((got[0], want[0], 2 ** -23 * mass),
                                      (got[1], want[1], 0.0)):
                    err = ((x.float() - ref.float()).abs() / (
                        1e-5 + 2 ** -7 * ref.float().abs() + extra)).max()
                    cs.check(err.item() <= 1.0, f"differs from plain "
                             f"({label}, {kind} indices)")
                return round(cs.device_ms(
                    torch, lambda: bwd(slab, gi, w4, *lvl, dout)), 5)

            times = {"own plan": timed()}
            if args.splits and own is not None:
                base = own(32, slab.shape[1], N, slab.shape[2],
                           0 if quad else Wl + 1, 1 if quad else 4)
                times["own plan"] = {"split": base.split,
                                     "device_ms": times["own plan"]}
                try:
                    for split in (1, 2, 4, 8, 16, 32):
                        mf.sample_bwd_plan = (
                            lambda *a, p=base._replace(split=split): p)
                        times[f"split {split}"] = timed()
                finally:
                    mf.sample_bwd_plan = own
            name = "quadfused_bwd" if quad else "fused_bwd"
            print(f"{name} [{label}, {kind} indices] {json.dumps(times)} "
                  f"({card})", flush=True)
            del slab, w4, dout, gi, want, mass
    return 0


if __name__ == "__main__":
    sys.exit(main())
