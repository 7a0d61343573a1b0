#!/usr/bin/env python3
"""Time `quad_scatter` on the card under other tilings than the one
`ops.gather.scatter_plan` picks.

Run from the repository root on a machine with one CUDA card:
`PYTHONPATH=. python3 scripts/torch_scatter_sweep.py`. At the encoder's
training shapes (32 slabs, C = 128, N = 21,760, the four levels' quad
rows; bf16) and with both index sets of `chip_smoke.py` (uniform, and
drawn as the model draws them) it replaces the plan by every combination
of rows per tile and cluster size given below, checks the result against
`quad_scatter_plain`, and prints one JSON line per shape and index set:
`{"rows x cluster": device_ms}` with the port's own plan first. Times
are `chip_smoke.device_ms` (the call captured 20 times into a CUDA graph
and replayed). It is how the plan's constants were chosen; nothing on
the port's paths calls it.
"""

from __future__ import annotations

import json
import sys

#: rows per tile to try per level (n = 4161, 1057, 273, 73), and clusters
ROWS = {4161: (261, 521, 1041), 1057: (67, 133, 265), 273: (35, 55, 69, 137),
        73: (37, 73)}
CLUSTERS = (1, 2, 4, 8)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_scatter_sweep: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from cape_tpu_torch.models.cape import level_shapes
    from cape_tpu_torch.ops import gather

    card = cs.card_identity()
    print(card, flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    B, H, P, C = 4, 8, 4, 128
    cases = [c for c in cs._row_cases(torch, g, level_shapes(512, 4), B, H,
                                      P, False) if c[0].startswith("encoder")]
    dg = torch.randn(B * H, cases[0][3].shape[1], C, generator=g,
                     device="cuda").bfloat16()
    own_plan = gather.scatter_plan

    def plan(rows, cluster, n, N):
        tiles = -(-n // rows)
        share = -(-(-(-N // 32)) // cluster) * 32
        chain = min(gather._MAX_CHAIN, max(32, share))
        use_tile = cluster > 1 or share > chain
        return gather.ScatterPlan(
            rows, tiles, cluster, chain, int(use_tile), gather._THREADS,
            gather._plan_bytes(rows, chain, C, use_tile))

    try:
        for label, n, kind, gi in cases:
            N = gi.shape[1]
            want = gather.quad_scatter_plain(dg, gi, n).float()
            tried = [None] + [plan(r, k, n, N) for r in ROWS[n]
                              for k in CLUSTERS]
            times = {}
            for p in tried:
                if p is not None and (
                        p.shared_bytes > gather._SHARED_TWO_BLOCKS
                        or N < p.cluster * gather._MIN_SHARE):
                    continue
                gather.scatter_plan = own_plan if p is None \
                    else (lambda *a, p=p: p)
                got = gather.quad_scatter(dg, gi, n).float()
                torch.cuda.synchronize()
                torch.testing.assert_close(got, want, atol=1e-5,
                                           rtol=2 ** -7)
                used = p or own_plan(B * H, n, N, C)
                name = f"{used.rows_per_tile} x {used.cluster}" + (
                    " (the port's plan)" if p is None else "")
                times[name] = cs.device_ms(
                    torch, lambda: gather.quad_scatter(dg, gi, n))
            print(f"quad_scatter [{label}, {kind} indices] "
                  f"{json.dumps(times)} ({card})", flush=True)
    finally:
        gather.scatter_plan = own_plan
    return 0


if __name__ == "__main__":
    sys.exit(main())
