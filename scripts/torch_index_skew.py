#!/usr/bin/env python3
"""How unevenly the flagship model's MSDA samples fall on the rows of each
level: the entries per quad row that the `fusedq` backward sorts into its
row lists (`ops/csrc/rowlist.cuh`), for every level sample of one
teacher-forced forward.

Run from the repository root, on the CPU (the counts do not depend on the
device): `python3 scripts/torch_index_skew.py`. Builds `CAPEConfig()`
with random weights from a seed and `chip_smoke.py`'s training batch, runs
`forward_losses` under `CAPE_MSDA_GATHER=fusedq`, and prints for each
distinct level-sample shape the mean entries per row and the largest
count on one row (the median over the slabs and the largest). Imports
nothing of JAX.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the training batch)
from cape_tpu_torch import CAPE, CAPEConfig  # noqa: E402
from cape_tpu_torch.ops import msda_fused  # noqa: E402
from cape_tpu_torch.train.train_step import forward_losses  # noqa: E402


def main() -> int:
    cfg = CAPEConfig()
    model = CAPE(cfg, device="cpu",
                 generator=torch.Generator().manual_seed(0))
    batch = chip_smoke._train_batch(np, cfg, np.random.default_rng(6))
    seen = {}
    sample = msda_fused._sample

    def record(public, slab, gi, w4, Wl):
        n = slab.shape[1]
        g = gi.long()
        most = [int(torch.bincount(row[(row >= 0) & (row < n)],
                                   minlength=n).max()) for row in g]
        seen.setdefault((tuple(slab.shape), g.shape[1]), most)
        return sample(public, slab, gi, w4, Wl)

    msda_fused._sample = record
    os.environ["CAPE_MSDA_GATHER"] = "fusedq"
    with torch.no_grad():
        forward_losses(model, cfg, batch)
    for (shape, N), most in seen.items():
        print(f"quad slab {shape}, N {N}: {N / shape[1]:.2f} entries a row "
              f"on average; the most on one row: median over slabs "
              f"{int(np.median(most))}, largest {max(most)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
