"""Hungarian matcher, class + coordinate LSAP matching: the port of
`cape_tpu.models.matcher` (parity with the reference's
`models/matcher.py:8-76`).

Not used on the CAPE path (its token order is fixed,
`roomformer_v2.py:925-926`); provided so users of the reference find the
same component surface. Inputs may be tensors or arrays; the matching runs
on the host in numpy with scipy's `linear_sum_assignment`.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def hungarian_match(
    pred_logits,                 # (B, Q, C) class logits
    pred_coords,                 # (B, Q, 2)
    target_labels: List,         # per-sample (Ni,)
    target_coords: List,         # per-sample (Ni, 2)
    cost_class: float = 1.0,
    cost_coords: float = 5.0,
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Per-sample optimal assignment between predictions and targets.

    Returns a list of (pred_indices, target_indices) int64 pairs.
    """
    from scipy.optimize import linear_sum_assignment

    pred_logits, pred_coords = _host(pred_logits), _host(pred_coords)
    out = []
    for b in range(pred_logits.shape[0]):
        tl = _host(target_labels[b]).astype(np.int64)
        tc = _host(target_coords[b]).astype(np.float64)
        if len(tl) == 0:
            out.append((np.array([], np.int64), np.array([], np.int64)))
            continue
        probs = _softmax(pred_logits[b])                # (Q, C)
        c_class = -probs[:, tl]                         # (Q, N)
        c_coords = np.abs(
            pred_coords[b][:, None, :] - tc[None, :, :]).sum(-1)  # (Q, N) L1
        cost = cost_class * c_class + cost_coords * c_coords
        rows, cols = linear_sum_assignment(cost)
        out.append((rows.astype(np.int64), cols.astype(np.int64)))
    return out


def _softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)
