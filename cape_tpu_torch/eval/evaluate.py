"""Serving-path pieces of `cape_tpu.eval.evaluate`: the decode wrapper and
the ragged keypoint extraction. PCK evaluation and the eval loop wait for
a later slice."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..data.token_types import TokenType
from ..models.cape import CAPE, autoregressive_decode


def extract_pred_keypoints(
    pred_logits: np.ndarray,   # (B, L, 3)
    pred_coords: np.ndarray,   # (B, L, 2)
    active: np.ndarray,        # (B, L) True while sample unfinished
    expected_counts: np.ndarray,  # (B,)
):
    """Ragged extraction: coords at positions predicted `coord`, in order,
    trimmed/zero-padded to the category keypoint count."""
    labels = pred_logits.argmax(-1)
    out = []
    for i in range(pred_logits.shape[0]):
        sel = (labels[i] == TokenType.coord) & active[i]
        kpts = pred_coords[i][sel]
        n = int(expected_counts[i])
        if len(kpts) >= n:
            kpts = kpts[:n]
        else:
            kpts = np.concatenate(
                [kpts, np.zeros((n - len(kpts), 2), kpts.dtype)], axis=0
            )
        out.append(kpts)
    return out


def decode(model: CAPE, images, sc, sm, se,
           max_len: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The counterpart of the JAX package's `_decode_jit`: one batched
    autoregressive decode on the model's device (PyTorch runs eagerly, so
    there is no trace to cache)."""
    return autoregressive_decode(model, images, sc, sm, se, max_len=max_len)
