"""Sequence -> keypoint utilities + data-leak detector, a copy of
`cape_tpu.utils.sequence`.

Parity with `util/sequence_utils.py:8-120` and
`models/engine_cape.py:304-391`.
"""

from __future__ import annotations

import warnings
from typing import List, Optional

import numpy as np

from ..data.token_types import TokenType
from .debug import debug_enabled  # noqa: F401  (the JAX module's name)


def extract_keypoints_from_sequence(
    coords: np.ndarray,        # (B, L, 2)
    token_labels: np.ndarray,  # (B, L), -1 pads
    mask: Optional[np.ndarray] = None,  # (B, L) valid-token mask
    max_keypoints: Optional[int] = None,
) -> List[np.ndarray]:
    """Filter coordinate tokens per sample -> ragged list of (Ni, 2)."""
    out = []
    for i in range(coords.shape[0]):
        sel = token_labels[i] == TokenType.coord
        if mask is not None:
            sel = sel & np.asarray(mask[i], bool)
        k = coords[i][sel]
        if max_keypoints is not None:
            k = k[:max_keypoints]
        out.append(k)
    return out


def extract_keypoints_from_predictions(
    pred_coords: np.ndarray,   # (B, L, 2)
    pred_logits: np.ndarray,   # (B, L, C)
    max_keypoints: Optional[int] = None,
) -> List[np.ndarray]:
    """Predicted-structure extraction: argmax token types select coords."""
    labels = pred_logits.argmax(-1)
    return extract_keypoints_from_sequence(pred_coords, labels,
                                           max_keypoints=max_keypoints)


def compare_pred_gt_keypoints(pred: np.ndarray, gt: np.ndarray,
                              atol: float = 1e-6) -> bool:
    """Leak detector (`util/sequence_utils.py:88-120`): autoregressive
    predictions must never be bit-identical to ground truth. Returns True
    (and warns) when identical."""
    pred = np.asarray(pred)
    gt = np.asarray(gt)
    if pred.shape != gt.shape:
        return False
    identical = np.allclose(pred, gt, atol=atol)
    if identical:
        warnings.warn(
            "Predicted keypoints are IDENTICAL to ground truth — data "
            "leakage or teacher forcing in the eval path.",
            RuntimeWarning,
        )
    return bool(identical)
