"""PCK@bbox metric — host-side numpy bookkeeping, a copy of
`cape_tpu.eval.pck` (float64 distances, so the counts are the JAX
package's to the keypoint).

Parity with `util/eval_utils.py:29-268`: visible keypoints only, distance
normalized by the bbox diagonal (default; 'max'/'mean' options), micro
(`pck_overall`) and macro (`mean_pck_categories`) aggregation with
per-category breakdown.
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional

import numpy as np


def compute_pck_bbox(
    pred_keypoints: np.ndarray,
    gt_keypoints: np.ndarray,
    bbox_width: float,
    bbox_height: float,
    visibility: Optional[np.ndarray] = None,
    threshold: float = 0.2,
    normalize_by: str = "diagonal",
):
    """Single-instance PCK. Returns (pck, num_correct, num_visible)."""
    pred = np.asarray(pred_keypoints, dtype=np.float64)
    gt = np.asarray(gt_keypoints, dtype=np.float64)
    assert pred.shape == gt.shape and pred.shape[-1] == 2, (pred.shape, gt.shape)
    n = len(pred)
    if visibility is None:
        visible = np.ones(n, bool)
    else:
        v = np.asarray(visibility).reshape(-1)
        assert len(v) == n, f"visibility {len(v)} != keypoints {n}"
        visible = v > 0
    num_visible = int(visible.sum())
    if num_visible == 0:
        return 0.0, 0, 0
    p, g = pred[visible], gt[visible]
    if np.allclose(p, g, atol=1e-6):
        warnings.warn(
            "Predictions identical to ground truth — possible data leakage "
            "(teacher forcing used instead of autoregressive inference?)",
            RuntimeWarning,
        )
    dist = normalized_distances(p, g, bbox_width, bbox_height, normalize_by)
    correct = int((dist < threshold).sum())
    return correct / num_visible, correct, num_visible


def normalized_distances(
    pred_keypoints: np.ndarray,
    gt_keypoints: np.ndarray,
    bbox_width: float,
    bbox_height: float,
    normalize_by: str = "diagonal",
) -> np.ndarray:
    """Each keypoint's distance over the bbox size, in float64: what
    `compute_pck_bbox` holds against its threshold."""
    p = np.asarray(pred_keypoints, dtype=np.float64)
    g = np.asarray(gt_keypoints, dtype=np.float64)
    dist = np.sqrt(((p - g) ** 2).sum(axis=1))
    if normalize_by == "diagonal":
        size = float(np.sqrt(bbox_width**2 + bbox_height**2))
    elif normalize_by == "max":
        size = float(max(bbox_width, bbox_height))
    elif normalize_by == "mean":
        size = float((bbox_width + bbox_height) / 2)
    else:
        raise ValueError(f"Unknown normalize_by: {normalize_by}")
    return dist / size


class PCKEvaluator:
    """Accumulates PCK across images and categories."""

    def __init__(self, threshold: float = 0.2, normalize_by: str = "diagonal"):
        self.threshold = threshold
        self.normalize_by = normalize_by
        self.reset()

    def reset(self):
        self.total_correct = 0
        self.total_visible = 0
        self.category_correct: Dict[int, int] = {}
        self.category_visible: Dict[int, int] = {}
        self.image_results = []

    def add_sample(self, pred, gt, bbox_width, bbox_height,
                   category_id: int = 0, visibility=None, image_id=None):
        pck, correct, visible = compute_pck_bbox(
            pred, gt, bbox_width, bbox_height, visibility,
            self.threshold, self.normalize_by,
        )
        self.total_correct += correct
        self.total_visible += visible
        self.category_correct[category_id] = (
            self.category_correct.get(category_id, 0) + correct
        )
        self.category_visible[category_id] = (
            self.category_visible.get(category_id, 0) + visible
        )
        self.image_results.append({
            "image_id": image_id, "category_id": category_id, "pck": pck,
            "num_correct": correct, "num_visible": visible,
        })

    def add_batch(self, pred_keypoints, gt_keypoints, bbox_widths,
                  bbox_heights, category_ids=None, visibility=None,
                  image_ids=None):
        n = len(pred_keypoints)
        for i in range(n):
            self.add_sample(
                pred_keypoints[i], gt_keypoints[i],
                float(bbox_widths[i]), float(bbox_heights[i]),
                int(category_ids[i]) if category_ids is not None else 0,
                visibility[i] if visibility is not None else None,
                image_ids[i] if image_ids is not None else None,
            )

    def get_results(self) -> Dict:
        overall = (
            self.total_correct / self.total_visible if self.total_visible else 0.0
        )
        per_cat = {
            c: (self.category_correct[c] / self.category_visible[c]
                if self.category_visible[c] else 0.0)
            for c in self.category_correct
        }
        return {
            "pck_overall": overall,
            "pck_per_category": per_cat,
            "mean_pck_categories": float(np.mean(list(per_cat.values()))) if per_cat else 0.0,
            "total_correct": self.total_correct,
            "total_visible": self.total_visible,
            "num_categories": len(per_cat),
            "num_images": len(self.image_results),
            "threshold": self.threshold,
        }
