"""The deterministic resize of `cape_tpu.data.augment` (val/test and
serving path). The train-time augmentations wait for the data-pipeline
slice, with the host training loop."""

from __future__ import annotations

from typing import Tuple

import numpy as np

try:
    import cv2

    _HAS_CV2 = True
except ImportError:  # pragma: no cover
    _HAS_CV2 = False


def _resize(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize to (h, w)."""
    h, w = size
    if _HAS_CV2:
        return cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
    # numpy fallback: nearest sampling (tests only)
    ys = (np.arange(h) * img.shape[0] / h).astype(np.int64)
    xs = (np.arange(w) * img.shape[1] / w).astype(np.int64)
    return img[ys][:, xs]


def resize_with_keypoints(img, keypoints, size: int):
    """Deterministic resize (val/test path, `mp100_cape.py:943-946`)."""
    h, w = img.shape[:2]
    out = _resize(img, (size, size))
    kpts = np.asarray(keypoints, dtype=np.float64).reshape(-1, 2).copy()
    kpts[:, 0] *= size / w
    kpts[:, 1] *= size / h
    return out, kpts
