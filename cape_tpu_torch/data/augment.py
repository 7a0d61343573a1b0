"""The deterministic resize of `cape_tpu.data.augment` (val/test and
serving path), through `data.image.resize`: cv2's bilinear resize where
cv2 is installed, the port's own bilinear resize elsewhere. The train-time
augmentations wait for the host training loop."""

from __future__ import annotations

import numpy as np

from .image import resize


def resize_with_keypoints(img, keypoints, size: int):
    """Deterministic resize (val/test path, `mp100_cape.py:943-946`)."""
    h, w = img.shape[:2]
    out = resize(img, (size, size))
    kpts = np.asarray(keypoints, dtype=np.float64).reshape(-1, 2).copy()
    kpts[:, 0] *= size / w
    kpts[:, 1] *= size / h
    return out, kpts
