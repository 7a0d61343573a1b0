"""Serving-path pieces of `cape_tpu.data.mp100`: the ImageNet constants
and the bbox clamp shared by the dataset crop and the serving API."""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def clamp_bbox(bbox, width: int, height: int):
    """Clamp a COCO (x, y, w, h) box into a width x height image.

    Returns int (x, y, w, h); raises ValueError when the clamped box is
    empty.
    """
    bx, by, bw, bh = bbox
    bx = max(0, int(bx))
    by = max(0, int(by))
    bw = min(int(bw), width - bx)
    bh = min(int(bh), height - by)
    if bw <= 0 or bh <= 0:
        raise ValueError(f"empty bbox crop {tuple(bbox)} on {width}x{height}")
    return bx, by, bw, bh
