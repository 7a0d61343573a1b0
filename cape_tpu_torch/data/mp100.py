"""MP-100 CAPE dataset: per-instance record loading on the host, the port
of `cape_tpu.data.mp100`.

Numpy end to end; the batches become tensors only at the device boundary
(`data.prefetch.to_device`). Semantics of the reference `MP100CAPE`
(`datasets/mp100_cape.py:74-832`), as the JAX package keeps them:

- first annotated instance only (`mp100_cape.py:309-327`)
- crop to bbox, shift keypoints into the bbox frame (`:332-349`)
- keep ALL keypoints incl. invisible to preserve skeleton index
  correspondence (`:353-392`)
- train augmentation (`data.augment.train_augment`, which requires cv2)
  / deterministic val resize (`:898-946`)
- image -> float32 / 255 (+ optional ImageNet normalization) (`:437-444`),
  or uint8 records normalised on the device (`uint8_images`)
- bilinear 4-corner tokenization (`:625-832`, see tokenizer.py)
- missing files / empty annotations raise `ImageNotFoundError` so the
  episodic sampler can resample (`:229, 422-425`); a file that no
  installed decoder can read raises `RuntimeError` instead
  (`data.image.decode_rgb`), so it is never resampled away in silence
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np

from .augment import resize_with_keypoints, train_augment
from .coco import COCOIndex
from .image import decode_rgb
from .tokenizer import DiscreteTokenizer, tokenize_keypoints

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def image_to_uint8(img: "np.ndarray") -> "np.ndarray":
    """Record image -> displayable uint8 RGB: uint8 passthrough
    (`uint8_images` records), float assumed [0,1]."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img
    return np.clip(img * 255.0, 0, 255).astype(np.uint8)


class ImageNotFoundError(Exception):
    """Raised for missing/invalid samples; triggers sampler retry."""


class _LRUBytes:
    """Tiny byte-budgeted LRU, safe under the loader thread pool (values
    are immutable-by-convention; a lock keeps the byte accounting exact)."""

    def __init__(self, budget_mb: int):
        self.budget = int(budget_mb) * (1 << 20)
        self.bytes = 0
        self.d = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key):
        with self._lock:
            v = self.d.get(key)
            if v is None:
                return None
            self.d.move_to_end(key)
            return v[0]

    def put(self, key, value, nbytes: int):
        if self.budget <= 0 or nbytes > self.budget:
            return
        with self._lock:
            old = self.d.pop(key, None)
            if old is not None:
                self.bytes -= old[1]
            self.d[key] = (value, nbytes)
            self.bytes += nbytes
            while self.bytes > self.budget and self.d:
                _, (_, n) = self.d.popitem(last=False)
                self.bytes -= n


def clamp_bbox(bbox, width: int, height: int):
    """Clamp a COCO (x, y, w, h) box into a width x height image.

    Returns int (x, y, w, h); raises ValueError when the clamped box is
    empty (shared by the dataset crop and the serving API).
    """
    bx, by, bw, bh = bbox
    bx = max(0, int(bx))
    by = max(0, int(by))
    bw = min(int(bw), width - bx)
    bh = min(int(bh), height - by)
    if bw <= 0 or bh <= 0:
        raise ValueError(f"empty bbox crop {tuple(bbox)} on {width}x{height}")
    return bx, by, bw, bh


class MP100Dataset:
    """COCO-format MP-100 loader producing numpy records.

    Args:
        img_folder: image root directory.
        ann_file: COCO annotation JSON path (or pre-parsed dict).
        tokenizer: DiscreteTokenizer instance shared with the model.
        image_size: output square size (reference resizes to 512).
        split: 'train' enables augmentation; others resize only.
        image_norm: apply ImageNet mean/std after /255.
        uint8_images: keep records as uint8 — /255 (+ image_norm) happens
            on device inside the model (`CAPE.encode_image`), quartering
            the host->device transfer and the record-cache footprint.
    """

    def __init__(
        self,
        img_folder: str,
        ann_file,
        tokenizer: DiscreteTokenizer,
        image_size: int = 512,
        split: str = "train",
        image_norm: bool = False,
        augment: Optional[bool] = None,
        cache_mb: int = 1024,
        uint8_images: bool = False,
    ):
        self.root = img_folder
        self.coco = COCOIndex(ann_file)
        self.ids = self.coco.get_img_ids()
        self.tokenizer = tokenizer
        self.image_size = image_size
        self.split = split
        self.image_norm = image_norm
        self.uint8_images = uint8_images
        self.augment = augment if augment is not None else (split == "train")
        # host-pipeline caches (episodic sampling revisits the same images):
        # - crop cache: decoded uint8 bbox crop + shifted keypoints; skips
        #   file read + PNG decode + crop on reuse (augment still runs)
        # - record cache (deterministic no-augment path only): the final
        #   record; fixed-episode validation costs ~zero host work after
        #   its first epoch. Returned arrays are READ-ONLY by convention:
        #   copy before writing (`to_device` copies them into tensors).
        self._crop_cache = _LRUBytes(cache_mb)
        self._record_cache = _LRUBytes(cache_mb)

    def __len__(self) -> int:
        return len(self.ids)

    # ------------------------------------------------------------------
    def get_record(self, index: int, rng: Optional[np.random.Generator] = None) -> Dict:
        """Load one instance record.

        Returns dict with: image (S,S,3) float32 (uint8 with
        `uint8_images`), keypoints (N,2) float64 in resized-image pixels,
        visibility (N,), category_id, skeleton (0-indexed edge list),
        bbox_width/height (original pixels), num_keypoints, image_id,
        seq_data (tokenized target dict). `rng` draws the augmentation
        (a fresh unseeded generator when None, as in the JAX package).
        """
        rng = rng or np.random.default_rng()
        img_id = self.ids[index]

        if not self.augment:
            cached = self._record_cache.get(img_id)
            if cached is not None:
                return dict(cached)  # shallow copy; arrays are read-only

        crop, keypoints, visibility, ann, bw, bh = self._load_crop(img_id)
        keypoints = keypoints.copy()  # cached array must stay pristine

        if self.augment:
            crop, keypoints = train_augment(crop, keypoints, self.image_size,
                                            rng)
        else:
            crop, keypoints = resize_with_keypoints(crop, keypoints,
                                                    self.image_size)

        if self.uint8_images:
            image = crop  # device normalizes (CAPE.encode_image)
        else:
            image = crop.astype(np.float32) / 255.0
            if self.image_norm:
                image = (image - IMAGENET_MEAN) / IMAGENET_STD

        category_id = ann.get("category_id", 0)
        seq_data = tokenize_keypoints(
            self.tokenizer,
            keypoints,
            height=self.image_size,
            width=self.image_size,
            visibility=visibility,
            category_id=category_id,
        )

        # keypoint/visibility/category alignment guard (`mp100_cape.py:465-491`)
        expected = self.coco.category_num_keypoints(category_id)
        if expected is not None and len(keypoints) != expected:
            raise ImageNotFoundError(
                f"Image {img_id}: {len(keypoints)} keypoints != category "
                f"{category_id} expectation {expected}"
            )

        record = {
            "image": image,
            "keypoints": keypoints,
            "visibility": visibility,
            "category_id": category_id,
            "skeleton": self.coco.category_skeleton(category_id),
            "bbox_width": float(bw),
            "bbox_height": float(bh),
            "num_keypoints": len(keypoints),
            "image_id": img_id,
            "seq_data": seq_data,
        }
        if not self.augment:
            self._record_cache.put(img_id, dict(record), image.nbytes)
        return record

    # ------------------------------------------------------------------
    def _load_crop(self, img_id: int):
        """Decode + bbox-crop one image (LRU cached — PNG decode dominates
        the per-record host cost; episodic sampling revisits images)."""
        cached = self._crop_cache.get(img_id)
        if cached is not None:
            return cached

        info = self.coco.load_img(img_id)
        path = os.path.join(self.root, info["file_name"])
        if not os.path.exists(path):
            raise ImageNotFoundError(f"Image not found: {path}")
        img = decode_rgb(path)
        if img is None or img.ndim != 3 or img.shape[0] == 0 or img.shape[1] == 0:
            raise ImageNotFoundError(f"Invalid image {path}")
        orig_h, orig_w = img.shape[:2]

        # first valid instance only (`mp100_cape.py:309-327`)
        ann = None
        for a in self.coco.load_anns(img_id):
            if a.get("keypoints") and "bbox" in a:
                kpts = np.asarray(a["keypoints"], dtype=np.float64).reshape(-1, 3)
                if (kpts[:, 2] > 0).any():
                    ann = a
                    break
        if ann is None:
            raise ImageNotFoundError(f"Image {img_id} has no valid annotations")

        kpts3 = np.asarray(ann["keypoints"], dtype=np.float64).reshape(-1, 3)
        visibility = kpts3[:, 2].astype(np.int32)
        keypoints = kpts3[:, :2].copy()

        try:
            bx, by, bw, bh = clamp_bbox(ann["bbox"], orig_w, orig_h)
        except ValueError:
            raise ImageNotFoundError(f"Image {img_id}: empty bbox crop")
        crop = np.ascontiguousarray(img[by : by + bh, bx : bx + bw])
        keypoints[:, 0] -= bx
        keypoints[:, 1] -= by

        entry = (crop, keypoints, visibility, ann, bw, bh)
        self._crop_cache.put(img_id, entry, crop.nbytes + keypoints.nbytes)
        return entry
