"""Deterministic synthetic MP-100 fixture for data-free tests, the port of
`cape_tpu.data.synthetic`: the same rng draws in the same order and the
same JSONs; the PNGs are written by the port's own stdlib-`zlib` writer
(`data.image.write_png`), so the fixture can be made on a machine without
PIL or cv2, and decode to the same pixels as the JAX package's.

The reference's tests require the real MP-100 images and silently skip
without them (SURVEY.md §4). This module generates a tiny, fully-valid
MP-100-style dataset tree (COCO JSONs + PNG images + category_splits.json)
so every pipeline test runs hermetically.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from .image import write_png


def make_synthetic_mp100(
    root: str,
    num_categories: int = 6,
    images_per_category: int = 6,
    keypoint_range=(4, 8),
    image_size=(96, 128),  # (h, w)
    seed: int = 0,
    learnable: bool = False,
    num_splits: int = 1,
    num_holdout: int = 4,
    layout_jitter: float = 0.02,
    marker_style: str = "indexed",
) -> Dict[str, str]:
    """Write a synthetic MP-100 tree under `root`.

    Layout (matches the MP-100 convention `build_mp100_cape` resolves —
    images under <root>/data, annotations under <root>/annotations):
        root/data/<file>.png
        root/annotations/mp100_split{S}_{train,val,test}.json
        root/category_splits.json

    `num_splits > 1` writes additional MP-100-style folds: fold S rotates
    the category list by S-1 before the train/val/test assignment (the real
    MP-100 5-fold protocol likewise re-partitions categories per split).
    `category_splits.json` describes split 1; other folds derive theirs
    from the annotation JSONs (`cape_tpu_torch.data.builder.resolve_split_file`
    fallback), exactly like the k-fold scripts expect.

    Categories are split train/val/test (mirroring category_splits.json in
    the reference); every category appears in exactly one meta-split, and
    each split's annotation JSON contains only its categories' images (the
    reference ships one JSON per split too).

    With `learnable=True` the task carries real signal instead of noise:
    keypoints sit at category-consistent relative positions inside the bbox
    (plus per-image Gaussian `layout_jitter`, in bbox-relative units) and
    each keypoint index is drawn as a distinctive colored disc on the image
    — so a model can localize keypoints visually and generalize to unseen
    categories, enabling end-to-end PCK training demos without the real
    MP-100. Raising `layout_jitter` gives the K-shot protocol a real
    signal: each support's coordinates are a noisy draw around the
    category layout, so mean-pooling K supports (the reference collate,
    `episodic_sampler.py:434-442`) denoises the prototype by ~1/sqrt(K)
    and 5-shot measurably beats 1-shot (the reference's core K-shot claim,
    `README.md:466-472`).

    `marker_style` controls whether keypoint IDENTITY is visually
    recoverable from the query image alone (learnable mode only):
      - 'indexed' (default): keypoint index i is always drawn in color
        kpt_colors[i], shared across categories — identity is readable
        off the image, so a trained model can IGNORE the support prior
        entirely (measured: PCK invariant to support-coordinate noise,
        PERF.md round 5). Good for localization demos, useless for
        K-shot ones.
      - 'uniform': every keypoint is the same fixed bright disc — the
        image reveals WHERE keypoints are but not WHICH, so index
        assignment must come from the support layout. This is the
        honest miniature of the real CAPE task (support = the only
        source of category structure) and the fixture on which the
        mean-pool K-shot claim is demonstrable.

    Returns dict with paths: {'root', 'train_ann', 'val_ann', 'test_ann',
    'split_file', 'img_dir'}.
    """
    rng = np.random.default_rng(seed)
    h, w = image_size
    img_dir = os.path.join(root, "data")
    ann_dir = os.path.join(root, "annotations")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)

    # per-keypoint-index marker colors, shared across categories (learnable
    # mode): index i is always drawn in color _KPT_COLORS[i]
    if marker_style not in ("indexed", "uniform"):
        raise ValueError(f"marker_style={marker_style!r}: 'indexed'|'uniform'")
    max_k = keypoint_range[1]
    # always draw from the stream so 'indexed' and 'uniform' fixtures share
    # identical layouts/bboxes for a given seed (controlled comparison)
    kpt_colors = (rng.integers(60, 256, size=(max_k, 3))).astype(np.int32)
    if marker_style == "uniform":
        kpt_colors = np.full((max_k, 3), 235, np.int32)

    categories = []
    cat_layouts = {}
    for cid in range(1, num_categories + 1):
        n_kpts = int(rng.integers(keypoint_range[0], keypoint_range[1] + 1))
        # chain skeleton, 1-indexed like real MP-100 COCO files
        skeleton = [[i, i + 1] for i in range(1, n_kpts)]
        categories.append(
            {
                "id": cid,
                "name": f"synth_cat_{cid}",
                "keypoints": [f"kp{i}" for i in range(n_kpts)],
                "skeleton": skeleton,
            }
        )
        # category-consistent relative layout within the bbox
        cat_layouts[cid] = rng.uniform(0.12, 0.88, size=(n_kpts, 2))

    # meta-split: >=2 categories each for episodic sampling. `num_holdout`
    # categories split evenly between val and test (scaled fixtures want
    # more than the default 2+2 for stable unseen-category PCK).
    n_train = max(2, num_categories - num_holdout)
    n_val = max(1, (num_categories - n_train) // 2)
    cat_ids = [c["id"] for c in categories]
    split_map = {
        "train": cat_ids[:n_train],
        "val": cat_ids[n_train : n_train + n_val],
        "test": cat_ids[n_train + n_val :],
    }

    img_id = 0
    ann_id = 0
    per_cat: Dict[int, dict] = {
        c["id"]: {"images": [], "annotations": []} for c in categories
    }

    for cat in categories:
        n_kpts = len(cat["keypoints"])
        for _ in range(images_per_category):
            img_id += 1
            fname = f"img_{img_id:04d}.png"

            # bbox inside the image with margin
            bw = int(rng.integers(w // 2, w - 8))
            bh = int(rng.integers(h // 2, h - 8))
            bx = int(rng.integers(0, w - bw))
            by = int(rng.integers(0, h - bh))
            if learnable:
                rel = cat_layouts[cat["id"]]
                jitter = rng.normal(0, layout_jitter, size=rel.shape)
                rel_j = np.clip(rel + jitter, 0.02, 0.98)
                kx = bx + rel_j[:, 0] * bw
                ky = by + rel_j[:, 1] * bh
                vis = np.full(n_kpts, 2, np.int64)
                arr = rng.integers(20, 90, size=(h, w, 3), dtype=np.uint8)
                yy, xx = np.mgrid[0:h, 0:w]
                for i in range(n_kpts):
                    d2 = (xx - kx[i]) ** 2 + (yy - ky[i]) ** 2
                    mask = d2 <= 3.0**2
                    arr[mask] = kpt_colors[i]
            else:
                kx = rng.uniform(bx + 1, bx + bw - 1, size=n_kpts)
                ky = rng.uniform(by + 1, by + bh - 1, size=n_kpts)
                vis = rng.choice([0, 1, 2], size=n_kpts, p=[0.1, 0.2, 0.7])
                if (vis > 0).sum() == 0:
                    vis[0] = 2
                arr = rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)
            write_png(os.path.join(img_dir, fname), arr)
            flat = []
            for x, y, v in zip(kx, ky, vis):
                flat += [float(x), float(y), int(v)]

            ann_id += 1
            per_cat[cat["id"]]["images"].append(
                {"id": img_id, "file_name": fname, "height": h, "width": w}
            )
            per_cat[cat["id"]]["annotations"].append(
                {
                    "id": ann_id,
                    "image_id": img_id,
                    "category_id": cat["id"],
                    "bbox": [bx, by, bw, bh],
                    "keypoints": flat,
                    "num_keypoints": int((vis > 0).sum()),
                    "iscrowd": 0,
                    "area": bw * bh,
                }
            )

    paths = {"root": root, "img_dir": img_dir}
    for split_num in range(1, num_splits + 1):
        rotated = cat_ids[split_num - 1:] + cat_ids[: split_num - 1]
        fold_map = {
            "train": rotated[:n_train],
            "val": rotated[n_train : n_train + n_val],
            "test": rotated[n_train + n_val :],
        }
        for s in ("train", "val", "test"):
            doc = {"images": [], "annotations": [], "categories": categories}
            for cid in fold_map[s]:
                doc["images"].extend(per_cat[cid]["images"])
                doc["annotations"].extend(per_cat[cid]["annotations"])
            p = os.path.join(ann_dir, f"mp100_split{split_num}_{s}.json")
            with open(p, "w") as f:
                json.dump(doc, f)
            if split_num == 1:
                paths[f"{s}_ann"] = p

    split_file = os.path.join(root, "category_splits.json")
    with open(split_file, "w") as f:
        json.dump(split_map, f)
    paths["split_file"] = split_file
    return paths
