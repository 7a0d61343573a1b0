"""MP-100 official split utilities, the port of `cape_tpu.data.splits`.

Parity with `datasets/mp100_splits.py:6-94`: derive train/test category
lists directly from the per-split annotation JSONs, verify disjointness,
and (new) synthesize a 3-way category_splits.json-style dict by carving a
validation set out of the train categories — so all 5 folds run even though
the reference ships a hand-made category_splits.json only for split 1.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

from .builder import resolve_annotation_file


def load_mp100_split(dataset_root: str, split_id: int = 1) -> Dict:
    """Category ids for one official split, with disjointness check."""
    cats = {}
    for image_set in ("train", "test"):
        path = resolve_annotation_file(dataset_root, split_id, image_set)
        with open(path) as f:
            data = json.load(f)
        cats[image_set] = sorted(c["id"] for c in data["categories"])
    overlap = set(cats["train"]) & set(cats["test"])
    if overlap:
        raise ValueError(
            f"MP-100 split {split_id}: {len(overlap)} overlapping categories "
            f"between train and test — official splits must be disjoint."
        )
    return {
        "train": cats["train"],
        "test": cats["test"],
        "split_id": split_id,
        "train_count": len(cats["train"]),
        "test_count": len(cats["test"]),
        "total_categories": len(cats["train"]) + len(cats["test"]),
    }


def get_all_mp100_splits(dataset_root: str) -> List[Dict]:
    return [load_mp100_split(dataset_root, i) for i in range(1, 6)]


def make_category_split_file(
    dataset_root: str,
    split_id: int,
    out_path: str,
    val_fraction: float = 0.125,
    seed: int = 0,
) -> str:
    """Write a 3-way {train,val,test} category split JSON for a fold.

    The reference's `category_splits.json` (69/10/20 categories) exists only
    for split 1; for other folds this carves `val_fraction` of the train
    categories into a validation meta-split deterministically.
    """
    import numpy as np

    info = load_mp100_split(dataset_root, split_id)
    train = list(info["train"])
    rng = np.random.default_rng(seed)
    n_val = max(1, int(round(len(train) * val_fraction)))
    val_idx = set(rng.choice(len(train), size=n_val, replace=False).tolist())
    split = {
        "train": [c for i, c in enumerate(train) if i not in val_idx],
        "val": [c for i, c in enumerate(train) if i in val_idx],
        "test": info["test"],
    }
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(split, f, indent=2)
    return out_path
