"""Minimal COCO-format annotation index (pure Python, no pycocotools): a
copy of `cape_tpu.data.coco` (the port imports nothing of `cape_tpu`).

The reference uses `pycocotools.coco.COCO` (`datasets/mp100_cape.py:100`);
that C extension is not a dependency, and MP-100 annotations are plain
JSON — a small dict-based index covers everything the pipeline needs:
images, per-image annotations, and per-category keypoint/skeleton metadata.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional


class COCOIndex:
    """Indexes a COCO-style annotation dict or JSON file."""

    def __init__(self, ann_file_or_dict):
        if isinstance(ann_file_or_dict, (str,)):
            with open(ann_file_or_dict) as f:
                data = json.load(f)
        else:
            data = ann_file_or_dict
        self.dataset = data
        self.imgs: Dict[int, dict] = {img["id"]: img for img in data.get("images", [])}
        self.cats: Dict[int, dict] = {c["id"]: c for c in data.get("categories", [])}
        self.img_to_anns: Dict[int, List[dict]] = {i: [] for i in self.imgs}
        for ann in data.get("annotations", []):
            self.img_to_anns.setdefault(ann["image_id"], []).append(ann)

    # -- pycocotools-compatible-ish accessors --------------------------
    def get_img_ids(self) -> List[int]:
        return sorted(self.imgs.keys())

    def load_img(self, img_id: int) -> dict:
        return self.imgs[img_id]

    def load_anns(self, img_id: int) -> List[dict]:
        return self.img_to_anns.get(img_id, [])

    def category_skeleton(self, category_id: int) -> List[List[int]]:
        """Skeleton edges for a category, normalized to 0-indexed.

        COCO-convention skeletons are 1-indexed (keypoint 1 = index 0; MP-100
        follows it). The reference forwards them RAW into a 0-indexed
        adjacency builder (`mp100_cape.py:494-517` ->
        `models/graph_utils.py:15-63`, whose docstring demands 0-indexed
        edges) — a systematic off-by-one in its GCN graph prior that its
        out-of-range filter quietly truncates. Per SURVEY.md §7.5 we do NOT
        replicate the bug: edges that are 1-indexed (no 0 anywhere in the
        skeleton) shift down by one here, so the adjacency connects the
        keypoints the annotation meant. Already-0-indexed skeletons (a 0
        appears) pass through unchanged.
        """
        cat = self.cats.get(category_id)
        if not cat:
            return []
        skeleton = cat.get("skeleton") or []
        edges = [[int(e[0]), int(e[1])] for e in skeleton if len(e) == 2]
        if edges and min(min(e) for e in edges) >= 1:
            edges = [[a - 1, b - 1] for a, b in edges]
        return edges

    def category_num_keypoints(self, category_id: int) -> Optional[int]:
        cat = self.cats.get(category_id)
        if not cat:
            return None
        kpts = cat.get("keypoints")
        return len(kpts) if kpts else None
