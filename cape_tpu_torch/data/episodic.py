"""Episodic sampling + fixed-shape batch assembly, the port of
`cape_tpu.data.episodic` (pure numpy, the same draws in the same order,
so the same seed gives byte-equal batches in both packages).

A host-side sampler produces **static-shape numpy batches** (support
keypoints padded to `max_support_keypoints`, skeleton edges padded to
`max_skeleton_edges` with -1), so every batch runs at one shape.

Semantics preserved from the reference:
- category -> image-index map from each image's first annotation
  (`episodic_sampler.py:49-60`)
- categories need >= support+queries examples (`:61-91`)
- episode = 1 category, K supports + Q queries sampled without replacement
  (`:94-110`)
- support coords normalized to [0,1] by post-transform image dims, mask
  True where visibility == 0 i.e. True = ignore (`:263-284`)
- K-shot aggregation: mean over support coords, `any` over masks; aggregated
  support repeated per query so support[i] aligns with query[i] (`:434-471`)
- retry-on-ImageNotFoundError resampling (`:234-371`)
- fixed pre-generated episode lists for stable val curves (`:162-170`)
"""

from __future__ import annotations

import json
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from .mp100 import ImageNotFoundError, MP100Dataset


class EpisodicSampler:
    """Samples (category, support indices, query indices) episodes."""

    def __init__(
        self,
        dataset: MP100Dataset,
        category_split_file: str,
        split: str = "train",
        num_queries: int = 2,
        num_support: int = 1,
        overfit_category: int = -1,
        single_image: bool = False,
    ):
        """`overfit_category`/`single_image` implement the reference's debug
        overfit mode (`train_cape_episodic.py:120-126`,
        `episodic_sampler.py:185-233`): restrict episodes to one category,
        optionally reusing ONE image as both support and query (the
        single-image overfit acceptance test, README.md:212-214)."""
        self.dataset = dataset
        self.num_queries = num_queries
        self.num_support = num_support
        self.single_image = single_image
        if overfit_category >= 0:
            requested = [overfit_category]
        else:
            with open(category_split_file) as f:
                splits = json.load(f)
            if split not in splits:
                raise ValueError(
                    f"Unknown split {split!r}; file has {list(splits)}"
                )
            requested = list(splits[split])

        cat_to_idx = defaultdict(list)
        for idx, img_id in enumerate(dataset.ids):
            anns = dataset.coco.load_anns(img_id)
            if anns:
                cid = anns[0].get("category_id", 0)
                if cid in requested:
                    cat_to_idx[cid].append(idx)
        min_examples = 1 if single_image else (num_queries + num_support)
        self.category_to_indices = dict(cat_to_idx)
        self.categories = [
            c for c in requested if len(cat_to_idx.get(c, ())) >= min_examples
        ]
        if not self.categories:
            raise ValueError(
                f"No category in split {split!r} has >= {min_examples} examples"
            )

    def sample_episode(self, rng: np.random.Generator) -> Dict:
        cid = self.categories[int(rng.integers(len(self.categories)))]
        pool = self.category_to_indices[cid]
        if self.single_image:
            idx = pool[int(rng.integers(len(pool)))] if len(pool) > 1 else pool[0]
            return {
                "category_id": cid,
                "support_indices": [idx] * self.num_support,
                "query_indices": [idx] * self.num_queries,
            }
        picks = rng.choice(len(pool), size=self.num_support + self.num_queries, replace=False)
        idxs = [pool[int(i)] for i in picks]
        return {
            "category_id": cid,
            "support_indices": idxs[: self.num_support],
            "query_indices": idxs[self.num_support :],
        }

    def fixed_episodes(self, n: int, seed: int) -> List[Dict]:
        rng = np.random.default_rng(seed)
        return [self.sample_episode(rng) for _ in range(n)]


def load_episode(
    dataset: MP100Dataset,
    episode: Dict,
    rng: np.random.Generator,
    max_retries: int = 100,
    sampler: Optional[EpisodicSampler] = None,
) -> Dict:
    """Load all records for an episode, resampling on bad images."""
    for _ in range(max_retries):
        try:
            supports = [dataset.get_record(i, rng) for i in episode["support_indices"]]
            queries = [dataset.get_record(i, rng) for i in episode["query_indices"]]
            return {
                "category_id": episode["category_id"],
                "supports": supports,
                "queries": queries,
            }
        except ImageNotFoundError:
            if sampler is None:
                raise
            episode = sampler.sample_episode(rng)
    raise RuntimeError(f"No valid episode after {max_retries} retries")


def collate_episodes(
    episodes: Sequence[Dict],
    image_size: int,
    max_support_keypoints: int,
    max_skeleton_edges: int,
) -> Dict[str, np.ndarray]:
    """Assemble loaded episodes into one fixed-shape numpy batch.

    Returns dict with leading dim B = num_episodes * queries_per_episode:
        query_images    (B, S, S, 3) uint8 (uint8_images datasets; device
                        normalizes) or float32 (host-normalized)
        support_coords  (B, MAXK, 2) float32, [0,1], K-shot mean-pooled
        support_mask    (B, MAXK) bool, True = invalid/ignore
        skeleton_edges  (B, MAXE, 2) int32, -1 padded
        targets         dict of (B, L[, 2]) arrays (tokenizer contract)
        category_ids    (B,) int32
        bbox_dims       (B, 2) float32 — original (w, h) pixels
        gt_visibility   (B, MAXK) int32 — query keypoint visibility
        num_keypoints   (B,) int32 — per-query category keypoint count
        sample_valid    (B,) bool — False for episodes that only pad the
                        batch to a fixed size (excluded from PCK)
    """
    q_images, tgt_lists = [], defaultdict(list)
    sc_list, sm_list, sk_list = [], [], []
    cids, bdims, vis_list, nkpts, valids = [], [], [], [], []

    for ep in episodes:
        supports, queries = ep["supports"], ep["queries"]
        # per-support padded coords/mask
        coords = np.zeros((len(supports), max_support_keypoints, 2), np.float32)
        masks = np.ones((len(supports), max_support_keypoints), bool)
        for si, s in enumerate(supports):
            n = min(s["num_keypoints"], max_support_keypoints)
            c = np.asarray(s["keypoints"][:n], np.float32) / float(image_size)
            coords[si, :n] = np.clip(c, 0.0, 1.0)
            masks[si, :n] = np.asarray(s["visibility"][:n]) == 0
        agg_coords = coords.mean(axis=0)
        agg_mask = masks.any(axis=0)

        # first support's skeleton, -1 padded (`episodic_sampler.py:461-465`)
        edges = np.full((max_skeleton_edges, 2), -1, np.int32)
        raw = supports[0]["skeleton"][:max_skeleton_edges]
        if raw:
            edges[: len(raw)] = np.asarray(raw, np.int32)

        for q in queries:
            q_images.append(q["image"])
            for k, v in q["seq_data"].items():
                tgt_lists[k].append(v)
            sc_list.append(agg_coords)
            sm_list.append(agg_mask)
            sk_list.append(edges)
            cids.append(ep["category_id"])
            bdims.append([q["bbox_width"], q["bbox_height"]])
            v = np.zeros((max_support_keypoints,), np.int32)
            n = min(q["num_keypoints"], max_support_keypoints)
            v[:n] = np.asarray(q["visibility"][:n], np.int32)
            vis_list.append(v)
            nkpts.append(q["num_keypoints"])
            valids.append(ep.get("valid", True))

    return {
        "query_images": np.stack(q_images),
        "support_coords": np.stack(sc_list),
        "support_mask": np.stack(sm_list),
        "skeleton_edges": np.stack(sk_list),
        "targets": {k: np.stack(v) for k, v in tgt_lists.items()},
        "category_ids": np.asarray(cids, np.int32),
        "bbox_dims": np.asarray(bdims, np.float32),
        "gt_visibility": np.stack(vis_list),
        "num_keypoints": np.asarray(nkpts, np.int32),
        "sample_valid": np.asarray(valids, bool),
    }


def validate_episode_batch(batch: Dict[str, np.ndarray]) -> None:
    """Host-side episodic-structure validation before the step.

    Parity with the reference's model-entry batch-shape checks
    (`cape_model.py:99-117`): every leading dim must be the same B
    (support[i] aligned with query[i] — the 1-shot episodic contract), the
    support mask must be boolean, coords (B, K, 2), edges (B, E, 2).
    Raises ValueError with the offending key.
    """
    b = batch["query_images"].shape[0]
    for key in ("support_coords", "support_mask", "skeleton_edges",
                "category_ids", "bbox_dims", "gt_visibility",
                "num_keypoints"):
        if key in batch and batch[key].shape[0] != b:
            raise ValueError(
                f"Support-Query batch mismatch: {key} has leading dim "
                f"{batch[key].shape[0]} but query_images has {b}. This "
                f"breaks the episodic support[i]<->query[i] alignment "
                f"(collate must repeat support per query)."
            )
    for key, v in batch["targets"].items():
        if v.shape[0] != b:
            raise ValueError(
                f"targets[{key!r}] leading dim {v.shape[0]} != batch {b}")
    if batch["support_mask"].dtype != np.bool_:
        raise ValueError(
            f"support_mask must be bool (True = ignore), got "
            f"{batch['support_mask'].dtype}")
    if batch["support_coords"].ndim != 3 or batch["support_coords"].shape[-1] != 2:
        raise ValueError(
            f"support_coords must be (B, K, 2), got "
            f"{batch['support_coords'].shape}")
    if batch["skeleton_edges"].ndim != 3 or batch["skeleton_edges"].shape[-1] != 2:
        raise ValueError(
            f"skeleton_edges must be (B, E, 2), got "
            f"{batch['skeleton_edges'].shape}")


def eval_batch_plan(num_episodes: int, eval_batch_size: int):
    """(batch_episodes, num_batches) for scoring exactly `num_episodes`.

    One place for the clamp + ceil-div every eval caller needs; pass the
    same `num_episodes` as `total_episodes` to `episode_batches` so the
    tail batch's padding rows are flagged invalid.
    """
    b = max(1, min(eval_batch_size, num_episodes))
    return b, -(-num_episodes // b)


def episode_batches(
    dataset: MP100Dataset,
    sampler: EpisodicSampler,
    batch_episodes: int,
    num_batches: int,
    image_size: int,
    max_support_keypoints: int,
    max_skeleton_edges: int,
    rng: np.random.Generator,
    fixed: Optional[List[Dict]] = None,
    num_threads: int = 1,
    total_episodes: Optional[int] = None,
    support_coord_noise: float = 0.0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield `num_batches` fixed-shape episode batches.

    With `fixed`, iterates a pre-generated episode list (stable validation);
    episodes past the end of the list (the tail batch padding to the static
    batch size) are re-wrapped and flagged `valid=False` so the evaluator
    skips them and each fixed episode scores exactly once.

    `total_episodes` caps the VALID episode count on the random-sampling
    path too: episodes beyond it (tail-batch padding) are generated but
    flagged invalid, so `num_batches * batch_episodes` can exceed the
    configured protocol without silently scoring extra episodes.

    `support_coord_noise > 0` perturbs every support's keypoint
    coordinates with i.i.d. Gaussian noise (std in normalized [0,1]
    units, drawn from the episode's child rng — deterministic per seed)
    BEFORE the K-shot mean-pool in `collate_episodes`. This is the
    controlled probe of the reference's K-shot premise (mean over K
    supports denoises the prototype at sigma/sqrt(K),
    `episodic_sampler.py:434-442`): with noisy supports, 5-shot recovers
    the layout 1-shot cannot. Eval-only knob (cli/evaluate
    --support_coord_noise); 0.0 = off, no behavior change.

    `num_threads > 1` loads the batch's episodes on a thread pool — the PNG
    decode and the resize release the GIL, so this is the
    DataLoader-workers replacement. Episode
    SAMPLING stays sequential on the parent `rng`; each episode then loads
    from a child generator seeded by integers DRAWN from the parent stream
    (never `rng.spawn()`: the spawn counter lives outside
    `bit_generator.state`, so spawned streams would not survive the
    checkpointed-RNG exact-resume contract). Batches are therefore
    deterministic for a given seed regardless of thread scheduling and
    identical to the single-thread path.
    """
    pool = (ThreadPoolExecutor(max_workers=num_threads)
            if num_threads > 1 else None)
    try:
        ep_idx = 0
        for _ in range(num_batches):
            specs = []
            for _ in range(batch_episodes):
                if fixed is not None:
                    episode = fixed[ep_idx % len(fixed)]
                    cap = (len(fixed) if total_episodes is None
                           else min(total_episodes, len(fixed)))
                else:
                    episode = sampler.sample_episode(rng)
                    cap = total_episodes
                valid = cap is None or ep_idx < cap
                ep_idx += 1
                child = np.random.default_rng(
                    rng.integers(0, 2**63 - 1, size=4))
                specs.append((episode, valid, child))

            def load(spec):
                episode, valid, child = spec
                loaded = load_episode(dataset, episode, child,
                                      sampler=sampler)
                loaded["valid"] = valid
                if support_coord_noise > 0.0:
                    # copy before perturbing: records may be shared via
                    # the dataset's decode cache
                    noisy = []
                    for s in loaded["supports"]:
                        s = dict(s)
                        kp = np.asarray(s["keypoints"], np.float32).copy()
                        kp += child.normal(
                            0.0, support_coord_noise * image_size,
                            size=kp.shape).astype(np.float32)
                        s["keypoints"] = kp
                        noisy.append(s)
                    loaded["supports"] = noisy
                return loaded

            eps = list(pool.map(load, specs) if pool
                       else map(load, specs))
            yield collate_episodes(
                eps, image_size, max_support_keypoints, max_skeleton_edges
            )
    finally:
        if pool:
            pool.shutdown(wait=False)
