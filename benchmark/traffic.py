"""The one traffic generator: it reads a mix's parameters (a
`traffic/<name>.json`) and makes, from the seed, the pools a driver
cycles through. Every seed gets the same multiset of sizes, keypoint
counts and crops, so that seeds change the values and not the work.

`keypoints` is a multiset of keypoint counts, [count, times] pairs.

- `serve`: raw RGB images of the listed sizes, and requests of `batch`
  images of one category, each with a crop of `bbox_frac` of each side and
  a one-shot prototype of a keypoint count from `keypoints`, with a
  skeleton;
- `train`: micro-batches of `episodes` x `queries` images at the model's
  size, 1-shot supports of counts from `keypoints` and tokenized targets;
- `eval`: episode batches of `batch` images whose episodes share one
  category and so one keypoint count, from `keypoints` in an order that
  spreads each count evenly and is the same for every seed.

Each kind's driver (`kinds/<kind>.py`) calls its generator here.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from reference.data import tokenize


def _blocky(rng, h: int, w: int, block: int) -> np.ndarray:
    """A uint8 RGB image of random `block`-pixel cells."""
    small = rng.integers(0, 256, ((h + block - 1) // block,
                                  (w + block - 1) // block, 3), np.uint8)
    return np.repeat(np.repeat(small, block, 0), block, 1)[:h, :w]


def _spread(values, n: int, rng) -> List:
    """`n` values cycling through `values`, in a seeded order."""
    out = [values[i % len(values)] for i in range(n)]
    return [out[i] for i in rng.permutation(n)]


def _layout(rng, n: int) -> np.ndarray:
    """`n` keypoints in [0.1, 0.9]^2."""
    return rng.uniform(0.1, 0.9, (n, 2)).astype(np.float32)


def _skeleton(rng, n: int, max_edges: int) -> List[List[int]]:
    """A chain over the keypoints plus a few random chords."""
    edges = [[i, i + 1] for i in range(n - 1)]
    for _ in range(n // 4):
        a, b = rng.integers(0, n, 2)
        if a != b:
            edges.append([int(a), int(b)])
    return edges[:max_edges]


def _support(rng, n: int, c: Dict):
    """(coords (K, 2), mask (K,), edges (E, 2)) of a 1-shot support of
    `n` keypoints, padded to the configuration's sizes."""
    K, E = c["max_support_keypoints"], c["max_skeleton_edges"]
    coords = np.zeros((K, 2), np.float32)
    coords[:n] = _layout(rng, n)
    mask = np.ones((K,), bool)
    mask[:n] = False
    edges = np.full((E, 2), -1, np.int32)
    sk = _skeleton(rng, n, E)
    edges[:len(sk)] = sk
    return coords, mask, edges


def _even(multiset) -> List[int]:
    """[value, times] pairs as one sequence in which every prefix holds
    each value in its share, the same for every seed, so that a window
    that ends inside the pool's cycle meets the mix's work."""
    total = sum(int(k) for _, k in multiset)
    used = [0] * len(multiset)
    out = []
    for i in range(total):
        j = max(range(len(multiset)),
                key=lambda j: (i + 1) * multiset[j][1] / total - used[j])
        used[j] += 1
        out.append(int(multiset[j][0]))
    return out


def _counts(t: Dict) -> List[int]:
    return [int(v) for v, k in t["keypoints"] for _ in range(int(k))]


def serve(t: Dict, c: Dict, seed: int) -> Dict:
    rng = np.random.default_rng(seed)
    sizes = [tuple(s) for s in t["sizes"]]
    per = t["pool_images"] // len(sizes)
    pool = [_blocky(rng, h, w, t["block"]) for (h, w) in sizes
            for _ in range(per)]
    fracs = np.linspace(t["bbox_frac"][0], t["bbox_frac"][1],
                        t["requests"] * t["batch"])
    fw = fracs[rng.permutation(len(fracs))]
    fh = fracs[rng.permutation(len(fracs))]
    counts = _spread(_counts(t), t["requests"], rng)
    requests = []
    for r in range(t["requests"]):
        # the same number of images of each size in every request
        idx = [s * per + int(rng.integers(per))
               for s in range(len(sizes))
               for _ in range(t["batch"] // len(sizes))]
        idx = [idx[i] for i in rng.permutation(len(idx))]
        boxes = []
        for j, i in enumerate(idx):
            H, W = pool[i].shape[:2]
            bw = int(W * fw[r * t["batch"] + j])
            bh = int(H * fh[r * t["batch"] + j])
            boxes.append((int(rng.integers(0, W - bw + 1)),
                          int(rng.integers(0, H - bh + 1)), bw, bh))
        n = counts[r]
        requests.append({"images": idx, "bboxes": boxes,
                         "support": _layout(rng, n),
                         "skeleton": _skeleton(rng, n,
                                               c["max_skeleton_edges"])})
    return {"pool": pool, "requests": requests}


def _query(rng, support: np.ndarray, jitter: float, vis_zero: float):
    n = len(support)
    kp = np.clip(support + rng.normal(0, jitter, support.shape), 0.02,
                 0.98).astype(np.float32)
    vis = np.where(rng.uniform(size=n) < vis_zero, 0, 2).astype(np.int32)
    return kp, vis


def train(t: Dict, c: Dict, seed: int) -> List[Dict]:
    rng = np.random.default_rng(seed)
    S, nb, L = c["image_size"], int(np.sqrt(c["vocab_size"])), c["seq_len"]
    counts = _spread(_counts(t), t["pool"] * t["episodes"], rng)
    batches = []
    for b in range(t["pool"]):
        imgs, sc, sm, se, tg = [], [], [], [], []
        for e in range(t["episodes"]):
            n = counts[b * t["episodes"] + e]
            coords, mask, edges = _support(rng, n, c)
            for _ in range(t["queries"]):
                kp, vis = _query(rng, coords[:n], t["jitter"],
                                 t["unlabeled"])
                imgs.append(_blocky(rng, S, S, t["block"]))
                sc.append(coords)
                sm.append(mask)
                se.append(edges)
                tg.append(tokenize(kp, vis, nb, L))
        batches.append({
            "query_images": np.stack(imgs), "support_coords": np.stack(sc),
            "support_mask": np.stack(sm), "skeleton_edges": np.stack(se),
            "targets": {k: np.stack([x[k] for x in tg]) for k in tg[0]}})
    return batches


def eval_batches(t: Dict, c: Dict, seed: int) -> List[Dict]:
    rng = np.random.default_rng(seed)
    S, nb, L = c["image_size"], int(np.sqrt(c["vocab_size"])), c["seq_len"]
    K = c["max_support_keypoints"]
    counts = _even(t["keypoints"])
    out = []
    for cat, n in enumerate(counts):
        base = _layout(rng, n)
        edges = np.full((c["max_skeleton_edges"], 2), -1, np.int32)
        sk = _skeleton(rng, n, c["max_skeleton_edges"])
        edges[:len(sk)] = sk
        imgs, sc, sm, tg, vis_all, dims = [], [], [], [], [], []
        for _ in range(t["batch"]):
            coords = np.zeros((K, 2), np.float32)
            coords[:n] = np.clip(base + rng.normal(0, t["jitter"], base.shape),
                                 0.02, 0.98)
            mask = np.ones((K,), bool)
            mask[:n] = False
            kp, vis = _query(rng, base, t["jitter"], t["unlabeled"])
            v = np.zeros((K,), np.int32)
            v[:n] = vis
            imgs.append(_blocky(rng, S, S, t["block"]))
            sc.append(coords)
            sm.append(mask)
            tg.append(tokenize(kp, vis, nb, L))
            vis_all.append(v)
            dims.append(rng.uniform(t["bbox_px"][0], t["bbox_px"][1], 2))
        B = t["batch"]
        out.append({
            "query_images": np.stack(imgs), "support_coords": np.stack(sc),
            "support_mask": np.stack(sm),
            "skeleton_edges": np.repeat(edges[None], B, 0),
            "targets": {k: np.stack([x[k] for x in tg]) for k in tg[0]},
            "category_ids": np.full((B,), cat, np.int32),
            "bbox_dims": np.asarray(dims, np.float32),
            "gt_visibility": np.stack(vis_all),
            "num_keypoints": np.full((B,), n, np.int32),
            "sample_valid": np.ones((B,), bool)})
    return out
