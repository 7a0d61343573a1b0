"""Prediction visualization CLI — Support | GT | Pred panels with skeletons:
the port of `cape_tpu.cli.visualize`.

Draws the support pose graph, ground-truth keypoints and autoregressive
predictions (`eval.evaluate.decode` on the card, or the CPU with
`--device cpu`) side by side with skeleton edges, one PNG per episode
(reference `scripts/eval_cape_checkpoint.py:784-1067`). Drawing needs cv2.

    python -m cape_tpu_torch.cli.visualize --checkpoint ... \
        --dataset_root ... --split test --num_episodes 8 --output_dir viz/
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("cli.visualize draws with cv2 (opencv-python), "
                           "which is not installed") from e
    return cv2


def _draw_pose(img_u8, kpts, skeleton, visibility=None, color=(0, 255, 0)):
    """Draw keypoints + skeleton edges on an HWC uint8 image (cv2)."""
    cv2 = _cv2()

    out = np.ascontiguousarray(img_u8.copy())
    n = len(kpts)
    for e in skeleton or []:
        a, b = int(e[0]), int(e[1])
        if 0 <= a < n and 0 <= b < n:
            pa = tuple(np.round(kpts[a]).astype(int))
            pb = tuple(np.round(kpts[b]).astype(int))
            cv2.line(out, pa, pb, (255, 160, 0), 1, cv2.LINE_AA)
    for i, (x, y) in enumerate(kpts):
        if visibility is not None and visibility[i] == 0:
            continue
        cv2.circle(out, (int(round(x)), int(round(y))), 3, color, -1,
                   cv2.LINE_AA)
        cv2.putText(out, str(i), (int(x) + 3, int(y) - 3),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.3, (255, 255, 255), 1)
    return out


def get_args_parser():
    p = argparse.ArgumentParser(
        "CAPE prediction visualization (PyTorch port)")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--dataset_root", default=None)
    p.add_argument("--category_split_file", default=None)
    p.add_argument("--split", default="test", choices=["val", "test"])
    p.add_argument("--num_episodes", type=int, default=8)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--output_dir", default="viz")
    p.add_argument("--device", default="cuda",
                   help="device to decode on: cuda (default) or cpu")
    return p


def main(argv=None):
    args = get_args_parser().parse_args(argv)
    cv2 = _cv2()

    from ..data.builder import build_mp100_cape, resolve_split_file
    from ..data.episodic import EpisodicSampler, episode_batches
    from ..data.mp100 import image_to_uint8
    from ..device import resolve_device
    from ..eval.evaluate import (decode, extract_gt_keypoints,
                                 extract_pred_keypoints, to_numpy)
    from ..models.cape import CAPE
    from ..utils.checkpoint import config_of, load_weights
    from ..utils.debug import debug_enabled

    device = resolve_device(args.device)
    cfg = config_of(args.checkpoint)
    if args.dataset_root:
        cfg = cfg.replace(dataset_root=args.dataset_root)
    if args.category_split_file:
        cfg = cfg.replace(category_split_file=args.category_split_file)

    ds = build_mp100_cape(args.split, cfg)
    sampler = EpisodicSampler(ds, resolve_split_file(cfg), args.split,
                              num_queries=1,
                              num_support=cfg.num_support_per_episode)
    fixed = sampler.fixed_episodes(args.num_episodes, args.seed)

    model = CAPE(cfg, device=device)
    load_weights(model, args.checkpoint)

    os.makedirs(args.output_dir, exist_ok=True)
    S = cfg.image_size
    batches = episode_batches(ds, sampler, 1, args.num_episodes, S,
                              cfg.max_support_keypoints,
                              cfg.max_skeleton_edges,
                              np.random.default_rng(args.seed), fixed=fixed)
    for bi, batch in enumerate(batches):
        out = to_numpy(decode(model, batch["query_images"],
                              batch["support_coords"], batch["support_mask"],
                              batch["skeleton_edges"]))
        lengths = out["lengths"]
        active = np.arange(cfg.seq_len)[None] < lengths[:, None]
        expected = np.asarray(batch["num_keypoints"])
        preds = extract_pred_keypoints(out["pred_logits"], out["pred_coords"],
                                       active, expected)
        gts = extract_gt_keypoints(batch["targets"], expected)

        img_u8 = image_to_uint8(batch["query_images"][0])[..., ::-1]  # BGR
        n = int(expected[0])
        skeleton = [
            e.tolist() for e in np.asarray(batch["skeleton_edges"][0])
            if e[0] >= 0
        ]
        vis = np.asarray(batch["gt_visibility"][0, :n])

        support_panel = np.full_like(img_u8, 32)
        sup = np.asarray(batch["support_coords"][0, :n]) * S
        support_panel = _draw_pose(support_panel, sup, skeleton,
                                   visibility=~np.asarray(
                                       batch["support_mask"][0, :n]) * 2,
                                   color=(0, 200, 255))
        gt_panel = _draw_pose(img_u8, gts[0] * S, skeleton, vis, (0, 255, 0))
        pred_panel = _draw_pose(img_u8, preds[0] * S, skeleton, vis,
                                (0, 0, 255))
        for panel, label in ((support_panel, "SUPPORT"), (gt_panel, "GT"),
                             (pred_panel, "PRED")):
            cv2.putText(panel, label, (4, 14), cv2.FONT_HERSHEY_SIMPLEX,
                        0.45, (255, 255, 255), 1)
        canvas = np.concatenate([support_panel, gt_panel, pred_panel], axis=1)
        cid = int(np.asarray(batch["category_ids"][0]))
        path = os.path.join(args.output_dir,
                            f"episode_{bi:03d}_cat{cid}.png")
        cv2.imwrite(path, canvas)
        print(f"wrote {path}", flush=True)
        if debug_enabled("DEBUG_VIS"):
            # per-episode numeric dump (the reference's DEBUG_VIS family,
            # `eval_cape_checkpoint.py:970` / engine_cape.py:40): generated
            # length, per-keypoint GT vs pred pixels + error
            err = np.linalg.norm(preds[0] - gts[0], axis=-1) * S
            print(f"[DEBUG_VIS] episode {bi} cat {cid}: generated "
                  f"{int(lengths[0])} tokens for {n} keypoints", flush=True)
            for ki in range(n):
                print(f"  kpt {ki}: gt={np.round(gts[0][ki] * S, 1).tolist()}"
                      f" pred={np.round(preds[0][ki] * S, 1).tolist()}"
                      f" err={err[ki]:.1f}px vis={int(vis[ki])}", flush=True)


if __name__ == "__main__":
    main()
