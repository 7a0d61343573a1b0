"""Checkpoint evaluation CLI: the port of `cape_tpu.cli.evaluate`.

Loads a self-describing checkpoint written by `train.loop.train_loop`
(config embedded in `meta.json`, the fp32 masters in `state.pt`), rebuilds
the model on the card (or the CPU with `--device cpu`), evaluates fixed
episodes on a chosen split with autoregressive decoding, prints
per-category PCK tables and writes `metrics_{split}.json`.

    python -m cape_tpu_torch.cli.evaluate \
        --checkpoint output/.../best_epoch_X_pck_Y \
        --dataset_root ... --split test --num_episodes 200
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def get_args_parser():
    p = argparse.ArgumentParser(
        "CAPE checkpoint evaluation (PyTorch port)")
    p.add_argument("--checkpoint", required=True,
                   help="checkpoint directory (epoch_N or best_*)")
    p.add_argument("--dataset_root", default=None,
                   help="override the checkpoint's dataset_root")
    p.add_argument("--category_split_file", default=None)
    p.add_argument("--split", default="test", choices=["val", "test"])
    p.add_argument("--num_episodes", type=int, default=200,
                   help="fixed eval episodes (default protocol: 100 val / 200 test)")
    p.add_argument("--num_support", type=int, default=None,
                   help="K-shot override (default: checkpoint config)")
    p.add_argument("--seed", type=int, default=123,
                   help="episode sampling seed (reference default 123)")
    p.add_argument("--eval_batch_size", type=int, default=None,
                   help="episodes per decode batch (default: checkpoint "
                        "config; batch-parallel, replaces the reference's "
                        "batch-1 protocol)")
    p.add_argument("--pck_threshold", type=float, default=0.2)
    p.add_argument("--pck_norm", default="original_bbox",
                   choices=["original_bbox", "resized"],
                   help="normalize PCK by the original bbox diagonal "
                        "(engine_cape.py default) or the resized "
                        "image_size dims (eval_cape_checkpoint.py:530-537)")
    p.add_argument("--gt_structure", action="store_true",
                   help="extract predicted keypoints at GT token positions "
                        "(reference fallback, engine_cape.py:1015-1022)")
    p.add_argument("--decode_max_len", default="auto",
                   help="KV-cache/decode-length cap: 'auto' (default) = "
                        "split's max keypoint count + EOS + margin, "
                        "rounded up to a multiple of 8 — PCK-identical "
                        "and faster per step; 'off' = full seq_len; or "
                        "an integer")
    p.add_argument("--support_coord_noise", type=float, default=0.0,
                   help="i.i.d. Gaussian noise std (normalized units) on "
                        "every support's keypoints before the K-shot "
                        "mean-pool — the controlled probe of mean-pool "
                        "denoising (episodic_sampler.py:434-442)")
    p.add_argument("--output_dir", default=None,
                   help="where to write metrics json (default: checkpoint dir)")
    p.add_argument("--device", default="cuda",
                   help="device to evaluate on: cuda (default) or cpu")
    return p


def main(argv=None):
    args = get_args_parser().parse_args(argv)

    from ..data.builder import build_mp100_cape, resolve_split_file
    from ..data.episodic import (EpisodicSampler, episode_batches,
                                 eval_batch_plan)
    from ..data.prefetch import prefetch, to_device
    from ..device import resolve_device
    from ..eval.evaluate import evaluate_cape
    from ..models.cape import CAPE
    from ..train.loop import val_decode_cap
    from ..utils.checkpoint import config_of, load_weights, read_meta

    device = resolve_device(args.device)
    meta = read_meta(args.checkpoint)
    cfg = config_of(args.checkpoint)
    if args.dataset_root:
        cfg = cfg.replace(dataset_root=args.dataset_root)
    if args.category_split_file:
        cfg = cfg.replace(category_split_file=args.category_split_file)
    if args.num_support:
        cfg = cfg.replace(num_support_per_episode=args.num_support)
    print(f"Checkpoint: {args.checkpoint} (epoch {meta['epoch']})", flush=True)

    ds = build_mp100_cape(args.split, cfg)
    split_file = resolve_split_file(cfg)
    sampler = EpisodicSampler(
        ds, split_file, args.split, num_queries=1,
        num_support=cfg.num_support_per_episode,
    )
    fixed = sampler.fixed_episodes(args.num_episodes, args.seed)

    model = CAPE(cfg, device=device)
    load_weights(model, args.checkpoint)

    eval_b, n_batches = eval_batch_plan(
        args.num_episodes, args.eval_batch_size or cfg.eval_batch_size)
    batches = episode_batches(
        ds, sampler, eval_b, n_batches, cfg.image_size,
        cfg.max_support_keypoints, cfg.max_skeleton_edges,
        np.random.default_rng(args.seed), fixed=fixed,
        total_episodes=args.num_episodes,
        support_coord_noise=args.support_coord_noise,
    )
    if args.decode_max_len == "auto":
        # coords + EOS + margin, multiple of 8; never above seq_len
        cap = val_decode_cap(cfg, ds, sampler.categories)
    elif str(args.decode_max_len).lower() in ("off", "none", "0", ""):
        cap = None
    else:
        cap = min(cfg.seq_len, int(args.decode_max_len))
    if cap:
        print(f"decode_max_len: {cap} (seq_len {cfg.seq_len})", flush=True)

    stats = evaluate_cape(model,
                          prefetch(batches, transform=lambda b: to_device(
                              b, device)),
                          cfg,
                          pck_threshold=args.pck_threshold, print_freq=20,
                          pck_norm=args.pck_norm,
                          gt_structure_fallback=args.gt_structure,
                          decode_max_len=cap)

    print(f"\n{'=' * 60}")
    print(f"PCK@{args.pck_threshold} ({args.split}, "
          f"{cfg.num_support_per_episode}-shot, {args.num_episodes} episodes)")
    print(f"  overall (micro): {stats['pck']:.2%}")
    print(f"  mean over categories (macro): {stats['pck_mean_categories']:.2%}")
    print(f"  correct/visible: {stats['pck_num_correct']}/{stats['pck_num_visible']}")
    print(f"{'=' * 60}\nPer-category PCK:")
    for cid, pck in sorted(stats["pck_per_category"].items()):
        print(f"  category {cid:>4}: {pck:.2%}")

    out_dir = args.output_dir or args.checkpoint
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"metrics_{args.split}.json")
    with open(out_path, "w") as f:
        json.dump({k: v for k, v in stats.items()}, f, indent=2, default=float)
    print(f"\nMetrics written to {out_path}", flush=True)
    return stats


if __name__ == "__main__":
    main()
