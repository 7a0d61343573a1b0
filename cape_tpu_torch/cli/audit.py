"""Validation-PCK leak audit CLI: the port of
`scripts/debug_validation_pck.py` (the reference's PCK-100% data-leakage
debugger, `models/debug_validation_pck.py`).

A thin wrapper over `eval.audit.audit_episodes`: it loads a checkpoint of
the port, decodes fixed episodes of a split autoregressively
(`eval.evaluate.decode` on the card, or the CPU with `--device cpu`) and
prints the 6-part report:
  1. predictions identical to GT?            (teacher-forcing leak)
  2. predictions identical to support?       (support copy-through)
  3. generation length vs expected keypoints (EOS behavior, max-len hits)
  4. coordinate spread                       (single-token collapse)
  5. per-episode PCK distribution            (100%-PCK episodes flagged)
  6. per-category breakdown
It exits 1 when a leak is detected.

    python -m cape_tpu_torch.cli.audit --checkpoint ... --dataset_root ... \
        --split val --num_episodes 20
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("CAPE validation-PCK leak audit "
                                "(PyTorch port)")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--dataset_root", default=None)
    p.add_argument("--category_split_file", default=None)
    p.add_argument("--split", default="val", choices=["val", "test"])
    p.add_argument("--num_episodes", type=int, default=20)
    p.add_argument("--eval_batch_size", type=int, default=None)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--device", default="cuda",
                   help="device to decode on: cuda (default) or cpu")
    return p


def main(argv=None):
    """Print the audit report; returns the audit dict (exits 1 on a
    leak)."""
    args = get_args_parser().parse_args(argv)

    from ..data.builder import build_mp100_cape, resolve_split_file
    from ..data.episodic import (EpisodicSampler, episode_batches,
                                 eval_batch_plan)
    from ..device import resolve_device
    from ..eval.audit import audit_episodes, format_audit_report
    from ..eval.evaluate import decode
    from ..models.cape import CAPE
    from ..utils.checkpoint import config_of, load_weights

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

    eval_b, n_batches = eval_batch_plan(
        args.num_episodes, args.eval_batch_size or cfg.eval_batch_size)
    batches = episode_batches(ds, sampler, eval_b, n_batches,
                              cfg.image_size, cfg.max_support_keypoints,
                              cfg.max_skeleton_edges,
                              np.random.default_rng(args.seed), fixed=fixed,
                              total_episodes=args.num_episodes)
    audit = audit_episodes(
        lambda b: decode(model, b["query_images"], b["support_coords"],
                         b["support_mask"], b["skeleton_edges"]),
        batches, cfg)
    print("\n" + format_audit_report(audit))
    if audit["leak_detected"]:
        sys.exit(1)
    return audit


if __name__ == "__main__":
    main()
