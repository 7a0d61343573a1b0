"""Demonstrate the K-shot mechanism: 5-shot > 1-shot on a noisy fixture.
The port of `scripts/run_kshot_demo.py`.

The reference's core K-shot claim (~40-60% 5-shot vs ~30-50% 1-shot,
`README.md:466-472`) rests on mean-pooling K supports
(`episodic_sampler.py:434-442`) denoising the support prototype. This
module generates the 40-category learnable fixture WITH per-image layout
jitter (each image's keypoints are a noisy draw around the category
layout, so K-shot averaging recovers the layout at sigma/sqrt(K)), trains
the standard recipe once with `cli.train`, then evaluates the SAME
checkpoint 1-shot and 5-shot on the never-seen test categories with
`cli.evaluate`, and last 1-shot with a large support noise
(`--sensitivity_sigma`) as a does-the-model-use-its-supports control.

    python -m cape_tpu_torch.cli.kshot_demo --root /tmp/kshot_fixture \
        --epochs 30

On the default 'indexed' fixture the keypoint index is colour-coded into
the query image (the same colours across categories), so a trained model
can read identity off the image and ignore the support prior; the
demonstrable setting is `--marker_style uniform` (every keypoint the same
disc: identity must come from the support layout):

    python -m cape_tpu_torch.cli.kshot_demo --root /tmp/kshot_uniform \
        --marker_style uniform --layout_jitter 0.08 --num_eval_episodes 240

Training and evaluation run on the card unless `--device cpu` is given.
Before the results JSON (the last line, the JAX script's keys) it prints
one `kshot train {...}` line with the training's best validation PCK and
its epoch, the mean epoch wall and the peak card memory, and one
`kshot eval {...}` line per evaluation with its wall.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def get_args_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("K-shot demonstration (PyTorch port)")
    ap.add_argument("--root", default="/tmp/kshot_fixture")
    ap.add_argument("--layout_jitter", type=float, default=0.08)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--episodes_per_epoch", type=int, default=50)
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--num_eval_episodes", type=int, default=80)
    ap.add_argument("--support_coord_noise", type=float, default=0.0,
                    help="eval-time support coordinate noise std "
                         "(normalized units); see module docstring")
    ap.add_argument("--marker_style", default="indexed",
                    choices=["indexed", "uniform"],
                    help="'uniform' draws every keypoint as the same disc "
                         "so identity must come from the support layout — "
                         "the fixture on which 5-shot>1-shot is "
                         "demonstrable (see data/synthetic.py)")
    ap.add_argument("--num_categories", type=int, default=40)
    ap.add_argument("--images_per_category", type=int, default=10)
    ap.add_argument("--num_holdout", type=int, default=8,
                    help="categories held out (split between val/test). "
                         "MANY categories x FEW images is the "
                         "anti-memorization regime: with few examples per "
                         "category the train loss can no longer be "
                         "minimized by memorizing per-category layouts "
                         "(which transfers zero to unseen categories) and "
                         "the support-copying solution wins")
    ap.add_argument("--sensitivity_sigma", type=float, default=0.3,
                    help="after the K-shot evals, re-run 1-shot with this "
                         "LARGE support noise as a does-the-model-even-"
                         "use-supports control (0 = skip)")
    ap.add_argument("--skip_train", action="store_true",
                    help="reuse an existing checkpoint under --root/out")
    ap.add_argument("--device", default="cuda",
                    help="device to train and evaluate on: cuda (default) "
                         "or cpu")
    return ap


def main(argv=None):
    """Run the demonstration; returns the results dict it prints last."""
    args = get_args_parser().parse_args(argv)

    import torch

    from ..data.synthetic import make_synthetic_mp100
    from ..device import resolve_device
    from ..utils.checkpoint import CheckpointManager
    from .evaluate import main as eval_main
    from .train import main as train_main

    card = resolve_device(args.device)
    on_card = card.type == "cuda"
    out_dir = os.path.join(args.root, "out")
    if not os.path.exists(os.path.join(args.root, "category_splits.json")):
        print(f"generating {args.num_categories}-category fixture "
              f"(layout_jitter={args.layout_jitter}, "
              f"{args.marker_style} markers) under {args.root}", flush=True)
        make_synthetic_mp100(
            args.root, num_categories=args.num_categories,
            images_per_category=args.images_per_category,
            keypoint_range=(5, 9), image_size=(256, 320), seed=7,
            learnable=True, num_holdout=args.num_holdout,
            layout_jitter=args.layout_jitter,
            marker_style=args.marker_style,
        )

    if not args.skip_train:
        if on_card:
            torch.cuda.reset_peak_memory_stats(card)
        t0 = time.perf_counter()
        res = train_main([
            "--dataset_root", args.root,
            "--category_split_file",
            os.path.join(args.root, "category_splits.json"),
            "--output_dir", out_dir,
            "--image_size", str(args.image_size),
            "--epochs", str(args.epochs),
            "--episodes_per_epoch", str(args.episodes_per_epoch),
            "--val_episodes_per_epoch", "24",
            "--batch_size", str(args.batch_size),
            "--num_queries_per_episode", "2",
            "--fixed_val_episodes",
            "--seed", "3",
            "--device", args.device,
        ])
        hist = res["history"]
        best = max(hist, key=lambda h: h["pck"]) if hist else None
        print("kshot train " + json.dumps({
            "wall_s": time.perf_counter() - t0,
            "epochs": len(hist),
            "epoch_wall_s": (sum(h["train_s"] + h["val_s"] for h in hist)
                             / max(len(hist), 1)),
            "best_val_pck": res["best_pck"],
            "best_epoch": best["epoch"] if best else None,
            "peak_bytes": (torch.cuda.max_memory_allocated(card)
                           if on_card else None)}), flush=True)
        del res

    # newest best checkpoint
    mgr = CheckpointManager(out_dir)
    ckpt = mgr.best() or mgr.latest()
    assert ckpt, f"no checkpoint under {out_dir}"
    print(f"evaluating checkpoint: {ckpt}", flush=True)

    def evaluate(name, k, noise):
        edir = os.path.join(args.root, name)
        t0 = time.perf_counter()
        eval_main([
            "--checkpoint", str(ckpt),
            "--dataset_root", args.root,
            "--category_split_file",
            os.path.join(args.root, "category_splits.json"),
            "--split", "test",
            "--num_episodes", str(args.num_eval_episodes),
            "--num_support", str(k),
            "--support_coord_noise", str(noise),
            "--seed", "123",
            "--output_dir", edir,
            "--device", args.device,
        ])
        print("kshot eval " + json.dumps({
            "protocol": name, "wall_s": time.perf_counter() - t0}),
            flush=True)
        with open(os.path.join(edir, "metrics_test.json")) as f:
            return json.load(f)

    results = {}
    for k in (1, 5):
        m = evaluate(f"eval_{k}shot", k, args.support_coord_noise)
        results[f"{k}shot"] = {
            "micro_pck": m["pck"],
            "macro_pck": m["pck_mean_categories"],
        }
        print(f"{k}-shot: {results[f'{k}shot']}", flush=True)

    if args.sensitivity_sigma > 0:
        # support-sensitivity control: re-run the 1-shot eval with LARGE
        # support noise. If PCK barely moves, the trained model is
        # ignoring the support prior and any K-shot comparison on this
        # checkpoint is structurally flat — report it so the flat result
        # carries its own diagnosis.
        m = evaluate("eval_sensitivity", 1, args.sensitivity_sigma)
        results["sensitivity"] = {
            "sigma": args.sensitivity_sigma,
            "micro_pck": m["pck"],
            "macro_pck": m["pck_mean_categories"],
            "drop_vs_1shot": round(
                (results["1shot"]["micro_pck"] or 0) - m["pck"], 4),
        }
        print(f"sensitivity (sigma={args.sensitivity_sigma}): "
              f"{results['sensitivity']}", flush=True)

    results["layout_jitter"] = args.layout_jitter
    results["support_coord_noise"] = args.support_coord_noise
    delta = (results["5shot"]["macro_pck"] or 0) - \
        (results["1shot"]["macro_pck"] or 0)
    results["macro_delta_5shot_minus_1shot"] = round(delta, 4)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
