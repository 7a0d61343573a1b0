"""Aggregate k-fold cross-validation results into kfold_summary.json: the
port of `scripts/aggregate_kfold_results.py` (numpy only; the port keeps
its own copy).

Collects `metrics_{split}.json` from each fold's output directory
(`fold_N/`, or `split_N/`), reports mean ± std (ddof 0) of PCK@0.2, micro
and macro, across folds, plus per-fold numbers. A missing fold is skipped
with a warning; no fold at all exits 1.

    python -m cape_tpu_torch.cli.aggregate_kfold --results_dir output/kfold \
        --splits 1 2 3 4 5 --eval_split test
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--results_dir", required=True,
                   help="directory containing fold_{N}/ subdirectories")
    p.add_argument("--splits", type=int, nargs="+", default=[1, 2, 3, 4, 5])
    p.add_argument("--eval_split", default="test", choices=["val", "test"])
    p.add_argument("--output", default=None,
                   help="summary path (default: results_dir/kfold_summary.json)")
    return p


def main(argv=None):
    args = get_args_parser().parse_args(argv)

    folds = {}
    for n in args.splits:
        path = None
        for cand in (
            os.path.join(args.results_dir, f"fold_{n}",
                         f"metrics_{args.eval_split}.json"),
            os.path.join(args.results_dir, f"split_{n}",
                         f"metrics_{args.eval_split}.json"),
        ):
            if os.path.exists(cand):
                path = cand
                break
        if path is None:
            print(f"[warn] fold {n}: metrics not found, skipping",
                  file=sys.stderr)
            continue
        with open(path) as f:
            folds[n] = json.load(f)

    if not folds:
        print("No fold results found.", file=sys.stderr)
        sys.exit(1)

    micro = [folds[n]["pck"] for n in folds]
    macro = [folds[n]["pck_mean_categories"] for n in folds]
    summary = {
        "eval_split": args.eval_split,
        "folds": sorted(folds),
        "pck_overall_mean": float(np.mean(micro)),
        "pck_overall_std": float(np.std(micro)),
        "pck_macro_mean": float(np.mean(macro)),
        "pck_macro_std": float(np.std(macro)),
        "per_fold": {
            str(n): {"pck": folds[n]["pck"],
                     "pck_mean_categories": folds[n]["pck_mean_categories"],
                     "num_images": folds[n].get("num_images")}
            for n in folds
        },
    }
    out = args.output or os.path.join(args.results_dir, "kfold_summary.json")
    with open(out, "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))
    print(f"\nPCK@0.2 over {len(folds)} folds: "
          f"{summary['pck_overall_mean']:.2%} ± {summary['pck_overall_std']:.2%} "
          f"(macro {summary['pck_macro_mean']:.2%} ± {summary['pck_macro_std']:.2%})")
    print(f"Summary written to {out}")
    return summary


if __name__ == "__main__":
    main()
