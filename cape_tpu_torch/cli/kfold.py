"""K-fold cross-validation over the 5 official MP-100 splits: the port of
`scripts/run_kfold_cross_validation.sh`. Trains and evaluates each fold in
turn with the port's `cli.train` and `cli.evaluate`, then aggregates mean
± std PCK@0.2 (`cli.aggregate_kfold`).

    DATASET_ROOT=/path/to/mp100 python -m cape_tpu_torch.cli.kfold [quick]

The mode is `quick` or anything else for the full protocol, as in the
shell script. The environment is the script's: `DATASET_ROOT` (required),
`OUTPUT_ROOT` (`output/kfold`), `SPLITS` (`"1 2 3 4 5"`), `EVAL_EPISODES`
(20 quick, 200 full), `EXTRA_TRAIN_ARGS` / `EXTRA_EVAL_ARGS` (flags
appended last, so they win over the mode's). `--device` (default `cuda`)
goes to both CLIs, before the extra flags.

Each fold writes `fold_<k>/`: the training's checkpoints, then
`metrics_test.json` of the best checkpoint (or the latest where no epoch
improved); `kfold_summary.json` goes under `OUTPUT_ROOT`. Every fold
prints one line `kfold fold {...}` with its train and eval walls and its
peak card memory.

The folds run in one process, where the script starts one per fold. A
fold leaves nothing to the next: `cli.train` and `cli.evaluate` keep
their model, optimizer, datasets, loader pools and prefetch threads in
their own frames, this module drops the training's result and empties the
card's cache, and the only process-wide state `cli.train` sets is numpy's
global seed, which it sets again at every call. The port logs with
`print`, so no logging handler piles up.

Under torchrun (or the `CAPE_*` variables) every rank runs this command:
`cli.train` makes the group at the first fold and finds it at the next
(`parallel.maybe_initialize`), rank 0 picks the checkpoint and gives it
to every rank, and rank 0 alone evaluates and writes the summary.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

#: the shell script's two argument sets (`run_kfold_cross_validation.sh`)
QUICK_TRAIN_ARGS = ["--epochs", "1", "--episodes_per_epoch", "20",
                    "--batch_size", "1", "--val_episodes_per_epoch", "10",
                    "--warmup_epochs", "0"]
QUICK_EVAL_EPISODES = "20"
FULL_TRAIN_ARGS = ["--epochs", "300", "--episodes_per_epoch", "1000",
                   "--batch_size", "2", "--accumulation_steps", "4"]
FULL_EVAL_EPISODES = "200"


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "MP-100 k-fold cross-validation (PyTorch port)")
    p.add_argument("mode", nargs="?", default="full",
                   help="quick, or anything else for the full protocol")
    p.add_argument("--device", default="cuda",
                   help="device to train and evaluate on: cuda (default) "
                        "or cpu")
    return p


def main(argv=None):
    """Run the protocol; returns {"folds": [per-fold record], "summary":
    the aggregate (None off rank 0)}."""
    args = get_args_parser().parse_args(argv)
    root = os.environ.get("DATASET_ROOT")
    if not root:
        print("DATASET_ROOT: set DATASET_ROOT to the MP-100 root",
              file=sys.stderr)
        sys.exit(1)
    out_root = os.environ.get("OUTPUT_ROOT") or "output/kfold"
    splits = (os.environ.get("SPLITS") or "1 2 3 4 5").split()
    if args.mode == "quick":
        train_args = list(QUICK_TRAIN_ARGS)
        eval_episodes = os.environ.get("EVAL_EPISODES") or QUICK_EVAL_EPISODES
    else:
        train_args = list(FULL_TRAIN_ARGS)
        eval_episodes = os.environ.get("EVAL_EPISODES") or FULL_EVAL_EPISODES
    train_args += ["--device", args.device]
    train_args += os.environ.get("EXTRA_TRAIN_ARGS", "").split()
    eval_args = ["--device", args.device]
    eval_args += os.environ.get("EXTRA_EVAL_ARGS", "").split()

    import torch

    from ..device import resolve_device
    from ..parallel import allgather_object, is_main
    from ..utils.checkpoint import CheckpointManager
    from . import aggregate_kfold, evaluate, train

    on_card = torch.device(args.device).type == "cuda"
    folds = []
    for split in splits:
        fold_dir = os.path.join(out_root, f"fold_{split}")
        print(f"=== Fold {split} -> {fold_dir} ===", flush=True)
        t0 = time.perf_counter()
        res = train.main(["--dataset_root", root, "--mp100_split", split,
                          "--output_dir", fold_dir] + train_args)
        train_s = time.perf_counter() - t0
        del res          # the model and its optimizer state go with it
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

        best = None
        if is_main():
            mgr = CheckpointManager(fold_dir)
            best = mgr.best() or mgr.latest() or ""
        best = allgather_object(best)[0]   # rank 0's choice on every rank
        if not best:
            print(f"No checkpoint produced for fold {split}", file=sys.stderr)
            sys.exit(1)
        t1 = time.perf_counter()
        if is_main():
            evaluate.main(["--checkpoint", best, "--dataset_root", root,
                           "--split", "test", "--num_episodes", eval_episodes,
                           "--output_dir", fold_dir] + eval_args)
        eval_s = time.perf_counter() - t1
        gc.collect()
        peak = None
        if on_card:      # the fold's peak; the next fold's starts here
            card = resolve_device(args.device)
            peak = torch.cuda.max_memory_allocated(card)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(card)
        rec = {"fold": int(split), "checkpoint": best, "train_s": train_s,
               "eval_s": eval_s, "peak_bytes": peak}
        folds.append(rec)
        print(f"kfold fold {json.dumps(rec)}", flush=True)

    summary = None
    if is_main():
        summary = aggregate_kfold.main(["--results_dir", out_root,
                                        "--splits", *splits,
                                        "--eval_split", "test"])
    return {"folds": folds, "summary": summary}


if __name__ == "__main__":
    main()
