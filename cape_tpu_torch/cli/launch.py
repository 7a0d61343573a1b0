"""Training launchers: the port of `START_CAPE_TRAINING.sh` (modes
`normal` and `quick`) and `TEST_CAPE.sh` (mode `smoke`), each a preset of
`cli.train`'s flags.

    DATASET_ROOT=/path/to/mp100 python -m cape_tpu_torch.cli.launch         # normal
    DATASET_ROOT=/path/to/mp100 python -m cape_tpu_torch.cli.launch quick
    python -m cape_tpu_torch.cli.launch smoke

- `normal`: 300 epochs x 1000 episodes, batch 2 x accumulation 4;
  `quick`: 5 epochs x 100 episodes, batch 1. Both need `DATASET_ROOT`,
  write under `OUTPUT_DIR` (`output/cape_episodic`) and first print the
  cards the run sees, where the shell script prints `jax.devices()`.
- `smoke`: 1 epoch x 5 episodes, batch 1, under `OUTPUT_DIR`
  (`output/test_cape`). With `DATASET_ROOT` unset it writes the synthetic
  fixture (6 categories x 6 images) into a temporary directory and trains
  a tiny model on it; it prints `TEST_CAPE: OK` at the end.

Every mode trains on the card unless `--device cpu` is given; none falls
back to the CPU by itself.
"""

from __future__ import annotations

import argparse
import os
import sys

#: `START_CAPE_TRAINING.sh` quick mode
QUICK_ARGS = ["--epochs", "5", "--episodes_per_epoch", "100",
              "--batch_size", "1", "--accumulation_steps", "1",
              "--warmup_epochs", "1", "--val_episodes_per_epoch", "50"]
#: `START_CAPE_TRAINING.sh` normal mode
NORMAL_ARGS = ["--epochs", "300", "--episodes_per_epoch", "1000",
               "--batch_size", "2", "--accumulation_steps", "4"]
#: `TEST_CAPE.sh`
SMOKE_ARGS = ["--epochs", "1", "--episodes_per_epoch", "5",
              "--batch_size", "1", "--accumulation_steps", "1",
              "--warmup_epochs", "0", "--val_episodes_per_epoch", "3",
              "--num_queries_per_episode", "1", "--print_freq", "1"]
#: `TEST_CAPE.sh`'s tiny model on the synthetic fixture (after
#: `--category_split_file`)
SMOKE_SYNTHETIC_ARGS = ["--image_size", "64", "--hidden_dim", "64",
                        "--dim_feedforward", "128", "--enc_layers", "2",
                        "--dec_layers", "2", "--nheads", "4",
                        "--seq_len", "24", "--vocab_size", "100",
                        "--backbone", "resnet_tiny", "--no_bf16"]


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("CAPE training launcher (PyTorch port)")
    p.add_argument("mode", nargs="?", default="normal",
                   choices=["normal", "quick", "smoke"])
    p.add_argument("--device", default="cuda",
                   help="device to train on: cuda (default) or cpu")
    return p


def _print_devices(device: str) -> None:
    import torch

    from ..device import resolve_device

    dev = resolve_device(device)       # raises for cuda without CUDA
    if dev.type != "cuda":
        print(f"torch backend: {dev}", flush=True)
        return
    names = [torch.cuda.get_device_name(i)
             for i in range(torch.cuda.device_count())]
    print(f"torch backend: cuda with {len(names)} device(s): {names}",
          flush=True)


def main(argv=None):
    """Run the mode's training; returns `cli.train`'s result."""
    args = get_args_parser().parse_args(argv)
    from .train import main as train_main

    root = os.environ.get("DATASET_ROOT")
    if args.mode == "smoke":
        extra = []
        if not root:
            print("DATASET_ROOT unset -> generating synthetic MP-100 fixture",
                  flush=True)
            import tempfile

            from ..data.synthetic import make_synthetic_mp100

            root = tempfile.mkdtemp(prefix="mp100_synth_")
            make_synthetic_mp100(root, num_categories=6, images_per_category=6)
            extra = (["--category_split_file",
                      os.path.join(root, "category_splits.json")]
                     + SMOKE_SYNTHETIC_ARGS)
        res = train_main(["--dataset_root", root, "--output_dir",
                          os.environ.get("OUTPUT_DIR") or "output/test_cape"]
                         + SMOKE_ARGS + extra + ["--device", args.device])
        print("TEST_CAPE: OK", flush=True)
        return res

    if not root:
        print("DATASET_ROOT: set DATASET_ROOT to the MP-100 root",
              file=sys.stderr)
        sys.exit(1)
    _print_devices(args.device)
    if args.mode == "quick":
        print("Quick mode: 5 epochs x 100 episodes, batch 1", flush=True)
        preset = QUICK_ARGS
    else:
        print("Normal mode: 300 epochs x 1000 episodes, batch 2 x acc 4",
              flush=True)
        preset = NORMAL_ARGS
    return train_main(["--dataset_root", root, "--output_dir",
                       os.environ.get("OUTPUT_DIR") or "output/cape_episodic"]
                      + preset + ["--device", args.device])


if __name__ == "__main__":
    main()
