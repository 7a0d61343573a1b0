"""Convert a reference (PyTorch) CAPE checkpoint into a port checkpoint:
the counterpart of `scripts/import_torch_checkpoint.py`.

The reference saves `{'model': CAPEModel.state_dict(), 'args': Namespace,
'epoch', 'best_pck'}`. This tool maps every live tensor onto the port's
`CAPE` (`utils.torch_import`) and writes a checkpoint directory in
`utils.checkpoint`'s format, which these read:

    python -m cape_tpu_torch.cli.evaluate --checkpoint <out>/epoch_N ...
    python -m cape_tpu_torch.cli.train    --resume     <out>/epoch_N ...
    CAPEPredictor.from_checkpoint("<out>/epoch_N")

Usage:

    python -m cape_tpu_torch.cli.import_checkpoint \
        --torch_checkpoint checkpoint_best.pth --output_dir imported/
    # override any architecture field the pickled args got wrong:
    #   --set image_size=512 --set seq_len=200

The model the checkpoint's optimizer state is built around lives on the
card unless `--device cpu` is given.

The file is read with `torch.load(weights_only=True)`: tensors, plain
containers and numbers, and of classes only `argparse.Namespace` (the
reference's pickled `args`). A file that needs any other class is
refused rather than unpickled.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional


def parse_set(values: Optional[List[str]]) -> Dict:
    """`FIELD=VALUE` overrides: ints, then floats, then true/false, else
    the string."""
    out = {}
    for item in values or []:
        k, _, v = item.partition("=")
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        if v == "true":
            v = True
        elif v == "false":
            v = False
        out[k] = v
    return out


def get_args_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        "Import a reference CAPE checkpoint (PyTorch port)")
    ap.add_argument("--torch_checkpoint", required=True,
                    help=".pth file saved by the reference trainer")
    ap.add_argument("--output_dir", required=True,
                    help="checkpoint directory to create")
    ap.add_argument("--set", action="append", metavar="FIELD=VALUE",
                    help="override a CAPEConfig field (repeatable)")
    ap.add_argument("--device", default="cuda",
                    help="device of the model: cuda (default) or cpu")
    return ap


def main(argv: Optional[List[str]] = None) -> str:
    """Convert; returns the written checkpoint directory."""
    args = get_args_parser().parse_args(argv)

    import torch

    from ..device import resolve_device
    from ..models.cape import CAPE
    from ..train.state import create_train_state
    from ..utils.checkpoint import CheckpointManager
    from ..utils.torch_import import (config_from_reference_args,
                                      import_reference_state_dict)

    device = resolve_device(args.device)
    print(f"Loading {args.torch_checkpoint} ...")
    with torch.serialization.safe_globals([argparse.Namespace]):
        ckpt = torch.load(args.torch_checkpoint, map_location="cpu",
                          weights_only=True)
    sd = ckpt["model"]
    ref_args = vars(ckpt["args"]) if ckpt.get("args") is not None else {}
    epoch = int(ckpt.get("epoch", 0) or 0)
    best_pck = float(ckpt.get("best_pck", 0.0) or 0.0)
    print(f"  {len(sd)} tensors, epoch={epoch}, best_pck={best_pck}")

    cfg = config_from_reference_args(ref_args, **parse_set(args.set))
    print(f"  config: hidden_dim={cfg.hidden_dim} enc={cfg.enc_layers} "
          f"dec={cfg.dec_layers} seq_len={cfg.seq_len} "
          f"image_size={cfg.image_size}")
    print("Converting ...")
    weights = import_reference_state_dict(sd, cfg)
    model = CAPE(cfg, device=device)
    model.load_state_dict(weights)
    # the fp32 values are the masters, whatever the model's dtype
    state = create_train_state(cfg, model, steps_per_epoch=1,
                               masters=weights)
    mgr = CheckpointManager(args.output_dir)
    mgr.save_epoch(state, epoch, cfg, best_pck=best_pck, patience=0,
                   extra={"imported_from": os.path.abspath(
                       args.torch_checkpoint)})
    out = os.path.join(mgr.dir, f"epoch_{epoch}")
    print(f"Wrote {out}")
    print("Evaluate with:\n  python -m cape_tpu_torch.cli.evaluate "
          f"--checkpoint {out} --dataset_root <MP100> --split test")
    return out


if __name__ == "__main__":
    main()
