"""Episodic CAPE training CLI: the port of `cape_tpu.cli.train`.

Same user-facing hyperparameters as the JAX package's CLI (flag names of
the reference parser, `train_cape_episodic.py:86-254`), plus `--device`,
driving `train.loop.train_loop` on the card (or on the CPU with
`--device cpu`). Run:

    python -m cape_tpu_torch.cli.train --dataset_root /path/to/mp100 \
        --category_split_file category_splits.json --epochs 300

Quick smoke on the CPU:

    python -m cape_tpu_torch.cli.train --dataset_root ... --epochs 1 \
        --episodes_per_epoch 5 --batch_size 1 --device cpu

Across processes, one per card, every process runs the same command:
under torchrun (`torchrun --nproc_per_node 8 -m cape_tpu_torch.cli.train
...`) or with the JAX package's variables set for each process
(`CAPE_COORDINATOR=host:port CAPE_NUM_PROCESSES=N CAPE_PROCESS_ID=i`).
The group's backend is `nccl` on the cards and `gloo` with `--device
cpu`; `--batch_size` is the global batch, split evenly across ranks.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from ..config import CAPEConfig


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("CAPE episodic training (PyTorch port)",
                                add_help=True)
    d = CAPEConfig()
    # episodic
    p.add_argument("--num_queries_per_episode", type=int, default=d.num_queries_per_episode)
    p.add_argument("--num_support_per_episode", type=int, default=d.num_support_per_episode)
    p.add_argument("--episodes_per_epoch", type=int, default=d.episodes_per_epoch)
    p.add_argument("--val_episodes_per_epoch", type=int, default=d.val_episodes_per_epoch)
    p.add_argument("--eval_batch_size", type=int, default=d.eval_batch_size,
                   help="episodes per validation decode batch")
    p.add_argument("--fixed_val_episodes", action="store_true", default=d.fixed_val_episodes)
    p.add_argument("--val_seed", type=int, default=d.val_seed)
    p.add_argument("--category_split_file", default=d.category_split_file)
    # encoders
    p.add_argument("--support_encoder_layers", type=int, default=d.support_encoder_layers)
    p.add_argument("--use_geometric_encoder", action="store_true", default=True)
    p.add_argument("--use_gcn_preenc", action="store_true", default=d.use_gcn_preenc)
    p.add_argument("--num_gcn_layers", type=int, default=d.num_gcn_layers)
    # optimization
    p.add_argument("--lr", type=float, default=d.lr)
    p.add_argument("--lr_backbone", type=float, default=d.lr_backbone)
    p.add_argument("--lr_linear_proj_mult", type=float, default=d.lr_linear_proj_mult)
    p.add_argument("--batch_size", type=int, default=d.batch_size)
    p.add_argument("--accumulation_steps", type=int, default=d.accumulation_steps)
    p.add_argument("--weight_decay", type=float, default=d.weight_decay)
    p.add_argument("--epochs", type=int, default=d.epochs)
    p.add_argument("--scheduler", default=d.scheduler,
                   choices=["multistep", "cosine_warmrestarts", "onecycle"])
    p.add_argument("--lr_drop", default="200,250")
    p.add_argument("--warmup_epochs", type=int, default=d.warmup_epochs)
    p.add_argument("--T_0", type=int, default=d.t0)
    p.add_argument("--T_mult", type=int, default=d.t_mult)
    p.add_argument("--eta_min", type=float, default=d.eta_min)
    p.add_argument("--early_stopping_patience", type=int, default=d.early_stopping_patience)
    p.add_argument("--clip_max_norm", type=float, default=d.clip_max_norm)
    # model
    p.add_argument("--backbone", default=d.backbone)
    p.add_argument("--input_channels", type=int, default=d.input_channels)
    p.add_argument("--image_size", type=int, default=d.image_size)
    p.add_argument("--image_norm", action="store_true", default=d.image_norm)
    p.add_argument("--num_feature_levels", type=int, default=d.num_feature_levels)
    p.add_argument("--enc_layers", type=int, default=d.enc_layers)
    p.add_argument("--dec_layers", type=int, default=d.dec_layers)
    p.add_argument("--dim_feedforward", type=int, default=d.dim_feedforward)
    p.add_argument("--hidden_dim", type=int, default=d.hidden_dim)
    p.add_argument("--dropout", type=float, default=d.dropout)
    p.add_argument("--nheads", type=int, default=d.nheads)
    p.add_argument("--dec_n_points", type=int, default=d.dec_n_points)
    p.add_argument("--enc_n_points", type=int, default=d.enc_n_points)
    # experimental decoder layer variants (train_cape_episodic.py:220-222)
    p.add_argument("--dec_layer_type", default=d.dec_layer_type,
                   choices=["v1", "v2", "v3", "v4", "v41", "v5", "v6"])
    p.add_argument("--dec_attn_concat_src", action="store_true",
                   default=d.dec_attn_concat_src)
    p.add_argument("--no_dec_qkv_proj", dest="dec_qkv_proj",
                   action="store_false", default=d.dec_qkv_proj)
    p.add_argument("--seq_len", type=int, default=d.seq_len)
    p.add_argument("--vocab_size", type=int, default=d.vocab_size)
    # loss
    p.add_argument("--no_aux_loss", dest="aux_loss", action="store_false", default=True)
    p.add_argument("--cls_loss_coef", type=float, default=d.cls_loss_coef)
    p.add_argument("--coords_loss_coef", type=float, default=d.coords_loss_coef)
    p.add_argument("--eos_weight", type=float, default=d.eos_weight)
    p.add_argument("--label_smoothing", type=float, default=d.label_smoothing)
    # dataset / runtime
    p.add_argument("--dataset_root", default=d.dataset_root)
    p.add_argument("--mp100_split", type=int, default=d.mp100_split, choices=[1, 2, 3, 4, 5])
    p.add_argument("--output_dir", default=d.output_dir)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--resume", default="")
    p.add_argument("--print_freq", type=int, default=10)
    p.add_argument("--no_bf16", dest="bf16", action="store_false", default=d.bf16)
    p.add_argument("--num_data_threads", type=int, default=d.num_data_threads,
                   help="episode-loading threads (DataLoader-workers equivalent)")
    p.add_argument("--steps_per_dispatch", type=int, default=d.steps_per_dispatch,
                   help="micro-steps grouped into one stacked batch "
                        "(make_scan_train_step); the epoch rounds to whole "
                        "groups")
    p.add_argument("--data_cache_mb", type=int, default=d.data_cache_mb,
                   help="host loader LRU budget (decoded crops / val "
                        "records) in MB; 0 disables")
    p.add_argument("--resnet_weights", default="",
                   help="optional .npz of a torchvision resnet50 state_dict")
    p.add_argument("--profile_dir", default="",
                   help="write a torch.profiler trace of steps 2-4 here")
    # debug overfit mode (reference --debug_overfit_category)
    p.add_argument("--debug_overfit_category", type=int, default=-1)
    p.add_argument("--debug_overfit_episodes", type=int, default=10)
    p.add_argument("--debug_single_image", action="store_true", default=False)
    p.add_argument("--disable_augment", action="store_true", default=False)
    p.add_argument("--device", default="cuda",
                   help="device to train on: cuda (default) or cpu")
    return p


def config_from_args(args: argparse.Namespace) -> CAPEConfig:
    fields = {f.name for f in dataclasses.fields(CAPEConfig)}
    kwargs = {k: v for k, v in vars(args).items() if k in fields}
    kwargs["t0"] = args.T_0
    kwargs["t_mult"] = args.T_mult
    kwargs["lr_drop_epochs"] = tuple(
        int(e) for e in str(args.lr_drop).split(",") if e
    )
    return CAPEConfig(**kwargs)


def main(argv=None):
    args = get_args_parser().parse_args(argv)
    cfg = config_from_args(args)

    # heavy imports after arg parsing so --help stays fast
    import torch

    from ..data.builder import build_mp100_cape, resolve_split_file
    from ..device import resolve_device
    from ..models.cape import CAPE
    from ..parallel import is_main, maybe_initialize, process_count
    from ..train.loop import train_loop

    # multi-process: the group first, so that `cuda` is this rank's card
    maybe_initialize("gloo" if torch.device(args.device).type == "cpu"
                     else None)
    device = resolve_device(args.device)
    if is_main():
        name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu")
        print(f"torch {torch.__version__} on {device} ({name}), "
              f"{process_count()} process(es)", flush=True)
        print(cfg.to_json(), flush=True)
    np.random.seed(cfg.seed)

    train_ds = build_mp100_cape("train", cfg)
    val_ds = build_mp100_cape("val", cfg)
    split_file = resolve_split_file(cfg)

    model = CAPE(cfg, device=device)
    result = train_loop(
        model, cfg, train_ds, val_ds, split_file,
        resume=args.resume or None, print_freq=args.print_freq,
    )
    print(f"Training done. Best PCK@0.2: {result['best_pck']:.2%}", flush=True)
    return result


if __name__ == "__main__":
    main()
