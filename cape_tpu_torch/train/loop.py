"""Full episodic training loop: epochs, validation PCK, early stopping,
best-checkpoint tracking, resume. The port of `cape_tpu.train.loop`.

Parity with the reference epoch loop (`train_cape_episodic.py:722-978`), as
the JAX package keeps it:
- per-epoch episodic training with fresh sampled (augmented) episodes;
- per-epoch autoregressive validation on fixed episodes (stable curves),
  with the decode capped at the val split's largest keypoint count;
- best-PCK checkpoints + last-N retention + patience early stopping;
- NaN-loss hard exit (`engine_cape.py:206-209`);
- host PRNG and dropout generator states saved for exact resume (§5.4).

The episode stream is the JAX loop's: the same seed, the same probe batch
drawn before the state is built (the port needs none to build its
parameters, but without the draw its stream would part from the JAX
loop's), the same per-epoch `episode_batches` on one parent generator and
the same validation generator. Where the JAX loop initialises the
parameters inside, this loop trains the caller's module with its weights.
`cfg.resnet_weights` is loaded into it before the train state is built,
since the optimizer freezes the backbone affines whenever it is set.

Dropout draws from one `torch.Generator` on the model's device, seeded by
`cfg.seed`, in place of the JAX loop's split keys.

Across processes (a `torch.distributed` group, `parallel.maybe_initialize`)
the loop is the JAX loop's multi-host branch, one card a rank:
- each rank builds its share of the global batch
  (`parallel.local_episode_count`) from its own stream
  (`parallel.host_rng(cfg.seed)`), and the train step makes the global
  update on every rank (`train.train_step`);
- rank 0's parameters and buffers are broadcast before the state is
  built (after `resnet_weights` are loaded);
- the dropout generator is seeded per rank (`parallel.rank_seed`): the
  JAX step draws another mask for every row of the global batch;
- validation is sharded: each rank decodes its slice of the fixed
  episodes (`parallel.host_episode_slice`) and every rank scores the
  gathered set, so that best-checkpoint and early-stopping decisions
  agree; there is no validation loss, as in the JAX loop;
- rank 0 alone writes checkpoints and logs. Each checkpoint holds every
  rank's numpy and dropout states (`rank_states`), and a resume with the
  same number of ranks restores them, which makes it exact; with another
  number, or from a single-process checkpoint, each rank draws fresh
  streams from `(cfg.seed, rank, epoch)`, as the JAX loop re-derives its
  host streams on resume.
"""

from __future__ import annotations

import functools
import math
import os
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..config import CAPEConfig
from ..data.episodic import (EpisodicSampler, episode_batches,
                             eval_batch_plan, validate_episode_batch)
from ..data.mp100 import MP100Dataset
from ..data.prefetch import prefetch, stack_batches, to_device
from ..eval.evaluate import evaluate_cape
from ..parallel import (allgather_object, host_episode_slice, host_rng,
                        is_main, local_episode_count, process_count,
                        process_index, rank_seed, replicate)
from ..utils.checkpoint import (CheckpointManager, numpy_rng_state,
                                restore, restore_numpy_rng,
                                restore_torch_rng, torch_rng_state)
from ..utils.debug import debug_enabled
from ..utils.logging import MetricLogger
from .state import create_train_state
from .train_step import (make_eval_loss_fn, make_scan_train_step,
                         make_train_step)


def val_decode_cap(cfg: CAPEConfig, ds: MP100Dataset, categories) -> int:
    """The decode-length cap of a split: its largest keypoint count + EOS +
    margin, a multiple of 8, never above seq_len (PCK-identical, faster
    per step; `eval.evaluate.evaluate_cape`)."""
    maxk = max((ds.coco.category_num_keypoints(c) or 0) for c in categories)
    return min(cfg.seq_len, -(-(maxk + 2) // 8) * 8)


def train_loop(
    model,
    cfg: CAPEConfig,
    train_ds: MP100Dataset,
    val_ds: MP100Dataset,
    category_split_file: str,
    resume: Optional[str] = None,
    print_freq: int = 10,
) -> Dict:
    """Run the full training of `model` (a `CAPE` built from `cfg`, on the
    device it trains on). Returns the final stats dict: best_pck, history
    (per epoch: epoch, train_loss, pck, the PCK counts, the train and
    validation walls in seconds) and the `TrainState`. Across processes
    every rank calls it with the same arguments (see the module
    docstring)."""
    device = model.device
    multi = process_count() > 1
    main = is_main()
    if not main:
        print_freq = 0  # log gating (reference setup_for_distributed)
    overfit = cfg.debug_overfit_category >= 0
    sampler = EpisodicSampler(
        train_ds, category_split_file, "train",
        num_queries=cfg.num_queries_per_episode,
        num_support=cfg.num_support_per_episode,
        overfit_category=cfg.debug_overfit_category,
        single_image=cfg.debug_single_image,
    )
    if overfit:
        # validate on the same overfit category/images (debug mode —
        # `train_cape_episodic.py:120-126`)
        val_sampler = EpisodicSampler(
            train_ds, category_split_file, "train", num_queries=1,
            num_support=cfg.num_support_per_episode,
            overfit_category=cfg.debug_overfit_category,
            single_image=cfg.debug_single_image,
        )
        val_ds = train_ds
    else:
        val_sampler = EpisodicSampler(
            val_ds, category_split_file, "val",
            num_queries=1, num_support=cfg.num_support_per_episode,
        )
    fixed_val = (
        val_sampler.fixed_episodes(cfg.val_episodes_per_epoch, cfg.val_seed)
        if cfg.fixed_val_episodes else None
    )
    val_cap = val_decode_cap(cfg, val_ds, val_sampler.categories)

    episodes = cfg.debug_overfit_episodes if overfit else cfg.episodes_per_epoch
    steps_per_epoch = max(episodes // cfg.batch_size, 1)
    # multi-step dispatch: round the epoch to whole groups of micro-steps
    spd = max(1, cfg.steps_per_dispatch)
    if spd > 1:
        steps_per_epoch = max(steps_per_epoch // spd, 1) * spd
    # per-rank input sharding: each rank builds its share of the global
    # episode batch from a rank-disjoint sampling stream
    local_batch = (local_episode_count(cfg.batch_size) if multi
                   else cfg.batch_size)
    rng = host_rng(cfg.seed) if multi else np.random.default_rng(cfg.seed)
    gen = torch.Generator(device=device).manual_seed(
        rank_seed(cfg.seed) if multi else cfg.seed)

    # the JAX loop's probe batch (it initialises the parameters on it):
    # drawn here too, so the episode stream stays the JAX loop's
    next(episode_batches(
        train_ds, sampler, local_batch, 1, cfg.image_size,
        cfg.max_support_keypoints, cfg.max_skeleton_edges, rng,
    ))
    masters = None
    if cfg.resnet_weights:
        from ..models.backbone import load_torch_resnet50_npz

        folded = load_torch_resnet50_npz(model.backbone, cfg.resnet_weights)
        masters = {f"backbone.{k}": v for k, v in folded.items()}
        if main:
            print(f"Loaded ImageNet backbone weights from "
                  f"{cfg.resnet_weights}", flush=True)
    replicate(model)  # rank 0's parameters and buffers on every rank
    state = create_train_state(cfg, model, steps_per_epoch, masters=masters)
    n_params = sum(p.numel() for p in model.parameters())
    if main:
        print(f"Model parameters: {n_params:,}", flush=True)

    # rank 0 alone opens (and cleans) the checkpoint directory
    ckpt = CheckpointManager(cfg.output_dir) if main else None
    start_epoch, best_pck, patience = 0, 0.0, 0
    if resume:
        state, meta = restore(resume, state)
        start_epoch = meta["epoch"] + 1
        best_pck = meta.get("best_pck", 0.0)
        patience = meta.get("patience", 0)
        ranks = meta.get("rank_states") or []
        if not multi:
            if meta.get("rng_state"):
                rng = restore_numpy_rng(meta["rng_state"])  # exact data order
            if meta.get("torch_rng_state"):
                restore_torch_rng(gen, meta["torch_rng_state"])  # exact dropout
        elif len(ranks) == process_count():
            mine = ranks[process_index()]
            rng = restore_numpy_rng(mine["rng_state"])
            restore_torch_rng(gen, mine["torch_rng_state"])
        else:
            # another number of ranks: fresh per-rank streams, as the JAX
            # loop re-derives its host streams on resume
            rng = host_rng(cfg.seed, epoch=start_epoch)
            gen.manual_seed(rank_seed(cfg.seed, epoch=start_epoch))
        if main:
            print(f"Resumed from {resume} at epoch {start_epoch} "
                  f"(best PCK {best_pck:.2%})", flush=True)

    train_step = (make_scan_train_step(model, cfg, steps_per_epoch)
                  if spd > 1 else
                  make_train_step(model, cfg, steps_per_epoch))
    eval_loss_fn = make_eval_loss_fn(model, cfg)
    on_device = functools.partial(to_device, device=device)

    def validated(gen_batches):
        # episodic-structure validation on the producer thread
        # (reference model-entry checks, cape_model.py:99-117)
        for b in gen_batches:
            validate_episode_batch(b)
            yield b

    history = []
    for epoch in range(start_epoch, cfg.epochs):
        t0 = time.perf_counter()
        logger = MetricLogger()
        stream = validated(episode_batches(
            train_ds, sampler, local_batch, steps_per_epoch,
            cfg.image_size, cfg.max_support_keypoints,
            cfg.max_skeleton_edges, rng,
            num_threads=cfg.num_data_threads,
        ))
        if spd > 1:
            # fuse spd host batches into one (spd, B, ...) group
            stream = stack_batches(stream, spd)
        # build and copy on the prefetch thread, ahead of the steps
        batches = prefetch(stream, transform=on_device)
        prof = None
        for it, batch in enumerate(logger.log_every(
                batches, print_freq, header=f"Epoch [{epoch}]")):
            # a torch.profiler trace of steps 2-4 of the first epoch
            if cfg.profile_dir and epoch == start_epoch and it == 2:
                prof = _start_profile()
            state, metrics = train_step(state, batch, gen)
            if prof is not None and it == 4:
                _stop_profile(prof, cfg.profile_dir, epoch)
                prof = None
            # spd>1: each metric carries a leading (spd,) axis — log every
            # real optimizer step so averages/NaN checks stay per-step
            host_m = {k: np.atleast_1d(v.detach().cpu().numpy())
                      for k, v in metrics.items()}
            for j, total in enumerate(host_m["total"]):
                total = float(total)
                if math.isnan(total):
                    raise RuntimeError(
                        f"NaN loss at epoch {epoch} step {it * spd + j} — "
                        f"aborting (parity with engine_cape.py:206-209)"
                    )
                logger.update(
                    loss=total, loss_ce=float(host_m["loss_ce"][j]),
                    loss_coords=float(host_m["loss_coords"][j]),
                    grad_norm=float(host_m["grad_norm"][j]),
                )
                if debug_enabled("DEBUG_CAPE"):
                    parts = " ".join(f"{k}={float(v[j]):.4f}"
                                     for k, v in sorted(host_m.items()))
                    print(f"[DEBUG_CAPE] epoch {epoch} it {it * spd + j}: "
                          f"{parts}", flush=True)
        if prof is not None:  # an epoch of fewer than 5 steps
            _stop_profile(prof, cfg.profile_dir, epoch)
        train_s = time.perf_counter() - t0

        # ---- validation: batched autoregressive decode ----
        t1 = time.perf_counter()
        if multi:
            # sharded: each rank decodes a disjoint slice of the episodes,
            # in per-rank batches of eval_batch_size // ranks (one card a
            # rank), and every rank scores the gathered outputs; no
            # validation loss, as in the JAX loop
            n_ranks = process_count()
            valid = -(-cfg.val_episodes_per_epoch // n_ranks)
            eval_b, n_val_batches = eval_batch_plan(
                valid, max(1, cfg.eval_batch_size // n_ranks))
            fixed = None
            if fixed_val is not None:
                fixed, valid = host_episode_slice(
                    fixed_val, cfg.val_episodes_per_epoch)
            val_rng = np.random.default_rng([cfg.val_seed, process_index()])
            eval_kw = dict(multihost=True)
        else:
            fixed, valid = fixed_val, cfg.val_episodes_per_epoch
            eval_b, n_val_batches = eval_batch_plan(valid, cfg.eval_batch_size)
            val_rng = np.random.default_rng(cfg.val_seed)
            eval_kw = dict(compute_loss=True, eval_loss_fn=eval_loss_fn)
        val_batches = episode_batches(
            val_ds, val_sampler, eval_b, n_val_batches,
            cfg.image_size, cfg.max_support_keypoints,
            cfg.max_skeleton_edges, val_rng,
            fixed=fixed, total_episodes=valid,
            num_threads=cfg.num_data_threads,
        )
        val_stats = evaluate_cape(
            model, prefetch(val_batches, transform=on_device), cfg,
            decode_max_len=val_cap, **eval_kw,
        )
        val_s = time.perf_counter() - t1
        pck = val_stats["pck"]
        train_loss = logger.meters["loss"].global_avg
        if main:
            print(
                f"Epoch {epoch}: train loss {train_loss:.4f} | val PCK@0.2 "
                f"{pck:.2%} (macro {val_stats['pck_mean_categories']:.2%}) | "
                f"{time.perf_counter() - t0:.1f}s", flush=True,
            )
        # overfitting heuristic banner (reference
        # `train_cape_episodic.py:793-835` val/train ratio banding)
        val_loss = val_stats.get("total", 0.0)
        if train_loss > 0 and val_loss > 0:
            ratio = val_loss / train_loss
            if ratio > 2.0:
                print(f"  ⚠ val/train loss ratio {ratio:.2f} — strong "
                      f"overfitting signs", flush=True)
            elif ratio > 1.5:
                print(f"  note: val/train loss ratio {ratio:.2f} — mild "
                      f"overfitting", flush=True)
        history.append({"epoch": epoch, "train_loss": train_loss, "pck": pck,
                        "pck_num_correct": val_stats["pck_num_correct"],
                        "pck_num_visible": val_stats["pck_num_visible"],
                        "train_s": train_s, "val_s": val_s})

        # ---- checkpointing / early stopping ----
        # every rank's rng states go to rank 0, which alone writes; the
        # decisions use the gathered PCK, the same on every rank
        rng_state, gen_state = numpy_rng_state(rng), torch_rng_state(gen)
        rank_states = (allgather_object({"rng_state": rng_state,
                                         "torch_rng_state": gen_state})
                       if multi else None)
        improved = pck > best_pck
        if improved:
            best_pck = pck
            patience = 0
            if main:
                ckpt.save_best(state, epoch, pck, cfg, best_pck, patience,
                               rng_state=rng_state, torch_rng_state=gen_state,
                               rank_states=rank_states)
        else:
            patience += 1
        if main:
            ckpt.save_epoch(state, epoch, cfg, best_pck, patience,
                            rng_state=rng_state, torch_rng_state=gen_state,
                            extra={"val_stats": {
                                k: v for k, v in val_stats.items()
                                if np.isscalar(v)}},
                            rank_states=rank_states)
        if cfg.early_stopping_patience and patience >= cfg.early_stopping_patience:
            if main:
                print(f"Early stopping at epoch {epoch} (no PCK "
                      f"improvement for {patience} epochs)", flush=True)
            break

    if main:
        ckpt.wait()
    return {"best_pck": best_pck, "history": history, "state": state}


def instrumented(on_batch: Callable, on_step: Callable,
                 module=None) -> Dict[str, Callable]:
    """Stand-ins for the seams of a loop's `train_loop` that report what it
    trains on: `on_batch(b)` sees each host batch where the loop validates
    it, and each train-step call runs as `on_step(step, state, batch,
    gen)`, which calls `step` and returns its result. `module` is this
    loop by default, or another with the same seams (the JAX package's).
    Install them with `unittest.mock.patch.multiple(module, **stand_ins)`
    or pytest's `monkeypatch.setattr`."""
    module = module or sys.modules[__name__]
    check = module.validate_episode_batch

    def validate(b):
        on_batch(b)
        return check(b)

    def wrap(make):
        def make_step(*args):
            step = make(*args)
            return lambda state, batch, gen: on_step(step, state, batch, gen)
        return make_step

    return {"validate_episode_batch": validate,
            "make_train_step": wrap(module.make_train_step),
            "make_scan_train_step": wrap(module.make_scan_train_step)}


def _start_profile():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _stop_profile(prof, profile_dir: str, epoch: int) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"train_epoch{epoch}_steps2-4.json")
    prof.export_chrome_trace(path)
    print(f"profiler trace of steps 2-4 written to {path}", flush=True)
