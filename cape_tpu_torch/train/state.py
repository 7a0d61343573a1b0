"""Train state, the fused group-LR AdamW and the LR schedules: the port of
`cape_tpu.train.state`.

The optimizer is the JAX package's optax chain, written out over flat lists
of fp32 tensors (`torch._foreach_*`), in the chain's order:

1. global-norm clip (`optax.clip_by_global_norm`: scale by max/norm only
   when the norm exceeds the limit, no epsilon);
2. Adam moments (`optax.scale_by_adam` defaults b1 0.9, b2 0.999, eps 1e-8,
   bias-corrected);
3. decoupled weight decay on every leaf (`optax.add_decayed_weights`);
4. per-group `-lr(count)`: backbone at `lr_backbone`, deformable
   `sampling_offsets` at `lr * lr_linear_proj_mult`, the rest at `lr`, and
   0 for frozen backbone affines;
5. `accumulation_steps` as `optax.MultiSteps`: the micro-step gradients
   are averaged (Welford, as optax does), the chain runs on the average
   every k-th micro-step, and the schedule counts real updates only.

The host keeps the counts (`OptState`'s ints, the schedule's source of
truth) and writes the scalars they give into a small fp32 tensor on the
masters' device before each call (`FusedAdamW.prepare`): the fold's
divisor, Adam's bias corrections and each group's `-lr`. The device work
(`fold`, `apply`) reads them from there and bakes in no host value, so
that a captured CUDA graph of it stays right at every step (`graphs`).

fp32 master parameters: the optimizer state owns an fp32 copy of every
parameter and updates it; a bf16 model's weights are refreshed from the
masters after each real update (flax keeps fp32 parameters and computes in
bf16, so the JAX package loses no update below bf16's resolution either).
Where a parameter is already fp32 (the fp32 islands, or an fp32 model),
the master is the parameter itself. The port updates in place where the
JAX package returns new trees.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..config import CAPEConfig
from ..models.backbone import FrozenAffine

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
#: the parameter groups, each with its own learning rate
GROUPS = ("base", "backbone", "offsets", "frozen")
#: the device scalars of one optimizer call, in `OptState.hyper`: the
#: fold's divisor, the bias corrections, each group's -lr
HYPER = ("fold", "bc1", "bc2") + tuple(f"lr_{g}" for g in GROUPS)


def make_lr_schedule(cfg: CAPEConfig, base_lr: float,
                     steps_per_epoch: int) -> Callable[[int], float]:
    """Per-step schedule: the configured scheduler times a linear warmup,
    evaluated in float32 like the JAX package's."""
    f32 = np.float32
    warmup_steps = cfg.warmup_epochs * steps_per_epoch

    def schedule(step: int) -> float:
        step = f32(step)
        epoch = step / f32(steps_per_epoch)
        if cfg.scheduler == "multistep":
            factor = f32(1.0)
            for e in cfg.lr_drop_epochs:
                factor = factor * (f32(0.1) if epoch >= e else f32(1.0))
            lr = f32(base_lr) * factor
        elif cfg.scheduler == "onecycle":
            total = max(cfg.epochs * steps_per_epoch, 1)
            pct = np.clip(step / f32(total), f32(0.0), f32(1.0))
            lr = cfg.eta_min + (base_lr - cfg.eta_min) * 0.5 * (
                1 + np.cos(f32(math.pi) * pct))
        else:  # cosine_warmrestarts (torch CosineAnnealingWarmRestarts)
            t0, tm = f32(cfg.t0), f32(cfg.t_mult)
            if tm == 1.0:
                t_cur, t_i = np.mod(epoch, t0), t0
            else:
                # closed form for the restart cycle n with
                # sum_{k<n} t0*tm^k <= epoch; the epsilon guards exact
                # boundaries (log(4)/log(2) can evaluate to 1.9999...)
                n = np.floor(np.log(np.maximum(epoch / t0 * (tm - 1) + 1,
                                               f32(1.0)))
                             / np.log(tm) + f32(1e-6))
                start = t0 * (tm ** n - 1) / (tm - 1)
                t_i = t0 * tm ** n
                t_cur = epoch - start
            lr = cfg.eta_min + (base_lr - cfg.eta_min) * 0.5 * (
                1 + np.cos(f32(math.pi) * t_cur / t_i))
        if warmup_steps > 0:
            lr = lr * np.clip((step + 1) / f32(warmup_steps), f32(0.0),
                              f32(1.0))
        return float(f32(lr))

    return schedule


def _param_labels(model: nn.Module, freeze_affine: bool = True
                  ) -> Dict[str, str]:
    """Label each parameter: frozen | backbone | offsets | base.

    Frozen-affine parameters are those of the backbone's `FrozenAffine`
    modules (the JAX package's `frozen_affine_*` leaves)."""
    affine = {f"{mn}.{pn}" for mn, m in model.named_modules()
              if isinstance(m, FrozenAffine)
              for pn, _ in m.named_parameters(recurse=False)}
    labels = {}
    for name, _ in model.named_parameters():
        if name in affine:
            labels[name] = "frozen" if freeze_affine else "backbone"
        elif "backbone" in name:
            labels[name] = "backbone"
        elif "sampling_offsets" in name:
            labels[name] = "offsets"
        else:
            labels[name] = "base"
    return labels


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """`optax.global_norm`: the fp32 L2 norm over every element."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


@dataclass
class OptState:
    """The optax state, flattened: one entry per parameter, in the order
    of `model.named_parameters()`."""

    names: List[str]
    labels: List[str]
    masters: List[torch.Tensor]      # fp32 parameters
    mu: List[torch.Tensor]           # Adam first moments, fp32
    nu: List[torch.Tensor]           # Adam second moments, fp32
    acc_grads: List[torch.Tensor]    # MultiSteps running mean, fp32
    adam_count: int = 0              # ScaleByAdamState.count
    sched_count: int = 0             # the group-LR link's count
    mini_step: int = 0               # MultiStepsState.mini_step
    gradient_step: int = 0           # MultiStepsState.gradient_step
    # this call's scalars (`HYPER`), fp32 on the masters' device; written
    # by `FusedAdamW.prepare`, not a part of the checkpoint
    hyper: Optional[torch.Tensor] = field(default=None, repr=False)


class FusedAdamW:
    """The port of `make_optimizer`: its chain (see the module docstring)
    as `init` and `update` over a model's parameters. Frozen backbone
    affines follow `freeze_backbone_affine`, or (None) are frozen iff
    pretrained weights are configured."""

    def __init__(self, cfg: CAPEConfig, steps_per_epoch: int):
        self.cfg = cfg
        self.steps_per_epoch = steps_per_epoch
        self.every_k = max(int(cfg.accumulation_steps), 1)
        self.freeze_affine = (cfg.freeze_backbone_affine
                              if cfg.freeze_backbone_affine is not None
                              else bool(cfg.resnet_weights))
        self.schedules = {
            "base": make_lr_schedule(cfg, cfg.lr, steps_per_epoch),
            "backbone": make_lr_schedule(cfg, cfg.lr_backbone,
                                         steps_per_epoch),
            "offsets": make_lr_schedule(
                cfg, cfg.lr * cfg.lr_linear_proj_mult, steps_per_epoch),
        }

    def group_lrs(self, count: int) -> Dict[str, float]:
        lrs = {k: s(count) for k, s in self.schedules.items()}
        lrs["frozen"] = 0.0
        return lrs

    def init(self, model: nn.Module,
             masters: Optional[Mapping[str, torch.Tensor]] = None
             ) -> OptState:
        """The state of a fresh run: the model's parameters become the fp32
        masters, except those `masters` gives fp32 values for by name (the
        model holding them rounded to its dtype)."""
        labels = _param_labels(model, self.freeze_affine)
        given = dict(masters or {})
        unknown = set(given) - set(labels)
        if unknown:
            raise KeyError(f"masters for no parameter: {sorted(unknown)}")
        names, masters = [], []
        for name, p in model.named_parameters():
            names.append(name)
            m = p.data if p.dtype == torch.float32 else p.data.float()
            if name in given:
                if tuple(given[name].shape) != tuple(p.shape):
                    raise ValueError(f"master {name!r}: shape "
                                     f"{tuple(given[name].shape)}, "
                                     f"parameter {tuple(p.shape)}")
                m.copy_(given[name])
            masters.append(m)

        def zeros():
            return [torch.zeros_like(m) for m in masters]

        return OptState(names, [labels[n] for n in names], masters, zeros(),
                        zeros(), zeros(),
                        hyper=torch.zeros(len(HYPER), dtype=torch.float32,
                                          device=masters[0].device))

    def update(self, grads: Sequence[torch.Tensor], state: OptState,
               params: Sequence[torch.Tensor]) -> bool:
        """Fold one micro-step's gradients in; on every k-th, apply the
        chain to the fp32 masters and refresh `params` from them. Returns
        whether this was a real update."""
        emit = self.prepare(state)
        self.fold(grads, state)
        if emit:
            self.apply(state, params)
        return emit

    def prepare(self, state: OptState) -> bool:
        """The host's part of one call: advance the counts and write the
        scalars they give into `state.hyper` (a copy queued on the current
        stream, ahead of the device work that reads it). Returns whether
        the call is a real update, which the host decides alone."""
        f32 = np.float32
        fold = float(state.mini_step + 1)
        emit = state.mini_step == self.every_k - 1
        state.mini_step = (state.mini_step + 1) % self.every_k
        bc1 = bc2 = 1.0
        lrs = dict.fromkeys(GROUPS, 0.0)
        if emit:
            # bias corrections at the incremented count; the group LRs at
            # the count before it increments
            state.adam_count += 1
            bc1 = float(f32(1) - f32(ADAM_B1) ** f32(state.adam_count))
            bc2 = float(f32(1) - f32(ADAM_B2) ** f32(state.adam_count))
            lrs = self.group_lrs(state.sched_count)
            state.sched_count += 1
            state.gradient_step += 1
        host = torch.tensor([fold, bc1, bc2] + [-lrs[g] for g in GROUPS],
                            dtype=torch.float32)
        if state.hyper.is_cuda:
            host = host.pin_memory()
        state.hyper.copy_(host, non_blocking=True)
        return emit

    def fold(self, grads: Sequence[torch.Tensor], state: OptState) -> None:
        """Fold one micro-step's gradients into the running mean (Welford,
        as optax.MultiSteps), dividing by `hyper`'s fold entry."""
        grads = [g.float() for g in grads]
        acc = state.acc_grads
        delta = torch._foreach_sub(grads, acc)
        torch._foreach_div_(delta, state.hyper[HYPER.index("fold")])
        torch._foreach_add_(acc, delta)

    def apply(self, state: OptState, params: Sequence[torch.Tensor]) -> None:
        """The chain on the averaged gradient, the fp32 masters updated and
        `params` refreshed from them, the average zeroed."""
        cfg = self.cfg
        g, hyper = state.acc_grads, state.hyper
        # 1. clip: (t / norm) * max_norm when norm >= max_norm
        norm = global_norm(g)
        one = torch.ones((), dtype=torch.float32, device=norm.device)
        clip = norm >= cfg.clip_max_norm
        u = torch._foreach_div(g, torch.where(clip, norm, one))
        torch._foreach_mul_(u, torch.where(clip, one * cfg.clip_max_norm,
                                           one))
        # 2. Adam moments, bias-corrected
        torch._foreach_mul_(state.mu, ADAM_B1)
        torch._foreach_add_(state.mu, u, alpha=1 - ADAM_B1)
        torch._foreach_mul_(state.nu, ADAM_B2)
        torch._foreach_addcmul_(state.nu, u, u, value=1 - ADAM_B2)
        del u
        u = torch._foreach_div(state.mu, hyper[HYPER.index("bc1")])
        den = torch._foreach_div(state.nu, hyper[HYPER.index("bc2")])
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, ADAM_EPS)
        torch._foreach_div_(u, den)
        del den
        # 3. decoupled weight decay on every leaf
        torch._foreach_add_(u, state.masters, alpha=cfg.weight_decay)
        # 4. per-group -lr
        for label in GROUPS:
            idx = [i for i, l in enumerate(state.labels) if l == label]
            if idx:
                torch._foreach_mul_([u[i] for i in idx],
                                    hyper[HYPER.index(f"lr_{label}")])
        torch._foreach_add_(state.masters, u)
        torch._foreach_zero_(g)
        with torch.no_grad():
            for p, m in zip(params, state.masters):
                if p.data_ptr() != m.data_ptr():
                    p.copy_(m)


@dataclass
class TrainState:
    """`step` counts micro-steps (the JAX package's `TrainState.step`);
    `model` holds the compute-dtype parameters, `tx` the optimizer and
    `opt_state` the fp32 masters and the optimizer state."""

    step: int
    model: nn.Module
    tx: FusedAdamW = field(repr=False)
    opt_state: OptState = field(repr=False)

    def state_dict(self) -> Dict:
        """What `load_state_dict` takes: `step`, the fp32 masters as
        `params`, `mu`, `nu`, `acc_grads` (dicts by parameter name, the
        state's own tensors) and the four counts. The model's compute-dtype
        copies are not in it: they are the masters, cast."""
        st = self.opt_state
        return {"step": self.step,
                "params": dict(zip(st.names, st.masters)),
                "mu": dict(zip(st.names, st.mu)),
                "nu": dict(zip(st.names, st.nu)),
                "acc_grads": dict(zip(st.names, st.acc_grads)),
                "adam_count": st.adam_count, "sched_count": st.sched_count,
                "mini_step": st.mini_step,
                "gradient_step": st.gradient_step}

    def load_state_dict(self, sd: Mapping) -> None:
        """Load a state: `step`, `params` (the fp32 masters), `mu`, `nu`,
        `acc_grads` (dicts by parameter name) and the four counts, from
        `state_dict()` (a checkpoint, `utils.checkpoint`) or carried over
        from the JAX package (`convert.from_jax_train_state`). Every entry
        must match."""
        st = self.opt_state
        for key in ("params", "mu", "nu", "acc_grads"):
            got = set(sd[key])
            if got != set(st.names):
                raise KeyError(f"{key}: missing {sorted(set(st.names) - got)}"
                               f", unexpected {sorted(got - set(st.names))}")
        params = dict(self.model.named_parameters())
        for i, name in enumerate(st.names):
            for key in ("params", "mu", "nu", "acc_grads"):
                shape = tuple(sd[key][name].shape)
                if shape != tuple(st.masters[i].shape):
                    raise ValueError(f"{key}[{name!r}]: shape {shape}, "
                                     f"expected {tuple(st.masters[i].shape)}")
        with torch.no_grad():
            for i, name in enumerate(st.names):
                st.masters[i].copy_(sd["params"][name])
                if params[name].data_ptr() != st.masters[i].data_ptr():
                    params[name].copy_(st.masters[i])
                st.mu[i].copy_(sd["mu"][name])
                st.nu[i].copy_(sd["nu"][name])
                st.acc_grads[i].copy_(sd["acc_grads"][name])
        self.step = int(sd["step"])
        st.adam_count = int(sd["adam_count"])
        st.sched_count = int(sd["sched_count"])
        st.mini_step = int(sd["mini_step"])
        st.gradient_step = int(sd["gradient_step"])


def create_train_state(cfg: CAPEConfig, model: nn.Module,
                       steps_per_epoch: int,
                       masters: Optional[Mapping[str, torch.Tensor]] = None
                       ) -> TrainState:
    """Build the state of a fresh run around `model`: its current
    parameters become the fp32 masters, except those `masters` gives fp32
    values for by name (weights loaded into a bf16 model, e.g. the
    backbone's from `models.backbone.load_torch_resnet50_npz`, keep their
    fp32 values as the JAX package's fp32 parameters do)."""
    tx = FusedAdamW(cfg, steps_per_epoch)
    return TrainState(step=0, model=model, tx=tx,
                      opt_state=tx.init(model, masters))
