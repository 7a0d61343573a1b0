"""Train and eval-loss steps: the port of `cape_tpu.train.train_step`.

One step is: teacher-forced forward -> weighted loss -> gradients of every
parameter -> the fused AdamW of `train.state` (clip, Adam, weight decay,
group LR, gradient accumulation). On the card every MSDA site runs the
gather kernel forward and the scatter kernel backward. The state is updated
in place and returned, where the JAX package returns a new one.

Dropout masks come from the explicit `torch.Generator` a step receives (on
the model's device), the counterpart of the JAX `rng`; `generator=None` is
deterministic, as a missing dropout rng is there. The NaN guard stays with
the host loop, which reads the returned losses.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from ..config import CAPEConfig
from ..losses import cape_criterion
from ..models.cape import CAPE
from .state import TrainState, global_norm


def _to_device(tree, device: torch.device):
    """A batch dict (nested, numpy arrays or tensors) on `device`."""
    if isinstance(tree, Mapping):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return torch.as_tensor(tree, device=device)


def forward_losses(model: CAPE, cfg: CAPEConfig, batch: Mapping,
                   generator: Optional[torch.Generator] = None,
                   sample_mask=None) -> Dict[str, torch.Tensor]:
    """The loss dict of one teacher-forced forward on `batch` (keys
    query_images, support_coords, support_mask, skeleton_edges, targets)."""
    b = _to_device(batch, model.device)
    outputs = model(b["query_images"], b["support_coords"], b["support_mask"],
                    b["skeleton_edges"], b["targets"], generator)
    if sample_mask is not None:
        sample_mask = torch.as_tensor(sample_mask, device=model.device)
    return cape_criterion(outputs, b["targets"], cfg, sample_mask=sample_mask)


def make_train_step(model: CAPE, cfg: CAPEConfig, steps_per_epoch: int
                    ) -> Callable[..., Tuple[TrainState, Dict]]:
    """Returns `step(state, batch, generator=None) -> (state, metrics)`.

    `metrics` are the loss dict and `grad_norm`, the global norm of this
    micro-step's gradients before clipping, as device scalars. The
    optimizer is the state's own (`state.tx`, from `create_train_state`)."""

    def train_step(state: TrainState, batch: Mapping,
                   generator: Optional[torch.Generator] = None):
        if state.model is not model:
            raise ValueError("the state was created for another model")
        if state.tx.steps_per_epoch != steps_per_epoch:
            raise ValueError(f"the state's optimizer has steps_per_epoch "
                             f"{state.tx.steps_per_epoch}, the step "
                             f"{steps_per_epoch}")
        params = [p for _, p in model.named_parameters()]
        losses = forward_losses(model, cfg, batch, generator)
        grads = torch.autograd.grad(losses["total"], params,
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, params)]
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["grad_norm"] = global_norm(grads)
        state.tx.update(grads, state.opt_state, params)
        state.step += 1
        return state, metrics

    return train_step


def make_scan_train_step(model: CAPE, cfg: CAPEConfig, steps_per_epoch: int
                         ) -> Callable[..., Tuple[TrainState, Dict]]:
    """N micro-steps over a STACKED batch (every leaf has a leading N axis),
    one after another with the same generator; metrics come back with a
    leading (N,) axis. The JAX package fuses these into one `lax.scan`
    dispatch; here it is a loop."""
    inner = make_train_step(model, cfg, steps_per_epoch)

    def slice_at(tree, i):
        if isinstance(tree, Mapping):
            return {k: slice_at(v, i) for k, v in tree.items()}
        return tree[i]

    def scan_step(state: TrainState, stacked_batch: Mapping,
                  generator: Optional[torch.Generator] = None):
        n = len(stacked_batch["query_images"])
        per_step = []
        for i in range(n):
            state, m = inner(state, slice_at(stacked_batch, i), generator)
            per_step.append(m)
        return state, {k: torch.stack([m[k] for m in per_step])
                       for k in per_step[0]}

    return scan_step


def make_eval_loss_fn(model: CAPE, cfg: CAPEConfig):
    """`eval_loss(batch)`: the teacher-forced losses of `model` on a
    validation batch, without dropout or gradients. Rows with
    `sample_valid` False (static-batch padding episodes) are left out of
    the averages."""

    def eval_loss(batch: Mapping) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            return forward_losses(model, cfg, batch,
                                  sample_mask=batch.get("sample_valid"))

    return eval_loss
