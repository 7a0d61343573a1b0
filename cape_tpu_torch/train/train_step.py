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

On a CUDA model in one process the step is the counterpart of the JAX
package's `jax.jit(train_step)`: `micro_step` is captured into CUDA graphs
at the first call per batch shape and replayed after (`graphs`), with
the optimizer's scalars written to the device by the host's count
(`FusedAdamW.prepare`); `make_scan_train_step` queues N replays with no
host read, the counterpart of its `lax.scan`. `graphs.step_route` names
the configs that stay eager. A micro-step is the root span
`train.micro_step` (`trace`): `step.prepare` (the optimizer's host count
and scalars, the program's lookup), then on the captured route
`step.copy_in`, `step.replay` and `step.clone` (the metrics out of the
graph's buffer).

Across processes (a `torch.distributed` group made before the step, see
`parallel`) each rank steps on its share of the global batch, and the
step stays the JAX package's global one: the loss denominators are summed
across ranks before the division, and the gradients and losses are summed
in one fp32 all-reduce after the backward, every micro-step. Every rank
then holds the global gradient, losses and `grad_norm` and makes the same
update. `DistributedDataParallel` cannot do this: its reducer hooks the
gradient accumulators, which `torch.autograd.grad` never runs.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from .. import trace
from ..config import CAPEConfig
from ..losses import cape_criterion
from ..losses.criterion import loss_denominators
from ..models.cape import CAPE
from ..parallel import allreduce_sum_flat, process_count
from .state import TrainState, global_norm


def _to_device(tree, device: torch.device):
    """A batch dict (nested, numpy arrays or tensors) on `device`."""
    if isinstance(tree, Mapping):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return torch.as_tensor(tree, device=device)


def forward_losses(model: CAPE, cfg: CAPEConfig, batch: Mapping,
                   generator: Optional[torch.Generator] = None,
                   sample_mask=None, denominators=None
                   ) -> Dict[str, torch.Tensor]:
    """The loss dict of one teacher-forced forward on `batch` (keys
    query_images, support_coords, support_mask, skeleton_edges, targets);
    `denominators` as `cape_criterion` takes them."""
    b = _to_device(batch, model.device)
    outputs = model(b["query_images"], b["support_coords"], b["support_mask"],
                    b["skeleton_edges"], b["targets"], generator)
    if sample_mask is not None:
        sample_mask = torch.as_tensor(sample_mask, device=model.device)
    return cape_criterion(outputs, b["targets"], cfg, sample_mask=sample_mask,
                          denominators=denominators)


def losses_and_grads(model: CAPE, cfg: CAPEConfig, batch: Mapping,
                     generator: Optional[torch.Generator] = None,
                     denominators=None):
    """The losses of one teacher-forced forward on a device batch and the
    gradient of every parameter (zeros where none flows), in the order of
    `model.named_parameters()`."""
    params = [p for _, p in model.named_parameters()]
    losses = forward_losses(model, cfg, batch, generator,
                            denominators=denominators)
    grads = torch.autograd.grad(losses["total"], params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, params)]
    return losses, grads


def micro_step(model: CAPE, cfg: CAPEConfig, state: TrainState,
               batch: Mapping, generator: Optional[torch.Generator],
               emit: bool, multi: bool = False) -> Dict[str, torch.Tensor]:
    """The device work of one micro-step on a device batch: forward,
    gradients, the fold and, when `emit` (the host's count, from
    `state.tx.prepare`), the update. Returns the loss dict and
    `grad_norm`. With `multi` the denominators, gradients and losses are
    summed across the process group. This is the body that `graphs`
    captures (without `multi`)."""
    den = None
    if multi:
        (den,) = allreduce_sum_flat([loss_denominators(batch["targets"],
                                                       cfg)])
    losses, grads = losses_and_grads(model, cfg, batch, generator, den)
    metrics = {k: v.detach() for k, v in losses.items()}
    if multi:
        # the global gradient and losses: one fp32 all-reduce (SUM)
        keys = list(metrics)
        summed = allreduce_sum_flat(grads + [metrics[k] for k in keys])
        grads = summed[:len(grads)]
        metrics = dict(zip(keys, summed[len(grads):]))
    metrics["grad_norm"] = global_norm(grads)
    state.tx.fold(grads, state.opt_state)
    if emit:
        state.tx.apply(state.opt_state,
                       [p for _, p in model.named_parameters()])
    return metrics


def make_train_step(model: CAPE, cfg: CAPEConfig, steps_per_epoch: int
                    ) -> Callable[..., Tuple[TrainState, Dict]]:
    """Returns `step(state, batch, generator=None) -> (state, metrics)`.

    `metrics` are the loss dict and `grad_norm`, the global norm of this
    micro-step's gradients before clipping, as device scalars. The
    optimizer is the state's own (`state.tx`, from `create_train_state`).
    Under a process group of more than one rank when the step is made,
    `batch` is this rank's share and the step is the global one (see the
    module docstring).

    On a CUDA model in one process, the counterpart of the JAX package's
    `jax.jit(train_step)`: the micro-step is captured into CUDA graphs at
    its first call per batch shape and replayed after
    (`graphs.step_program`); `graphs.step_route` says which configs stay
    eager, decided here, before any capture."""
    run = _micro_step_runner(model, cfg, steps_per_epoch)

    def train_step(state: TrainState, batch: Mapping,
                   generator: Optional[torch.Generator] = None):
        keys, values = run(state, batch, generator)
        return state, dict(zip(keys, values))

    return train_step


def _micro_step_runner(model: CAPE, cfg: CAPEConfig, steps_per_epoch: int):
    """`run(state, batch, generator) -> (keys, values)`: one micro-step on
    the route `graphs.step_route` picks, with the state's counts advanced;
    `values` are the metrics in a sequence of device scalars, new tensors
    that no later step overwrites."""
    from .. import graphs

    multi = process_count() > 1
    captured = graphs.step_route(model, cfg) is None

    def run(state: TrainState, batch: Mapping,
            generator: Optional[torch.Generator]):
        if state.model is not model:
            raise ValueError("the state was created for another model")
        if state.tx.steps_per_epoch != steps_per_epoch:
            raise ValueError(f"the state's optimizer has steps_per_epoch "
                             f"{state.tx.steps_per_epoch}, the step "
                             f"{steps_per_epoch}")
        with trace.span("train.micro_step", root=True):
            with trace.span("step.prepare"):
                emit = state.tx.prepare(state.opt_state)
                program = (graphs.step_program(model, state, batch,
                                               generator)
                           if captured else None)
            if captured:
                keys, out = program.run(model, cfg, state, batch, emit)
                with trace.span("step.clone"):
                    values = out.clone().unbind(0)
            else:
                metrics = micro_step(model, cfg, state,
                                     _to_device(batch, model.device),
                                     generator, emit, multi)
                keys, values = list(metrics), list(metrics.values())
        state.step += 1
        return keys, values

    return run


def make_scan_train_step(model: CAPE, cfg: CAPEConfig, steps_per_epoch: int
                         ) -> Callable[..., Tuple[TrainState, Dict]]:
    """N micro-steps over a STACKED batch (every leaf has a leading N axis),
    one after another with the same generator; metrics come back with a
    leading (N,) axis. The counterpart of the JAX package's `lax.scan`
    dispatch: on the captured route (`make_train_step`) the N replays are
    queued with no host read between them and write their metrics into
    one (N, metrics) device buffer, which the caller reads once."""
    run = _micro_step_runner(model, cfg, steps_per_epoch)

    def slice_at(tree, i):
        if isinstance(tree, Mapping):
            return {k: slice_at(v, i) for k, v in tree.items()}
        return tree[i]

    def scan_step(state: TrainState, stacked_batch: Mapping,
                  generator: Optional[torch.Generator] = None):
        n = len(stacked_batch["query_images"])
        keys, rows = None, []
        for i in range(n):
            keys, values = run(state, slice_at(stacked_batch, i), generator)
            rows.append(torch.stack(list(values)))
        buf = torch.stack(rows)                          # (N, metrics)
        return state, {k: buf[:, j] for j, k in enumerate(keys)}

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
