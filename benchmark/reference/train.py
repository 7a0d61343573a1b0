"""Plain float32 training of the reference model: the CAPE criterion, the
optimizer chain and its schedule, written from their definitions.

- Loss per decoder layer: class-weighted cross-entropy ([1, 1, eos_weight]
  over coord/sep/eos, weighted mean over supervised visible positions)
  plus coords_loss_coef x the mean L1 over visible coordinate elements;
  the total sums every layer (the auxiliary ones too).
- Optimizer: the micro-steps' gradients averaged over
  `accumulation_steps`; then global-norm clipping to `clip_max_norm`,
  Adam (0.9, 0.999, 1e-8, bias-corrected), decoupled weight decay on every
  leaf, and a learning rate per group: the backbone's, the sampling
  offsets' (lr x lr_linear_proj_mult) and the rest's, each under the
  cosine schedule with warm restarts (t0, t_mult, eta_min, in epochs of
  `steps_per_epoch` updates) times a linear warm-up over `warmup_epochs`.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch


def criterion(classes, refs, targets, c: Dict, signs=None
              ) -> Dict[str, torch.Tensor]:
    """The losses by the program's names: `loss_ce` and `loss_coords` of
    the last layer, `loss_ce_{i}` and `loss_coords_{i}` of the others, and
    `total`. classes (layers, B, L, 3), refs (layers, B, L, 2). `signs`
    (layers, B, L, 2), where given, stands in for sign(refs - target) in
    the L1 terms: their values at the positions where it agrees, and
    their gradients everywhere, are those of the L1 with these signs."""
    labels = targets["token_labels"].long()
    vis = targets["visibility_mask"].bool()
    ce_mask = (labels != -1) & vis
    co_mask = (labels == 0) & vis
    safe = labels.clamp(0, 2)
    class_w = torch.tensor([1.0, 1.0, c["eos_weight"]],
                           device=labels.device)
    w = class_w[safe] * ce_mask.float()
    m = co_mask.float()[..., None]
    total, out = 0.0, {}
    last = len(classes) - 1
    for i, (logits, coords) in enumerate(zip(classes, refs)):
        logp = torch.log_softmax(logits, -1)
        nll = -logp.gather(-1, safe[..., None])[..., 0]
        ce = (nll * w).sum() / w.sum().clamp(min=1e-30)
        diff = coords - targets["target_seq"]
        diff = diff.abs() if signs is None else diff * signs[i]
        l1 = (diff * m).sum() / (2.0 * m.sum()).clamp(min=1e-30)
        tag = "" if i == last else f"_{i}"
        out["loss_ce" + tag], out["loss_coords" + tag] = ce, l1
        total = total + c["cls_loss_coef"] * ce + c["coords_loss_coef"] * l1
    out["total"] = total
    return out


def learning_rate(c: Dict, base: float, update: int,
                  steps_per_epoch: int) -> float:
    """The learning rate of the `update`-th update (from 0)."""
    epoch = update / steps_per_epoch
    t0, tm = c["t0"], c["t_mult"]
    if tm == 1:
        t_cur, t_i = epoch % t0, t0
    else:
        n = math.floor(math.log(max(epoch / t0 * (tm - 1) + 1, 1.0))
                       / math.log(tm) + 1e-6)
        t_cur = epoch - t0 * (tm ** n - 1) / (tm - 1)
        t_i = t0 * tm ** n
    lr = c["eta_min"] + (base - c["eta_min"]) * 0.5 * (
        1 + math.cos(math.pi * t_cur / t_i))
    warm = c["warmup_epochs"] * steps_per_epoch
    if warm > 0:
        lr *= min(max((update + 1) / warm, 0.0), 1.0)
    return lr


def group_of(name: str) -> str:
    if "backbone" in name:
        return "backbone"
    if "sampling_offsets" in name:
        return "offsets"
    return "base"


class AdamW:
    """The optimizer chain over named float32 parameters."""

    def __init__(self, params: Dict[str, torch.Tensor], c: Dict,
                 steps_per_epoch: int):
        if c["scheduler"] != "cosine_warmrestarts":
            raise ValueError("the reference follows cosine_warmrestarts only")
        if c.get("freeze_backbone_affine") or c.get("resnet_weights"):
            raise ValueError("the reference trains every leaf")
        self.p, self.c, self.spe = params, c, steps_per_epoch
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.acc = {k: torch.zeros_like(v) for k, v in params.items()}
        self.micro = 0
        self.updates = 0

    def step(self, grads: Dict[str, torch.Tensor]) -> bool:
        """Add one micro-step's gradients; update every
        `accumulation_steps`-th. Returns whether it updated."""
        k = max(int(self.c["accumulation_steps"]), 1)
        for n, g in grads.items():
            self.acc[n] += g / k
        self.micro += 1
        if self.micro % k:
            return False
        c = self.c
        norm = torch.sqrt(sum((g * g).sum() for g in self.acc.values()))
        scale = c["clip_max_norm"] / norm if norm >= c["clip_max_norm"] \
            else torch.ones((), device=norm.device)
        self.updates += 1
        t = self.updates
        lrs = {"base": c["lr"], "backbone": c["lr_backbone"],
               "offsets": c["lr"] * c["lr_linear_proj_mult"]}
        lrs = {g: learning_rate(c, v, t - 1, self.spe)
               for g, v in lrs.items()}
        with torch.no_grad():
            for n, p in self.p.items():
                u = self.acc[n] * scale
                self.mu[n].mul_(0.9).add_(u, alpha=0.1)
                self.nu[n].mul_(0.999).addcmul_(u, u, value=0.001)
                mh = self.mu[n] / (1 - 0.9 ** t)
                vh = self.nu[n] / (1 - 0.999 ** t)
                upd = mh / (vh.sqrt() + 1e-8) + c["weight_decay"] * p
                p.sub_(lrs[group_of(n)] * upd)
                self.acc[n].zero_()
        return True


def grads_of(loss: torch.Tensor, params: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
    names = list(params)
    gs = torch.autograd.grad(loss, [params[n] for n in names],
                             allow_unused=True)
    return {n: torch.zeros_like(params[n]) if g is None else g
            for n, g in zip(names, gs)}


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.float()))
            for k, v in tensors.items()}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              names: List[str]) -> Dict[str, float]:
    """Each leaf's |prog - ref| / max(ref, the median leaf's ref)."""
    med = sorted(ref[n] for n in names)[len(names) // 2]
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
            for n in names}
