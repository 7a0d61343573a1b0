"""CAPE losses: the port of `cape_tpu.losses.criterion`.

Visibility-masked, EOS-weighted token cross-entropy plus masked coordinate
L1, per decoder layer (`models/cape_losses.py:39-202` of the reference):

- token-type cross-entropy over positions where `token_labels != -1` AND
  `visibility_mask`, with class weights [1, 1, eos_weight] and the
  `F.cross_entropy(weight=...)` weighted-mean reduction
  (sum(w_i * ce_i) / sum(w_i)); with `label_smoothing > 0` an unweighted
  smoothed NLL instead;
- L1 over coordinate positions gated by the same visibility mask, mean over
  the selected *elements* (x and y);
- the same losses per auxiliary decoder layer; total = sum of
  cls_loss_coef * loss_ce + coords_loss_coef * loss_coords.

Every reduction is in fp32; an empty selection gives a zero loss.

Across processes the JAX step is one global program: its means divide by
the weight sums of the global batch. Each rank here divides its own sums
by those global denominators (`loss_denominators`, summed across ranks by
the train step before the division), so that the ranks' losses and
gradients add up to the global ones. The denominators depend on labels
and masks only: no gradient flows through them.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..config import CAPEConfig

#: the class head's outputs: coord, sep, eos
NUM_CLASSES = 3


def _masked_mean(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den where den > 0, else 0 (no NaN from an empty selection)."""
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0),
                       torch.zeros_like(num))


def _ce_weights(labels: torch.Tensor, mask: torch.Tensor, num_classes: int,
                eos_weight: float, label_smoothing: float) -> torch.Tensor:
    """Per-position CE weights: class weight [1, 1, eos_weight] times the
    mask, or the mask alone under label smoothing."""
    if label_smoothing > 0:
        return mask.float()
    safe_labels = labels.clamp(0, num_classes - 1).long()
    class_w = torch.ones((num_classes,), dtype=torch.float32,
                         device=labels.device)
    class_w[2] = eos_weight
    return class_w[safe_labels] * mask.float()


def token_ce_loss(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor, eos_weight: float,
                  label_smoothing: float = 0.0,
                  den: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted-mean CE. logits (B, L, C); labels (B, L) with -1 pads;
    mask (B, L) bool selecting supervised positions; `den` replaces the
    weight sum (the global one across processes).

    With `label_smoothing > 0` the EOS class weight is dropped:
    loss_i = (1-eps)*nll_i + eps/C * sum_c(-logp_ic), plain mean.
    """
    num_classes = logits.shape[-1]
    safe_labels = labels.clamp(0, num_classes - 1).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe_labels[..., None])[..., 0]
    if label_smoothing > 0:
        eps = float(label_smoothing)
        smooth = -logp.sum(-1) / num_classes
        nll = (1.0 - eps) * nll + eps * smooth
    w = _ce_weights(labels, mask, num_classes, eos_weight, label_smoothing)
    return _masked_mean((nll * w).sum(), w.sum() if den is None else den)


def coords_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                   mask: torch.Tensor,
                   den: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked element-mean L1. pred/target (B, L, 2); mask (B, L); `den`
    replaces the element count (the global one across processes)."""
    diff = (pred.float() - target.float()).abs()
    m = mask.float()[..., None]
    return _masked_mean((diff * m).sum(), 2.0 * m.sum() if den is None
                        else den)


def _masks(targets: Dict[str, torch.Tensor],
           sample_mask: Optional[torch.Tensor]):
    """(labels, CE mask, coordinate mask) of a batch's targets."""
    labels = targets["token_labels"]
    vis = targets["visibility_mask"].bool()
    ce_mask = (labels != -1) & vis
    coord_mask = (labels == 0) & vis
    if sample_mask is not None:
        keep = sample_mask.bool()[:, None]
        ce_mask = ce_mask & keep
        coord_mask = coord_mask & keep
    return labels, ce_mask, coord_mask


def loss_denominators(targets: Dict[str, torch.Tensor], cfg: CAPEConfig,
                      sample_mask: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """(2,) fp32: the CE weight sum and the L1 element count of a batch,
    the denominators of every layer's losses. Summed across processes they
    are the global batch's, which `cape_criterion(denominators=...)`
    divides by."""
    labels, ce_mask, coord_mask = _masks(targets, sample_mask)
    w = _ce_weights(labels, ce_mask, NUM_CLASSES, cfg.eos_weight,
                    cfg.label_smoothing)
    return torch.stack([w.sum(), 2.0 * coord_mask.float().sum()])


def cape_criterion(outputs: Dict[str, torch.Tensor],
                   targets: Dict[str, torch.Tensor], cfg: CAPEConfig,
                   sample_mask: Optional[torch.Tensor] = None,
                   denominators: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
    """All losses and the weighted total.

    Args:
        outputs: `CAPE.forward`'s dict — pred_logits (B, L, 3), pred_coords
            (B, L, 2), optional aux_classes/aux_coords (A, B, L, ...).
        targets: the tokenizer's dict — token_labels, visibility_mask,
            target_seq.
        sample_mask: optional (B,) bool; False rows contribute nothing
            (static-batch padding episodes in eval, `sample_valid`).
        denominators: optional (2,) from `loss_denominators`, summed
            across processes; None divides by this batch's own.
    Returns:
        dict with loss_ce, loss_coords, per-aux-layer loss_{ce,coords}_{i},
        and 'total'.
    """
    labels, ce_mask, coord_mask = _masks(targets, sample_mask)
    target_seq = targets["target_seq"]
    ce_den, co_den = (None, None) if denominators is None else denominators

    def layer_losses(logits, coords):
        return (token_ce_loss(logits, labels, ce_mask, cfg.eos_weight,
                              cfg.label_smoothing, ce_den),
                coords_l1_loss(coords, target_seq, coord_mask, co_den))

    ce, co = layer_losses(outputs["pred_logits"], outputs["pred_coords"])
    losses = {"loss_ce": ce, "loss_coords": co}
    total = cfg.cls_loss_coef * ce + cfg.coords_loss_coef * co
    if "aux_classes" in outputs:
        for i in range(outputs["aux_classes"].shape[0]):
            ce, co = layer_losses(outputs["aux_classes"][i],
                                  outputs["aux_coords"][i])
            losses[f"loss_ce_{i}"] = ce
            losses[f"loss_coords_{i}"] = co
            total = total + cfg.cls_loss_coef * ce + cfg.coords_loss_coef * co
    losses["total"] = total
    return losses
