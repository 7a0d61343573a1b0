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
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..config import CAPEConfig


def _masked_mean(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den where den > 0, else 0 (no NaN from an empty selection)."""
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0),
                       torch.zeros_like(num))


def token_ce_loss(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor, eos_weight: float,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Weighted-mean CE. logits (B, L, C); labels (B, L) with -1 pads;
    mask (B, L) bool selecting supervised positions.

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
        w = mask.float()
    else:
        class_w = torch.ones((num_classes,), dtype=torch.float32,
                             device=logits.device)
        class_w[2] = eos_weight
        w = class_w[safe_labels] * mask.float()
    return _masked_mean((nll * w).sum(), w.sum())


def coords_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Masked element-mean L1. pred/target (B, L, 2); mask (B, L)."""
    diff = (pred.float() - target.float()).abs()
    m = mask.float()[..., None]
    return _masked_mean((diff * m).sum(), 2.0 * m.sum())


def cape_criterion(outputs: Dict[str, torch.Tensor],
                   targets: Dict[str, torch.Tensor], cfg: CAPEConfig,
                   sample_mask: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
    """All losses and the weighted total.

    Args:
        outputs: `CAPE.forward`'s dict — pred_logits (B, L, 3), pred_coords
            (B, L, 2), optional aux_classes/aux_coords (A, B, L, ...).
        targets: the tokenizer's dict — token_labels, visibility_mask,
            target_seq.
        sample_mask: optional (B,) bool; False rows contribute nothing
            (static-batch padding episodes in eval, `sample_valid`).
    Returns:
        dict with loss_ce, loss_coords, per-aux-layer loss_{ce,coords}_{i},
        and 'total'.
    """
    labels = targets["token_labels"]
    vis = targets["visibility_mask"].bool()
    ce_mask = (labels != -1) & vis
    coord_mask = (labels == 0) & vis
    if sample_mask is not None:
        keep = sample_mask.bool()[:, None]
        ce_mask = ce_mask & keep
        coord_mask = coord_mask & keep
    target_seq = targets["target_seq"]

    def layer_losses(logits, coords):
        return (token_ce_loss(logits, labels, ce_mask, cfg.eos_weight,
                              cfg.label_smoothing),
                coords_l1_loss(coords, target_seq, coord_mask))

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
