"""Autoregressive validation/test evaluation with PCK@0.2, the port of
`cape_tpu.eval.evaluate`.

Parity with `evaluate_cape` / `evaluate_unseen_categories`
(`models/engine_cape.py:394-1114`), as the JAX package keeps it:

- predictions are generated autoregressively (never teacher-forced);
- GT keypoints come from the target sequence via GT token labels, predicted
  keypoints from PREDICTED token labels (argmax of the class head,
  `engine_cape.py:643-662` / `util/sequence_utils.py:8-65`);
- per-sample predictions are trimmed/zero-padded to the category's keypoint
  count (`engine_cape.py:743-798`);
- keypoints scale from [0,1] to image pixels (x image_size) before PCK
  against original-bbox dimensions (`engine_cape.py:815-828`);
- micro + macro PCK with per-category breakdown.

Deviations from the reference (the JAX package's, kept):
- token positions after a sample's own EOS are excluded from extraction via
  the `active` mask;
- the optional validation loss is computed teacher-forced.

The decode runs on the model's device (the card unless the model was
built on the CPU), as replays of captured CUDA graphs on the card
(`decode`); its outputs and the batch's metadata come to the host once
per batch, and the PCK bookkeeping stays numpy float64.
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, Iterable, Mapping, Optional

import numpy as np
import torch

from .. import graphs, trace
from ..config import CAPEConfig
from ..data.token_types import TokenType
from ..models.cape import CAPE, autoregressive_decode
from ..parallel import allgather_tree
from ..utils.debug import debug_enabled
from ..utils.logging import MetricLogger
from .pck import PCKEvaluator

#: the batch keys the host scoring reads
_META_KEYS = ("targets", "category_ids", "bbox_dims", "gt_visibility",
              "num_keypoints", "sample_valid")


def to_numpy(tree):
    """A nested dict of tensors (on any device) or arrays as numpy arrays
    on the host."""
    if isinstance(tree, Mapping):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def extract_pred_keypoints(
    pred_logits: np.ndarray,   # (B, L, 3)
    pred_coords: np.ndarray,   # (B, L, 2)
    active: np.ndarray,        # (B, L) True while sample unfinished
    expected_counts: np.ndarray,  # (B,)
):
    """Ragged extraction: coords at positions predicted `coord`, in order,
    trimmed/zero-padded to the category keypoint count."""
    labels = pred_logits.argmax(-1)
    out = []
    for i in range(pred_logits.shape[0]):
        sel = (labels[i] == TokenType.coord) & active[i]
        kpts = pred_coords[i][sel]
        n = int(expected_counts[i])
        if len(kpts) >= n:
            kpts = kpts[:n]
        else:
            kpts = np.concatenate(
                [kpts, np.zeros((n - len(kpts), 2), kpts.dtype)], axis=0
            )
        out.append(kpts)
    return out


def extract_gt_keypoints(targets: Dict[str, np.ndarray],
                         expected_counts: np.ndarray):
    """GT coords via GT token labels (coord positions are the first N)."""
    coords = np.asarray(targets["target_seq"])
    labels = np.asarray(targets["token_labels"])
    out = []
    for i in range(coords.shape[0]):
        sel = labels[i] == TokenType.coord
        out.append(coords[i][sel][: int(expected_counts[i])])
    return out


def decode(model: CAPE, images, sc, sm, se,
           max_len: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The counterpart of the JAX package's `_decode_jit`: one batched
    autoregressive decode on the model's device. On a CUDA model, replays
    of the program captured for the (model, batch shape, `max_len`, MSDA
    selection) key at its first call (`graphs.decode`), as jax's jit cache
    keeps one compiled decode a key; on the CPU the same bodies eagerly
    (`autoregressive_decode`)."""
    if model.device.type == "cuda":
        return graphs.decode(model, images, sc, sm, se, max_len=max_len)
    return autoregressive_decode(model, images, sc, sm, se, max_len=max_len)


def _score(evaluator: PCKEvaluator, cfg: CAPEConfig, out: Dict,
           meta: Dict, pck_norm: str, gt_structure_fallback: bool,
           decode_max_len: Optional[int]) -> np.ndarray:
    """One batch's host scoring: the decode's keypoints extracted and
    added to `evaluator` against the ground truth. Returns the batch's
    `sample_valid` rows."""
    pred_logits = out["pred_logits"].astype(np.float32)
    pred_coords = out["pred_coords"].astype(np.float32)
    valid = meta.get("sample_valid",
                     np.ones(pred_logits.shape[0], bool))
    # incomplete-generation warning (`roomformer_v2.py:608-621`,
    # WARN_INCOMPLETE_GENERATION env toggle)
    n_unfinished = int((out["unfinished"] & valid).sum())
    if n_unfinished and os.environ.get("WARN_INCOMPLETE_GENERATION", "1") == "1":
        warnings.warn(
            f"{n_unfinished} sequence(s) hit "
            f"max_len={decode_max_len or cfg.seq_len} "
            f"without predicting EOS — the model may not have learned "
            f"stopping behavior (check EOS weighting/training length).",
            RuntimeWarning,
        )
    # active mask: positions before each sample's EOS
    lengths = out["lengths"]
    active = np.arange(pred_logits.shape[1])[None, :] < lengths[:, None]

    if debug_enabled("DEBUG_KEYPOINT_BUG"):
        # per-step token-type trace of the first real sample, mirroring
        # the reference's generation-loop diagnostic
        # (`roomformer_v2.py:474-528`, first 10 steps)
        i0 = int(np.argmax(valid))
        names = {0: "COORD", 1: "SEP", 2: "EOS"}
        print(f"[DEBUG_KEYPOINT_BUG] sample {i0}: generated "
              f"{int(lengths[i0])} tokens (max {cfg.seq_len})",
              flush=True)
        for step in range(min(10, int(lengths[i0]))):
            t = int(pred_logits[i0, step].argmax())
            print(f"  step {step}: {names.get(t, t)} "
                  f"coords={pred_coords[i0, step].round(4).tolist()}",
                  flush=True)

    expected = meta["num_keypoints"]
    if gt_structure_fallback:
        # predicted coords at GT coord positions (the first N steps —
        # GT labels are [coord]*N + eos): token-type mistakes don't
        # shift the extraction (`engine_cape.py:1015-1022`)
        preds = [pred_coords[i, : int(expected[i])]
                 for i in range(pred_coords.shape[0])]
    else:
        preds = extract_pred_keypoints(pred_logits, pred_coords, active,
                                       expected)
    gts = extract_gt_keypoints(meta["targets"], expected)

    bbox = meta["bbox_dims"]
    vis = meta["gt_visibility"]
    cids = meta["category_ids"]
    for i in range(len(preds)):
        if not valid[i]:  # static-batch padding episode
            continue
        n = int(expected[i])
        # reference env-toggle diagnostics (engine_cape.py:40 family)
        if debug_enabled("DEBUG_KEYPOINT_COUNT"):
            print(f"[DEBUG_KEYPOINT_COUNT] cat {int(cids[i])}: "
                  f"generated {int(lengths[i])} tokens vs expected "
                  f"{n} coords + EOS", flush=True)
        if debug_enabled("DEBUG_EXTRACT"):
            n_coord = int(((pred_logits[i].argmax(-1) == TokenType.coord)
                           & active[i]).sum())
            print(f"[DEBUG_EXTRACT] sample {i}: {n_coord} coord tokens "
                  f"-> {'trim' if n_coord > n else 'pad'} to {n}",
                  flush=True)
        gt = gts[i]
        if len(gt) < n:  # safety: pad GT like predictions
            gt = np.concatenate([gt, np.zeros((n - len(gt), 2))], axis=0)
        if pck_norm == "resized":
            bw = bh = float(cfg.image_size)
        else:
            bw, bh = float(bbox[i, 0]), float(bbox[i, 1])
        evaluator.add_sample(
            preds[i] * cfg.image_size,
            gt * cfg.image_size,
            bbox_width=bw,
            bbox_height=bh,
            category_id=int(cids[i]),
            visibility=vis[i, :n],
        )
    return valid


def evaluate_cape(
    model: CAPE,
    batches: Iterable[Dict],
    cfg: CAPEConfig,
    pck_threshold: float = 0.2,
    compute_loss: bool = False,
    eval_loss_fn=None,
    print_freq: int = 0,
    pck_norm: str = "original_bbox",
    gt_structure_fallback: bool = False,
    multihost: bool = False,
    decode_max_len: "int | None" = None,
) -> Dict:
    """Run autoregressive eval over episode batches. Returns stats dict with
    pck, pck_mean_categories, per-category PCK, counts (+ losses).

    The JAX function's arguments without `params` (the module holds its
    weights). Batches are numpy dicts (`data.episodic.episode_batches`) or
    the same as tensors (`data.prefetch.to_device`).

    `pck_norm` selects the reference's two (inconsistent) normalizations:
    'original_bbox' divides the pixel distance by the ORIGINAL bbox
    diagonal (`engine_cape.py:743-747, 1028-1063`, the default);
    'resized' pins the post-resize image_size x image_size dims
    (`eval_cape_checkpoint.py:530-537`).

    `gt_structure_fallback=True` extracts predicted keypoints at the GT
    token-label positions instead of the predicted labels — the reference's
    `evaluate_unseen_categories` fallback (`engine_cape.py:1015-1022`),
    useful for isolating coordinate quality from token-type errors.

    Both the PCK accumulation and the optional teacher-forced loss
    (`eval_loss_fn(batch)`, e.g. `train.make_eval_loss_fn(model, cfg)`)
    exclude `sample_valid=False` padding rows (static-batch wrap-around
    episodes).

    `decode_max_len` caps the decode's KV-cache length below cfg.seq_len —
    PCK-identical whenever it exceeds the split's largest keypoint count
    + 1 (EOS), since extraction reads at most num_keypoints coords and the
    per-step math is unchanged.

    `multihost=True` (sharded evaluation across processes): each rank
    decodes its own slice of the episodes (batches built from
    `parallel.host_episode_slice`, the same count of batches of the same
    size on every rank); the decode outputs and the batch's metadata are
    then gathered (`parallel.allgather_tree`) so that every rank scores
    the full set: the same PCK on every rank, so that checkpoint and
    early-stopping decisions agree. A decode that stops early still pads
    its outputs to (B, seq_len, ...), so the gathered shapes agree."""
    if pck_norm not in ("original_bbox", "resized"):
        raise ValueError(f"pck_norm={pck_norm!r}: 'original_bbox'|'resized'")
    evaluator = PCKEvaluator(threshold=pck_threshold)
    logger = MetricLogger()

    n_batches = 0
    for batch in batches:
        with trace.span("eval.batch", root=True):
            out = decode(
                model, batch["query_images"], batch["support_coords"],
                batch["support_mask"], batch["skeleton_edges"],
                decode_max_len)
            with trace.span("eval.fetch"):
                out = to_numpy(out)
                meta = {k: batch[k] for k in _META_KEYS if k in batch}
                if multihost:
                    out, meta = allgather_tree(out), allgather_tree(meta)
                else:
                    meta = to_numpy(meta)
            with trace.span("eval.score"):
                valid = _score(evaluator, cfg, out, meta, pck_norm,
                               gt_structure_fallback, decode_max_len)
            if compute_loss and eval_loss_fn is not None:
                losses = eval_loss_fn(batch)
                logger.update(**{k: float(v) for k, v in losses.items()})
        n_batches += 1
        if debug_enabled("DEBUG_EVAL") or debug_enabled("DEBUG_PCK"):
            r = evaluator.get_results()
            print(f"[DEBUG_EVAL] batch {n_batches}: "
                  f"{int(valid.sum())} samples, running PCK "
                  f"{r['pck_overall']:.2%} "
                  f"({r['total_correct']}/{r['total_visible']})", flush=True)
        if print_freq and n_batches % print_freq == 0:
            r = evaluator.get_results()
            print(f"[eval] batch {n_batches}: PCK so far "
                  f"{r['pck_overall']:.2%}", flush=True)

    results = evaluator.get_results()
    stats = {k: m.global_avg for k, m in logger.meters.items()}
    stats.update({
        "pck": results["pck_overall"],
        "pck_mean_categories": results["mean_pck_categories"],
        "pck_per_category": results["pck_per_category"],
        "pck_num_correct": results["total_correct"],
        "pck_num_visible": results["total_visible"],
        "num_images": results["num_images"],
    })
    stats.setdefault("loss", 0.0)
    return stats
