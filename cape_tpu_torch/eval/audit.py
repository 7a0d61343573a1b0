"""Validation-PCK leakage audit — the reusable 6-part analysis.

The port of `cape_tpu.eval.audit`, the reference's 902-LoC leak audit
(`tests/test_validation_pck_debug.py:1-12`) and PCK-100% debugger
(`models/debug_validation_pck.py:1-307`), distilled into one function
(the JAX package's `scripts/debug_validation_pck.py` and
`tests/test_leak_audit.py` call its counterpart). Decode outputs and
batches may be numpy arrays or tensors on any device; they come to the
host once per batch.

The six parts:
  1. pred == GT            — teacher-forcing leak into the decode path
  2. pred == support       — support coordinates copied through
  3. generated length      — per-sample length vs the category keypoint
                             count (EOS behavior) + max-len hit rate
  4. coordinate spread     — single-token collapse detector
  5. per-episode PCK       — distribution + suspicious 100%-PCK count
  6. per-category breakdown — PCK / length-error / leak counts by category
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, Iterable

import numpy as np

from ..config import CAPEConfig
from .evaluate import extract_gt_keypoints, extract_pred_keypoints, to_numpy
from .pck import compute_pck_bbox


def audit_episodes(
    decode_fn: Callable[[Dict], Dict],
    batches: Iterable[Dict[str, np.ndarray]],
    cfg: CAPEConfig,
    pck_threshold: float = 0.2,
    atol: float = 1e-6,
) -> Dict:
    """Run the 6-part leakage audit over episode batches.

    Args:
        decode_fn: batch -> decode output dict (pred_logits, pred_coords,
            lengths, unfinished; numpy arrays or tensors) — normally an
            `autoregressive_decode` closure; tests may inject a stub to
            exercise detection branches.
        batches: episode batches from `episode_batches` (any batch size;
            `sample_valid` padding rows are skipped).
    Returns:
        dict with per-part results + `flags` (list of human-readable
        problems) + `leak_detected` bool.
    """
    identical_gt = identical_support = 0
    lengths, expected_counts, pcks, spreads = [], [], [], []
    maxlen_hits = 0
    token_hist = np.zeros(3, np.int64)
    per_cat = defaultdict(lambda: {
        "n": 0, "pck_sum": 0.0, "len_err_sum": 0.0,
        "identical_gt": 0, "identical_support": 0,
    })
    n_samples = 0

    for batch in batches:
        out = to_numpy(decode_fn(batch))
        batch = to_numpy(batch)
        logits = np.asarray(out["pred_logits"], np.float32)
        coords = np.asarray(out["pred_coords"], np.float32)
        sample_lengths = np.asarray(out["lengths"])
        valid = np.asarray(batch.get(
            "sample_valid", np.ones(logits.shape[0], bool)))
        active = (np.arange(logits.shape[1])[None]
                  < sample_lengths[:, None])
        expected = np.asarray(batch["num_keypoints"])
        preds = extract_pred_keypoints(logits, coords, active, expected)
        gts = extract_gt_keypoints(batch["targets"], expected)

        for i in range(logits.shape[0]):
            if not valid[i]:
                continue
            n_samples += 1
            cid = int(np.asarray(batch["category_ids"])[i])
            cat = per_cat[cid]
            cat["n"] += 1
            pred, gt = preds[i], gts[i]
            n = min(len(pred), len(gt))

            # 1/2: leak detectors
            if n and np.allclose(pred[:n], gt[:n], atol=atol):
                identical_gt += 1
                cat["identical_gt"] += 1
            sup = np.asarray(batch["support_coords"])[i, :n]
            if n and np.allclose(pred[:n], sup, atol=atol):
                identical_support += 1
                cat["identical_support"] += 1

            # 3: length behavior (expected generated = N coords + EOS)
            gen_len = int(sample_lengths[i])
            exp_len = int(expected[i]) + 1
            lengths.append(gen_len)
            expected_counts.append(exp_len)
            cat["len_err_sum"] += abs(gen_len - exp_len)
            if gen_len >= cfg.seq_len:
                maxlen_hits += 1
            token_hist += np.bincount(
                logits[i, : gen_len].argmax(-1), minlength=3)[:3]

            # 4: collapse detector
            spreads.append(float(pred.std()) if len(pred) else 0.0)

            # 5: per-episode PCK
            gtp = gt
            if len(gtp) < int(expected[i]):
                gtp = np.concatenate(
                    [gtp, np.zeros((int(expected[i]) - len(gtp), 2))])
            bw, bh = np.asarray(batch["bbox_dims"])[i]
            vis = np.asarray(batch["gt_visibility"])[i, : int(expected[i])]
            pck, _, _ = compute_pck_bbox(
                pred * cfg.image_size, gtp * cfg.image_size,
                float(bw), float(bh), threshold=pck_threshold,
                visibility=vis)
            pcks.append(pck)
            cat["pck_sum"] += pck

    mean_spread = float(np.mean(spreads)) if spreads else 0.0
    len_exact = sum(
        1 for g, e in zip(lengths, expected_counts) if g == e)
    results = {
        "num_samples": n_samples,
        "identical_gt": identical_gt,
        "identical_support": identical_support,
        "length_mean": float(np.mean(lengths)) if lengths else 0.0,
        "length_expected_mean": (
            float(np.mean(expected_counts)) if expected_counts else 0.0),
        "length_exact_matches": len_exact,
        "maxlen_hits": maxlen_hits,
        "coord_spread_mean": mean_spread,
        "collapse_suspected": bool(spreads) and mean_spread < 1e-3,
        "pck_mean": float(np.mean(pcks)) if pcks else 0.0,
        "pck_min": float(np.min(pcks)) if pcks else 0.0,
        "pck_max": float(np.max(pcks)) if pcks else 0.0,
        "pck_perfect_count": sum(1 for p in pcks if p >= 1.0),
        "token_hist": token_hist.tolist(),
        "per_category": {
            cid: {
                "n": c["n"],
                "pck": c["pck_sum"] / c["n"],
                "mean_length_error": c["len_err_sum"] / c["n"],
                "identical_gt": c["identical_gt"],
                "identical_support": c["identical_support"],
            }
            for cid, c in sorted(per_cat.items())
        },
    }

    flags = []
    if identical_gt:
        flags.append(
            f"LEAK: {identical_gt}/{n_samples} predictions identical to GT "
            "(teacher forcing reached the eval path?)")
    if identical_support:
        flags.append(
            f"COPY: {identical_support}/{n_samples} predictions identical "
            "to the support coordinates")
    if results["collapse_suspected"]:
        flags.append(
            f"COLLAPSE: mean coordinate spread {mean_spread:.2e} < 1e-3 "
            "(single-token collapse)")
    if n_samples and maxlen_hits == n_samples:
        flags.append("EOS: every sample hit max_len — stopping never learned")
    if n_samples and results["pck_perfect_count"] == n_samples:
        flags.append(
            "SUSPICIOUS: PCK is 100% on every episode — check for leakage")
    results["flags"] = flags
    results["leak_detected"] = identical_gt > 0
    return results


def format_audit_report(a: Dict) -> str:
    """Render `audit_episodes` output as the 6-part human report."""
    lines = [
        f"===== PCK leak audit ({a['num_samples']} samples) =====",
        f"1. pred == GT (leak!):        {a['identical_gt']}",
        f"2. pred == support (copy!):   {a['identical_support']}",
        (f"3. generated length: mean {a['length_mean']:.1f} vs expected "
         f"{a['length_expected_mean']:.1f} "
         f"(exact: {a['length_exact_matches']}/{a['num_samples']}, "
         f"max_len hits: {a['maxlen_hits']}); "
         f"token types coord/sep/eos: {a['token_hist']}"),
        (f"4. coord spread: mean {a['coord_spread_mean']:.4f} "
         f"({'COLLAPSE suspected' if a['collapse_suspected'] else 'ok'})"),
        (f"5. PCK: mean {a['pck_mean']:.2%}, min {a['pck_min']:.2%}, "
         f"max {a['pck_max']:.2%} "
         f"(100%-PCK episodes: {a['pck_perfect_count']})"),
        "6. per-category:",
    ]
    for cid, c in a["per_category"].items():
        lines.append(
            f"     cat {cid:>4}: n={c['n']:<3} PCK {c['pck']:.2%}  "
            f"len-err {c['mean_length_error']:.1f}  "
            f"leaks gt/sup {c['identical_gt']}/{c['identical_support']}")
    for f in a["flags"]:
        lines.append(f"!! {f}")
    if not a["flags"]:
        lines.append("No leakage indicators found.")
    return "\n".join(lines)
