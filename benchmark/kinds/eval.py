"""Protocol evaluation: `evaluate_cape` over in-memory episode batches whose
episodes share one category, one call a batch with the decode capped at
that category's keypoint count + 1, a trained model's length.

End-to-end: episodes scored per second over the window. Check: a seeded
sample of the window's batches, the longest count among them: the decode
against the reference teacher-forced over the served tokens
(`coords_gap`, `logits_gap`, `class_gap`), and the reference's PCK
counts of the served decode against the counts `evaluate_cape` returned
(`pck_count_gap`).
"""

from __future__ import annotations

import time

import numpy as np
import torch

import check as checks
import common
import counts
import traffic
from reference.data import extract_keypoints, pck_counts


def _cap(batch) -> int:
    return int(batch["num_keypoints"].max()) + 1


def pools(t, c, seed):
    """The cell's traffic, made from the seed."""
    return traffic.eval_batches(t, c, seed)


def work(p):
    """What no seed changes: each batch's keypoint count, in order."""
    return [int(b["num_keypoints"][0]) for b in p]


def setup(run) -> None:
    from cape_tpu_torch.eval import evaluate as port_eval
    t, st = run.t, run.state
    cfg = run.port_config()
    st.update(model=run.port_model(cfg), cfg=cfg,
              pool=pools(t, run.c, run.seed),
              orig_decode=port_eval.decode,
              sample=common.Reservoir(t["check_batches"], run.seed + 1),
              longest=None)
    decode = port_eval.decode
    if run.traced:
        decode = common.synced(decode, run, "eval.decode")

    def recording(*a, **k):
        out = decode(*a, **k)
        st["last"] = out
        return out

    port_eval.decode = recording
    run.mark("pools made")
    seen = set()
    for b in st["pool"]:
        if _cap(b) not in seen:
            seen.add(_cap(b))
            _score(run, b)
    run.mark("warm-up done")
    run.spans = common.Spans()


def _score(run, batch):
    from cape_tpu_torch.eval import evaluate_cape
    st = run.state
    return evaluate_cape(st["model"], [batch], st["cfg"],
                         decode_max_len=_cap(batch))


def window(run):
    st, pool = run.state, run.state["pool"]
    longest = max(_cap(b) for b in pool)
    i = episodes = steps = 0
    flops = 0.0
    t0 = time.perf_counter()
    while True:
        b = pool[i % len(pool)]
        s = time.perf_counter()
        with torch.profiler.record_function("bench.eval.batch"):
            stats = _score(run, b)
        if run.traced:
            run.spans.add("eval.batch", time.perf_counter() - s)
        n = int(b["sample_valid"].sum())
        episodes += n
        steps += _cap(b)
        flops += counts.decode_flops(run.c, len(b["sample_valid"]), _cap(b))
        rec = (i % len(pool), st["last"],
               (stats["pck_num_correct"], stats["pck_num_visible"]))
        keep = _cap(b) == longest and st["longest"] is None
        if keep:
            st["longest"] = i
        st["sample"].offer(rec, keep=keep)
        i += 1
        if time.perf_counter() - t0 >= run.seconds:
            break
    wall = time.perf_counter() - t0
    run.units = {"attempted": i * run.t["batch"], "failed": 0,
                 "batches": i, "episodes": episodes, "steps": steps,
                 "wall_s": wall}
    run.work = {"flops": flops}
    return {"eval_episodes_per_s": episodes / wall}


def traced_units(run) -> None:
    pool = run.state["pool"]
    n = run.t["traced_batches"]
    for k in range(n):
        _score(run, pool[k % len(pool)])
    run.traced_work = {"batches": n,
                       "steps": sum(_cap(pool[k % len(pool)])
                                    for k in range(n))}


def release(run) -> None:
    from cape_tpu_torch import graphs
    from cape_tpu_torch.eval import evaluate as port_eval
    st = run.state
    port_eval.decode = st.pop("orig_decode")
    graphs.clear(st["model"])
    del st["model"]
    st.pop("last", None)


def check(run):
    c, st, dev = run.c, run.state, run.device
    ref = checks.reference(c, run.weights, dev)
    qref = (checks.reference(c, run.weights, dev, torch.float8_e4m3fn)
            if run.control else None)
    parts, count_gap = [], 0
    for bidx, out, served_counts in st["sample"].sample():
        b = st["pool"][bidx]
        lengths = out["lengths"].to(dev).long()
        parts.append(checks.decode_gaps(
            ref, *(torch.as_tensor(b[k], device=dev) for k in (
                "query_images", "support_coords", "support_mask",
                "skeleton_edges")),
            out["pred_logits"].to(dev), out["pred_coords"].to(dev), lengths,
            c, qref))
        lg = out["pred_logits"].float().cpu().numpy()
        pc = out["pred_coords"].float().cpu().numpy()
        n = b["num_keypoints"]
        preds = [extract_keypoints(lg[i], pc[i], int(lengths[i]), int(n[i]))
                 for i in range(len(n))]
        gts = [b["targets"]["target_seq"][i, :int(n[i])].astype(np.float64)
               for i in range(len(n))]
        vis = [b["gt_visibility"][i, :int(n[i])] for i in range(len(n))]
        mine = pck_counts(preds, gts, b["bbox_dims"], vis, c["image_size"])
        count_gap = max(count_gap, abs(mine[0] - served_counts[0])
                        + abs(mine[1] - served_counts[1]))
    out = checks.merge_max(parts, ("coords_gap", "logits_gap", "class_gap"))
    out.update(pck_count_gap=float(count_gap),
               tokens=sum(p["tokens"] for p in parts))
    run.log(f"check: {len(parts)} batches, {out['tokens']} decoded tokens")
    return out
