"""Serving: one client in a closed loop sends `CAPEPredictor.predict`
requests of raw images of one category and waits for each answer.

End-to-end: the 95th percentile of the latency of every request of the
window, and the images answered per second over the window. Check: a
seeded sample of the window's requests: the reference's own crop and
resize against the images the program fed its decode (`prepare_levels`),
the decode against the reference teacher-forced over the served tokens
(`coords_gap`, `logits_gap`, `class_gap`), the reference's mapping of the
served decode to pixels against the returned keypoints (`pixel_gap`), and
every served coordinate mapped to pixels by the reference's crop origin
and scale against the same coordinate mapped by the origin and scale the
program's preparation returned for that image (`map_gap`).
"""

from __future__ import annotations

import time

import numpy as np
import torch

import check as checks
import common
import counts
import traffic
from reference.data import crop_resize, extract_keypoints


def pools(t, c, seed):
    """The cell's traffic, made from the seed."""
    return traffic.serve(t, c, seed)


def work(p):
    """What no seed changes: the pool's image shapes and the requests'
    keypoint counts."""
    return (sorted(i.shape for i in p["pool"]),
            sorted(len(r["support"]) for r in p["requests"]))


def setup(run) -> None:
    from cape_tpu_torch import serve as port_serve
    t, st = run.t, run.state
    cfg = run.port_config()
    model = run.port_model(cfg)
    pred = port_serve.CAPEPredictor(cfg, model, batch_size=t["batch"],
                                    device=run.device)
    made = pools(t, run.c, run.seed)
    run.mark("pools made")
    st.update(pred=pred, pools=made, orig_decode=port_serve.decode,
              orig_prepare=port_serve.CAPEPredictor._prepare,
              sample=common.Reservoir(t["check_requests"], run.seed + 1))

    decode = port_serve.decode
    prepare = st["orig_prepare"]
    if run.traced:
        decode = common.synced(decode, run, "serve.decode")
        untimed = prepare

        def prepare(self, *a, **k):
            s = time.perf_counter()
            with torch.profiler.record_function("bench.serve.prepare"):
                out = untimed(self, *a, **k)
            run.spans.add("serve.prepare", time.perf_counter() - s)
            return out

    def recording_prepare(self, *a, **k):
        out = prepare(self, *a, **k)
        st["maps"].append((out["origin"], out["scale"]))
        return out

    port_serve.CAPEPredictor._prepare = recording_prepare

    def recording(*a, **k):
        out = decode(*a, **k)
        st["last"] = (a[1], out)
        return out

    port_serve.decode = recording
    for r in made["requests"][:t["warmup_requests"]]:
        _request(run, r)
    run.mark("warm-up done")
    run.spans = common.Spans()


def _request(run, r):
    pools = run.state["pools"]
    run.state["maps"] = []
    return run.state["pred"].predict(
        [pools["pool"][i] for i in r["images"]], r["support"],
        skeleton=r["skeleton"], bboxes=r["bboxes"])


def window(run):
    st, reqs = run.state, run.state["pools"]["requests"]
    lat, i, failed = [], 0, 0
    t0 = time.perf_counter()
    while True:
        r = reqs[i % len(reqs)]
        s = time.perf_counter()
        try:
            res = _request(run, r)
        except (RuntimeError, ValueError) as e:
            failed += 1
            run.log(f"request {i} failed: {e!r}")
            res = None
        lat.append(time.perf_counter() - s)
        if res is not None:
            imgs, out = st["last"]
            st["sample"].offer((i % len(reqs), imgs, out, res, st["maps"]))
        i += 1
        if time.perf_counter() - t0 >= run.seconds:
            break
    wall = time.perf_counter() - t0
    tokens = int(st["last"][1]["lengths"].max()) if "last" in st else 0
    run.units = {"attempted": i, "failed": failed, "requests": i - failed,
                 "images": (i - failed) * run.t["batch"], "wall_s": wall,
                 "tokens": tokens}
    run.work = {"flops": (i - failed) * counts.decode_flops(
        run.c, run.t["batch"], tokens)}
    return {"serve_p95_ms": float(np.percentile(lat, 95)) * 1e3,
            "serve_images_per_s": (i - failed) * run.t["batch"] / wall}


def traced_units(run) -> None:
    reqs = run.state["pools"]["requests"]
    n = run.t["traced_requests"]
    for k in range(n):
        _request(run, reqs[k % len(reqs)])
    run.traced_work = {"requests": n}


def release(run) -> None:
    from cape_tpu_torch import graphs
    from cape_tpu_torch import serve as port_serve
    st = run.state
    port_serve.decode = st.pop("orig_decode")
    port_serve.CAPEPredictor._prepare = st.pop("orig_prepare")
    pred = st.pop("pred")
    graphs.clear(pred.model)
    del pred
    st.pop("last", None)


def _to_pixels(k: np.ndarray, origin, scale) -> np.ndarray:
    """Model-frame pixels (N, 2) to the original image's."""
    out = np.array(k, np.float64)
    out[:, 0] = out[:, 0] * scale[0] + origin[0]
    out[:, 1] = out[:, 1] * scale[1] + origin[1]
    return out


def check(run):
    c, S, st = run.c, run.c["image_size"], run.state
    pools = st["pools"]
    ref = checks.reference(c, run.weights, run.device)
    qref = (checks.reference(c, run.weights, run.device,
                             torch.float8_e4m3fn) if run.control else None)
    parts, prep, prep_q, pix, mapped = [], 0.0, 0.0, 0.0, 0.0
    for ridx, fed, out, res, prog_maps in st["sample"].sample():
        r = pools["requests"][ridx]
        mine, maps = [], []
        for i, box in zip(r["images"], r["bboxes"]):
            img, origin, scale = crop_resize(pools["pool"][i], box, S)
            mine.append(img)
            maps.append((origin, scale))
        mine = np.stack(mine)
        fed = np.asarray(fed).astype(np.int16)
        prep = max(prep, float(np.abs(mine.astype(np.int16) - fed).max()))
        if run.control:
            q = np.stack([crop_resize(pools["pool"][i], box, S,
                                      torch.float8_e4m3fn)[0]
                          for i, box in zip(r["images"], r["bboxes"])])
            prep_q = max(prep_q, float(np.abs(q.astype(np.int16)
                                              - fed).max()))
        B = len(mine)
        sc, sm, se = checks.support_arrays(r["support"], r["skeleton"], c)
        dev = run.device
        logits = out["pred_logits"][:B].to(dev)
        pcoords = out["pred_coords"][:B].to(dev)
        lengths = out["lengths"][:B].to(dev).long()
        parts.append(checks.decode_gaps(
            ref, torch.as_tensor(mine, device=dev),
            torch.as_tensor(np.repeat(sc[None], B, 0), device=dev),
            torch.as_tensor(np.repeat(sm[None], B, 0), device=dev),
            torch.as_tensor(np.repeat(se[None], B, 0), device=dev),
            logits, pcoords, lengths, c, qref))
        lg, pc = logits.cpu().numpy(), pcoords.cpu().numpy()
        n = len(r["support"])
        for b, (o, s) in enumerate(maps):
            k = extract_keypoints(lg[b], pc[b], int(lengths[b]), n) * S
            pix = max(pix, float(np.abs(_to_pixels(k, o, s)
                                        - res[b]["keypoints"]).max()))
            served = pc[b, :int(lengths[b])].astype(np.float64) * S
            mapped = max(mapped, float(np.abs(
                _to_pixels(served, o, s)
                - _to_pixels(served, *prog_maps[b])).max()))
    out = checks.merge_max(parts, ("coords_gap", "logits_gap", "class_gap"))
    out.update(prepare_levels=prep, pixel_gap=pix, map_gap=mapped,
               tokens=sum(p["tokens"] for p in parts))
    if run.control:
        out["control"]["prepare_levels"] = prep_q
    run.log(f"check: {len(parts)} requests, {out['tokens']} served tokens")
    return out
