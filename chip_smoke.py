#!/usr/bin/env python3
"""Drive the PyTorch port (`cape_tpu_torch`) on one CUDA card.

Run from the root of the repository: `python3 chip_smoke.py`. It needs one
card, builds the hand-written CUDA kernels from `cape_tpu_torch/ops/csrc`,
and exits non-zero at the first phase that fails:

1. card identity (`nvidia-smi` name and power limit);
2. each kernel against its plain PyTorch version on the card at the shapes
   of the serving path (fp32 and bf16), with its time, its plain
   version's time, a library call's time where one computes the same
   function, and its bound;
3. the serving path at the flagship width (`CAPEConfig()` defaults:
   ResNet-50, 512 px, 6+6 layers, bf16, random weights from a seed):
   `CAPEPredictor(batch_size=8)` answers 3 requests of 8 images; the
   kernels' launch counters must show the path went through them;
4. the same weights with `use_pallas_msda=True`: one request through the
   whole-op MSDA kernel, and its fp32 encoder memory against the default
   model's;
5. one image in fp32 on the card (kernels) against the CPU (plain
   versions): encoder memory and the first decode step's logits.

The line before last is a JSON object with every kernel's launches, error
and times; the last line is `{"ok": true, "device": {...}}`. Times are
CUDA-event means after a warm-up; bounds use the H100 SXM peaks (3.35 TB/s,
67 TFLOP/s fp32 outside the tensor cores).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

# COCO-style 17-keypoint prototype and skeleton (0-indexed)
PROTO_17 = [
    (0.50, 0.12), (0.54, 0.10), (0.46, 0.10), (0.58, 0.12), (0.42, 0.12),
    (0.64, 0.26), (0.36, 0.26), (0.70, 0.42), (0.30, 0.42), (0.72, 0.56),
    (0.28, 0.56), (0.60, 0.58), (0.40, 0.58), (0.62, 0.76), (0.38, 0.76),
    (0.63, 0.94), (0.37, 0.94)]
SKELETON_17 = [
    [15, 13], [13, 11], [16, 14], [14, 12], [11, 12], [5, 11], [6, 12],
    [5, 6], [5, 7], [6, 8], [7, 9], [8, 10], [1, 2], [0, 1], [0, 2],
    [1, 3], [2, 4], [3, 5], [4, 6]]


class Failed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise Failed(msg)


def cuda_ms(torch, fn, iters=20, warmup=3):
    """Mean milliseconds per call over `iters` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card_identity():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0 and out.stdout.strip(),
          f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def gather_bytes(torch, table, idx):
    """Bytes a row gather must move: each distinct in-range row of `table`
    (B, n, C) that `idx` (B, ...) selects, read once; the indices read
    once; the (B, N, C) output written once."""
    B, n, C = table.shape
    flat = idx.reshape(B, -1).long()
    rows = (torch.arange(B, device=idx.device)[:, None] * n + flat)[
        (flat >= 0) & (flat < n)]
    distinct = torch.unique(rows).numel()
    return (distinct * C * table.element_size() + idx.numel() * 4
            + flat.numel() * C * table.element_size())


# ----------------------------------------------------------------------
def phase_kernels(torch, card):
    """Kernel vs plain at the serving path's shapes; returns the entries
    of the kernels line (launches filled in later)."""
    from cape_tpu_torch.ops import gather, msda_kernel
    from cape_tpu_torch.models.cape import level_shapes

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    B, H, Dh, P = 8, 8, 32, 4
    shapes = level_shapes(512, 4)
    S = sum(h * w for h, w in shapes)
    W0 = shapes[0][1]

    # -- quad_gather: encoder level 0 and the decode-step slab -----------
    n_enc = (W0 + 1) + shapes[0][0] * W0
    n_dec = sum((w + 1) + h * w for h, w in shapes)
    cases = {"encoder level 0": (n_enc, S * P), "decode step": (n_dec, 4 * P)}
    g_err = 0.0
    g_times = {}
    for label, (n, N) in cases.items():
        for dtype in (torch.float32, torch.bfloat16):
            quad = torch.randn(B * H, n, 4 * Dh, generator=g, device=dev
                               ).to(dtype)
            gi = torch.randint(0, n, (B * H, N), generator=g, device=dev,
                               dtype=torch.int32)
            gi[:, :8] = 3                                   # duplicates
            gi[:, 8:12] = torch.tensor([-1, -n, n, n + 7], device=dev,
                                       dtype=torch.int32)   # out of range
            got = gather.quad_gather(quad, gi)
            want = gather.quad_gather_plain(quad, gi)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"quad_gather differs from plain ({label}, {dtype})")
            check(not got[:, 8:12].any(), "quad_gather: OOB rows not zero")
            g_err = max(g_err, (got.float() - want.float()).abs().max().item())
        # times at the serving dtype with in-range indices (the path's own)
        gi = torch.randint(0, n, (B * H, N), generator=g, device=dev,
                           dtype=torch.int32)
        idx64 = gi.long()[..., None].expand(-1, -1, 4 * Dh)
        nbytes = gather_bytes(torch, quad, gi)
        g_times[label] = {
            "ms": cuda_ms(torch, lambda: gather.quad_gather(quad, gi)),
            "plain_ms": cuda_ms(torch,
                                lambda: gather.quad_gather_plain(quad, gi)),
            "library_ms": cuda_ms(torch, lambda: torch.gather(quad, 1, idx64)),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "shape": f"quad {tuple(quad.shape)} bf16, gi {tuple(gi.shape)}",
        }
        print(f"quad_gather [{label}] {g_times[label]} ({card})", flush=True)
    print("quad_gather: bit-exact against plain in fp32 and bf16, "
          "duplicate and out-of-range indices included", flush=True)

    # -- msda_forward: the encoder shape --------------------------------
    L = len(shapes)
    loc = torch.rand(B, S, H, L, P, 2, generator=g, device=dev) * 4.0 - 1.5
    attn = torch.softmax(torch.randn(B, S, H, L * P, generator=g,
                                     device=dev), -1).reshape(B, S, H, L, P)
    m_err = 0.0
    tol = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
    for dtype in (torch.float32, torch.bfloat16):
        value = torch.randn(B, S, H, Dh, generator=g, device=dev).to(dtype)
        idx, w, valid = msda_kernel.prepare_corners(shapes, loc,
                                                    attn.to(dtype))
        value_bh = value.transpose(1, 2).reshape(B * H, S, Dh).contiguous()
        got = msda_kernel.msda_forward(value_bh, idx, w, valid)
        want = msda_kernel.msda_forward_plain(value_bh, idx, w, valid)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        print(f"msda_forward {dtype}: max abs err {err:.3e} "
              f"(tolerance {tol[dtype]:g} abs + rel)", flush=True)
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=tol[dtype], rtol=tol[dtype])
        m_err = max(m_err, err)
    K4 = idx.shape[-1]
    # value rows read once (those the corners select), idx/w/valid read
    # once, the (BH, Lq, Dh) output written once
    nbytes = (gather_bytes(torch, value_bh, idx) - idx.numel() * 4
              - idx.numel() * Dh * value_bh.element_size()
              + idx.numel() * 12 + B * H * S * Dh * value_bh.element_size())
    flops = 2 * B * H * S * K4 * Dh + B * H * S * K4
    m = {"ms": cuda_ms(torch, lambda: msda_kernel.msda_forward(
            value_bh, idx, w, valid)),
         "plain_ms": cuda_ms(torch, lambda: msda_kernel.msda_forward_plain(
            value_bh, idx, w, valid), iters=5),
         "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
         "ops_ms": flops / FP32_FLOPS * 1e3}
    print(f"msda_forward [encoder, value {tuple(value_bh.shape)} bf16, "
          f"K4={K4}] {m} ({card})", flush=True)

    enc = g_times["encoder level 0"]
    return [
        {"name": "quad_gather", "route": "cuda",
         "source": "cape_tpu_torch/ops/csrc/gather.cu",
         "replaces": "cape_tpu/ops/gather_mxu.py:57",
         "launches": 0, "max_abs_err": g_err, "ms": enc["ms"],
         "plain_ms": enc["plain_ms"], "bound_ms": enc["bound_ms"],
         "bound_by": "bytes", "library_ms": enc["library_ms"]},
        {"name": "msda_forward", "route": "cuda",
         "source": "cape_tpu_torch/ops/csrc/msda.cu",
         "replaces": "cape_tpu/ops/msda_pallas.py:48",
         "launches": 0, "max_abs_err": m_err, "ms": m["ms"],
         "plain_ms": m["plain_ms"],
         "bound_ms": max(m["bytes_ms"], m["ops_ms"]),
         "bound_by": "bytes" if m["bytes_ms"] >= m["ops_ms"] else "operations",
         "library_ms": None},
    ]


# ----------------------------------------------------------------------
def _requests(np, n_requests, batch):
    """Seeded uint8 images of varying sizes; every other one with a bbox."""
    rng = np.random.default_rng(0)
    sizes = [(480, 640), (512, 512), (300, 400), (640, 480), (256, 320),
             (720, 540), (400, 400), (350, 600)]
    reqs = []
    for r in range(n_requests):
        imgs, boxes = [], []
        for i in range(batch):
            h, w = sizes[(r + i) % len(sizes)]
            imgs.append(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
            boxes.append((w // 8, h // 10, w // 2, (h * 3) // 4)
                         if i % 2 else None)
        reqs.append((imgs, boxes))
    return reqs


def _check_results(np, results, n_images, n_kpts):
    check(len(results) == n_images, f"{len(results)} results, {n_images} images")
    for r in results:
        check(r["keypoints"].shape == (n_kpts, 2), "keypoint shape")
        check(np.isfinite(r["keypoints"]).all(), "non-finite keypoints")
        check(r["generated"].shape == (n_kpts,), "generated shape")


def _reset_counts(gather, msda_kernel):
    gather.quad_gather.launches = 0
    msda_kernel.msda_forward.launches = 0


def phase_serving(torch, np, card):
    """The flagship serving path: 3 requests of 8 images, default config;
    then one request with use_pallas_msda=True on the same weights."""
    from cape_tpu_torch import CAPE, CAPEConfig, CAPEPredictor
    from cape_tpu_torch.ops import gather, msda_kernel

    cfg = CAPEConfig()
    check(cfg.bf16 and cfg.image_size == 512 and cfg.seq_len == 200,
          "flagship defaults changed")
    t0 = time.perf_counter()
    model = CAPE(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    print(f"flagship model built in {time.perf_counter() - t0:.3f} s "
          f"({sum(p.numel() for p in model.parameters())} parameters)",
          flush=True)
    pred = CAPEPredictor(cfg, model, batch_size=8)
    reqs = _requests(np, 3, 8)
    kw = dict(skeleton=SKELETON_17)
    proto = np.asarray(PROTO_17, np.float32)

    _reset_counts(gather, msda_kernel)
    times, steps = [], []
    for imgs, boxes in reqs:
        t0 = time.perf_counter()
        res = pred.predict(imgs, proto, bboxes=boxes, **kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        _check_results(np, res, len(imgs), len(PROTO_17))
        steps.append(max(r["length"] for r in res))
    default_counts = {"quad_gather": gather.quad_gather.launches,
                      "msda_forward": msda_kernel.msda_forward.launches}
    L = cfg.num_feature_levels
    want = sum(cfg.enc_layers * L + cfg.dec_layers * s for s in steps)
    print(f"default path: {default_counts} launches over 3 requests, "
          f"decode steps {steps}", flush=True)
    check(default_counts["quad_gather"] == want,
          f"quad_gather launched {default_counts['quad_gather']} times, "
          f"the path needs {want}")
    check(default_counts["msda_forward"] == 0,
          "msda_forward launched on the default path")
    print(f"predict ms/request (batch 8, 512 px, bf16): "
          f"{[round(t, 3) for t in times]} ({card})", flush=True)

    # -- use_pallas_msda=True: same weights, one request --------------------
    cfg_p = cfg.replace(use_pallas_msda=True)
    model_p = CAPE(cfg_p, device="cuda",
                   generator=torch.Generator().manual_seed(1))
    model_p.load_state_dict(model.state_dict())
    pred_p = CAPEPredictor(cfg_p, model_p, batch_size=8)
    imgs, boxes = reqs[0]
    _reset_counts(gather, msda_kernel)
    t0 = time.perf_counter()
    res = pred_p.predict(imgs, proto, bboxes=boxes, **kw)
    torch.cuda.synchronize()
    ms_p = (time.perf_counter() - t0) * 1e3
    _check_results(np, res, len(imgs), len(PROTO_17))
    s = max(r["length"] for r in res)
    pallas_counts = {"quad_gather": gather.quad_gather.launches,
                     "msda_forward": msda_kernel.msda_forward.launches}
    print(f"use_pallas_msda path: {pallas_counts} launches over 1 request, "
          f"decode steps {s}, {ms_p:.3f} ms ({card})", flush=True)
    check(pallas_counts["msda_forward"] == cfg.enc_layers,
          "msda_forward must run once per encoder layer")
    check(pallas_counts["quad_gather"] == cfg.dec_layers * s,
          "quad_gather must run once per decoder layer and step")
    del model_p, pred_p
    return model, default_counts, pallas_counts


def phase_fp32_checks(torch, np, model):
    """fp32: use_pallas encoder memory vs the default's on the card, and
    the card (kernels) vs the CPU (plain versions) for one image."""
    from cape_tpu_torch import CAPE
    from cape_tpu_torch.models.cape import autoregressive_decode

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = model.cfg.replace(bf16=False)
    m32 = CAPE(cfg32, device="cuda", generator=torch.Generator().manual_seed(0))
    m32p = CAPE(cfg32.replace(use_pallas_msda=True), device="cuda",
                generator=torch.Generator().manual_seed(0))
    m32p.load_state_dict(m32.state_dict())
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, (2, 512, 512, 3), dtype=np.uint8)
    with torch.inference_mode():
        x = torch.as_tensor(imgs, device="cuda")
        mem = m32.encode_image(x)
        mem_p = m32p.encode_image(x)
    err = (mem - mem_p).abs().max().item()
    print(f"fp32 encoder memory, use_pallas_msda vs default on the card: "
          f"max abs err {err:.3e} (tolerance 1e-4 abs + 1e-4 rel)", flush=True)
    torch.testing.assert_close(mem_p, mem, atol=1e-4, rtol=1e-4)
    del m32p

    m_cpu = CAPE(cfg32, device="cpu", generator=torch.Generator().manual_seed(2))
    m_cpu.load_state_dict(m32.state_dict())
    K = cfg32.max_support_keypoints
    sc = np.zeros((1, K, 2), np.float32)
    sc[0, :17] = PROTO_17
    sm = np.ones((1, K), bool)
    sm[0, :17] = False
    se = np.full((1, cfg32.max_skeleton_edges, 2), -1, np.int32)
    se[0, :len(SKELETON_17)] = SKELETON_17
    one = imgs[:1]
    with torch.inference_mode():
        mem_gpu = m32.encode_image(torch.as_tensor(one, device="cuda")).cpu()
        mem_cpu = m_cpu.encode_image(torch.as_tensor(one))
        out_gpu = autoregressive_decode(m32, one, sc, sm, se, force_length=1)
        out_cpu = autoregressive_decode(m_cpu, one, sc, sm, se,
                                        force_length=1)
    e_mem = (mem_gpu - mem_cpu).abs().max().item()
    lg, lc = out_gpu["pred_logits"][:, 0].cpu(), out_cpu["pred_logits"][:, 0]
    e_log = (lg - lc).abs().max().item()
    print(f"fp32 card vs CPU, one image: encoder memory max abs err "
          f"{e_mem:.3e}, first-step logits max abs err {e_log:.3e} "
          f"(tolerance 1e-3 abs + 1e-3 rel, TF32 off)", flush=True)
    torch.testing.assert_close(mem_gpu, mem_cpu, atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(lg, lc, atol=1e-3, rtol=1e-3)


# ----------------------------------------------------------------------
def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        import numpy as np

        from cape_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2
    try:
        card = card_identity()
        print(card, flush=True)
        print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}", flush=True)
        t0 = time.perf_counter()
        _build.build_all()
        print(f"kernels built in {time.perf_counter() - t0:.3f} s", flush=True)
        for name in _build.SOURCES:
            for line in _build.build_log(name).splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}", flush=True)
        kernels = phase_kernels(torch, card)
        model, default_counts, pallas_counts = phase_serving(torch, np, card)
        phase_fp32_checks(torch, np, model)
        check("jax" not in sys.modules and not any(
            k == "cape_tpu" or k.startswith("cape_tpu.") for k in sys.modules),
            "the port loaded jax or the JAX package")
    except (Failed, AssertionError, RuntimeError, ValueError) as e:
        print(f"chip_smoke FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    # each kernel's launches from its own path's run
    kernels[0]["launches"] = default_counts["quad_gather"]
    kernels[1]["launches"] = pallas_counts["msda_forward"]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
