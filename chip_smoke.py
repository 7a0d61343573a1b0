#!/usr/bin/env python3
"""Drive the PyTorch port (`cape_tpu_torch`) on one CUDA card.

Run from the root of the repository: `python3 chip_smoke.py`. It needs one
card, builds the hand-written CUDA kernels from `cape_tpu_torch/ops/csrc`,
and exits non-zero at the first phase that fails:

1. card identity (`nvidia-smi` name and power limit);
2. each of the seven kernels against its plain PyTorch version on the
   card at the shapes of the serving and training paths (fp32 and bf16),
   with two times, its plain version's time, a library call's time where
   one computes the same function, and its bound. The two row kernels
   (`quad_gather`, `quad_scatter`) are checked and timed at all four
   levels of the encoder's and the decoder's shapes and at the decode
   step's, with uniform indices and with indices drawn as the model draws
   them; the two fused backwards at the encoder's four levels and the
   decoder's level 0, the same two index sets, with dw4 exactly 0 at
   every corner outside the slab and a strided slab bit-equal to its
   copy;
3. the serving path at the flagship width (`CAPEConfig()` defaults:
   ResNet-50, 512 px, 6+6 layers, bf16, random weights from a seed):
   `CAPEPredictor(batch_size=8)` answers 3 requests of 8 images; the
   kernels' launch counters must show the path went through them;
4. the same weights with `use_pallas_msda=True`: one request through the
   whole-op MSDA kernel;
5. the same weights under `CAPE_MSDA_GATHER=fused` and `fusedq` with
   `CAPE_DECODE_PREQUAD=0`: one request each, every MSDA site of the
   encoder and of the decode steps through the fused kernels and none
   through `quad_gather`; and one `fused` request with the prepacked
   decode, whose steps fall back to `quad_gather` with a warning;
6. the training path at the flagship width: `make_train_step` takes 8
   micro-steps of 4 query images (2 real AdamW updates, dropout 0.1),
   48 gathers and 48 scatters each; the forward/backward/optimizer split;
   two micro-steps with `use_pallas_msda=True`; two each under `fused`
   and `fusedq` (48 forward and 48 backward launches of the fused
   kernels, no gather and no scatter);
7. fp32 on the card (kernels) against the CPU (plain versions): the
   encoder memory of every MSDA path, the first decode step's logits, and
   at a reduced config the loss and every parameter's gradient on the
   default, `use_pallas_msda`, `fused` and `fusedq` paths, a scatter that
   loses duplicate indices (which that check must reject), and one real
   update.

The line before last is a JSON object with every kernel's launches, error
and times; the last line is `{"ok": true, "device": {...}}`. A kernel has
two times. `ms` is the mean of eager calls of its Python wrapper between
two CUDA events after a warm-up: what the path pays per call, which is the
host's time wherever the host is the slower of the two (every decode-step
and decoder shape). `device_ms` is the same call captured 20 times into a
CUDA graph and replayed: what the call costs the device. Shares of the
bound are `bound_ms / device_ms`; bounds use the H100 SXM peaks (3.35 TB/s,
67 TFLOP/s fp32 outside the tensor cores). A line says "L2-warm" where a
case's working set is below the 50 MB L2 (its inputs stay cached between
the calls of a loop) and "above the L2" where it is not.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
import warnings

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
L2_BYTES = 50e6

#: level-sample cases of the fused kernels at the flagship width, as
#: (Hl, Wl, N): N = Lq * P rows per slab, 5440 queries x 4 points in the
#: encoder, 200 x 4 in the teacher-forced decoder, 1 x 4 in a decode step
SAMPLE_CASES = {"encoder level 0": (64, 64, 21760),
                "encoder level 3": (8, 8, 21760),
                "decoder level 0": (64, 64, 800),
                "decode step level 0": (64, 64, 4)}

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


def device_ms(torch, fn, launches=20, replays=5):
    """Milliseconds of device time per call of `fn`: `launches` calls are
    captured once into a CUDA graph (after a warm-up on a side stream, so
    that builds and first-use set-up happen outside the capture), the
    graph is replayed `replays` times between two events, and the time is
    divided by the calls. No host work lies between the kernels of a
    replay, so unlike `cuda_ms` this is what the call costs the device.
    It raises if `fn` cannot be captured (a sync or a host read in it)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * launches)
    del graph
    return ms


def both_ms(torch, fn, iters=20):
    """(`ms`, `device_ms`) of one call: the eager wrapper between events
    as the path pays it (host time where the host is the slower), and the
    device alone."""
    return cuda_ms(torch, fn, iters=iters), device_ms(torch, fn)


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


@contextlib.contextmanager
def selection(**env):
    """Set the port's CAPE_* variables for a block (None removes one)."""
    def put(values):
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    old = {k: os.environ.get(k) for k in env}
    try:
        put(env)
        yield
    finally:
        put(old)


def _kernel_counters():
    """name in the kernels line -> (wrapper, its counter attribute)."""
    from cape_tpu_torch.ops import gather, msda_fused, msda_kernel

    return {"quad_gather": (gather.quad_gather, "launches"),
            "quad_scatter": (gather.quad_scatter, "launches"),
            "msda_forward": (msda_kernel.msda_forward, "launches"),
            "fused_fwd": (msda_fused.fused_level_sample, "launches"),
            "fused_bwd": (msda_fused.fused_level_sample, "bwd_launches"),
            "quadfused_fwd": (msda_fused.quadfused_level_sample, "launches"),
            "quadfused_bwd": (msda_fused.quadfused_level_sample,
                              "bwd_launches")}


def _reset_counts():
    for fn, attr in _kernel_counters().values():
        setattr(fn, attr, 0)


def _counts():
    return {k: getattr(fn, attr) for k, (fn, attr) in
            _kernel_counters().items()}


def _check_counts(counts, what, **want):
    """Exactly `want` launches of the kernels named, none of any other."""
    full = dict.fromkeys(counts, 0) | want
    check(counts == full, f"{what} launched {counts}; the path needs {full}")


# ----------------------------------------------------------------------
def phase_kernels(torch, card):
    """Kernel vs plain at the serving path's shapes; returns the entries
    of the kernels line (launches filled in later)."""
    from cape_tpu_torch.ops import msda_kernel
    from cape_tpu_torch.models.cape import level_shapes

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    B, H, Dh, P = 8, 8, 32, 4
    shapes = level_shapes(512, 4)
    S = sum(h * w for h, w in shapes)

    gather_entry = _gather_kernel(torch, g, card)

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
         "device_ms": device_ms(torch, lambda: msda_kernel.msda_forward(
            value_bh, idx, w, valid)),
         "plain_ms": cuda_ms(torch, lambda: msda_kernel.msda_forward_plain(
            value_bh, idx, w, valid), iters=5),
         "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
         "ops_ms": flops / FP32_FLOPS * 1e3}
    print(f"msda_forward [encoder, value {tuple(value_bh.shape)} bf16, "
          f"K4={K4}] {m} ({card})", flush=True)

    scatter = _scatter_kernel(torch, g, card)
    fused = _fused_kernels(torch, g, card)
    return [
        gather_entry,
        {"name": "msda_forward", "route": "cuda",
         "source": "cape_tpu_torch/ops/csrc/msda.cu",
         "replaces": "cape_tpu/ops/msda_pallas.py:48",
         "launches": 0, "max_abs_err": m_err, "ms": m["ms"],
         "device_ms": m["device_ms"], "plain_ms": m["plain_ms"],
         "bound_ms": max(m["bytes_ms"], m["ops_ms"]),
         "bound_by": "bytes" if m["bytes_ms"] >= m["ops_ms"] else "operations",
         "library_ms": None},
        scatter,
    ] + fused


def _model_indices(torch, g, shapes, B, H, P, refs, prequad=False):
    """Gather rows as the model draws them: every query samples P points
    per head and level around its own reference point `refs` (B, Lq, 2,
    normalised), here with a seeded normal offset of 2 cells of the level,
    turned into quad-row indices by the port's own
    `_quad_bases_and_weights`. Returns one `gi` (B*H, Lq*P) int32 per
    level, or with `prequad` the decode step's single `gi`
    (B*H, Lq*L*P) into the prepacked slab of all levels."""
    from cape_tpu_torch.ops.msda import (_quad_bases_and_weights,
                                         quad_level_offsets)

    dev = refs.device
    Lq, L = refs.shape[1], len(shapes)
    cells = torch.tensor([[w, h] for h, w in shapes], device=dev,
                         dtype=torch.float32)
    off = torch.randn(B, Lq, H, L, P, 2, generator=g, device=dev) * 2.0
    loc = refs[:, :, None, None, None, :] + off / cells[:, None, :]
    attn = torch.full((B, Lq, H, L, P), 1.0 / (L * P), device=dev)
    bases = [base for _, base, _ in _quad_bases_and_weights(
        shapes, loc, attn, torch.float32)]           # each (B, Lq, H, P)
    if prequad:
        qoffs = quad_level_offsets(shapes)
        gi = torch.stack([b + o for b, o in zip(bases, qoffs)], dim=3)
        return gi.movedim(2, 1).reshape(B * H, Lq * L * P).to(
            torch.int32).contiguous()
    return [b.transpose(1, 2).reshape(B * H, Lq * P).contiguous()
            for b in bases]


def _encoder_refs(torch, shapes, B, dev):
    """The encoder's reference points: the cell centres of every level's
    grid in query order (level by level, row-major), (B, S, 2)."""
    refs = []
    for h, w in shapes:
        ys, xs = torch.meshgrid(
            (torch.arange(h, device=dev, dtype=torch.float32) + 0.5) / h,
            (torch.arange(w, device=dev, dtype=torch.float32) + 0.5) / w,
            indexing="ij")
        refs.append(torch.stack([xs.reshape(-1), ys.reshape(-1)], -1))
    return torch.cat(refs)[None].expand(B, -1, -1)


def _row_cases(torch, g, shapes, B, H, P, decode_step):
    """The (label, n, index set, gi) cases of the two row kernels at
    B * H slabs: the encoder's and the teacher-forced decoder's four
    levels, and for the gather the decode step's prepacked slab; each with
    uniform indices and with the model's local ones."""
    dev = torch.device("cuda")
    n_level = [(w + 1) + h * w for h, w in shapes]
    sites = {"encoder": _encoder_refs(torch, shapes, B, dev),
             "decoder": torch.rand(B, 200, 2, generator=g, device=dev)}
    cases = []
    for site, refs in sites.items():
        local = _model_indices(torch, g, shapes, B, H, P, refs)
        for lvl, n in enumerate(n_level):
            N = refs.shape[1] * P
            uniform = torch.randint(0, n, (B * H, N), generator=g,
                                    device=dev, dtype=torch.int32)
            cases.append((f"{site} level {lvl}", n, "uniform", uniform))
            cases.append((f"{site} level {lvl}", n, "model", local[lvl]))
        del local
    if decode_step:
        n = sum(n_level)
        refs = torch.rand(B, 1, 2, generator=g, device=dev)
        N = len(shapes) * P
        cases.append(("decode step", n, "uniform", torch.randint(
            0, n, (B * H, N), generator=g, device=dev, dtype=torch.int32)))
        cases.append(("decode step", n, "model", _model_indices(
            torch, g, shapes, B, H, P, refs, prequad=True)))
    return cases


def _awkward(torch, gi, n, dups):
    """`gi` with `dups` duplicates of row 3 and the four out-of-range
    values after them."""
    gi = gi.clone()
    gi[:, :dups] = 3
    gi[:, dups:dups + 4] = torch.tensor([-1, -n, n, n + 7], device=gi.device,
                                        dtype=torch.int32)
    return gi


def _gather_kernel(torch, g, card):
    """quad_gather vs its plain version (bit-exact) at the serving path's
    64 slabs: the encoder's four levels, the teacher-forced decoder's, and
    the decode step's prepacked slab, uniform and model-like indices, fp32
    and bf16; then its times in bf16."""
    from cape_tpu_torch.models.cape import level_shapes
    from cape_tpu_torch.ops import gather

    dev = torch.device("cuda")
    B, H, Dh, P = 8, 8, 32, 4
    C = 4 * Dh
    shapes = level_shapes(512, 4)
    err, times = 0.0, {}
    quads = {}
    for label, n, kind, gi in _row_cases(torch, g, shapes, B, H, P, True):
        if n not in quads:
            quads.clear()
            quads[n] = torch.randn(B * H, n, C, generator=g, device=dev)
        bad = _awkward(torch, gi, n, 8)
        for dtype in (torch.float32, torch.bfloat16):
            quad = quads[n].to(dtype)
            got = gather.quad_gather(quad, bad)
            want = gather.quad_gather_plain(quad, bad)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"quad_gather differs from plain "
                  f"({label}, {kind} indices, {dtype})")
            check(not got[:, 8:12].any(), "quad_gather: OOB rows not zero")
            err = max(err, (got.float() - want.float()).abs().max().item())
            del got, want
        # times at the serving dtype with the path's own (in-range) indices
        idx64 = gi.long()[..., None].expand(-1, -1, C)
        nbytes = gather_bytes(torch, quad, gi)
        t = {"shape": f"quad {tuple(quad.shape)} bf16, gi {tuple(gi.shape)}",
             "inputs": "L2-warm" if nbytes < L2_BYTES else "above the L2",
             "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        with torch.inference_mode():
            t["ms"], t["device_ms"] = both_ms(
                torch, lambda: gather.quad_gather(quad, gi))
            t["library_ms"], t["library_device_ms"] = both_ms(
                torch, lambda: torch.gather(quad, 1, idx64))
            t["plain_ms"] = cuda_ms(
                torch, lambda: gather.quad_gather_plain(quad, gi), iters=5)
        t["bound_share"] = t["bound_ms"] / t["device_ms"]
        times[label, kind] = t
        print(f"quad_gather [{label}, {kind} indices] {json.dumps(t)} "
              f"({card})", flush=True)
    print("quad_gather: bit-exact against plain in fp32 and bf16 at every "
          "case above, duplicate and out-of-range indices included",
          flush=True)
    head = times["encoder level 0", "uniform"]
    return {"name": "quad_gather", "route": "cuda",
            "source": "cape_tpu_torch/ops/csrc/gather.cu",
            "replaces": "cape_tpu/ops/gather_mxu.py:57",
            "launches": 0, "max_abs_err": err, "ms": head["ms"],
            "device_ms": head["device_ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": "bytes",
            "library_ms": head["library_ms"]}


def _scatter_kernel(torch, g, card):
    """quad_scatter (the gather's backward) vs its plain version at the
    training path's 32 slabs (4 images x 8 heads, C = 128): the four
    levels of the encoder (N = 21,760) and of the teacher-forced decoder
    (N = 800), uniform and model-like indices, fp32 and bf16, with
    duplicates and out-of-range indices; a slab whose n is no multiple of
    its tile and one with C = 32; then its times in bf16 beside
    `scatter_add_` computing the same function (bf16 in, fp32 sum, bf16
    out) and beside the bare fp32 `scatter_add_`."""
    from cape_tpu_torch.models.cape import level_shapes
    from cape_tpu_torch.ops import gather

    dev = torch.device("cuda")
    B, H, P, C = 4, 8, 4, 128
    BH = B * H
    # fp32: the same terms summed in another order (which warp's add lands
    # first varies run to run, here and in the plain version's
    # `index_add_`; then the blocks of a cluster in rank order). A sum of
    # T terms carries up to about 2^-23 of the sum of their magnitudes, so
    # that is the third part of the tolerance: 5e-7 where 5 rows meet
    # (level 0), 3e-5 where 300 do (level 3). bf16: that, then one rounding
    # to bf16 (one bf16 ulp where a sum lands near a rounding boundary)
    tol = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-5, 2 ** -7)}

    def agree(label, dg, gi, n):
        got = gather.quad_scatter(dg, gi, n)
        want = gather.quad_scatter_plain(dg, gi, n)
        mass = gather.quad_scatter_plain(dg.float().abs(), gi, n)
        torch.cuda.synchronize()
        check(got.dtype == dg.dtype and got.shape == (dg.shape[0], n,
                                                      dg.shape[2]),
              "quad_scatter: wrong dtype or shape")
        atol, rtol = tol[dg.dtype]
        diff = (got.float() - want.float()).abs()
        worst = (diff / (atol + rtol * want.float().abs()
                         + 2 ** -23 * mass)).max().item()
        e = diff.max().item()
        print(f"quad_scatter [{label}, {dg.dtype}]: max abs err {e:.3e}, "
              f"{worst:.3f} of the tolerance ({atol:g} abs + {rtol:g} rel + "
              f"2^-23 of the summed magnitudes); plan "
              f"{tuple(gather.scatter_plan(gi.shape[0], n, *dg.shape[1:]))}",
              flush=True)
        check(worst <= 1.0, f"quad_scatter differs from plain ({label}, "
              f"{dg.dtype}): {worst:.3f} of the tolerance")
        return e

    err, times = 0.0, {}
    for dtype in tol:
        # n no multiple of the tile and N none of the cluster; C = 32; and
        # more indices than a cluster chains in one pass, on narrow rows
        for label, (b, n, N, c) in {"ragged": (5, 1000, 4999, C),
                                    "C = 32": (BH, 273, 5000, 32),
                                    "two passes": (1, 40, 200001, 8)}.items():
            dg = torch.randn(b, N, c, generator=g, device=dev).to(dtype)
            gi = _awkward(torch, torch.randint(
                0, n, (b, N), generator=g, device=dev, dtype=torch.int32),
                n, 64)
            err = max(err, agree(label, dg, gi, n))
    dgs = {}
    for label, n, kind, gi in _row_cases(torch, g, level_shapes(512, 4), B,
                                         H, P, False):
        N = gi.shape[1]
        if N not in dgs:
            dgs.clear()
            dgs[N] = torch.randn(BH, N, C, generator=g, device=dev)
        for dtype in tol:
            dg = dgs[N].to(dtype)
            err = max(err, agree(f"{label}, {kind} indices", dg,
                                 _awkward(torch, gi, n, 64), n))
        # times in bf16 (the training path's dtype), in-range indices. The
        # bound: dg and gi read once, the slab written once in dg's dtype
        idx64 = gi.long()[..., None].expand(-1, -1, C)
        dg32 = dg.float()
        nbytes = (dg.numel() * dg.element_size() + gi.numel() * 4
                  + BH * n * C * dg.element_size())
        t = {"shape": f"dg {tuple(dg.shape)} bf16, gi {tuple(gi.shape)}, "
                      f"n {n}",
             "inputs": "L2-warm" if nbytes < L2_BYTES else "above the L2",
             "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        t["ms"], t["device_ms"] = both_ms(
            torch, lambda: gather.quad_scatter(dg, gi, n))
        # the library computing the kernel's function ...
        t["library_ms"], t["library_device_ms"] = both_ms(
            torch, lambda: torch.zeros(BH, n, C, device=dev).scatter_add_(
                1, idx64, dg.float()).to(dg.dtype))
        # ... and its bare fp32 call, which does less (no casts)
        t["bare_scatter_add_ms"], t["bare_scatter_add_device_ms"] = both_ms(
            torch, lambda: torch.zeros(BH, n, C, device=dev).scatter_add_(
                1, idx64, dg32))
        t["plain_ms"] = cuda_ms(
            torch, lambda: gather.quad_scatter_plain(dg, gi, n), iters=5)
        t["bound_share"] = t["bound_ms"] / t["device_ms"]
        times[label, kind] = t
        print(f"quad_scatter [{label}, {kind} indices] {json.dumps(t)} "
              f"({card})", flush=True)
    head = times["encoder level 0", "uniform"]
    return {"name": "quad_scatter", "route": "cuda",
            "source": "cape_tpu_torch/ops/csrc/scatter.cu",
            "replaces": "cape_tpu/ops/gather_mxu.py:68",
            "launches": 0, "max_abs_err": err, "ms": head["ms"],
            "device_ms": head["device_ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": "bytes",
            "library_ms": head["library_ms"]}


def _sample_inputs(torch, g, BH, Hl, Wl, N, Dh, dtype, quad, awkward):
    """(slab, gi, w4, dout) of one level sample on the card. The raw slab
    is a level slice of a longer (BH, S, Dh) value (rows contiguous, batch
    stride longer than the slab), as the fused core hands it over; the
    quad slab is contiguous. `gi` covers what the path can produce: the
    raw top-left corner from -(Wl+1) on, or a quad row of [0, n). With
    `awkward` it also holds indices far below 0 and past the end (with
    non-zero weights), duplicates and row-edge cells, and zero weights."""
    dev = torch.device("cuda")
    HW = Hl * Wl
    if quad:
        rows, lo = (Wl + 1) + HW, 0
        slab = torch.randn(BH, rows, 4 * Dh, generator=g, device=dev
                           ).to(dtype)
    else:
        rows, lo = HW, -(Wl + 1)
        value = torch.randn(BH, HW + 1344, Dh, generator=g, device=dev
                            ).to(dtype)
        slab = value[:, 320:320 + HW]
    gi = torch.randint(lo, rows, (BH, N), generator=g, device=dev,
                       dtype=torch.int32)
    w4 = torch.rand(BH, N, 4, generator=g, device=dev).to(dtype)
    dout = torch.randn(BH, N, Dh, generator=g, device=dev).to(dtype)
    if awkward:
        special = [3, -1, rows + 7, 3, lo - 3, rows, -10 * rows, Wl - 1,
                   2 * Wl - 1, rows - 1]
        k = min(N, len(special))
        gi[:, :k] = torch.tensor(special[:k], device=dev, dtype=torch.int32)
        w4[:, 0, 1:3] = 0
        if N >= 96:
            gi[:, 16:80] = 5                    # 64 rows onto one index
            w4[:, 80:96] = 0                    # zero weights, in range
    return slab, gi, w4, dout


def _sample_bound_ms(torch, slab, gi, w4, Wl, backward):
    """The least time for one level sample on these inputs: the slab rows
    that the corners select, gi and w4 read once and the output written
    once (backward: dout read as well, dslab in the slab's dtype and dw4
    written), against the fp32 multiply-adds of the blend."""
    BH, rows, width = slab.shape
    N = gi.shape[1]
    Dh = width if Wl is not None else width // 4
    elt = slab.element_size()
    idx = gi.long()[..., None]
    if Wl is not None:
        idx = idx + torch.tensor([0, 1, Wl, Wl + 1], device=gi.device)
    flat = (torch.arange(BH, device=gi.device)[:, None, None] * rows + idx)[
        (idx >= 0) & (idx < rows)]
    # rows read, gi, w4, and one (BH, N, Dh) array: out written, or dout read
    nbytes = (torch.unique(flat).numel() * width * elt + gi.numel() * 4
              + w4.numel() * elt + BH * N * Dh * elt)
    flops = 2 * BH * N * 4 * Dh
    if backward:
        nbytes += slab.numel() * elt + w4.numel() * elt     # dslab, dw4
        flops *= 2
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3


def _off_range(torch, gi, Wl, rows):
    """(BH, N, 4) mask of the corners outside the slab: the raw slab's
    corners gi + shift_c outside [0, rows), or every corner of a quad row
    gi outside [0, rows)."""
    g = gi.long()[..., None]
    if Wl is None:
        return ((g < 0) | (g >= rows)).expand(-1, -1, 4)
    t = g + torch.tensor([0, 1, Wl, Wl + 1], device=gi.device)
    return (t < 0) | (t >= rows)


@contextlib.contextmanager
def _forced_plan(mf, plan):
    """The level samples' backwards tiled by `plan` instead of their own."""
    own = mf.sample_bwd_plan
    mf.sample_bwd_plan = lambda *args: plan
    try:
        yield
    finally:
        mf.sample_bwd_plan = own


def _check_sample_bwd(torch, mf, label, slab, gi, w4, dout, Wl):
    """One backward (`*_level_sample_bwd`, the kernel) against its plain
    version: dslab within its tolerance, dw4 within its, dw4 exactly 0 at
    every corner outside the slab, and a strided raw slab bit-equal to its
    contiguous copy (the row lists are summed in the same order every run).
    Returns the largest errors (dslab, dw4)."""
    quad = Wl is None
    kind = "quadfused" if quad else "fused"
    lvl = () if quad else (Wl,)
    bwd = mf.quadfused_level_sample_bwd if quad else mf.fused_level_sample_bwd
    plain = mf.quadfused_level_sample_bwd_plain if quad \
        else mf.fused_level_sample_bwd_plain
    dslab, dw4 = bwd(slab, gi, w4, *lvl, dout)
    same = bwd(slab.contiguous(), gi, w4, *lvl, dout)
    want = plain(slab, gi, w4, *lvl, dout)
    # the summed magnitudes of the terms that meet in a dslab value
    mass = plain(slab, gi, w4.float().abs(), *lvl, dout.float().abs())[0]
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip((dslab, dw4), same)),
          f"{kind} backward: a strided slab and its copy differ ({label})")
    off = _off_range(torch, gi, Wl, slab.shape[1])
    check(not dw4[off].any(), f"{kind} backward: dw4 of a corner outside "
          f"the slab is not 0 ({label})")
    # the same terms summed in another order: a sum of T terms carries up
    # to about 2^-23 of the sum of their magnitudes (fp32); bf16 adds one
    # rounding of the result (one ulp where a sum lands near a boundary)
    rtol = 1e-5 if slab.dtype == torch.float32 else 2 ** -7
    errs = []
    for name, got, ref, extra in (("dslab", dslab, want[0], 2 ** -23 * mass),
                                  ("dw4", dw4, want[1], 0.0)):
        check(got.dtype == slab.dtype and got.shape == ref.shape,
              f"{kind} {name}: wrong dtype or shape ({label})")
        diff = (got.float() - ref.float()).abs()
        worst = (diff / (1e-5 + rtol * ref.float().abs() + extra)).max().item()
        e = diff.max().item()
        print(f"{kind} {name} [{label}, {slab.dtype}]: max abs err {e:.3e}, "
              f"{worst:.3f} of the tolerance (1e-05 abs + {rtol:g} rel"
              + (" + 2^-23 of the summed magnitudes)" if name == "dslab"
                 else ")"), flush=True)
        check(worst <= 1.0, f"{kind} {name} differs from plain ({label}, "
              f"{slab.dtype}): {worst:.3f} of the tolerance")
        errs.append(e)
    return errs


def _fused_kernels(torch, g, card):
    """The four fused level-sample kernels (fused.cu, quadfused.cu) against
    their plain versions, fp32 and bf16: forward and backward (through
    autograd) at encoder level 0, at the smallest level (the most rows per
    slab row), at the teacher-forced decoder's and the decode step's row
    counts; the backwards alone also at encoder levels 1 and 2, a
    non-square level, Dh = 16, a forced cluster and two passes. Then their
    times in bf16: the forwards at encoder levels 0 and 3 and the decoder,
    the backwards at the four encoder levels and decoder level 0 with
    uniform and with model-like indices."""
    from cape_tpu_torch.models.cape import level_shapes
    from cape_tpu_torch.ops import msda_fused as mf

    Dh, cases = 32, SAMPLE_CASES
    # forward: the same terms in another order (fused multiply-adds), then
    # one rounding in bf16 (one ulp where a sum lands near a boundary); the
    # backward's tolerances are `_check_sample_bwd`'s
    tols = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-5, 2 ** -7)}
    errs = {}
    for quad in (False, True):
        kind = "quadfused" if quad else "fused"
        fwd = mf.quadfused_level_sample if quad else mf.fused_level_sample
        errs[kind] = {(key, dt): 0.0 for key in ("fwd", "bwd")
                      for dt in tols}
        for label, (Hl, Wl, N) in cases.items():
            for dtype in (torch.float32, torch.bfloat16):
                slab, gi, w4, dout = _sample_inputs(
                    torch, g, 64, Hl, Wl, N, Dh, dtype, quad, awkward=True)
                lvl = () if quad else (Wl,)
                s_g, w_g = slab.detach().requires_grad_(True), \
                    w4.detach().requires_grad_(True)
                out = fwd(s_g, gi, w_g, *lvl)
                dslab, dw4 = torch.autograd.grad(out, (s_g, w_g), dout)
                if quad:
                    want = mf.quadfused_level_sample_plain(slab, gi, w4)
                    want_b = mf.quadfused_level_sample_bwd(slab, gi, w4,
                                                           dout)
                else:
                    want = mf.fused_level_sample_plain(slab, gi, w4, Wl)
                    want_b = mf.fused_level_sample_bwd(slab, gi, w4, Wl,
                                                       dout)
                    same = fwd(slab.contiguous(), gi, w4, Wl)
                    check(torch.equal(same, out),
                          "fused_fwd: a strided slab and its copy differ")
                torch.cuda.synchronize()
                check(not out[:, 2].any() and not dw4[:, 2].any(),
                      f"{kind}: an off-range row is not zero ({label})")
                # autograd's backward is the kernel's
                check(torch.equal(dslab, want_b[0])
                      and torch.equal(dw4, want_b[1]),
                      f"{kind}: autograd's backward is not the kernel's")
                check(out.dtype == dtype and out.shape == want.shape,
                      f"{kind} out: wrong dtype or shape")
                e = (out.float() - want.float()).abs().max().item()
                atol, rtol = tols[dtype]
                print(f"{kind} out [{label}, {dtype}]: max abs err {e:.3e} "
                      f"(tolerance {atol:g} abs + {rtol:g} rel)", flush=True)
                torch.testing.assert_close(out.float(), want.float(),
                                           atol=atol, rtol=rtol)
                errs[kind]["fwd", dtype] = max(errs[kind]["fwd", dtype], e)
                e = max(_check_sample_bwd(torch, mf, label, slab, gi, w4,
                                          dout, None if quad else Wl))
                errs[kind]["bwd", dtype] = max(errs[kind]["bwd", dtype], e)
                del out, dslab, dw4, want, want_b, s_g, w_g

    # the backwards alone: (BH, Hl, Wl, N, Dh, forced plan or None)
    bwd_cases = {"encoder level 1": (32, 32, 32, 21760, Dh, None),
                 "encoder level 2": (32, 16, 16, 21760, Dh, None),
                 "non-square 40 x 56": (32, 40, 56, 5000, Dh, None),
                 "Dh = 16": (32, 16, 16, 5000, 16, None),
                 "forced cluster of 8": (5, 16, 16, 5003, Dh, "cluster"),
                 "two passes": (1, 5, 8, 200001, Dh, None)}
    for quad in (False, True):
        kind = "quadfused" if quad else "fused"
        for label, (BH, Hl, Wl, N, dh, force) in bwd_cases.items():
            for dtype in (torch.float32, torch.bfloat16):
                slab, gi, w4, dout = _sample_inputs(
                    torch, g, BH, Hl, Wl, N, dh, dtype, quad, awkward=True)
                rows, width = slab.shape[1], slab.shape[2]
                halo = 0 if quad else Wl + 1
                plan = mf.sample_bwd_plan(BH, rows, N, width, halo,
                                          1 if quad else 4)
                if force == "cluster":
                    # 8 blocks a tile, tiles of 24 rows, 2 groups a row
                    chain = -(-(-(-N // 32)) // 8) * 32
                    plan = mf.SampleBwdPlan(
                        24, -(-rows // 24), 8, chain, 1, 512,
                        mf._list_bytes(24, chain, width, True, halo, 512), 2)
                with _forced_plan(mf, plan):
                    e = max(_check_sample_bwd(torch, mf, f"{label}; plan "
                                              f"{tuple(plan)}", slab, gi, w4,
                                              dout, None if quad else Wl))
                errs[kind]["bwd", dtype] = max(errs[kind]["bwd", dtype], e)
                del slab, gi, w4, dout

    entries = []
    for quad in (False, True):
        kind = "quadfused" if quad else "fused"
        times = {"fwd": {}, "bwd": {}}
        # forwards in bf16 with the path's own index range: the serving
        # batch (64 slabs) for the encoder, the training batch (32) for the
        # teacher-forced decoder
        for label, BH in (("encoder level 0", 64), ("encoder level 3", 64),
                          ("decoder level 0", 32)):
            Hl, Wl, N = cases[label]
            slab, gi, w4, _ = _sample_inputs(
                torch, g, BH, Hl, Wl, N, Dh, torch.bfloat16, quad,
                awkward=False)
            lvl = () if quad else (Wl,)
            k_fn = mf.quadfused_level_sample if quad \
                else mf.fused_level_sample
            p_fn = mf.quadfused_level_sample_plain if quad \
                else mf.fused_level_sample_plain
            args = (slab, gi, w4, *lvl)
            b_ms, o_ms = _sample_bound_ms(torch, slab, gi, w4,
                                          None if quad else Wl, False)
            with torch.no_grad():
                times["fwd"][label] = {
                    "ms": cuda_ms(torch, lambda: k_fn(*args)),
                    "device_ms": device_ms(torch, lambda: k_fn(*args)),
                    "plain_ms": cuda_ms(torch, lambda: p_fn(*args), iters=5,
                                        warmup=1),
                    "bytes_ms": b_ms, "ops_ms": o_ms,
                    "shape": f"slab {tuple(slab.shape)} bf16, gi "
                             f"{tuple(gi.shape)}"}
            print(f"{kind}_fwd [{label}] {times['fwd'][label]} ({card})",
                  flush=True)
        # backwards at the training batch (32 slabs), every encoder level
        # and decoder level 0, uniform indices and the model's (quad bases
        # of `_quad_bases_and_weights`; the raw slab's cell is the base
        # - (Wl + 1), as `ops/msda.py` computes it)
        shapes = level_shapes(512, 4)
        for label, _, ikind, gq in _row_cases(torch, g, shapes, 4, 8, 4,
                                              False):
            if label.startswith("decoder") and label != "decoder level 0":
                continue
            Hl, Wl = shapes[int(label[-1])]
            N = gq.shape[1]
            slab, _, w4, dout = _sample_inputs(
                torch, g, 32, Hl, Wl, N, Dh, torch.bfloat16, quad,
                awkward=False)
            gi = gq if quad else (gq - (Wl + 1)).contiguous()
            lvl = () if quad else (Wl,)
            k_fn = mf.quadfused_level_sample_bwd if quad \
                else mf.fused_level_sample_bwd
            p_fn = mf.quadfused_level_sample_bwd_plain if quad \
                else mf.fused_level_sample_bwd_plain
            args = (slab, gi, w4, *lvl, dout)
            b_ms, o_ms = _sample_bound_ms(torch, slab, gi, w4,
                                          None if quad else Wl, True)
            t = {"shape": f"slab {tuple(slab.shape)} bf16, gi "
                          f"{tuple(gi.shape)}",
                 "inputs": "L2-warm" if b_ms * 1e-3 * HBM_BYTES_PER_S
                 < L2_BYTES else "above the L2",
                 "plan": tuple(mf.sample_bwd_plan(
                     32, slab.shape[1], N, slab.shape[2],
                     0 if quad else Wl + 1, 1 if quad else 4))}
            t["ms"], t["device_ms"] = both_ms(torch, lambda: k_fn(*args))
            t["plain_ms"] = cuda_ms(torch, lambda: p_fn(*args), iters=5,
                                    warmup=1)
            t["bytes_ms"], t["ops_ms"] = b_ms, o_ms
            t["bound_share"] = max(b_ms, o_ms) / t["device_ms"]
            times["bwd"][label, ikind] = t
            print(f"{kind}_bwd [{label}, {ikind} indices] {json.dumps(t)} "
                  f"({card})", flush=True)
            del slab, w4, dout, gi
        line = {"fused": (88, 99), "quadfused": (231, 249)}[kind]
        for key, at in zip(("fwd", "bwd"), line):
            t = times[key]["encoder level 0"] if key == "fwd" \
                else times[key]["encoder level 0", "uniform"]
            e32, e16 = (errs[kind][key, dt] for dt in tols)
            print(f"{kind}_{key}: largest error against plain over the "
                  f"cases above, fp32 {e32:.3e}, bf16 {e16:.3e}", flush=True)
            entries.append({
                "name": f"{kind}_{key}", "route": "cuda",
                "source": f"cape_tpu_torch/ops/csrc/{kind}.cu",
                "replaces": f"cape_tpu/ops/msda_fused.py:{at}",
                "launches": 0, "max_abs_err": max(e32, e16),
                "ms": t["ms"], "device_ms": t["device_ms"],
                "plain_ms": t["plain_ms"],
                "bound_ms": max(t["bytes_ms"], t["ops_ms"]),
                "bound_by": "bytes" if t["bytes_ms"] >= t["ops_ms"]
                else "operations", "library_ms": None})
    return entries


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


def phase_serving(torch, np, card):
    """The flagship serving path: 3 requests of 8 images, default config;
    then one request with use_pallas_msda=True on the same weights."""
    from cape_tpu_torch import CAPE, CAPEConfig, CAPEPredictor

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

    _reset_counts()
    times, steps = [], []
    for imgs, boxes in reqs:
        t0 = time.perf_counter()
        res = pred.predict(imgs, proto, bboxes=boxes, **kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        _check_results(np, res, len(imgs), len(PROTO_17))
        steps.append(max(r["length"] for r in res))
    default_counts = _counts()
    default_res = res
    L = cfg.num_feature_levels
    want = sum(cfg.enc_layers * L + cfg.dec_layers * s for s in steps)
    print(f"default path: {default_counts} launches over 3 requests, "
          f"decode steps {steps}", flush=True)
    _check_counts(default_counts, "the default path", quad_gather=want)
    print(f"predict ms/request (batch 8, 512 px, bf16): "
          f"{[round(t, 3) for t in times]} ({card})", flush=True)

    # -- use_pallas_msda=True: same weights, one request --------------------
    cfg_p = cfg.replace(use_pallas_msda=True)
    model_p = CAPE(cfg_p, device="cuda",
                   generator=torch.Generator().manual_seed(1))
    model_p.load_state_dict(model.state_dict())
    pred_p = CAPEPredictor(cfg_p, model_p, batch_size=8)
    imgs, boxes = reqs[0]
    _reset_counts()
    t0 = time.perf_counter()
    res = pred_p.predict(imgs, proto, bboxes=boxes, **kw)
    torch.cuda.synchronize()
    ms_p = (time.perf_counter() - t0) * 1e3
    _check_results(np, res, len(imgs), len(PROTO_17))
    s = max(r["length"] for r in res)
    pallas_counts = _counts()
    print(f"use_pallas_msda path: {pallas_counts} launches over 1 request, "
          f"decode steps {s}, {ms_p:.3f} ms ({card})", flush=True)
    _check_counts(pallas_counts, "the use_pallas_msda path",
                  msda_forward=cfg.enc_layers, quad_gather=cfg.dec_layers * s)
    del model_p, pred_p

    # -- CAPE_MSDA_GATHER=fused|fusedq on the same weights: the last default
    # request again (it is warm), then each selection with the unpacked
    # decode, then `fused` with the prepacked decode
    imgs, boxes = reqs[-1]

    def request(label, **env):
        with selection(**env), warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            pred.predict(imgs, proto, bboxes=boxes, **kw)      # warm-up
            _reset_counts()
            n_warm = len(caught)
            t0 = time.perf_counter()
            res = pred.predict(imgs, proto, bboxes=boxes, **kw)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        counts = _counts()
        _check_results(np, res, len(imgs), len(PROTO_17))
        s = max(r["length"] for r in res)
        # bf16 keypoints against the default path's, reported only: the
        # formulations round at other places and random weights amplify it
        diff = max(np.abs(a["keypoints"] - b["keypoints"]).max()
                   for a, b in zip(res, default_res))
        same_len = [a["length"] for a in res] == [b["length"]
                                                  for b in default_res]
        print(f"{label}: {counts} launches over 1 request, decode steps "
              f"{s}, {ms:.3f} ms warm; keypoints differ from the default "
              f"path's by at most {diff:.3f} px, lengths equal: {same_len} "
              f"({card})", flush=True)
        return counts, s, {str(w.message) for w in caught[n_warm:]
                           if "CAPE_MSDA" in str(w.message)}

    enc = cfg.enc_layers * L
    _, s, _ = request("default path again", CAPE_MSDA_GATHER=None,
                      CAPE_DECODE_PREQUAD=None)
    fused_counts = {}
    for impl, name in (("fused", "fused_fwd"), ("fusedq", "quadfused_fwd")):
        counts, s, warned = request(
            f"CAPE_MSDA_GATHER={impl} CAPE_DECODE_PREQUAD=0",
            CAPE_MSDA_GATHER=impl, CAPE_DECODE_PREQUAD="0")
        _check_counts(counts, f"the {impl} request",
                      **{name: enc + cfg.dec_layers * L * s})
        check(not warned, f"the {impl} request warned: {warned}")
        fused_counts[name] = counts[name]
    counts, s, warned = request(
        "CAPE_MSDA_GATHER=fused, prepacked decode", CAPE_MSDA_GATHER="fused",
        CAPE_DECODE_PREQUAD=None)
    _check_counts(counts, "the fused request with the prepacked decode",
                  fused_fwd=enc, quad_gather=cfg.dec_layers * s)
    check(len(warned) == 1 and "CAPE_DECODE_PREQUAD=0" in next(iter(warned)),
          f"the prepacked decode under fused must warn once, got {warned}")
    print(f"  its warning: {next(iter(warned))}", flush=True)
    return model, default_counts, pallas_counts, fused_counts


def _train_batch(np, cfg, rng):
    """One seeded teacher-forced batch of batch_size episodes x
    num_queries_per_episode query images: uint8 images, a jittered
    17-keypoint prototype as support and targets from the port's
    tokenizer."""
    from cape_tpu_torch.data.tokenizer import (DiscreteTokenizer,
                                               tokenize_keypoints)

    B = cfg.batch_size * cfg.num_queries_per_episode
    S, K, E = cfg.image_size, cfg.max_support_keypoints, cfg.max_skeleton_edges
    tok = DiscreteTokenizer(cfg.num_bins, cfg.seq_len)
    proto = np.asarray(PROTO_17, np.float32)
    sc = np.zeros((B, K, 2), np.float32)
    sm = np.ones((B, K), bool)
    se = np.full((B, E, 2), -1, np.int32)
    targets = []
    for i in range(B):
        sc[i, :17] = np.clip(proto + rng.normal(0, 0.02, proto.shape), 0, 1)
        sm[i, :17] = False
        se[i, :len(SKELETON_17)] = SKELETON_17
        kpts = np.clip(proto + rng.normal(0, 0.05, proto.shape), 0, 1) * S
        targets.append(tokenize_keypoints(tok, kpts, S, S,
                                          rng.integers(1, 3, 17)))
    return {"query_images": rng.integers(0, 256, (B, S, S, 3),
                                         dtype=np.uint8),
            "support_coords": sc, "support_mask": sm, "skeleton_edges": se,
            "targets": {k: np.stack([t[k] for t in targets])
                        for k in targets[0]}}


def phase_training(torch, np, card):
    """The flagship teacher-forced training step: 8 micro-steps = 2 real
    AdamW updates (accumulation_steps=4) with dropout 0.1, 4 query images
    each; then the forward/backward/optimizer split, and one micro-step on
    the use_pallas_msda path."""
    from cape_tpu_torch import CAPE, CAPEConfig
    from cape_tpu_torch.train import create_train_state, make_train_step
    from cape_tpu_torch.train.state import global_norm
    from cape_tpu_torch.train.train_step import forward_losses

    cfg = CAPEConfig()
    check(cfg.bf16 and cfg.image_size == 512 and cfg.dropout == 0.1
          and cfg.aux_loss and cfg.batch_size == 2
          and cfg.num_queries_per_episode == 2
          and cfg.accumulation_steps == 4 and not cfg.use_remat_encoder,
          "flagship training defaults changed")
    spe = cfg.episodes_per_epoch // cfg.batch_size
    model = CAPE(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    state = create_train_state(cfg, model, spe)
    step = make_train_step(model, cfg, spe)
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(3)
    batches = [_train_batch(np, cfg, rng) for _ in range(8)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = [p for p in model.parameters()]
    per_step = cfg.enc_layers * cfg.num_feature_levels \
        + cfg.dec_layers * cfg.num_feature_levels
    launches = {"quad_gather": 0, "quad_scatter": 0, "msda_forward": 0}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i, batch in enumerate(batches):
        before_p = [t.detach().clone() for t in params]
        before_m = [t.clone() for t in state.opt_state.masters]
        _reset_counts()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        counts = _counts()
        for k in launches:
            launches[k] += counts[k]
        m = {k: v.item() for k, v in metrics.items()}
        print(f"micro-step {i + 1}: {times[-1]:.3f} ms, total "
              f"{m['total']:.6f}, grad_norm {m['grad_norm']:.6f}, "
              f"launches {counts}", flush=True)
        check(all(np.isfinite(v) for v in m.values()), "non-finite metrics")
        check(m["grad_norm"] > 0, "zero gradient norm")
        _check_counts(counts, f"micro-step {i + 1}", quad_gather=per_step,
                      quad_scatter=per_step)
        same_p = all(torch.equal(a, b) for a, b in zip(before_p, params))
        changed_m = sum(not torch.equal(a, b) for a, b in
                        zip(before_m, state.opt_state.masters))
        if (i + 1) % cfg.accumulation_steps:
            check(same_p and changed_m == 0,
                  f"parameters changed on micro-step {i + 1}")
        else:
            # the bf16 weights are the fp32 masters, cast. Early in the
            # warmup an update (~lr/2500) is below the fp32 resolution of
            # the norm scales near 1 and below the bf16 resolution of most
            # weights: the masters keep what bf16 cannot
            refreshed = all(torch.equal(p, m.to(p.dtype)) for p, m in
                            zip(params, state.opt_state.masters))
            changed_p = sum(not torch.equal(a, b)
                            for a, b in zip(before_p, params))
            print(f"  real update {(i + 1) // cfg.accumulation_steps}: "
                  f"{changed_m} of {len(params)} fp32 master tensors and "
                  f"{changed_p} model tensors changed", flush=True)
            check(refreshed, "bf16 weights not refreshed from the masters")
            check(changed_m > 0.5 * len(params) and changed_p > 0,
                  f"only {changed_m} parameter tensors changed on a real "
                  "update")
        del before_p, before_m
    peak = torch.cuda.max_memory_allocated()
    check(state.step == 8 and state.opt_state.gradient_step == 2,
          "step counts")
    updates = times[cfg.accumulation_steps - 1::cfg.accumulation_steps]
    print(f"flagship training (B=4 images, 512 px, bf16, dropout 0.1, "
          f"{n_params} parameters): ms per micro-step "
          f"{[round(t, 3) for t in times]} (those ending an accumulation "
          f"include the optimizer: {[round(t, 3) for t in updates]}); peak "
          f"memory {peak} bytes ({card})", flush=True)

    # -- the split: forward, backward and a real optimizer update, timed
    # apart with a sync between them on the same batches
    split = {"forward": [], "backward": [], "optimizer micro": [],
             "optimizer update": []}
    for batch in batches[:cfg.accumulation_steps]:
        t0 = time.perf_counter()
        losses = forward_losses(model, cfg, batch, gen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = torch.autograd.grad(losses["total"], params)
        global_norm(grads)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        emitted = state.tx.update(grads, state.opt_state, params)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        split["forward"].append((t1 - t0) * 1e3)
        split["backward"].append((t2 - t1) * 1e3)
        split["optimizer update" if emitted else "optimizer micro"].append(
            (t3 - t2) * 1e3)
        del losses, grads
    split = {k: [round(t, 3) for t in v] for k, v in split.items()}
    print(f"training split ms: {split} ({card})", flush=True)
    return model, launches


def phase_training_pallas(torch, np, model, card):
    """Flagship micro-steps with use_pallas_msda=True on the same weights,
    each with 12 msda_forward launches (6 encoder + 6 decoder sites) and,
    in the backward's recomputed core, 48 gathers and 48 scatters; the
    second is timed warm. Its deterministic loss against the default
    path's (bf16)."""
    from cape_tpu_torch import CAPE
    from cape_tpu_torch.train import create_train_state, make_train_step
    from cape_tpu_torch.train.train_step import forward_losses

    cfg = model.cfg.replace(use_pallas_msda=True)
    spe = cfg.episodes_per_epoch // cfg.batch_size
    model_p = CAPE(cfg, device="cuda", generator=torch.Generator().manual_seed(1))
    model_p.load_state_dict(model.state_dict())
    state = create_train_state(cfg, model_p, spe)
    batch = _train_batch(np, cfg, np.random.default_rng(4))
    with torch.no_grad():
        want = forward_losses(model, cfg, batch)["total"].item()
        got = forward_losses(model_p, cfg, batch)["total"].item()
    print(f"use_pallas_msda deterministic loss {got:.6f} vs default "
          f"{want:.6f} (tolerance 2e-2 rel: bf16)", flush=True)
    check(abs(got - want) <= 2e-2 * abs(want), "use_pallas_msda loss differs")
    step = make_train_step(model_p, cfg, spe)
    gen = torch.Generator(device="cuda").manual_seed(1)
    sites = cfg.enc_layers + cfg.dec_layers
    per_step = sites * cfg.num_feature_levels
    for i in range(2):
        _reset_counts()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = _counts()
        m = {k: v.item() for k, v in metrics.items()}
        print(f"use_pallas_msda micro-step {i + 1}: {ms:.3f} ms, total "
              f"{m['total']:.6f}, grad_norm {m['grad_norm']:.6f}, launches "
              f"{counts} ({card})", flush=True)
        check(all(np.isfinite(v) for v in m.values()) and m["grad_norm"] > 0,
              "use_pallas_msda step: non-finite or zero metrics")
        _check_counts(counts, "the use_pallas_msda micro-step",
                      quad_gather=per_step, quad_scatter=per_step,
                      msda_forward=sites)
    return counts


def phase_training_fused(torch, np, model, card):
    """Flagship micro-steps under CAPE_MSDA_GATHER=fused and fusedq on the
    same weights: per micro-step 48 forward and 48 backward launches of
    the selected kernels (6 encoder + 6 decoder sites x 4 levels; no remat
    at this batch), no gather and no scatter. Three micro-steps each (the
    first is the warm-up), next to three more of the default path in the
    same state of the card; the deterministic bf16 loss against the
    default path's. Returns the backward launches of each selection."""
    from cape_tpu_torch.train import create_train_state, make_train_step
    from cape_tpu_torch.train.train_step import forward_losses

    cfg = model.cfg
    spe = cfg.episodes_per_epoch // cfg.batch_size
    batch = _train_batch(np, cfg, np.random.default_rng(6))
    per_step = (cfg.enc_layers + cfg.dec_layers) * cfg.num_feature_levels
    state = create_train_state(cfg, model, spe)
    step = make_train_step(model, cfg, spe)
    gen = torch.Generator(device="cuda").manual_seed(2)
    launched = {}
    for impl, kind in ((None, None), ("fused", "fused"),
                       ("fusedq", "quadfused")):
        label = f"CAPE_MSDA_GATHER={impl}" if impl else "default path"
        if impl:
            # on the weights as they stand now: the steps above moved them
            with torch.no_grad():
                want = forward_losses(model, cfg, batch)["total"].item()
                with selection(CAPE_MSDA_GATHER=impl):
                    got = forward_losses(model, cfg, batch)["total"].item()
            print(f"{label} deterministic loss {got:.6f} vs default "
                  f"{want:.6f} (tolerance 2e-2 rel: bf16)", flush=True)
            check(abs(got - want) <= 2e-2 * abs(want),
                  f"{label}: loss differs from the default path's")
            launched[kind] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with selection(CAPE_MSDA_GATHER=impl):
            for i in range(3):
                _reset_counts()
                t0 = time.perf_counter()
                state, metrics = step(state, batch, gen)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                counts = _counts()
                m = {k: v.item() for k, v in metrics.items()}
                print(f"{label} micro-step {i + 1}: {ms:.3f} ms, total "
                      f"{m['total']:.6f}, grad_norm {m['grad_norm']:.6f}, "
                      f"launches {counts} ({card})", flush=True)
                check(all(np.isfinite(v) for v in m.values())
                      and m["grad_norm"] > 0,
                      f"{label} step: non-finite or zero metrics")
                if impl:
                    _check_counts(counts, f"the {label} micro-step",
                                  **{f"{kind}_fwd": per_step,
                                     f"{kind}_bwd": per_step})
                    launched[kind] += counts[f"{kind}_bwd"]
                else:
                    _check_counts(counts, "the default micro-step",
                                  quad_gather=per_step, quad_scatter=per_step)
        print(f"{label}: peak memory over these micro-steps "
              f"{torch.cuda.max_memory_allocated()} bytes", flush=True)
    return launched


def _grads(torch, model, cfg, batch):
    """The deterministic loss and every parameter's gradient, the latter
    copied to the CPU."""
    from cape_tpu_torch.train.train_step import forward_losses

    losses = forward_losses(model, cfg, batch)
    g = torch.autograd.grad(losses["total"], list(model.parameters()))
    return losses["total"].item(), [x.cpu() for x in g]


def _grad_ratios(torch, got, want):
    """Per tensor: max abs error over its tolerance, GRAD_RTOL of the
    tensor's own L2 norm plus GRAD_ATOL of the global norm (the floor for
    tensors whose gradient is near zero, where only noise is left)."""
    from cape_tpu_torch.train.state import global_norm

    norm = global_norm(want).item()
    return [(a - b).abs().max().item()
            / (GRAD_RTOL * torch.linalg.vector_norm(b).item()
               + GRAD_ATOL * norm) for a, b in zip(got, want)]


#: fp32 gradient tolerance, card against CPU (see phase_fp32_grads)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
#: elements of one update allowed to differ by more than 1e-2 lr, card
#: against CPU: 4 of 37,151,706 measured on an H100, with 25x headroom
UPDATE_FAR = 100


def phase_fp32_grads(torch, np):
    """fp32 gradients and one real update, card (kernels) against CPU
    (plain versions), same seeded weights and batch, TF32 off, at a config
    small enough for the CPU (ResNet-50 at 128 px, 2+2 layers, dropout
    0), on the default and the use_pallas_msda path and under
    CAPE_MSDA_GATHER=fused and fusedq. This is the check that the value
    path gets its gradient; a scatter that loses the contributions of
    duplicate indices must fail it."""
    from cape_tpu_torch import CAPE, CAPEConfig
    from cape_tpu_torch.ops import gather
    from cape_tpu_torch.train import create_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = CAPEConfig().replace(image_size=128, enc_layers=2, dec_layers=2,
                               dropout=0.0, bf16=False, batch_size=1,
                               accumulation_steps=1, warmup_epochs=0)
    spe = 10
    batch = _train_batch(np, cfg, np.random.default_rng(5))
    weights = CAPE(cfg, device="cpu",
                   generator=torch.Generator().manual_seed(5)).state_dict()
    models, cpu_grads = {}, {}
    sites = (cfg.enc_layers + cfg.dec_layers) * cfg.num_feature_levels
    for label, pallas, impl, kind in (
            ("default", False, None, None),
            ("use_pallas_msda", True, None, None),
            ("fused", False, "fused", "fused"),
            ("fusedq", False, "fusedq", "quadfused")):
        c = cfg.replace(use_pallas_msda=pallas)
        m_cpu = CAPE(c, device="cpu", generator=torch.Generator().manual_seed(6))
        m_gpu = CAPE(c, device="cuda", generator=torch.Generator().manual_seed(6))
        m_cpu.load_state_dict(weights)
        m_gpu.load_state_dict(weights)
        names = [n for n, _ in m_cpu.named_parameters()]
        with selection(CAPE_MSDA_GATHER=impl):
            l_cpu, g_cpu = _grads(torch, m_cpu, c, batch)
            _reset_counts()
            l_gpu, g_gpu = _grads(torch, m_gpu, c, batch)
        if kind:
            # the CPU run above counts nothing: these are the card's
            _check_counts(_counts(), f"the fp32 {label} gradient",
                          **{f"{kind}_fwd": sites, f"{kind}_bwd": sites})
        ratios = _grad_ratios(torch, g_gpu, g_cpu)
        order = sorted(range(len(names)), key=lambda i: -ratios[i])
        value = sum(g.abs().sum().item() for n, g in zip(names, g_gpu)
                    if "value_proj.weight" in n)
        print(f"fp32 card vs CPU [{label}]: loss {l_gpu:.7f} vs {l_cpu:.7f}; "
              f"gradient error over tolerance, largest: "
              f"{[(names[i], f'{ratios[i]:.3e}') for i in order[:4]]}; "
              f"value_proj gradient mass on the card {value:.6f} "
              f"(tolerance per tensor {GRAD_RTOL:g} of its own L2 norm + "
              f"{GRAD_ATOL:g} of the global norm: fp32 summation order of "
              f"convs and matmuls, TF32 off, and the backward kernels' "
              f"atomics)", flush=True)
        check(value > 0, f"no gradient reached value_proj on the card "
              f"({label})")
        check(abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu),
              f"fp32 loss differs ({label})")
        check(ratios[order[0]] <= 1.0,
              f"fp32 gradient of {names[order[0]]} ({label}): "
              f"{ratios[order[0]]:.3e} of its tolerance")
        models[label], cpu_grads[label] = (m_cpu, m_gpu), g_cpu

    # the same check against a faulty scatter: plain stores in place of
    # atomic adds, so of the rows that share an index one wins
    def lossy_scatter(dg, gi, n):
        B, N, C = dg.shape
        valid = (gi >= 0) & (gi < n)
        rows = (torch.arange(B, device=gi.device)[:, None] * n
                + gi.long())[valid]
        out = torch.zeros((B * n, C), dtype=torch.float32, device=dg.device)
        out.index_put_((rows,), dg[valid].float())
        return out.reshape(B, n, C).to(dg.dtype)

    scatter = gather.quad_scatter
    gather.quad_scatter = lossy_scatter
    try:
        _, g_bad = _grads(torch, models["default"][1], cfg, batch)
    finally:
        gather.quad_scatter = scatter
    bad = _grad_ratios(torch, g_bad, cpu_grads["default"])
    flagged = [n for n, r in zip(names, bad) if r > 1.0]
    value_bad = [r for n, r in zip(names, bad) if "value_proj.weight" in n]
    print(f"fp32 card vs CPU with a scatter that loses duplicates: "
          f"{len(flagged)} of {len(names)} tensors beyond tolerance, "
          f"value_proj.weight at {min(value_bad):.3e}..{max(value_bad):.3e} "
          f"of it", flush=True)
    check(min(value_bad) > 1.0,
          "the gradient check cannot see a scatter that loses duplicates")

    # one real update on each device (default path), compared in units of
    # the group lr
    after = {}
    for dev, m in zip(("cpu", "cuda"), models["default"]):
        st = create_train_state(cfg, m, spe)
        before = [t.detach().cpu().clone() for t in st.opt_state.masters]
        make_train_step(m, cfg, spe)(st, batch)
        after[dev] = [(a.detach().cpu() - b) for a, b in
                      zip(st.opt_state.masters, before)]
    lrs = st.tx.group_lrs(0)
    worst, n_far = 0.0, 0
    for label, d_gpu, d_cpu in zip(st.opt_state.labels, after["cuda"],
                                   after["cpu"]):
        if lrs[label] == 0.0:
            check(not d_gpu.any() and not d_cpu.any(), "a frozen leaf moved")
            continue
        diff = ((d_gpu - d_cpu) / lrs[label]).abs()
        worst = max(worst, diff.max().item())
        n_far += int((diff > 1e-2).sum())
    total = sum(d.numel() for d in after["cpu"])
    print(f"fp32 card vs CPU after one update: {n_far} of {total} elements "
          f"differ by more than 1e-2 lr, the largest by {worst:.3e} lr "
          f"(tolerance: at most {UPDATE_FAR} such elements. Adam's first "
          f"step is g/(|g|+eps): an element whose gradient is within fp32 "
          f"noise of zero can move by up to one lr either way)", flush=True)
    check(n_far <= UPDATE_FAR, "fp32 update differs between card and CPU")



def phase_fp32_checks(torch, np, model):
    """fp32: use_pallas encoder memory vs the default's on the card, the
    card (kernels) vs the CPU (plain versions) for one image, and the
    fused formulations vs the default path on the card."""
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

    # the fused formulations on the card against the default path on the
    # card: the encoder memory, and the first decode step with the unpacked
    # decode (its 6 layers x 4 levels go through the fused kernels too)
    sites = cfg32.enc_layers * cfg32.num_feature_levels
    for impl, name in (("fused", "fused_fwd"), ("fusedq", "quadfused_fwd")):
        with selection(CAPE_MSDA_GATHER=impl, CAPE_DECODE_PREQUAD="0"), \
                torch.inference_mode():
            _reset_counts()
            mem_f = m32.encode_image(x)
            out_f = autoregressive_decode(m32, one, sc, sm, se,
                                          force_length=1)
        _check_counts(_counts(), f"the fp32 {impl} check", **{
            name: 2 * sites + cfg32.dec_layers * cfg32.num_feature_levels})
        lf = out_f["pred_logits"][:, 0]
        print(f"fp32 {impl} vs default on the card: encoder memory max abs "
              f"err {(mem_f - mem).abs().max().item():.3e} (tolerance 1e-4 "
              f"abs + 1e-4 rel), first-step logits max abs err "
              f"{(lf.cpu() - lg).abs().max().item():.3e} (tolerance 1e-3 "
              f"abs + 1e-3 rel)", flush=True)
        torch.testing.assert_close(mem_f, mem, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(lf.cpu(), lg, atol=1e-3, rtol=1e-3)


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
    for name in ("CAPE_MSDA_GATHER", "CAPE_MSDA_TINY", "CAPE_DECODE_PREQUAD"):
        os.environ.pop(name, None)     # each phase sets what it selects
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
        model, default_counts, pallas_counts, fused_counts = phase_serving(
            torch, np, card)
        train_model, train_counts = phase_training(torch, np, card)
        phase_training_pallas(torch, np, train_model, card)
        fused_bwd_counts = phase_training_fused(torch, np, train_model, card)
        del train_model
        phase_fp32_checks(torch, np, model)
        phase_fp32_grads(torch, np)
        check("jax" not in sys.modules and not any(
            k == "cape_tpu" or k.startswith("cape_tpu.") for k in sys.modules),
            "the port loaded jax or the JAX package")
    except (Failed, AssertionError, RuntimeError, ValueError) as e:
        print(f"chip_smoke FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    # each kernel's launches from its own path's run: the serving requests
    # for the forward kernels, the training micro-steps for the backward
    launches = {"quad_gather": default_counts["quad_gather"],
                "msda_forward": pallas_counts["msda_forward"],
                "quad_scatter": train_counts["quad_scatter"],
                "fused_fwd": fused_counts["fused_fwd"],
                "quadfused_fwd": fused_counts["quadfused_fwd"],
                "fused_bwd": fused_bwd_counts["fused"],
                "quadfused_bwd": fused_bwd_counts["quadfused"]}
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
