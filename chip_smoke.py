#!/usr/bin/env python3
"""Drive the PyTorch port (`cape_tpu_torch`) on one CUDA card.

Run from the root of the repository: `python3 chip_smoke.py`. It needs one
card, builds the hand-written CUDA kernels from `cape_tpu_torch/ops/csrc`,
and exits non-zero at the first phase that fails:

1. card identity (`nvidia-smi` name and power limit), the versions of
   cv2 and PIL (or "absent") and the resize and decode routes the port
   takes;
2. each of the seven kernels against its plain PyTorch version on the
   card at the shapes of the serving and training paths (fp32 and bf16),
   with two times, its plain version's time, a library call's time where
   one computes the same function, and its bound. The two row kernels
   (`quad_gather`, `quad_scatter`) are checked and timed at all four
   levels of the encoder's and the decoder's shapes and at the decode
   step's, with uniform indices and with indices drawn as the model draws
   them; the whole-op `msda_forward` at the serving encoder, the training
   encoder and the teacher-forced decoder with uniform and model-like
   locations (and a profiler listing that one call is one kernel); the
   fused forwards at the encoder's four levels, the decoder's level 0 and
   the decode step; the two fused backwards at the encoder's four levels
   and the decoder's level 0, the same two index sets, with dw4 exactly 0
   at every corner outside the slab and a strided slab bit-equal to its
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
6. the evaluation path on the same weights: the port writes a synthetic
   MP-100 tree (10 categories of 12 PNGs, 8-17 keypoints) into a
   temporary directory; the port's own PNG reader and bilinear resize
   against the installed decoder and resize on its images; the val
   `MP100Dataset`, 12 fixed 1-shot episodes in 2 batches of 8 (4 padding
   rows) built with 1 and 4 loader threads (byte-equal);
   `evaluate_cape` over `prefetch(..., transform=to_device)` with the
   auto decode cap, twice (identical stats), then under `fused` with
   `CAPE_DECODE_PREQUAD=0`; launch counts against the decode steps, and
   the per-batch split of the wall (waiting for the batch, decode, host
   scoring) with episodes per second;
7. the training path at the flagship width: `make_train_step` takes 8
   micro-steps of 4 query images (2 real AdamW updates, dropout 0.1),
   48 gathers and 48 scatters each; the forward/backward/optimizer split;
   two micro-steps with `use_pallas_msda=True`; two each under `fused`
   and `fusedq` (48 forward and 48 backward launches of the fused
   kernels, no gather and no scatter);
8. the training entry point at the flagship width, in this process:
   `cli.train` with augmentation and a seeded torchvision `resnet_weights`
   on the sized eval's tree (2 epochs of 8 micro-steps, validation on 16
   fixed episodes), launch counts of the whole run; the loaded affines
   frozen, the convs moved; a second run resumed from `epoch_0` (the
   same episodes and rng states; the masters bit-exact or within a stated
   tolerance, with the op that gives other bits named); one epoch more
   under `fused`; `CAPEPredictor.from_checkpoint` against the model in
   memory and `cli.evaluate` against the loop's last validation; the
   update, epoch, validation, batch build and checkpoint times and the
   loop's peak memory;
9. the model variants at the flagship width (`phase_variants`; no lr
   warmup): v2, v3, v4, v41, v5, v6 and v1, each with
   `dec_attn_concat_src`, take 4 micro-steps (one real update; 48 gathers
   and 48 scatters each, 24 for v3, whose decoder has no MSDA), every
   trained parameter moves, and their decode raises the JAX package's
   ValueError; v2 and v3 take 2 micro-steps under `fused` (48/24 forward
   and backward launches, no gather); the legacy support encoder and
   `dec_qkv_proj=False` answer a request of 8 (enc + dec x steps gathers)
   and take 4 micro-steps; the fp32 loss and gradients of v2, v3, v41 and
   the legacy encoder on the card against fp64 on the CPU, at the reduced
   config of phase 10; a
   synthetic reference checkpoint (random tensors in the reference's key
   layout) through `cli.import_checkpoint` into
   `CAPEPredictor.from_checkpoint`, whose request of 8 gives the keypoints
   of the same import loaded in memory; ms per micro-step and per update,
   peak memory, and the phase's wall;
10. fp32 on the card (kernels) against the CPU (plain versions): the
   encoder memory of every MSDA path, the first decode step's logits, one
   eval batch of 4 episodes scored by `evaluate_cape` (decode logits,
   counts and every keypoint's normalised distance), and
   at a reduced config the loss and every parameter's gradient on the
   default, `use_pallas_msda`, `fused` and `fusedq` paths, a scatter that
   loses duplicate indices (which that check must reject), and one real
   update;
11. multi-process data parallelism (`phase_ddp`): two ranks as
   subprocesses of this script (`--ddp-rank`) on the one card, in an
   explicitly requested `gloo` group on CUDA tensors (a stand-in for two
   cards: nccl refuses two ranks on one device). They decode phase 6's
   12 episodes sharded (`evaluate_cape(multihost=True)`: the stats and
   the gathered decode outputs must be the single-process run's), take a
   flagship update of 4 micro-steps of 2 query images a rank (the
   flagship micro-step of 4 split in two; 48 gathers and 48 scatters a
   micro-step on each rank; the masters bit-equal across the ranks), and
   two fp32 micro-steps at phase 10's reduced config, whose reduced
   gradient and update are held against the single-process step on the
   same global batch with phase 10's tolerances; ms per micro-step and
   per all-reduce, and the eval's gather ms per batch. Then a one-rank
   nccl group through `parallel.maybe_initialize` in this process:
   all_reduce, all_gather, broadcast and barrier on the card.

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
the calls of a loop) and "above the L2" where it is not. The two row
kernels' entries also carry `library_device_ms` (the library call
captured and replayed the same way), and the kernels the evaluation path
runs `eval_launches` (its default run for `quad_gather`, its `fused` run
for `fused_fwd`), the kernels the training entry point runs
`train_loop_launches` (its auto run for `quad_gather` and `quad_scatter`,
its `fused` epoch for `fused_fwd` and `fused_bwd`), and every kernel
`variant_launches`, its launches in phase 9's runs (training steps and
requests; not its fp32 comparisons). The script prints its total wall
before the two JSON lines.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types
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
#: the forwards' timed cases, (label, slabs, (Hl, Wl, N)): the encoder's
#: four levels and the decode step at the serving batch (64 slabs), the
#: teacher-forced decoder at the training batch (32)
FWD_TIMED = tuple(
    [(f"encoder level {i}", 64, (64 >> i, 64 >> i, 21760)) for i in range(4)]
    + [("decoder level 0", 32, SAMPLE_CASES["decoder level 0"]),
       ("decode step level 0", 64, SAMPLE_CASES["decode step level 0"])])

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
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    gather_entry = _gather_kernel(torch, g, card)
    msda_entry = _msda_kernel(torch, g, card)
    scatter = _scatter_kernel(torch, g, card)
    fused = _fused_kernels(torch, g, card)
    return [gather_entry, msda_entry, scatter] + fused


def _model_locations(torch, g, shapes, B, H, P, refs):
    """Sampling locations (B, Lq, H, L, P, 2) as the model draws them:
    every query samples P points per head and level around its own
    reference point `refs` (B, Lq, 2, normalised), here with a seeded
    normal offset of 2 cells of the level."""
    dev = refs.device
    Lq, L = refs.shape[1], len(shapes)
    cells = torch.tensor([[w, h] for h, w in shapes], device=dev,
                         dtype=torch.float32)
    off = torch.randn(B, Lq, H, L, P, 2, generator=g, device=dev) * 2.0
    return refs[:, :, None, None, None, :] + off / cells[:, None, :]


def _model_indices(torch, g, shapes, B, H, P, refs, prequad=False):
    """Gather rows as the model draws them (`_model_locations`), turned
    into quad-row indices by the port's own
    `_quad_bases_and_weights`. Returns one `gi` (B*H, Lq*P) int32 per
    level, or with `prequad` the decode step's single `gi`
    (B*H, Lq*L*P) into the prepacked slab of all levels."""
    from cape_tpu_torch.ops.msda import (_quad_bases_and_weights,
                                         quad_level_offsets)

    dev = refs.device
    Lq, L = refs.shape[1], len(shapes)
    loc = _model_locations(torch, g, shapes, B, H, P, refs)
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


#: sites of the whole-op MSDA kernel at the flagship width, as (B, Lq):
#: the serving encoder (a request of 8 images) and the training encoder
#: (4 query images a micro-step), every cell of the 4 levels a query
#: (Lq = None), and the teacher-forced decoder (4 images, 200 tokens)
MSDA_CASES = {"serving encoder": (8, None), "training encoder": (4, None),
              "teacher-forced decoder": (4, 200)}


def _msda_inputs(torch, g, shapes, B, Lq, kind, dtype, H=8, Dh=32, P=4):
    """(value, loc, attn) of one MSDA site on the card: value (B, S, H, Dh)
    and the softmaxed attention weights in `dtype`; fp32 locations either
    uniform in [-1.5, 2.5] (about 15 of 16 corners outside their level)
    or drawn as the model draws them (`_model_locations`) around the
    site's reference points: the encoder's cell centres (Lq = None), the
    decoder's seeded points in [0, 1)."""
    dev = torch.device("cuda")
    S, L = sum(h * w for h, w in shapes), len(shapes)
    refs = _encoder_refs(torch, shapes, B, dev) if Lq is None \
        else torch.rand(B, Lq, 2, generator=g, device=dev)
    Lq = refs.shape[1]
    value = torch.randn(B, S, H, Dh, generator=g, device=dev).to(dtype)
    if kind == "uniform":
        loc = torch.rand(B, Lq, H, L, P, 2, generator=g, device=dev) * 4.0 \
            - 1.5
    else:
        loc = _model_locations(torch, g, shapes, B, H, P, refs)
    attn = torch.softmax(torch.randn(B, Lq, H, L * P, generator=g,
                                     device=dev), -1)
    return value, loc, attn.reshape(B, Lq, H, L, P).to(dtype)


def _msda_bound_ms(torch, value, shapes, loc, attn):
    """The least time of the op on these inputs, whatever computes it: the
    locations and attention weights read once, each distinct in-range
    value row the corners select (one head's Dh values of one cell) read
    once, the (B, Lq, H*Dh) output written once; against the fp32
    multiply-adds of the in-range corners."""
    from cape_tpu_torch.ops.msda_kernel import prepare_corners

    B, S, H, Dh = value.shape
    elt = value.element_size()
    idx, _, valid = prepare_corners(shapes, loc, attn)
    ok = valid > 0
    rows = (torch.arange(B * H, device=idx.device)[:, None, None] * S
            + idx)[ok]
    nbytes = (loc.numel() * 4 + attn.numel() * elt
              + torch.unique(rows).numel() * Dh * elt
              + B * loc.shape[1] * H * Dh * elt)
    flops = 2 * Dh * int(ok.sum().item())
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3


def _msda_kernel(torch, g, card):
    """msda_forward (csrc/msda.cu) against its plain version at the three
    sites of `MSDA_CASES`, uniform and model-like locations, fp32 and
    bf16; a profiler listing of one `ms_deform_attn_pallas` call on the
    card (one kernel, nothing else); then its times in bf16 at every site
    and location set, with the same-work bound. Returns the entry of the
    kernels line: the serving encoder with model-like locations."""
    from torch.profiler import ProfilerActivity, profile

    from cape_tpu_torch.models.cape import level_shapes
    from cape_tpu_torch.ops import msda_kernel as mk

    shapes = level_shapes(512, 4)
    # fp32: the same corners and weights as the plain version, bit for bit
    # (the kernel rounds its corner math as PyTorch does), summed in
    # another order; bf16: one rounding of those sums, one ulp apart where
    # a sum lands near a boundary
    tols = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-5, 2 ** -7)}
    err, times = 0.0, {}
    for site, (B, Lq) in MSDA_CASES.items():
        for kind in ("uniform", "model"):
            for dtype in tols:
                value, loc, attn = _msda_inputs(torch, g, shapes, B, Lq, kind,
                                                dtype)
                got = mk.msda_forward(value, shapes, loc, attn)
                want = mk.msda_forward_plain(value, shapes, loc, attn)
                torch.cuda.synchronize()
                check(got.dtype == dtype and got.shape == want.shape,
                      "msda_forward: wrong dtype or shape")
                e = (got.float() - want.float()).abs().max().item()
                atol, rtol = tols[dtype]
                print(f"msda_forward [{site}, {kind} locations, {dtype}]: "
                      f"max abs err {e:.3e} (tolerance {atol:g} abs + "
                      f"{rtol:g} rel)", flush=True)
                torch.testing.assert_close(got.float(), want.float(),
                                           atol=atol, rtol=rtol)
                err = max(err, e)
                del got, want
                if dtype != torch.bfloat16:
                    continue
                b_ms, o_ms = _msda_bound_ms(torch, value, shapes, loc, attn)
                args = (value, shapes, loc, attn)
                t = {"shape": f"value {tuple(value.shape)} bf16, loc "
                              f"{tuple(loc.shape)}",
                     "inputs": "L2-warm" if b_ms * 1e-3 * HBM_BYTES_PER_S
                     < L2_BYTES else "above the L2"}
                t["ms"], t["device_ms"] = both_ms(
                    torch, lambda: mk.msda_forward(*args))
                t["plain_ms"] = cuda_ms(
                    torch, lambda: mk.msda_forward_plain(*args), iters=5,
                    warmup=1)
                t["bytes_ms"], t["ops_ms"] = b_ms, o_ms
                t["bound_share"] = max(b_ms, o_ms) / t["device_ms"]
                times[site, kind] = t
                print(f"msda_forward [{site}, {kind} locations] "
                      f"{json.dumps(t)} ({card})", flush=True)
                del value, loc, attn, args

    # one site is one launch on the card: no corner preparation, no
    # transpose of the value or the output
    value, loc, attn = _msda_inputs(torch, g, shapes, 4, 200, "model",
                                    torch.bfloat16)
    n0 = mk.msda_forward.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        mk.ms_deform_attn_pallas(value, shapes, loc, attn)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    n = mk.msda_forward.launches - n0
    print(f"ms_deform_attn_pallas on the card: {n} msda_forward launch, "
          f"device events {names}", flush=True)
    check(n == 1 and len(names) == 1 and "msda_forward_kernel" in names[0],
          "ms_deform_attn_pallas is not one kernel launch on the card")
    t = times["serving encoder", "model"]
    return {"name": "msda_forward", "route": "cuda",
            "source": "cape_tpu_torch/ops/csrc/msda.cu",
            "replaces": "cape_tpu/ops/msda_pallas.py:48",
            "launches": 0, "max_abs_err": err, "ms": t["ms"],
            "device_ms": t["device_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": max(t["bytes_ms"], t["ops_ms"]),
            "bound_by": "bytes" if t["bytes_ms"] >= t["ops_ms"]
            else "operations", "library_ms": None}


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
            "library_ms": head["library_ms"],
            "library_device_ms": head["library_device_ms"]}


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
            "library_ms": head["library_ms"],
            "library_device_ms": head["library_device_ms"]}


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
                if not quad:
                    # the forward's plan at these shapes too: other lane
                    # widths (Dh = 16), rows a thread and ragged row counts
                    out = mf.fused_level_sample(slab, gi, w4, Wl)
                    same = mf.fused_level_sample(slab.contiguous(), gi, w4,
                                                 Wl)
                    want = mf.fused_level_sample_plain(slab, gi, w4, Wl)
                    torch.cuda.synchronize()
                    check(torch.equal(same, out),
                          "fused_fwd: a strided slab and its copy differ")
                    e = (out.float() - want.float()).abs().max().item()
                    atol, rtol = tols[dtype]
                    fplan = mf.sample_fwd_plan(BH, N, dh, slab.element_size())
                    print(f"fused out [{label}, {dtype}; plan "
                          f"{tuple(fplan)}]: max abs err {e:.3e} (tolerance "
                          f"{atol:g} abs + {rtol:g} rel)", flush=True)
                    torch.testing.assert_close(out.float(), want.float(),
                                               atol=atol, rtol=rtol)
                    errs[kind]["fwd", dtype] = max(errs[kind]["fwd", dtype],
                                                   e)
                    del out, same, want
                del slab, gi, w4, dout

    entries = []
    for quad in (False, True):
        kind = "quadfused" if quad else "fused"
        times = {"fwd": {}, "bwd": {}}
        # forwards in bf16 with the path's own index range: the serving
        # batch (64 slabs) for the encoder's four levels and the decode
        # step, the training batch (32) for the teacher-forced decoder
        for label, BH, (Hl, Wl, N) in FWD_TIMED:
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
            t = times["fwd"][label]
            t["bound_share"] = max(b_ms, o_ms) / t["device_ms"]
            if not quad:
                t["plan"] = tuple(mf.sample_fwd_plan(BH, N, Dh, 2))
            print(f"{kind}_fwd [{label}] {json.dumps(t)} ({card})",
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


# ----------------------------------------------------------------------
#: the eval phase's synthetic MP-100 tree: 10 categories of 12 images with
#: 8-17 keypoints, so the val split holds 2 categories and 24 images
EVAL_TREE = dict(num_categories=10, images_per_category=12,
                 keypoint_range=(8, 17))
EVAL_EPISODES = 12
#: the sized eval's tree: MP-100's 10 val categories (of 100: 70 train,
#: 10 val, 20 test in every fold) with 20 images each, at 480 x 640, the
#: commonest source size of MP-100's COCO-derived images; as few train and
#: test categories as the fixture allows, since the run reads none
EVAL_SIZED_TREE = dict(num_categories=22, num_holdout=20,
                       images_per_category=20, keypoint_range=(8, 17),
                       image_size=(480, 640))
#: the eval protocol's val episode count (`--num_episodes`: 100 val, 200
#: test)
EVAL_SIZED_EPISODES = 100


def _same_bytes(a, b):
    """Two nested batch dicts with the same keys, dtypes, shapes, bytes."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_bytes(a[k], b[k])
                                            for k in a)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


@contextlib.contextmanager
def _recorded_decode(torch, trained_length=False):
    """Record each decode `evaluate_cape` runs: its synchronised ms, its
    decode steps (the longest sample's length) and its outputs.

    `trained_length=True` runs every decode for the steps a trained model
    takes on the batch: its largest keypoint count + 1 (EOS), through
    `autoregressive_decode`'s `force_length` (random weights emit EOS at
    `min_decode_len`)."""
    from cape_tpu_torch.eval import evaluate
    from cape_tpu_torch.models.cape import autoregressive_decode

    orig, calls = evaluate.decode, []

    def decode(model, images, sc, sm, se, max_len=None):
        force = int((~torch.as_tensor(sm)).sum(1).max()) + 1 \
            if trained_length else None
        t0 = time.perf_counter()
        out = autoregressive_decode(model, images, sc, sm, se,
                                    force_length=force, max_len=max_len) \
            if trained_length else orig(model, images, sc, sm, se, max_len)
        if out["lengths"].is_cuda:
            torch.cuda.synchronize()
        calls.append({"ms": (time.perf_counter() - t0) * 1e3,
                      "steps": int(out["lengths"].max()), "out": out})
        return out

    evaluate.decode = decode
    try:
        yield calls
    finally:
        evaluate.decode = orig


def _timed(it, log):
    """Yield from `it`, logging (asked, got) host times of each item."""
    it = iter(it)
    while True:
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        log.append((t0, time.perf_counter()))
        yield item


class EvalSetup:
    """What an eval phase built: the flagship config on a synthetic tree,
    its fixed episodes and the auto decode cap."""

    def __init__(self, cfg, root, tree=EVAL_TREE, episodes=EVAL_EPISODES):
        from cape_tpu_torch.data.builder import resolve_split_file
        from cape_tpu_torch.data.episodic import EpisodicSampler
        from cape_tpu_torch.data.synthetic import make_synthetic_mp100

        paths = make_synthetic_mp100(root, **tree)
        self.cfg = cfg.replace(dataset_root=paths["root"],
                               category_split_file=paths["split_file"])
        ds = self.dataset()
        self.sampler = EpisodicSampler(
            ds, resolve_split_file(self.cfg), "val", num_queries=1,
            num_support=self.cfg.num_support_per_episode)
        self.fixed = self.sampler.fixed_episodes(episodes, 0)
        maxk = max((ds.coco.category_num_keypoints(c) or 0)
                   for c in self.sampler.categories)
        # the eval CLI's "auto" cap: coords + EOS + margin, a multiple of 8
        self.cap = min(self.cfg.seq_len, -(-(maxk + 2) // 8) * 8)
        self.n_images = len(ds)

    def dataset(self):
        """A fresh val dataset (cold caches)."""
        from cape_tpu_torch.data.builder import build_mp100_cape

        return build_mp100_cape("val", self.cfg)

    def batches(self, np, ds, n, batch, threads=1, cfg=None):
        """The first `n` fixed episodes in batches of `batch`, padded."""
        from cape_tpu_torch.data.episodic import episode_batches

        cfg = cfg or self.cfg
        return episode_batches(
            ds, self.sampler, batch, -(-n // batch), cfg.image_size,
            cfg.max_support_keypoints, cfg.max_skeleton_edges,
            np.random.default_rng(0), fixed=self.fixed[:n],
            num_threads=threads, total_episodes=n)


def _image_routes(np, ev):
    """The port's own PNG reader and bilinear resize, which run where cv2
    and PIL are missing, on the eval tree's images: the reader gives the
    installed decoder's bytes, the resize is within 1 level of the
    installed one."""
    from cape_tpu_torch.data import image

    ds = ev.dataset()
    worst = 0
    for img_id in ds.ids[:6]:
        path = os.path.join(ds.root, ds.coco.load_img(img_id)["file_name"])
        own, lib = image.read_png(path), image.decode_rgb(path)
        check(own.tobytes() == lib.tobytes(),
              f"the own PNG reader differs from {image.DECODE_ROUTE}: {path}")
        size = (ev.cfg.image_size, ev.cfg.image_size)
        diff = np.abs(image.resize_bilinear(own, size).astype(np.int16)
                      - image.resize(own, size).astype(np.int16))
        worst = max(worst, int(diff.max()))
    check(worst <= 1, f"the own bilinear resize is {worst} levels from "
          f"{image.RESIZE_ROUTE}")
    print(f"own image routes on 6 tree images: PNG reader equal to "
          f"{image.DECODE_ROUTE}, bilinear resize within {worst} level of "
          f"{image.RESIZE_ROUTE}", flush=True)


def _eval_run(torch, np, model, ev, n, eb, visible, label,
              trained_length=False, **env):
    """`evaluate_cape` over the real pipeline (a cold dataset, one loader
    thread, `prefetch` with `to_device`) on the first `n` fixed episodes
    in batches of `eb`, under the auto cap; checks the episode and visible
    keypoint counts and that every stat is finite. Returns the stats,
    launch counts, decode steps, each decode's outputs, and the wall and
    per-batch host times in ms (waiting for the batch, the synchronised
    decode, the host scoring after it)."""
    from cape_tpu_torch.data.prefetch import prefetch, to_device
    from cape_tpu_torch.eval import evaluate_cape

    log = []
    ds = ev.dataset()
    with selection(**env), _recorded_decode(torch, trained_length) as calls:
        _reset_counts()
        t0 = time.perf_counter()
        stats = evaluate_cape(
            model, _timed(prefetch(ev.batches(np, ds, n, eb),
                                   transform=to_device), log),
            ev.cfg, decode_max_len=ev.cap)
        t_end = time.perf_counter()
    counts = _counts()
    check(len(calls) == -(-n // eb), f"{label}: {len(calls)} decodes")
    check(stats["num_images"] == n,
          f"{label}: num_images {stats['num_images']}")
    check(stats["pck_num_visible"] == visible,
          f"{label}: {stats['pck_num_visible']} visible keypoints "
          f"scored, the batches hold {visible}")
    finite = [stats["pck"], stats["pck_mean_categories"],
              *stats["pck_per_category"].values()]
    check(all(np.isfinite(v) for v in finite) and 0 <= stats["pck"] <= 1,
          f"{label}: stats {stats}")
    ends = [asked for asked, _ in log[1:]] + [t_end]
    return types.SimpleNamespace(
        stats=stats, counts=counts, steps=[c["steps"] for c in calls],
        outs=[c["out"] for c in calls],
        wall=(t_end - t0) * 1e3,
        wait=[(got - asked) * 1e3 for asked, got in log],
        decode=[c["ms"] for c in calls],
        score=[(end - got) * 1e3 - c["ms"]
               for (_, got), end, c in zip(log, ends, calls)])


def _visible(np, batches):
    """Visible ground-truth keypoints of the real rows of `batches`."""
    return sum(int((b["gt_visibility"][i, :b["num_keypoints"][i]] > 0).sum())
               for b in batches for i in np.flatnonzero(b["sample_valid"]))


def phase_eval(torch, np, model, card, root):
    """The evaluation path at the flagship width on the serving phase's
    weights: a synthetic MP-100 tree on disk -> the val `MP100Dataset` ->
    12 fixed 1-shot episodes in 2 batches of 8 (4 padding rows) built with
    1 and with 4 threads -> `prefetch(..., transform=to_device)` ->
    `evaluate_cape` under the auto decode cap, twice, then once under
    `CAPE_MSDA_GATHER=fused` with `CAPE_DECODE_PREQUAD=0`; launch counts
    checked against the decode steps. A check at a toy size: its times are
    not the eval's (`phase_eval_sized` measures those)."""
    from cape_tpu_torch.data.episodic import eval_batch_plan

    t0 = time.perf_counter()
    ev = EvalSetup(model.cfg, root)
    cfg = ev.cfg
    print(f"eval tree: {ev.n_images} val images in "
          f"{len(ev.sampler.categories)} categories written and indexed in "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms; auto decode_max_len "
          f"{ev.cap} (seq_len {cfg.seq_len})", flush=True)
    check(ev.n_images == 24 and len(ev.sampler.categories) == 2,
          "the eval tree's val split changed")
    _image_routes(np, ev)
    eb, nb = eval_batch_plan(EVAL_EPISODES, cfg.eval_batch_size)
    check((eb, nb) == (8, 2), f"eval batch plan {(eb, nb)}")

    # the batches, cold, with 1 and with 4 loader threads: byte-equal
    build_ms, built = {}, {}
    for threads in (1, 4):
        ds = ev.dataset()
        t0 = time.perf_counter()
        built[threads] = list(ev.batches(np, ds, EVAL_EPISODES, eb, threads))
        build_ms[threads] = (time.perf_counter() - t0) * 1e3 / nb
    check(len(built[1]) == nb and all(
        _same_bytes(a, b) for a, b in zip(built[1], built[4])),
        "batches built with 4 threads differ from 1 thread's")
    valid = np.concatenate([b["sample_valid"] for b in built[1]])
    check(valid.sum() == EVAL_EPISODES and not valid[EVAL_EPISODES:].any(),
          f"padding rows: sample_valid {valid.tolist()}")
    S = cfg.image_size
    check(built[1][0]["query_images"].dtype == np.uint8 and
          built[1][0]["query_images"].shape == (eb, S, S, 3),
          f"eval batches are not uint8 ({eb}, {S}, {S}, 3)")
    visible = _visible(np, built[1])
    print(f"eval batches: {nb} x {eb} episodes, byte-equal with 1 and 4 "
          f"threads; build ms per batch (cold caches) 1 thread "
          f"{build_ms[1]:.3f}, 4 threads {build_ms[4]:.3f}; "
          f"{visible} visible GT keypoints", flush=True)

    L = cfg.num_feature_levels
    enc = cfg.enc_layers * L

    def run(label, **env):
        r = _eval_run(torch, np, model, ev, EVAL_EPISODES, eb, visible,
                      label, **env)
        print(f"{label}: PCK@0.2 {r.stats['pck']:.6f} "
              f"({r.stats['pck_num_correct']}/{r.stats['pck_num_visible']}), "
              f"mean over categories {r.stats['pck_mean_categories']:.6f}; "
              f"decode steps {r.steps}; launches {r.counts}; wall "
              f"{r.wall:.3f} ms, {EVAL_EPISODES / r.wall * 1e3:.3f} "
              f"episodes/s; per batch: waiting for the batch "
              f"{[round(t, 3) for t in r.wait]} ms, decode (synchronised) "
              f"{[round(t, 3) for t in r.decode]} ms, host scoring "
              f"{[round(t, 3) for t in r.score]} ms ({card})", flush=True)
        return r

    first = run("eval, default path")
    stats, counts, steps = first.stats, first.counts, first.steps
    _check_counts(counts, "the eval's default path",
                  quad_gather=sum(enc + cfg.dec_layers * s for s in steps))
    again = run("eval, default path again").stats
    check(again == stats, f"a second eval gave other stats: {again} "
          f"against {stats}")
    r = run("eval, CAPE_MSDA_GATHER=fused CAPE_DECODE_PREQUAD=0",
            CAPE_MSDA_GATHER="fused", CAPE_DECODE_PREQUAD="0")
    fused, fcounts, fsteps = r.stats, r.counts, r.steps
    _check_counts(fcounts, "the fused eval", fused_fwd=sum(
        enc + cfg.dec_layers * L * s for s in fsteps))
    print(f"eval PCK@0.2: default path {stats['pck']:.6f}, fused "
          f"{fused['pck']:.6f} ({card})", flush=True)
    return ev, first, counts, fcounts


def phase_eval_sized(torch, np, model, card, root):
    """The evaluation path at a measuring size, on the serving phase's
    weights: the eval protocol's 100 val episodes over MP-100's 10 val
    categories, from 480 x 640 source images, in 13 batches of 8 (4
    padding rows). The batches are built cold with 1 and with 4 loader
    threads (byte-equal); then `evaluate_cape` runs for the random
    weights' own decode length and for a trained model's (each batch's
    largest keypoint count + 1), launch counts checked. Prints the first
    batch apart from the rest, and each part's share of the wall."""
    from cape_tpu_torch.data.episodic import eval_batch_plan

    t0 = time.perf_counter()
    ev = EvalSetup(model.cfg, root, EVAL_SIZED_TREE, EVAL_SIZED_EPISODES)
    cfg, n = ev.cfg, EVAL_SIZED_EPISODES
    h, w = EVAL_SIZED_TREE["image_size"]
    print(f"sized eval tree: {ev.n_images} val images of {h} x {w} in "
          f"{len(ev.sampler.categories)} categories written and indexed in "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms; auto decode_max_len "
          f"{ev.cap}", flush=True)
    check(ev.n_images == 200 and len(ev.sampler.categories) == 10,
          "the sized eval tree's val split changed")
    eb, nb = eval_batch_plan(n, cfg.eval_batch_size)
    check((eb, nb) == (8, 13), f"sized eval batch plan {(eb, nb)}")

    build_ms, built = {}, {}
    for threads in (1, 4):
        ds = ev.dataset()
        t0 = time.perf_counter()
        built[threads] = list(ev.batches(np, ds, n, eb, threads))
        build_ms[threads] = (time.perf_counter() - t0) * 1e3 / nb
    check(len(built[1]) == nb and all(
        _same_bytes(a, b) for a, b in zip(built[1], built[4])),
        "sized eval batches built with 4 threads differ from 1 thread's")
    visible = _visible(np, built[1])
    trained = [int((~b["support_mask"]).sum(1).max()) + 1 for b in built[1]]
    del built
    print(f"sized eval batches: {nb} x {eb} episodes, byte-equal with 1 "
          f"and 4 threads; build ms per batch (cold dataset, 16 image "
          f"loads) 1 thread {build_ms[1]:.3f}, 4 threads "
          f"{build_ms[4]:.3f}; {visible} visible GT keypoints", flush=True)

    enc = cfg.enc_layers * cfg.num_feature_levels
    for label, forced in (("sized eval, random weights' decode length",
                           False),
                          ("sized eval, trained decode length", True)):
        r = _eval_run(torch, np, model, ev, n, eb, visible, label,
                      trained_length=forced)
        _check_counts(r.counts, label, quad_gather=sum(
            enc + cfg.dec_layers * s for s in r.steps))
        if forced:
            check(r.steps == trained, f"{label}: decode steps {r.steps}, "
                  f"a trained model's {trained}")
        share = {k: 100 * sum(getattr(r, k)) / r.wall
                 for k in ("wait", "decode", "score")}
        rest = r.decode[1:]
        print(f"{label}: decode steps {r.steps}; quad_gather launches "
              f"{r.counts['quad_gather']}; wall {r.wall:.3f} ms, "
              f"{n / r.wall * 1e3:.3f} episodes/s; first batch: waiting "
              f"{r.wait[0]:.3f}, decode {r.decode[0]:.3f}, scoring "
              f"{r.score[0]:.3f} ms; batches 2-{nb}: waiting "
              f"{sum(r.wait[1:]):.3f} in all (at most "
              f"{max(r.wait[1:]):.3f}), decode {np.mean(rest):.3f} a batch "
              f"({min(rest):.3f}-{max(rest):.3f}), "
              f"{sum(rest) / sum(r.steps[1:]):.3f} a decode step with "
              f"the batch's encoder spread over its steps, scoring "
              f"{np.mean(r.score[1:]):.3f} a batch; shares of the wall: "
              f"waiting {share['wait']:.2f}%, decode {share['decode']:.2f}%, "
              f"scoring {share['score']:.2f}% ({card})", flush=True)


#: the training entry point's run (`phase_train_loop`): `cli.train` at the
#: `CAPEConfig()` defaults on the sized eval's tree (2 train categories and
#: MP-100's 10 val categories of 20 images of 480 x 640): 16 episodes an
#: epoch are 8 micro-steps of 2 episodes x 2 queries, 2 real updates
TRAIN_LOOP_FLAGS = ["--epochs", "2", "--episodes_per_epoch", "16",
                    "--val_episodes_per_epoch", "16", "--eval_batch_size", "8",
                    "--fixed_val_episodes", "--num_data_threads", "4",
                    "--print_freq", "0"]

#: the largest master difference allowed between the straight run's
#: `epoch_1` and one resumed from its `epoch_0` under `auto`, where
#: `quad_scatter`'s fp32 sums run in another order each run: 3x the
#: largest gap measured (1.333e-05 over four runs, NVIDIA H100 80GB HBM3)
RESUME_AUTO_TOL = 4e-05


def _torchvision_resnet50(np, seed):
    """A seeded resnet50 state_dict under torchvision's key names (conv
    weights He-scaled, BN weight/bias/running statistics), shaped from the
    port's `ResNet50`, plus the `fc` head a real one carries."""
    import torch.nn as nn

    from cape_tpu_torch.models.backbone import FrozenAffine, ResNet50

    rng = np.random.default_rng(seed)
    sd = {}
    for name, m in ResNet50().named_modules():
        tv = name.replace("downsample_conv", "downsample.0").replace(
            "downsample_bn", "downsample.1")
        if isinstance(m, nn.Conv2d):
            shape = tuple(m.weight.shape)
            sd[f"{tv}.weight"] = (rng.normal(size=shape) * np.sqrt(
                2.0 / np.prod(shape[1:]))).astype(np.float32)
        elif isinstance(m, FrozenAffine):
            n = m.scale.numel()
            sd[f"{tv}.weight"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
            sd[f"{tv}.bias"] = rng.normal(0, 0.1, n).astype(np.float32)
            sd[f"{tv}.running_mean"] = rng.normal(0, 0.2, n).astype(np.float32)
            sd[f"{tv}.running_var"] = rng.uniform(0.3, 2, n).astype(np.float32)
    sd["fc.weight"] = rng.normal(size=(1000, 2048)).astype(np.float32)
    sd["fc.bias"] = np.zeros(1000, np.float32)
    return sd


def _loop_recorder(torch, loop):
    """A record of what `train.loop.train_loop` trains on, and the patch
    that fills it (`train.loop.instrumented`): each train batch's episodes
    (category ids and a digest of its query images, taken where the loop
    validates the batch) and each micro-step's synchronised ms and the
    device memory allocated before it."""
    import hashlib
    from unittest import mock

    rec = types.SimpleNamespace(episodes=[], ms=[], mem=[])

    def on_batch(b):
        rec.episodes.append((b["category_ids"].tolist(), hashlib.sha1(
            b["query_images"].tobytes()).hexdigest()))

    def on_step(step, state, batch, gen):
        torch.cuda.synchronize()
        rec.mem.append(torch.cuda.memory_allocated())
        t0 = time.perf_counter()
        out = step(state, batch, gen)
        torch.cuda.synchronize()
        rec.ms.append((time.perf_counter() - t0) * 1e3)
        return out

    return rec, mock.patch.multiple(loop, **loop.instrumented(on_batch,
                                                              on_step))


def _train_run(torch, flags):
    """`cli.train.main(flags)` in this process with its kernel launches,
    decodes and micro-steps recorded; returns them with the result, the
    wall and the peak device memory."""
    from cape_tpu_torch.cli import train as cli_train
    from cape_tpu_torch.train import loop

    rec, patched = _loop_recorder(torch, loop)
    with _recorded_decode(torch) as decodes, patched:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        res = cli_train.main(flags)
        wall = (time.perf_counter() - t0) * 1e3
        counts = _counts()
    rec.res, rec.wall, rec.counts = res, wall, counts
    rec.steps = [d["steps"] for d in decodes]
    rec.peak = torch.cuda.max_memory_allocated()
    return rec


def _master_diffs(ck, path_a, path_b):
    """Max abs difference of every fp32 master tensor between two
    checkpoints: (name -> difference, tensors that differ, the largest)."""
    sa, sb = (ck.load_state(p, "cuda")["params"] for p in (path_a, path_b))
    diffs = {n: (sa[n] - sb[n]).abs().max().item() for n in sa}
    return diffs, sum(d > 0 for d in diffs.values()), max(diffs,
                                                          key=diffs.get)


def _nondeterministic_ops(torch, model, cfg, batch):
    """Which ops of a micro-step's backward give other bits on a second
    run from identical inputs (one batch, dropout from one seed): the
    parameters whose gradients differ between two backward passes, those
    that still differ under `torch.use_deterministic_algorithms` (which
    also makes cuDNN pick deterministic algorithms; `quad_scatter` stays
    as it is, so the two counts move with its draws), the ops PyTorch
    flags as nondeterministic in that mode, and how many of the backward's
    own `quad_scatter` calls give other bits when rerun on their inputs."""
    from cape_tpu_torch.ops import gather
    from cape_tpu_torch.train.train_step import forward_losses

    params = dict(model.named_parameters())
    calls = []
    scatter = gather.quad_scatter

    def recorded_scatter(dg, gi, n):
        calls.append((dg.detach().clone(), gi.clone(), n))
        return scatter(dg, gi, n)

    recorded_scatter.launches = 0   # the wrapper counts on the module name

    def grads(record=False):
        gen = torch.Generator(device="cuda").manual_seed(0)
        gather.quad_scatter = recorded_scatter if record else scatter
        try:
            loss = forward_losses(model, cfg, batch, gen)["total"]
            return torch.autograd.grad(loss, list(params.values()),
                                       allow_unused=True)
        finally:
            gather.quad_scatter = scatter

    def differ(g1, g2):
        return [n for n, a, b in zip(params, g1, g2)
                if a is not None and not torch.equal(a, b)]

    plain = differ(grads(record=True), grads())
    scatter_differ = sum(not torch.equal(scatter(dg, gi, n),
                                         scatter(dg, gi, n))
                         for dg, gi, n in calls)
    n_scatter = len(calls)
    del calls
    flagged = set()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            det = differ(grads(), grads())
        finally:
            torch.use_deterministic_algorithms(False)
    for w in caught:
        msg = str(w.message)
        if "does not have a deterministic implementation" in msg:
            flagged.add(msg.split(" does not have")[0])
        elif "CuBLAS" in msg:
            flagged.add("cuBLAS (CUBLAS_WORKSPACE_CONFIG unset)")
    return types.SimpleNamespace(differ=plain, det_differ=det,
                                 flagged=sorted(flagged),
                                 scatter_differ=scatter_differ,
                                 n_scatter=n_scatter)


def phase_train_loop(torch, np, card, root):
    """The training entry point at the flagship width, in this process:
    `cli.train` with augmentation and seeded `resnet_weights` on the sized
    eval's tree (2 epochs of 8 micro-steps, validation on 16 fixed
    episodes) and a second run resumed from its `epoch_0`; the same pair
    under `CAPE_MSDA_GATHER=fused`; `CAPEPredictor.from_checkpoint` and
    `cli.evaluate` on what the first run wrote. Checks the launches of
    every run, the frozen and loaded backbone affines, the resumes, and
    that the predictor and the evaluate CLI agree with the loop. Prints
    the update, epoch, validation and batch build times, the checkpoint's
    bytes and save and restore times, and the loop's peak memory."""
    from cape_tpu_torch import CAPEConfig, CAPEPredictor
    from cape_tpu_torch.cli import evaluate as cli_evaluate
    from cape_tpu_torch.data.builder import build_mp100_cape
    from cape_tpu_torch.data.episodic import EpisodicSampler, episode_batches
    from cape_tpu_torch.models.backbone import resnet50_state_from_torchvision
    from cape_tpu_torch.utils import checkpoint as ck

    t_phase = time.perf_counter()
    split_file = os.path.join(root, "category_splits.json")
    npz = os.path.join(root, "resnet50_seed0.npz")
    tv = _torchvision_resnet50(np, 0)
    np.savez(npz, **tv)
    out = {n: os.path.join(root, f"loop_{n}")
           for n in ("auto", "auto_resumed", "fused", "fused_resumed")}
    common = ["--dataset_root", root, "--category_split_file", split_file,
              "--resnet_weights", npz, *TRAIN_LOOP_FLAGS]

    def resumed(straight, run, label):
        """`run`, resumed from `straight`'s epoch_0, trained its epoch 1 on
        the same episodes to the same rng states; the masters' differences
        of the two epoch_1 checkpoints."""
        check([h["epoch"] for h in run.res["history"]] == [1],
              f"{label}: resumed epochs")
        check(run.episodes == straight.episodes[micro:],
              f"{label}: the resumed run trained on other episodes")
        ends = [os.path.join(out[n], "epoch_1")
                for n in (label, f"{label}_resumed")]
        ma, mb = (ck.read_meta(p) for p in ends)
        check(ma["rng_state"] == mb["rng_state"]
              and ma["torch_rng_state"] == mb["torch_rng_state"],
              f"{label}: rng states differ after the resumed epoch")
        return _master_diffs(ck, *ends)

    # -- the straight run: 2 epochs
    a = _train_run(torch, common + ["--output_dir", out["auto"]])
    state = a.res["state"]
    model, cfg = state.model, state.model.cfg
    check(cfg.replace(**{k: getattr(CAPEConfig(), k) for k in (
        "epochs", "episodes_per_epoch", "val_episodes_per_epoch",
        "num_data_threads", "resnet_weights", "dataset_root",
        "category_split_file", "output_dir")}) == CAPEConfig(),
        "the train CLI's config is not the flagship's")
    micro = cfg.episodes_per_epoch // cfg.batch_size
    n_epochs, k = cfg.epochs, cfg.accumulation_steps
    check(len(a.ms) == n_epochs * micro and state.step == n_epochs * micro
          and state.opt_state.gradient_step == n_epochs * micro // k,
          f"{len(a.ms)} micro-steps recorded, state step {state.step}")
    check(sorted(n for n in os.listdir(out["auto"]) if n.startswith("epoch_"))
          == [f"epoch_{e}" for e in range(n_epochs)],
          f"checkpoints written: {sorted(os.listdir(out['auto']))}")
    hist = a.res["history"]
    check(len(hist) == n_epochs and all(
        np.isfinite(h["train_loss"]) for h in hist), f"history {hist}")
    n_val = -(-cfg.val_episodes_per_epoch // cfg.eval_batch_size)
    check(len(a.steps) == n_epochs * n_val, f"{len(a.steps)} decodes")
    L = cfg.num_feature_levels
    per_micro = (cfg.enc_layers + cfg.dec_layers) * L
    enc = cfg.enc_layers * L
    val_gathers = sum(enc + cfg.dec_layers * s for s in a.steps) \
        + len(a.steps) * per_micro
    _check_counts(a.counts, "the training run (auto)",
                  quad_gather=n_epochs * micro * per_micro + val_gathers,
                  quad_scatter=n_epochs * micro * per_micro)

    # the backbone: the folded npz values are the affines' masters and did
    # not move (frozen); a conv weight moved; the bf16 model holds the cast
    st = state.opt_state
    masters = dict(zip(st.names, st.masters))
    labels = dict(zip(st.names, st.labels))
    params = dict(model.named_parameters())
    folded = resnet50_state_from_torchvision(model.backbone, tv)
    affine = [n for n in folded if n.endswith((".scale", ".bias"))]
    check(affine and all(labels[f"backbone.{n}"] == "frozen" for n in affine)
          and all(torch.equal(masters[f"backbone.{n}"].cpu(), folded[n])
                  for n in affine),
          "backbone affines are not the folded weights, or moved")
    convs = [n for n in folded if n.endswith("conv2.weight")]
    moved = sum(not torch.equal(masters[f"backbone.{n}"].cpu(), folded[n])
                for n in convs)
    check(moved == len(convs), f"{moved} of {len(convs)} conv2 weights moved")
    check(all(torch.equal(params[n], masters[n].to(params[n].dtype))
              for n in st.names), "model weights are not the masters, cast")

    updates = [sum(a.ms[i:i + k]) for i in range(0, len(a.ms), k)]
    print(f"train loop (cli.train, flagship, augmentation, resnet_weights): "
          f"{len(a.ms)} micro-steps, ms each (synchronised) "
          f"{[round(t, 3) for t in a.ms]}; ms per real update "
          f"{[round(t, 3) for t in updates]}; epochs: train wall "
          f"{[round(h['train_s'] * 1e3, 3) for h in hist]} ms, validation "
          f"wall {[round(h['val_s'] * 1e3, 3) for h in hist]} ms; run wall "
          f"{a.wall:.3f} ms; decode steps {a.steps}; launches {a.counts}; "
          f"val PCK {[h['pck'] for h in hist]} "
          f"({hist[-1]['pck_num_correct']}/{hist[-1]['pck_num_visible']}); "
          f"device memory before each micro-step {a.mem[::micro]} bytes "
          f"(epoch starts); peak {a.peak} bytes ({card})", flush=True)

    # -- augmented batch builds, cold, 1 and 4 loader threads: byte-equal
    built, build_ms = {}, {}
    for threads in (1, 4):
        ds = build_mp100_cape("train", cfg)
        sampler = EpisodicSampler(ds, split_file, "train",
                                  num_queries=cfg.num_queries_per_episode)
        t0 = time.perf_counter()
        built[threads] = list(episode_batches(
            ds, sampler, cfg.batch_size, 4, cfg.image_size,
            cfg.max_support_keypoints, cfg.max_skeleton_edges,
            np.random.default_rng(5), num_threads=threads))
        build_ms[threads] = (time.perf_counter() - t0) * 1e3 / 4
    check(all(_same_bytes(x, y) for x, y in zip(built[1], built[4])),
          "augmented batches of 4 threads differ from 1 thread's")
    del built
    print(f"augmented train batches ({cfg.batch_size} episodes x "
          f"{cfg.num_queries_per_episode + 1} images of 480 x 640, cold "
          f"dataset): build ms per batch 1 thread {build_ms[1]:.3f}, 4 "
          f"threads {build_ms[4]:.3f} ({card})", flush=True)

    # -- resume from epoch_0 into another directory: epoch 1 again. Under
    # auto `quad_scatter`'s fp32 sums run in another order each run, so
    # the masters are held to RESUME_AUTO_TOL and the op is named
    b = _train_run(torch, common + ["--output_dir", out["auto_resumed"],
                                    "--resume",
                                    os.path.join(out["auto"], "epoch_0")])
    diffs, n_diff, worst = resumed(a, b, "auto")
    if n_diff == 0:
        print(f"resume (auto): bit-exact on the card (episodes, both rng "
              f"states and all {len(diffs)} master tensors)", flush=True)
    else:
        nd = _nondeterministic_ops(
            torch, b.res["state"].model, cfg,
            _train_batch(np, cfg, np.random.default_rng(3)))
        ops = nd.flagged + ([f"quad_scatter ({nd.scatter_differ} of "
                             f"{nd.n_scatter} calls)"]
                            if nd.scatter_differ else [])
        print(f"resume (auto): not bit-exact on the card: {n_diff} of "
              f"{len(diffs)} master tensors differ, the most {worst} by "
              f"{diffs[worst]:.3e} (tolerance {RESUME_AUTO_TOL:.3e}). A "
              f"backward twice from identical inputs differs in "
              f"{len(nd.differ)} of {len(diffs)} gradients (first: "
              f"{nd.differ[:4]}), under torch.use_deterministic_algorithms "
              f"in {len(nd.det_differ)} ({nd.det_differ[:4]}); ops giving "
              f"other bits run to run: {ops}", flush=True)
        check(diffs[worst] <= RESUME_AUTO_TOL,
              "resumed masters beyond the tolerance")
        check(ops, "the resume differs, yet no op was found that gives "
              "other bits run to run")
    del b

    # -- the same straight run and resume under `fused`, whose backwards
    # write the same bits every run: the resumed masters must be bit-equal
    with selection(CAPE_MSDA_GATHER="fused", CAPE_DECODE_PREQUAD="0"):
        f = _train_run(torch, common + ["--output_dir", out["fused"]])
        del f.res["state"]
        fr = _train_run(torch, common + [
            "--output_dir", out["fused_resumed"], "--resume",
            os.path.join(out["fused"], "epoch_0")])
        del fr.res["state"]
    for run, epochs, label in ((f, n_epochs, "fused"),
                               (fr, 1, "fused, resumed")):
        fwd = sum(enc + cfg.dec_layers * L * s for s in run.steps) \
            + len(run.steps) * per_micro
        _check_counts(run.counts, f"the training run ({label})",
                      fused_fwd=epochs * micro * per_micro + fwd,
                      fused_bwd=epochs * micro * per_micro)
    fdiffs, f_diff, fworst = resumed(f, fr, "fused")
    print(f"fused: {len(f.ms)} micro-steps, ms each "
          f"{[round(t, 3) for t in f.ms]}; decode steps {f.steps}; launches "
          f"{f.counts}; peak {f.peak} bytes; resumed from epoch_0: "
          + ("bit-exact (episodes, both rng states and all "
             f"{len(fdiffs)} master tensors)" if f_diff == 0 else
             f"{f_diff} master tensors differ, the most {fworst} by "
             f"{fdiffs[fworst]:.3e}") + f" ({card})", flush=True)
    check(f_diff == 0, "under fused the resumed masters are not bit-equal "
          "to the straight run's")

    # -- from_checkpoint and the evaluate CLI on the straight run's epoch_1
    last = os.path.join(out["auto"], f"epoch_{n_epochs - 1}")
    imgs, boxes = _requests(np, 1, 8)[0]
    proto = np.asarray(PROTO_17, np.float32)
    mem = CAPEPredictor(cfg, model).predict(imgs, proto, SKELETON_17,
                                            bboxes=boxes)
    loaded = CAPEPredictor.from_checkpoint(last)
    got = loaded.predict(imgs, proto, SKELETON_17, bboxes=boxes)
    _check_results(np, got, 8, 17)
    check(all(np.array_equal(x["keypoints"], y["keypoints"])
              and x["length"] == y["length"] for x, y in zip(got, mem)),
          "from_checkpoint predicts other keypoints than the model in memory")
    del loaded
    stats = cli_evaluate.main([
        "--checkpoint", last, "--split", "val", "--num_episodes",
        str(cfg.val_episodes_per_epoch), "--seed", str(cfg.val_seed),
        "--eval_batch_size", str(cfg.eval_batch_size),
        "--output_dir", os.path.join(root, "metrics")])
    check((stats["pck_num_correct"], stats["pck_num_visible"]) == (
        hist[-1]["pck_num_correct"], hist[-1]["pck_num_visible"]),
        f"cli.evaluate scored {stats['pck_num_correct']}/"
        f"{stats['pck_num_visible']}, the loop's last validation "
        f"{hist[-1]['pck_num_correct']}/{hist[-1]['pck_num_visible']}")
    print(f"from_checkpoint: 8 keypoint sets equal to the in-memory "
          f"model's; cli.evaluate on {last.rsplit(os.sep, 1)[-1]}: "
          f"{stats['pck_num_correct']}/{stats['pck_num_visible']}, the "
          f"loop's last validation's", flush=True)

    # -- a checkpoint's bytes, save and restore, on the straight run's state
    mgr = ck.CheckpointManager(os.path.join(root, "timed"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save_epoch(state, 0, cfg, 0.0, 0)
    save_ms = (time.perf_counter() - t0) * 1e3
    nbytes = os.path.getsize(os.path.join(mgr.latest(), ck.STATE_FILE))
    t0 = time.perf_counter()
    mgr.restore(mgr.latest(), state)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    print(f"checkpoint: {nbytes} bytes (state.pt: fp32 masters, mu, nu, "
          f"acc_grads of {sum(m.numel() for m in st.masters)} parameters); "
          f"save {save_ms:.3f} ms, restore {restore_ms:.3f} ms ({card})",
          flush=True)
    launches = {"quad_gather": a.counts["quad_gather"],
                "quad_scatter": a.counts["quad_scatter"],
                "fused_fwd": f.counts["fused_fwd"],
                "fused_bwd": f.counts["fused_bwd"]}
    del state, model, a
    print(f"phase_train_loop wall {(time.perf_counter() - t_phase):.3f} s",
          flush=True)
    return launches


def _eval_fp32(torch, np, m32, m_cpu, ev):
    """fp32: one batch of 4 fixed episodes scored by `evaluate_cape` on the
    card (kernels) and on the CPU (plain versions), under the auto cap."""
    from cape_tpu_torch.data.prefetch import to_device
    from cape_tpu_torch.eval import evaluate_cape
    from cape_tpu_torch.eval.evaluate import (extract_gt_keypoints,
                                              extract_pred_keypoints)
    from cape_tpu_torch.eval.pck import normalized_distances

    cfg = m32.cfg.replace(dataset_root=ev.cfg.dataset_root,
                          category_split_file=ev.cfg.category_split_file)
    batch = next(ev.batches(np, ev.dataset(), 4, 4, cfg=cfg))
    out, stats = {}, {}
    for name, model, b in (("card", m32, to_device(batch)),
                           ("cpu", m_cpu, batch)):
        with _recorded_decode(torch) as calls:
            stats[name] = evaluate_cape(model, [b], cfg,
                                        decode_max_len=ev.cap)
        out[name] = {k: v.cpu().numpy() for k, v in calls[0]["out"].items()}
    lg, lc = out["card"]["pred_logits"], out["cpu"]["pred_logits"]
    err = float(np.abs(lg - lc).max())
    print(f"fp32 eval, card vs CPU (4 episodes, decode steps "
          f"{int(out['card']['lengths'].max())} / "
          f"{int(out['cpu']['lengths'].max())}): decode logits max abs err "
          f"{err:.3e} (tolerance 1e-3 abs + 1e-3 rel); PCK "
          f"{stats['card']['pck_num_correct']}/"
          f"{stats['card']['pck_num_visible']} on the card, "
          f"{stats['cpu']['pck_num_correct']}/"
          f"{stats['cpu']['pck_num_visible']} on the CPU", flush=True)
    torch.testing.assert_close(torch.as_tensor(lg), torch.as_tensor(lc),
                               atol=1e-3, rtol=1e-3)
    check(stats["card"]["pck_num_visible"] == stats["cpu"]["pck_num_visible"],
          "fp32 eval: visible keypoints differ")

    def scored(o):
        """Normalised distance of every visible keypoint of a real row, as
        `evaluate_cape` scores it."""
        n = batch["num_keypoints"]
        active = np.arange(o["pred_logits"].shape[1])[None] \
            < o["lengths"][:, None]
        preds = extract_pred_keypoints(o["pred_logits"], o["pred_coords"],
                                       active, n)
        gts = extract_gt_keypoints(batch["targets"], n)
        d = {}
        for i in np.flatnonzero(batch["sample_valid"]):
            bw, bh = batch["bbox_dims"][i]
            dist = normalized_distances(preds[i] * cfg.image_size,
                                        gts[i] * cfg.image_size,
                                        float(bw), float(bh))
            for k in np.flatnonzero(batch["gt_visibility"][i, :n[i]] > 0):
                d[int(i), int(k)] = float(dist[k])
        return d

    dc, dp = scored(out["card"]), scored(out["cpu"])
    check(dc.keys() == dp.keys(), "fp32 eval: other keypoints scored")
    print(f"fp32 eval: normalised distances of the {len(dc)} scored "
          f"keypoints differ between card and CPU by at most "
          f"{max(abs(dc[k] - dp[k]) for k in dc):.3e}; the nearest to the "
          f"threshold 0.2 lies {min(abs(d - 0.2) for d in dc.values()):.3e} "
          f"from it", flush=True)
    if stats["card"]["pck_num_correct"] != stats["cpu"]["pck_num_correct"]:
        for key in dc:
            if (dc[key] < 0.2) != (dp[key] < 0.2):
                print(f"  keypoint {key}: normalised distance {dc[key]:.6f} "
                      f"on the card, {dp[key]:.6f} on the CPU", flush=True)
                check(abs(dc[key] - 0.2) < 1e-3 and abs(dp[key] - 0.2) < 1e-3,
                      f"fp32 eval: keypoint {key} scored differently away "
                      "from the threshold")


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


def _grads(torch, model, cfg, batch, allow_unused=False):
    """The deterministic loss and every parameter's gradient, the latter
    copied to the CPU. A parameter the loss does not reach raises, or
    with `allow_unused` gets None."""
    from cape_tpu_torch.train.train_step import forward_losses

    losses = forward_losses(model, cfg, batch)
    g = torch.autograd.grad(losses["total"], list(model.parameters()),
                            allow_unused=allow_unused)
    return losses["total"].item(), [None if x is None else x.cpu()
                                    for x in g]


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
    fused formulations vs the default path on the card. Returns the fp32
    models on the card and on the CPU (same weights)."""
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
    return m32, m_cpu


# ----------------------------------------------------------------------
#: the teacher-forced-only configs of phase_variants: v2-v6 (all with
#: dec_attn_concat_src, the prefix of v4/v41/v5/v6) and v1 with it
VARIANT_TRAIN = {
    "v2": {"dec_layer_type": "v2"},
    "v3": {"dec_layer_type": "v3"},
    "v4": {"dec_layer_type": "v4"},
    "v41": {"dec_layer_type": "v41"},
    "v5": {"dec_layer_type": "v5"},
    "v6": {"dec_layer_type": "v6"},
    "v1": {"dec_layer_type": "v1"},
}
#: the options that also serve
VARIANT_SERVE = {"legacy_encoder": {"use_geometric_encoder": False},
                 "no_qkv_proj": {"dec_qkv_proj": False}}


def _variant_steps(torch, np, cfg, label, card, n_steps, counts_per_step,
                   impl=None):
    """`n_steps` micro-steps of `make_train_step` on a fresh flagship model
    of `cfg` (4 query images each, dropout 0.1): finite losses, the launch
    counts of every micro-step, and after a real update every trained
    parameter's fp32 master moved; only v2-v6 leave parameters without a
    gradient, the support encoder's. Returns (model, summed counts)."""
    from cape_tpu_torch import CAPE
    from cape_tpu_torch.train import create_train_state, make_train_step

    spe = cfg.episodes_per_epoch // cfg.batch_size
    model = CAPE(cfg, device="cuda", generator=torch.Generator().manual_seed(9))
    # the init zeroes the residual branches' last BN scales, the heads' last
    # layers and the MSDA offset and weight projections, which leaves the
    # branches, the heads' hidden layers and level_embed without a gradient
    # on a first update: seeded noise of 0.02 gives every parameter one
    g = torch.Generator().manual_seed(10)
    with torch.no_grad():
        for p in model.parameters():
            p.add_((0.02 * torch.randn(p.shape, generator=g)).to(p))
    state = create_train_state(cfg, model, spe)
    step = make_train_step(model, cfg, spe)
    rng = np.random.default_rng(9)
    gen = torch.Generator(device="cuda").manual_seed(9)
    before = [m.clone() for m in state.opt_state.masters]
    grad_seen = [False] * len(before)
    total = dict.fromkeys(_counts(), 0)
    times = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with selection(CAPE_MSDA_GATHER=impl):
        for i in range(n_steps):
            batch = _train_batch(np, cfg, rng)
            _reset_counts()
            t0 = time.perf_counter()
            state, metrics = step(state, batch, gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            counts = _counts()
            for k, v in counts.items():
                total[k] += v
            m = {k: v.item() for k, v in metrics.items()}
            check(all(np.isfinite(v) for v in m.values()),
                  f"{label}: non-finite metrics {m}")
            _check_counts(counts, f"{label} micro-step {i + 1}",
                          **counts_per_step)
            grad_seen = [s or bool(a.any()) for s, a in
                         zip(grad_seen, state.opt_state.acc_grads)]
    peak = torch.cuda.max_memory_allocated()
    lrs = state.tx.group_lrs(0)
    trained = [i for i, lab in enumerate(state.opt_state.labels)
               if lrs[lab] > 0]
    if n_steps >= cfg.accumulation_steps:
        check(state.opt_state.gradient_step >= 1, f"{label}: no update")
        still = [state.opt_state.names[i] for i in trained if grad_seen[i]
                 and torch.equal(before[i], state.opt_state.masters[i])]
        unused = [state.opt_state.names[i] for i in trained
                  if not grad_seen[i]]
        check(not still, f"{label}: trained parameters did not move: "
              f"{still[:5]}")
        variant = cfg.dec_layer_type != "v1"
        check(all(n.startswith("support_encoder.") for n in unused)
              and bool(unused) == variant,
              f"{label}: parameters without a gradient: {unused[:5]}")
        print(f"  {label}: {len(trained) - len(unused)} of "
              f"{len(state.opt_state.names)} master tensors trained and "
              f"moved; {len(unused)} without a gradient (unused by the "
              f"variant)", flush=True)
    updates = times[cfg.accumulation_steps - 1::cfg.accumulation_steps]
    print(f"  {label}: ms per micro-step {[round(t, 3) for t in times]}, "
          f"of which ending an update {[round(t, 3) for t in updates]}; "
          f"ms per update {round(sum(times[:cfg.accumulation_steps]), 3)}"
          f"{'' if n_steps >= cfg.accumulation_steps else ' (no update)'};"
          f" peak memory {peak} bytes; launches {total} ({card})",
          flush=True)
    return model, total


def _check_decode_refused(torch, np, model, label):
    """The decode of a teacher-forced-only model raises the JAX package's
    ValueError (`cape_tpu/models/decoder.py:432-447`)."""
    from cape_tpu_torch.models.cape import autoregressive_decode

    cfg = model.cfg
    K = cfg.max_support_keypoints
    sc = np.zeros((1, K, 2), np.float32)
    sc[0, :17] = PROTO_17
    sm = np.ones((1, K), bool)
    sm[0, :17] = False
    se = np.full((1, cfg.max_skeleton_edges, 2), -1, np.int32)
    img = np.zeros((1, cfg.image_size, cfg.image_size, 3), np.uint8)
    try:
        autoregressive_decode(model, img, sc, sm, se)
    except ValueError as e:
        msg = str(e)
        check("layer_type='v1'" in msg or "attn_concat_src" in msg,
              f"{label}: the decode raised another ValueError: {msg}")
        return msg
    raise Failed(f"{label}: the decode of a teacher-forced-only model ran")


def _reference_layout(torch, np, model, seed):
    """A reference (PyTorch) CAPE checkpoint's state dict for `model`'s
    config, random tensors from `seed` in the reference's key layout
    (`CAPEModel.state_dict()`: torchvision backbone names with BN
    statistics, nn.MultiheadAttention's packed in_proj, GCN Conv1d, the
    heads aliased under the decoder, the reference's unused support
    tensors). Returns (reference dict, the port tensors each non-backbone
    reference tensor should import as)."""
    import re

    rng = np.random.default_rng(seed)

    def rand(shape, key):
        if key.endswith(".bias"):
            v = 0.1 * rng.normal(size=shape)
        elif len(shape) == 1:                       # norm scales
            v = 1.0 + 0.1 * rng.normal(size=shape)
        elif key in ("level_embed", "decoder.query_embed"):
            v = rng.normal(size=shape)
        elif key.endswith(("token_embed.weight", "edge_embedding.weight")):
            v = rng.normal(size=shape) * shape[-1] ** -0.5
        else:                                       # fan-in scaled
            v = rng.normal(size=shape) * np.prod(shape[1:]) ** -0.5
        return v.astype(np.float32)

    port = {k: rand(tuple(v.shape), k) for k, v in model.state_dict().items()
            if not k.startswith("backbone.")}
    tr, dec = "base_model.transformer", "base_model.transformer.decoder"
    rules = (
        (r"^input_projs\.(\d)\.", r"base_model.input_proj.\1."),
        (r"^level_embed$", f"{tr}.level_embed"),
        (r"^encoder\.", f"{tr}.encoder."),
        (r"^decoder\.query_embed$", "base_model.query_embed.weight"),
        (r"^decoder\.class_heads\.", "base_model.class_embed."),
        (r"^decoder\.coords_heads\.", "base_model.coords_embed."),
        (r"^decoder\.", f"{dec}."),
        (r"^support_encoder\.coord_mlp_0\.", "support_encoder.coord_mlp.0."),
        (r"^support_encoder\.coord_mlp_1\.", "support_encoder.coord_mlp.2."),
        (r"^support_encoder\.gcn\.(\d+)\.linear\.",
         r"support_encoder.gcn_layers.\1.conv."),
        (r"^support_encoder\.layers\.",
         "support_encoder.transformer_encoder.layers."),
    )
    ref = {}
    for key, v in port.items():
        for pat, rep in rules:
            new, n = re.subn(pat, rep, key)
            if n:
                break
        m = re.match(r"(.*)\.(q|k|v)_proj\.(weight|bias)$", new)
        if m and ("self_attn" in new or "support_attn" in new):
            packed = f"{m.group(1)}.in_proj_{m.group(3)}"
            parts = ref.setdefault(packed, {})
            parts[m.group(2)] = v
            continue
        if ".gcn_layers." in new and new.endswith("weight"):
            v = v[:, :, None]
        ref[new] = v
        if new.startswith(("base_model.class_embed.",
                           "base_model.coords_embed.")):
            ref[new.replace("base_model.", f"{dec}.", 1)] = v
    for key in [k for k, v in ref.items() if isinstance(v, dict)]:
        ref[key] = np.concatenate([ref[key][c] for c in "qkv"])
    D = model.cfg.hidden_dim
    ref["support_cross_attention_layers.0.in_proj_weight"] = np.zeros(
        (3 * D, D), np.float32)
    ref["support_proj.weight"] = np.zeros((D, D), np.float32)
    # the backbone under torchvision's names, with BN statistics
    bb = model.backbone
    for name, p in bb.named_parameters():
        shape = tuple(p.shape)
        if name.endswith(".scale") or name.endswith(".bias"):
            continue
        key = name.replace("downsample_conv", "downsample.0")
        ref[f"base_model.backbone.0.body.{key}"] = (
            rng.normal(size=shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        ).astype(np.float32)
    for name, mod in bb.named_modules():
        if hasattr(mod, "scale") and isinstance(mod.scale, torch.nn.Parameter):
            n = mod.scale.numel()
            key = "base_model.backbone.0.body." + name.replace(
                "downsample_bn", "downsample.1")
            ref[f"{key}.weight"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
            ref[f"{key}.bias"] = rng.normal(0, 0.1, n).astype(np.float32)
            ref[f"{key}.running_mean"] = rng.normal(0, 0.2, n).astype(
                np.float32)
            ref[f"{key}.running_var"] = rng.uniform(0.3, 2.0, n).astype(
                np.float32)
            ref[f"{key}.num_batches_tracked"] = np.array(1000, np.int64)
    return ref, port


def phase_variants(torch, np, card, root):
    """The model variants at the flagship width (`CAPEConfig()`, bf16,
    dropout 0.1, random weights): 4 micro-steps (one real update) of each
    teacher-forced-only config, its decode refused; 2 `fused` micro-steps
    of v2 and v3; a request of 8 and 4 micro-steps of the legacy support
    encoder and of `dec_qkv_proj=False`; fp32 gradients on the card
    against fp64 ones on the CPU for v2, v3, v41 and the legacy encoder at
    phase_fp32_grads' config; and a
    synthetic reference checkpoint through `cli.import_checkpoint` into
    `CAPEPredictor.from_checkpoint`. Returns the summed launches."""
    from cape_tpu_torch import CAPE, CAPEConfig, CAPEPredictor
    from cape_tpu_torch.cli import import_checkpoint
    from cape_tpu_torch.utils.torch_import import import_reference_state_dict

    t_phase = time.perf_counter()
    base = CAPEConfig()
    check(base.bf16 and base.image_size == 512 and base.dropout == 0.1
          and base.accumulation_steps == 4 and base.hidden_dim == 256
          and base.enc_layers == 6 and base.dec_layers == 6,
          "flagship defaults changed")
    # no lr warmup: in its first step an update (~lr/2500) is below the
    # fp32 resolution of the norm scales near 1, and the check below wants
    # every trained tensor moved after one update
    base = base.replace(warmup_epochs=0)
    L = base.num_feature_levels
    enc, dec = base.enc_layers * L, base.dec_layers * L
    total = dict.fromkeys(_counts(), 0)

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    print("phase_variants: teacher-forced-only configs, 4 micro-steps of 4 "
          "images each (1 real update)", flush=True)
    for name, kw in VARIANT_TRAIN.items():
        cfg = base.replace(dec_attn_concat_src=True, **kw)
        per = enc if name == "v3" else enc + dec
        model, counts = _variant_steps(
            torch, np, cfg, f"{name} + dec_attn_concat_src", card, 4,
            dict(quad_gather=per, quad_scatter=per))
        add(counts)
        msg = _check_decode_refused(torch, np, model, name)
        print(f"  {name}: the decode raised ValueError: {msg[:72]}...",
              flush=True)
        del model
        torch.cuda.empty_cache()

    print("phase_variants: v2 and v3 under CAPE_MSDA_GATHER=fused, 2 "
          "micro-steps", flush=True)
    for name in ("v2", "v3"):
        cfg = base.replace(dec_attn_concat_src=True, **VARIANT_TRAIN[name])
        per = enc if name == "v3" else enc + dec
        model, counts = _variant_steps(
            torch, np, cfg, f"{name} fused", card, 2,
            dict(fused_fwd=per, fused_bwd=per), impl="fused")
        add(counts)
        del model
        torch.cuda.empty_cache()

    print("phase_variants: the options that serve", flush=True)
    reqs = _requests(np, 1, 8)
    proto = np.asarray(PROTO_17, np.float32)
    for name, kw in VARIANT_SERVE.items():
        cfg = base.replace(**kw)
        model, counts = _variant_steps(
            torch, np, cfg, name, card, 4,
            dict(quad_gather=enc + dec, quad_scatter=enc + dec))
        add(counts)
        pred = CAPEPredictor(cfg, model, batch_size=8)
        imgs, boxes = reqs[0]
        pred.predict(imgs, proto, bboxes=boxes, skeleton=SKELETON_17)
        _reset_counts()
        t0 = time.perf_counter()
        res = pred.predict(imgs, proto, bboxes=boxes, skeleton=SKELETON_17)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = _counts()
        _check_results(np, res, len(imgs), len(PROTO_17))
        steps = max(r["length"] for r in res)
        _check_counts(counts, f"the {name} request",
                      quad_gather=enc + base.dec_layers * steps)
        add(counts)
        print(f"  {name}: a request of 8 (warm) {ms:.3f} ms, {steps} decode "
              f"steps, launches {counts} ({card})", flush=True)
        del model, pred
        torch.cuda.empty_cache()

    # -- fp32 on the card (kernels) against the CPU (plain versions)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    small = CAPEConfig().replace(image_size=128, enc_layers=2, dec_layers=2,
                                 dropout=0.0, bf16=False, batch_size=1,
                                 accumulation_steps=1, warmup_epochs=0)
    batch = _train_batch(np, small, np.random.default_rng(5))
    for name, kw in (("v2", VARIANT_TRAIN["v2"]), ("v3", VARIANT_TRAIN["v3"]),
                     ("v41", VARIANT_TRAIN["v41"]),
                     ("legacy_encoder", VARIANT_SERVE["legacy_encoder"])):
        c = small.replace(**kw)
        if name != "legacy_encoder":
            c = c.replace(dec_attn_concat_src=True)
        m_cpu = CAPE(c, device="cpu", generator=torch.Generator().manual_seed(7))
        m_gpu = CAPE(c, device="cuda", generator=torch.Generator().manual_seed(8))
        m_gpu.load_state_dict(m_cpu.state_dict())
        # the reference computes in fp64: fp32 on the CPU is itself not one
        # answer here (v41's encoder.layers.0.linear1.bias gradient, a sum
        # that cancels, lies 2.7 tolerances apart between 1 and 4 CPU
        # threads, and the 1-thread run is the fp64 one's)
        m_cpu.double()
        names = [n for n, _ in m_cpu.named_parameters()]
        l_cpu, g_cpu = _grads(torch, m_cpu, c, batch, allow_unused=True)
        l_gpu, g_gpu = _grads(torch, m_gpu, c, batch, allow_unused=True)
        # v2-v6 leave the whole support encoder out, and nothing else
        unused = [n for n, g in zip(names, g_cpu) if g is None]
        want_unused = ([n for n in names if n.startswith("support_encoder.")]
                       if c.dec_layer_type != "v1" else [])
        check(unused == want_unused
              and bool(unused) == (name != "legacy_encoder"),
              f"{name}: parameters without a gradient on the CPU: "
              f"{unused[:5]}, expected {want_unused[:5]}")
        check([n for n, g in zip(names, g_gpu) if g is None] == unused,
              f"{name}: the card leaves other parameters without a "
              f"gradient than the CPU")
        names, g_cpu, g_gpu = zip(*[t for t in zip(names, g_cpu, g_gpu)
                                    if t[1] is not None])
        ratios = _grad_ratios(torch, g_gpu, g_cpu)
        order = sorted(range(len(names)), key=lambda i: -ratios[i])
        print(f"  fp32 card vs fp64 CPU [{name}]: loss {l_gpu:.7f} vs "
              f"{l_cpu:.7f}; gradient error over tolerance, largest: "
              f"{[(names[i], f'{ratios[i]:.3e}') for i in order[:3]]} "
              f"(per tensor {GRAD_RTOL:g} of its L2 norm + {GRAD_ATOL:g} "
              f"of the global norm, TF32 off)", flush=True)
        check(abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu),
              f"fp32 loss differs ({name})")
        check(ratios[order[0]] <= 1.0,
              f"fp32 gradient of {names[order[0]]} ({name}): "
              f"{ratios[order[0]]:.3e} of its tolerance")
        del m_cpu, m_gpu

    # -- a reference checkpoint through the import CLI
    cfg = CAPEConfig()
    t0 = time.perf_counter()
    layout_model = CAPE(cfg.replace(bf16=False), device="cpu")
    ref, port = _reference_layout(torch, np, layout_model, seed=11)
    del layout_model
    imported = import_reference_state_dict(ref, cfg)
    wrong = [k for k, v in port.items()
             if not torch.equal(imported[k], torch.from_numpy(v))]
    check(not wrong, f"the reference layout does not import to itself: "
          f"{wrong[:5]}")
    fields = ("hidden_dim", "nheads", "enc_layers", "dec_layers",
              "dim_feedforward", "dropout", "num_feature_levels",
              "dec_n_points", "enc_n_points", "seq_len", "vocab_size",
              "image_size")
    pth = os.path.join(root, "checkpoint_best.pth")
    torch.save({"model": {k: torch.from_numpy(np.asarray(v))
                          for k, v in ref.items()},
                "args": argparse.Namespace(**{f: getattr(cfg, f)
                                               for f in fields}),
                "epoch": 12, "best_pck": 0.5}, pth)
    t1 = time.perf_counter()
    out = import_checkpoint.main(["--torch_checkpoint", pth, "--output_dir",
                                  os.path.join(root, "imported")])
    t2 = time.perf_counter()
    pred = CAPEPredictor.from_checkpoint(out, batch_size=8)
    check(pred.model.cfg.to_json() == cfg.to_json(),
          "the imported checkpoint's config is not the flagship's")
    model = CAPE(cfg, device="cuda", generator=torch.Generator().manual_seed(3))
    model.load_state_dict(imported)
    in_memory = CAPEPredictor(cfg, model, batch_size=8)
    imgs, boxes = reqs[0]
    _reset_counts()
    res = pred.predict(imgs, proto, bboxes=boxes, skeleton=SKELETON_17)
    torch.cuda.synchronize()
    counts = _counts()
    _check_results(np, res, len(imgs), len(PROTO_17))
    steps = max(r["length"] for r in res)
    _check_counts(counts, "the imported checkpoint's request",
                  quad_gather=enc + base.dec_layers * steps)
    add(counts)
    want = in_memory.predict(imgs, proto, bboxes=boxes, skeleton=SKELETON_17)
    same = all(np.array_equal(a["keypoints"], b["keypoints"])
               and a["length"] == b["length"] for a, b in zip(res, want))
    print(f"  reference import: {len(ref)} reference tensors; layout, save "
          f"{(t1 - t0) * 1e3:.3f} ms, cli.import_checkpoint "
          f"{(t2 - t1) * 1e3:.3f} ms; from_checkpoint's request of 8: "
          f"{steps} decode steps, keypoints equal to the in-memory "
          f"import's: {same}", flush=True)
    check(same, "from_checkpoint's keypoints differ from the in-memory "
          "import's")
    del pred, in_memory, model
    torch.cuda.empty_cache()
    print(f"phase_variants: {time.perf_counter() - t_phase:.3f} s wall, "
          f"launches {total}", flush=True)
    return total


# ----------------------------------------------------------------------
#: phase_ddp: two ranks on the one card (the flagship micro-step of 4
#: query images split in two), a real update of 4 micro-steps
DDP_RANKS = 2
DDP_MICRO_STEPS = 4
#: the reduced fp32 config of phase_fp32_grads, two micro-steps (the first
#: leaves the reduced gradient in the accumulator), a global batch of 2
#: episodes
DDP_FP32 = dict(image_size=128, enc_layers=2, dec_layers=2, dropout=0.0,
                bf16=False, batch_size=2, accumulation_steps=2,
                warmup_epochs=0)


def _rows(tree, lo, n):
    """Rows [lo, lo + n) of every leaf of a batch dict."""
    if isinstance(tree, dict):
        return {k: _rows(v, lo, n) for k, v in tree.items()}
    return tree[lo:lo + n]


def _digest(torch, tensors):
    """sha256 of the tensors' bytes, in order."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().reshape(-1).contiguous().view(torch.uint8)
                 .cpu().numpy().tobytes())
    return h.hexdigest()


def _ddp_eval(torch, np, model, spec, card):
    """This rank's slice of phase_eval's 12 fixed episodes through
    `evaluate_cape(multihost=True)` on the serving phase's weights, in a
    batch of 8 as the single-process run decodes them (so that every
    episode is decoded at the same batch shape); the gather's ms per
    batch."""
    from cape_tpu_torch.data.builder import (build_mp100_cape,
                                             resolve_split_file)
    from cape_tpu_torch.data.episodic import EpisodicSampler, episode_batches
    from cape_tpu_torch.data.prefetch import prefetch, to_device
    from cape_tpu_torch.eval import evaluate
    from cape_tpu_torch.parallel import host_episode_slice, process_index

    cfg = model.cfg
    ds = build_mp100_cape("val", cfg)
    sampler = EpisodicSampler(ds, resolve_split_file(cfg), "val",
                              num_queries=1,
                              num_support=cfg.num_support_per_episode)
    local, valid = host_episode_slice(
        sampler.fixed_episodes(EVAL_EPISODES, 0), EVAL_EPISODES)
    eb = cfg.eval_batch_size
    batches = episode_batches(
        ds, sampler, eb, -(-len(local) // eb), cfg.image_size,
        cfg.max_support_keypoints, cfg.max_skeleton_edges,
        np.random.default_rng([0, process_index()]), fixed=local,
        total_episodes=valid)
    import torch.distributed as dist

    gather, gather_ms, gathered = evaluate.allgather_tree, [], []

    def timed_gather(tree):
        # after a barrier: the time leaves out the wait for the other rank
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        out = gather(tree)
        gather_ms.append((time.perf_counter() - t0) * 1e3)
        gathered.append(out)
        return out

    evaluate.allgather_tree = timed_gather
    try:
        t0 = time.perf_counter()
        stats = evaluate.evaluate_cape(
            model, prefetch(batches, transform=to_device), cfg,
            multihost=True, decode_max_len=spec["cap"])
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        evaluate.allgather_tree = gather
    # two gathers a batch: the decode outputs, then the metadata; the
    # gathered outputs of the real episodes, in episode order
    per_batch = [a + b for a, b in zip(gather_ms[::2], gather_ms[1::2])]
    rows = [(o, m["sample_valid"]) for o, m in
            zip(gathered[::2], gathered[1::2])]
    np.savez(os.path.join(spec["out"], f"eval{process_index()}.npz"),
             **{k: np.concatenate([o[k][v] for o, v in rows])
                for k in ("pred_logits", "pred_coords", "lengths")})
    print(f"ddp eval: {valid} of {len(local)} local episodes valid, PCK@0.2 "
          f"{stats['pck']:.6f} ({stats['pck_num_correct']}/"
          f"{stats['pck_num_visible']}); wall {wall:.3f} ms, gather "
          f"{[round(t, 3) for t in per_batch]} ms per batch ({card})",
          flush=True)
    return {"stats": {k: v for k, v in stats.items() if np.isscalar(v)},
            "per_category": {str(k): v for k, v in
                             stats["pck_per_category"].items()},
            "gather_ms": per_batch, "wall_ms": wall}


def _timed_allreduce(torch, log):
    """Patch the train step's all-reduce: the gradients' call (the one of
    more than one tensor) timed after a barrier, so that the time leaves
    out the wait for the other rank, and synchronised (ms appended to
    `log`). Returns the restore function."""
    import torch.distributed as dist

    from cape_tpu_torch.train import train_step

    inner = train_step.allreduce_sum_flat

    def timed(tensors):
        if len(tensors) == 1:
            return inner(tensors)
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        out = inner(tensors)
        torch.cuda.synchronize()
        log.append((time.perf_counter() - t0) * 1e3)
        return out

    train_step.allreduce_sum_flat = timed
    return lambda: setattr(train_step, "allreduce_sum_flat", inner)


def _ddp_flagship(torch, np, model, card):
    """The flagship update of `model` (the `CAPEConfig()` widths) on this
    rank's half of each micro-step (2 of its 4 query images), bf16,
    dropout 0.1 from a per-rank generator: per micro-step 48 gathers and
    48 scatters, its ms and the all-reduce's ms; the masters' digest
    after the real update."""
    from cape_tpu_torch.parallel import (local_episode_count, process_index,
                                         rank_seed, replicate)
    from cape_tpu_torch.train import create_train_state, make_train_step

    cfg = model.cfg
    spe = cfg.episodes_per_epoch // cfg.batch_size
    rng = np.random.default_rng(3)
    batches = [_train_batch(np, cfg, rng) for _ in range(DDP_MICRO_STEPS)]
    n = local_episode_count(cfg.batch_size) * cfg.num_queries_per_episode
    lo = process_index() * n
    replicate(model)
    state = create_train_state(cfg, model, spe)
    step = make_train_step(model, cfg, spe)
    gen = torch.Generator(device="cuda").manual_seed(rank_seed(cfg.seed))
    per_step = (cfg.enc_layers + cfg.dec_layers) * cfg.num_feature_levels
    before = [m.clone() for m in state.opt_state.masters]
    times, reduce_ms = [], []
    restore = _timed_allreduce(torch, reduce_ms)
    try:
        for i, batch in enumerate(batches):
            _reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, _rows(batch, lo, n), gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            counts = _counts()
            m = {k: v.item() for k, v in metrics.items()}
            print(f"ddp flagship micro-step {i + 1}: {times[-1]:.3f} ms "
                  f"(all-reduce {reduce_ms[-1]:.3f} ms), total "
                  f"{m['total']:.6f}, grad_norm {m['grad_norm']:.6f}, "
                  f"launches {counts} ({card})", flush=True)
            check(all(np.isfinite(v) for v in m.values()),
                  "non-finite metrics")
            _check_counts(counts, f"ddp micro-step {i + 1}",
                          quad_gather=per_step, quad_scatter=per_step)
    finally:
        restore()
    check(state.opt_state.gradient_step == 1, "no real update")
    changed = sum(not torch.equal(a, b) for a, b in
                  zip(before, state.opt_state.masters))
    check(changed > 0.5 * len(before), f"only {changed} masters moved")
    print(f"ddp flagship ({n} query images a rank, bf16, dropout 0.1): ms "
          f"per micro-step {[round(t, 3) for t in times]}, all-reduce ms "
          f"{[round(t, 3) for t in reduce_ms]} ({card})", flush=True)
    return {"masters": _digest(torch, state.opt_state.masters),
            "metrics": m, "ms": times, "allreduce_ms": reduce_ms}


def _ddp_fp32(torch, np, out_dir):
    """The reduced fp32 config, TF32 off: two micro-steps on this rank's
    half of one global batch; rank 0 saves the reduced gradient (the
    accumulator after the first) and the masters after the update."""
    from cape_tpu_torch import CAPE, CAPEConfig
    from cape_tpu_torch.parallel import is_main, process_index
    from cape_tpu_torch.train import create_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = CAPEConfig().replace(**DDP_FP32)
    batch = _train_batch(np, cfg, np.random.default_rng(5))
    n = cfg.num_queries_per_episode
    mine = _rows(batch, process_index() * n, n)
    model = CAPE(cfg, device="cuda", generator=torch.Generator().manual_seed(5))
    state = create_train_state(cfg, model, 10)
    step = make_train_step(model, cfg, 10)
    state, m1 = step(state, mine)
    grads = [a.to("cpu", copy=True) for a in state.opt_state.acc_grads]
    state, m2 = step(state, mine)
    if is_main():
        torch.save({"grads": grads,
                    "masters": [m.cpu() for m in state.opt_state.masters],
                    "totals": [m1["total"].item(), m2["total"].item()]},
                   os.path.join(out_dir, "fp32.pt"))
    return {"masters": _digest(torch, state.opt_state.masters)}


def ddp_rank(spec_path) -> int:
    """One rank of phase_ddp (run by it as a subprocess): an explicitly
    requested gloo group of two ranks on the one card, CUDA tensors."""
    import numpy as np
    import torch

    from cape_tpu_torch import CAPE, CAPEConfig
    from cape_tpu_torch.parallel import (allgather_object, maybe_initialize,
                                         process_index)

    with open(spec_path) as f:
        spec = json.load(f)
    try:
        check(maybe_initialize("gloo"), "no group of two ranks")
        # the serving phase's weights, on which phase_eval ran
        model = CAPE(CAPEConfig.from_json(spec["eval_cfg"]), device="cuda",
                     generator=torch.Generator().manual_seed(0))
        check(_digest(torch, model.state_dict().values()) == spec["weights"],
              "the rank's weights are not the serving phase's")
        res = {"eval": _ddp_eval(torch, np, model, spec, spec["card"]),
               "flagship": _ddp_flagship(torch, np, model, spec["card"])}
        del model
        res["fp32"] = _ddp_fp32(torch, np, spec["out"])
        for key in ("flagship", "fp32"):
            digests = allgather_object(res[key]["masters"])
            check(len(set(digests)) == 1,
                  f"the ranks' {key} masters differ: {digests}")
    except (Failed, AssertionError, RuntimeError, ValueError) as e:
        print(f"ddp rank FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    with open(os.path.join(spec["out"], f"rank{process_index()}.json"),
              "w") as f:
        json.dump(res, f)
    return 0


def _ddp_nccl(torch, store):
    """A one-rank nccl group through `maybe_initialize` (no backend named:
    CUDA is there): all_reduce, all_gather, broadcast and barrier on the
    card, each timed once; the group is destroyed after."""
    import torch.distributed as dist

    from cape_tpu_torch.parallel import maybe_initialize

    with selection(CAPE_COORDINATOR=f"file://{store}",
                   CAPE_NUM_PROCESSES="1", CAPE_PROCESS_ID="0"):
        check(maybe_initialize() is False, "one rank is not multi-process")
    ms = {}
    try:
        check(dist.get_backend() == "nccl",
              f"backend {dist.get_backend()}, not nccl")

        def timed(name, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms[name] = round((time.perf_counter() - t0) * 1e3, 3)

        x = torch.arange(1 << 20, dtype=torch.float32, device="cuda")
        want = x.clone()
        timed("all_reduce", lambda: dist.all_reduce(x))
        parts = [torch.empty_like(x)]
        timed("all_gather", lambda: dist.all_gather(parts, x))
        y = torch.full((3,), 7.0, device="cuda")
        timed("broadcast", lambda: dist.broadcast(y, src=0))
        timed("barrier", dist.barrier)
        check(torch.equal(x, want) and torch.equal(parts[0], want)
              and torch.equal(y, torch.full_like(y, 7.0)),
              "one-rank nccl collectives changed their data")
    finally:
        dist.destroy_process_group()
    return ms


def phase_ddp(torch, np, card, model, ev, single):
    """Multi-process data parallelism on the one card: two ranks as
    subprocesses over an explicitly requested gloo group on CUDA tensors
    (a stand-in for two cards: nccl refuses two ranks on one device).
    They decode phase_eval's 12 episodes sharded (`single`, its default
    run: the stats must be its stats, the gathered decode outputs its
    outputs), take a flagship update (masters bit-equal
    across ranks, 48 gathers and 48 scatters a micro-step) and the
    reduced fp32 update (the reduced gradient and the update against the
    single-process step on the same global batch, with phase_fp32_grads'
    tolerances). Then a one-rank nccl group in this process."""
    from cape_tpu_torch import CAPE, CAPEConfig
    from cape_tpu_torch.train import create_train_state, make_train_step

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ddp_")
    try:
        spec = {"eval_cfg": ev.cfg.to_json(), "cap": ev.cap, "card": card,
                "weights": _digest(torch, model.state_dict().values()),
                "out": tmp}
        spec_path = os.path.join(tmp, "spec.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        env = dict(os.environ, CAPE_COORDINATOR=f"file://{tmp}/store",
                   CAPE_NUM_PROCESSES=str(DDP_RANKS))
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--ddp-rank",
             spec_path], env=dict(env, CAPE_PROCESS_ID=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(DDP_RANKS)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=300)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, out in enumerate(outs):
            for line in out.splitlines():
                print(f"[rank {r}] {line}", flush=True)
        check(all(p.returncode == 0 for p in procs),
              f"a rank failed: exit codes {[p.returncode for p in procs]}")
        res = []
        for r in range(DDP_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                res.append(json.load(f))

        # sharded eval: every rank scored the gathered set (the mean over
        # categories to 1e-12: the gathered order of the categories is
        # another summation order); random weights score PCK 0, so the
        # gathered outputs are held against the single-process decode's
        keys = ("pck", "pck_num_correct", "pck_num_visible", "num_images")
        want = {k: single.stats[k] for k in keys}
        for r, x in enumerate(res):
            got = x["eval"]["stats"]
            check({k: got[k] for k in keys} == want
                  and abs(got["pck_mean_categories"]
                          - single.stats["pck_mean_categories"]) <= 1e-12
                  and x["eval"]["per_category"] == {
                      str(k): v for k, v in
                      single.stats["pck_per_category"].items()},
                  f"rank {r}'s sharded eval stats {got} differ from the "
                  f"single-process {single.stats}")
        eb = len(single.outs[0]["lengths"])
        real = [{k: v[:EVAL_EPISODES - i * eb].cpu().numpy()
                 for k, v in o.items()} for i, o in enumerate(single.outs)]
        sharded = [np.load(os.path.join(tmp, f"eval{r}.npz"))
                   for r in range(DDP_RANKS)]
        for k in ("pred_logits", "pred_coords", "lengths"):
            want_k = np.concatenate([o[k] for o in real])
            for r, got in enumerate(sharded):
                check(got[k].shape == want_k.shape,
                      f"rank {r}'s gathered {k}: {got[k].shape}, "
                      f"{want_k.shape} single-process")
                same = np.array_equal(got[k], want_k)
                err = float(np.abs(got[k].astype(np.float64)
                                   - want_k).max())
                print(f"ddp eval rank {r}: gathered {k} of the "
                      f"{EVAL_EPISODES} episodes against the "
                      f"single-process decode: bit-equal {same}, max abs "
                      f"err {err:.3e}", flush=True)
                # each episode sits in a batch of 8 on both sides, and a
                # row's decode does not depend on the other rows
                check(same, f"rank {r}'s gathered {k} differ from the "
                      f"single-process decode's")
        check(res[0]["flagship"]["masters"] == res[1]["flagship"]["masters"],
              "flagship masters differ between the ranks")

        # the reduced fp32 update against the single process on the card
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg = CAPEConfig().replace(**DDP_FP32)
        batch = _train_batch(np, cfg, np.random.default_rng(5))
        ref = CAPE(cfg, device="cuda", generator=torch.Generator().manual_seed(5))
        st = create_train_state(cfg, ref, 10)
        step = make_train_step(ref, cfg, 10)
        before = [m.to("cpu", copy=True) for m in st.opt_state.masters]
        st, m1 = step(st, batch)
        want_g = [a.to("cpu", copy=True) for a in st.opt_state.acc_grads]
        st, m2 = step(st, batch)
        want_m = [m.to("cpu", copy=True) for m in st.opt_state.masters]
        got = torch.load(os.path.join(tmp, "fp32.pt"), weights_only=True)
        for got_l, want_l in zip(got["totals"], (m1, m2)):
            w = want_l["total"].item()
            check(abs(got_l - w) <= 1e-4 * abs(w),
                  f"fp32 two-rank loss {got_l} vs single-process {w}")
        names = st.opt_state.names
        ratios = _grad_ratios(torch, got["grads"], want_g)
        worst = max(range(len(names)), key=lambda i: ratios[i])
        lrs = st.tx.group_lrs(0)
        n_far, far = 0, 0.0
        for label, b, g_m, w_m in zip(st.opt_state.labels, before,
                                      got["masters"], want_m):
            if lrs[label] == 0.0:
                check(torch.equal(g_m, b) and torch.equal(w_m, b),
                      "a frozen leaf moved")
                continue
            diff = ((g_m - w_m) / lrs[label]).abs()
            far = max(far, diff.max().item())
            n_far += int((diff > 1e-2).sum())
        print(f"ddp fp32 two ranks vs one process on the card: losses "
              f"{got['totals']} vs {[m1['total'].item(), m2['total'].item()]}"
              f"; reduced gradient error over tolerance, largest "
              f"{names[worst]} {ratios[worst]:.3e} (tolerance per tensor "
              f"{GRAD_RTOL:g} of its own L2 norm + {GRAD_ATOL:g} of the "
              f"global norm); after the update {n_far} elements differ by "
              f"more than 1e-2 lr, the largest by {far:.3e} lr (at most "
              f"{UPDATE_FAR})", flush=True)
        check(ratios[worst] <= 1.0, f"fp32 reduced gradient of "
              f"{names[worst]}: {ratios[worst]:.3e} of its tolerance")
        check(n_far <= UPDATE_FAR, "fp32 two-rank update differs from the "
              "single-process update")
        del ref, st, step

        nccl = _ddp_nccl(torch, os.path.join(tmp, "nccl_store"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    flag = [x["flagship"] for x in res]
    print(f"phase_ddp: two ranks on one card over gloo (a stand-in: no "
          f"scaling measured): flagship ms per micro-step per rank "
          f"{[[round(t, 3) for t in f['ms']] for f in flag]}, all-reduce "
          f"ms per micro-step {[[round(t, 3) for t in f['allreduce_ms']] for f in flag]}"
          f"; sharded eval gather ms per batch "
          f"{[[round(t, 3) for t in x['eval']['gather_ms']] for x in res]}; "
          f"one-rank nccl ms {nccl}; {time.perf_counter() - t_phase:.3f} s "
          f"wall ({card})", flush=True)


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        import numpy as np

        from cape_tpu_torch.data import image
        from cape_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2
    for name in ("CAPE_MSDA_GATHER", "CAPE_MSDA_TINY", "CAPE_DECODE_PREQUAD"):
        os.environ.pop(name, None)     # each phase sets what it selects
    libs = image.library_versions()
    tree = tempfile.TemporaryDirectory(prefix="chip_smoke_mp100_")
    try:
        card = card_identity()
        print(card, flush=True)
        print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}", flush=True)
        print(f"image libraries: cv2 {libs['cv2']}, PIL {libs['PIL']}; the "
              f"port resizes by {image.RESIZE_ROUTE} and decodes by "
              f"{image.DECODE_ROUTE}", flush=True)
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
        ev, eval_run, eval_counts, eval_fused_counts = phase_eval(
            torch, np, model, card, tree.name)
        sized = os.path.join(tree.name, "sized")
        phase_eval_sized(torch, np, model, card, sized)
        train_model, train_counts = phase_training(torch, np, card)
        phase_training_pallas(torch, np, train_model, card)
        fused_bwd_counts = phase_training_fused(torch, np, train_model, card)
        del train_model
        loop_counts = phase_train_loop(torch, np, card, sized)
        shutil.rmtree(sized)
        variants_dir = os.path.join(tree.name, "variants")
        os.makedirs(variants_dir)
        variant_counts = phase_variants(torch, np, card, variants_dir)
        shutil.rmtree(variants_dir)
        m32, m_cpu = phase_fp32_checks(torch, np, model)
        _eval_fp32(torch, np, m32, m_cpu, ev)
        del m32, m_cpu
        phase_fp32_grads(torch, np)
        phase_ddp(torch, np, card, model, ev, eval_run)
        check("jax" not in sys.modules and not any(
            k == "cape_tpu" or k.startswith("cape_tpu.") for k in sys.modules),
            "the port loaded jax or the JAX package")
    except (Failed, AssertionError, RuntimeError, ValueError) as e:
        print(f"chip_smoke FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    finally:
        tree.cleanup()
    # each kernel's launches from its own path's run: the serving requests
    # for the forward kernels, the training micro-steps for the backward
    launches = {"quad_gather": default_counts["quad_gather"],
                "msda_forward": pallas_counts["msda_forward"],
                "quad_scatter": train_counts["quad_scatter"],
                "fused_fwd": fused_counts["fused_fwd"],
                "quadfused_fwd": fused_counts["quadfused_fwd"],
                "fused_bwd": fused_bwd_counts["fused"],
                "quadfused_bwd": fused_bwd_counts["quadfused"]}
    # and the evaluation path's runs (default path, then `fused`), and the
    # training entry point's (its run under auto, then its `fused` epoch)
    eval_launches = {"quad_gather": eval_counts["quad_gather"],
                     "fused_fwd": eval_fused_counts["fused_fwd"]}
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["name"] in eval_launches:
            k["eval_launches"] = eval_launches[k["name"]]
        if k["name"] in loop_counts:
            k["train_loop_launches"] = loop_counts[k["name"]]
        k["variant_launches"] = variant_counts[k["name"]]
    print(f"chip_smoke: {time.perf_counter() - t_start:.3f} s in all",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddp-rank"]:     # a rank of phase_ddp
        sys.exit(ddp_rank(sys.argv[2]))
    sys.exit(main())
