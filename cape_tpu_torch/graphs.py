"""Captured CUDA-graph programs: compile once, replay many.

The JAX package runs its decode and its train step as compiled XLA
programs: `eval.evaluate._decode_jit` (the encoders and a `lax.while_loop`
over the tokens, one program per model and batch shape, kept in jax's jit
cache), `jax.jit(train_step)` and the `lax.scan` of `steps_per_dispatch`
steps. `jax.jit` is not a module of the JAX package, so this file has no
counterpart there; it is their counterpart on the card. A program here is
captured once per key into CUDA graphs (`torch.cuda.CUDAGraph`) and then
replayed, one launch a graph:

- the decode (`decode`), keyed as the jit cache keys `_decode_jit`: by
  model, input shapes and dtypes, token cap and the MSDA selection (and
  whether `force_length` is set: its value is an input). A prologue graph (`models.cape.decode_prologue`: both
  encoders, the decode-time constants, the BOS state) is replayed once,
  then a chunk graph of `models.cape.DECODE_CHUNK` token bodies
  (`decode_token`) until the host reads that every sample has finished,
  or the cap (a tail graph takes the rest where the cap is not a multiple
  of the chunk): one host read a chunk, where the eager loop read one a
  token before this module;
- the micro-step of training (`step_program`), keyed by model, train
  state, batch shapes, dropout generator and MSDA selection: one graph
  that folds the gradients and one that folds and updates, the host
  picking by its own count (`train.state.FusedAdamW.prepare`, which
  writes the step's scalars into a device tensor before the replay).

How the programs are kept right:

- inputs are copied into static buffers before a replay, and outputs are
  copied out of the graph's buffers after it (`decode_outputs`, the
  train step's `clone`), before another graph replays;
- each capture is preceded by a warm-up of the same body on the capture's
  side stream (first use of every op and kernel build outside the
  capture), as PyTorch's graph documentation asks;
- one memory pool per model, shared by its graphs. Every graph's static
  outputs stay referenced by its program, so no later capture reuses
  them, and the graphs replay one at a time on one stream. The programs
  keep no reference to the model, nor to its pool: they die with it, not
  in a later collection of cyclic garbage (a graph destroyed while
  another captures invalidates that capture, so no collection runs during
  one);
- dropout: the step's `torch.Generator` is registered with its graphs
  (`CUDAGraph.register_generator_state`), so that each replay draws from
  the generator's current offset and advances it, as eager calls do;
- the kernels' launch counters (`ops.launch_counters`): warm-ups and
  captures count nothing (they are the program's set-up, as a trace is in
  JAX); each replay adds the launches its graph holds;
- spans and counters (`trace`): a capture with its warm-up is the span
  `graphs.capture` and counts one `graphs.captures`; the decode records
  the spans and counters of the eager `models.cape.decode_chunked` under
  the same names, a replay timed on the device as `decode.prologue` or
  `decode.chunk`, and the micro-step's `step.*` spans its copy-in, replay
  and copy-out;
- captures run with `capture_error_mode="thread_local"`: the prefetch
  thread may copy the next batch to the card meanwhile.

What stays eager is decided by configuration before any capture
(`step_route`), never by catching a failed capture: a capture that fails
raises, and there is no CPU route on the card. On the CPU every entry point
runs the same bodies eagerly.
"""

from __future__ import annotations

import contextlib
import gc
import os
import weakref
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from .config import CAPEConfig
from .models.cape import (CAPE, DECODE_CHUNK, decode_length, decode_outputs,
                          decode_pending, decode_prologue, decode_token)
from .ops import launch_counters
from .parallel import process_count
from . import trace

#: the variables that select an MSDA formulation, read while a body is
#: captured, and so a part of every program's key
SELECTION = ("CAPE_MSDA_GATHER", "CAPE_MSDA_TINY", "CAPE_DECODE_PREQUAD")


def _selection() -> Tuple:
    return tuple(os.environ.get(k) for k in SELECTION)


class _ModelGraphs:
    """A model's memory pool, capture stream and programs by key."""

    def __init__(self, device: torch.device):
        self.pool = torch.cuda.graph_pool_handle()
        with torch.cuda.device(device):
            self.stream = torch.cuda.Stream()
        self.programs: Dict[Tuple, object] = {}


_MODELS: "weakref.WeakKeyDictionary[CAPE, _ModelGraphs]" = \
    weakref.WeakKeyDictionary()


def _graphs_of(model: CAPE) -> _ModelGraphs:
    mg = _MODELS.get(model)
    if mg is None:
        mg = _MODELS[model] = _ModelGraphs(model.device)
    return mg


def programs(model: CAPE) -> list:
    """The keys of a model's captured programs."""
    mg = _MODELS.get(model)
    return [] if mg is None else list(mg.programs)


def clear(model: CAPE) -> None:
    """Drop a model's programs and its memory pool (the next call captures
    anew)."""
    _MODELS.pop(model, None)


def _counts() -> Dict[str, int]:
    return {k: getattr(fn, attr)
            for k, (fn, attr) in launch_counters().items()}


def _set_counts(counts: Mapping[str, int]) -> None:
    for k, (fn, attr) in launch_counters().items():
        setattr(fn, attr, counts[k])


@contextlib.contextmanager
def _uncounted():
    """Launches inside the block leave the counters as they were."""
    saved = _counts()
    try:
        yield
    finally:
        _set_counts(saved)


class _Graph:
    """One captured graph and the kernel launches it holds."""

    def __init__(self, mg: _ModelGraphs, fn: Callable,
                 generator: Optional[torch.Generator] = None,
                 warm: Optional[Callable] = None):
        """Capture `fn` on the model's side stream into the model's pool,
        after `warm` (a warm-up of the same work) where given; `self.out`
        is what the captured call returned."""
        with trace.span("graphs.capture"):
            if warm is not None:
                _warm_up(mg, warm)
            self.graph = torch.cuda.CUDAGraph()
            if generator is not None:
                self.graph.register_generator_state(generator)
            # a graph destroyed while another captures invalidates the
            # capture: collect cyclic garbage first, and let no collection
            # run inside
            gc.collect()
            enabled = gc.isenabled()
            gc.disable()
            try:
                with _uncounted():
                    before = _counts()
                    with torch.cuda.graph(self.graph, pool=mg.pool,
                                          stream=mg.stream,
                                          capture_error_mode="thread_local"):
                        self.out = fn()
                    after = _counts()
            finally:
                if enabled:
                    gc.enable()
        trace.count("graphs.captures")
        self.launches = [(*launch_counters()[k], after[k] - before[k])
                         for k in after if after[k] != before[k]]

    def replay(self) -> None:
        self.graph.replay()
        for fn, attr, n in self.launches:
            setattr(fn, attr, getattr(fn, attr) + n)


def _warm_up(mg: _ModelGraphs, fn: Callable) -> None:
    """`fn` run eagerly on the capture stream, ordered after the current
    stream's work and before its later work; its launches uncounted."""
    current = torch.cuda.current_stream()
    mg.stream.wait_stream(current)
    with _uncounted(), torch.cuda.stream(mg.stream):
        fn()
    current.wait_stream(mg.stream)


def _tensors(tree):
    """A batch tree (numpy arrays or tensors) as tensors, without copies."""
    if isinstance(tree, Mapping):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.as_tensor(tree)


def _signature(tree) -> Tuple:
    if isinstance(tree, Mapping):
        return tuple((k, _signature(tree[k])) for k in sorted(tree))
    return (tuple(tree.shape), tree.dtype)


def _empty_like(tree, device):
    if isinstance(tree, Mapping):
        return {k: _empty_like(v, device) for k, v in tree.items()}
    return torch.empty(tuple(tree.shape), dtype=tree.dtype, device=device)


def _copy_into(static, tree) -> None:
    """Copy a batch tree's leaves (numpy arrays or tensors) into the static
    buffers of the same keys."""
    if isinstance(static, Mapping):
        for k, v in static.items():
            _copy_into(v, tree[k])
        return
    static.copy_(torch.as_tensor(tree))


# -- the decode ------------------------------------------------------------
class _DecodeProgram:
    """The captured decode of one key: a prologue graph, a chunk graph of
    `DECODE_CHUNK` token bodies and, where the cap is not a multiple of
    it, a tail graph of the rest, over one carry: the chunks of the eager
    `models.cape.decode_chunked`."""

    def __init__(self, model: CAPE, mg: _ModelGraphs, inputs, length: int,
                 forced: bool):
        self.seq_len = model.cfg.seq_len
        self.device = model.device
        self.inputs = tuple(torch.empty_like(t) for t in inputs)
        for s, t in zip(self.inputs, inputs):
            s.copy_(t)
        # `force_length` is an input too: one program for every length
        self.force = (torch.ones((), dtype=torch.int64, device=model.device)
                      if forced else None)

        def prologue():
            return decode_prologue(model, *self.inputs, length)

        def tokens(carry, n):
            for _ in range(n):
                decode_token(model, carry, self.force)
            return decode_pending(carry)

        self.prologue = _Graph(mg, prologue,
                               warm=lambda: tokens(prologue(), 1))
        self.carry = self.prologue.out
        full, tail = divmod(length, DECODE_CHUNK)
        chunk = _Graph(mg, lambda: tokens(self.carry, DECODE_CHUNK)) \
            if full else None
        # (graph, token bodies it runs)
        self.chunks = [(chunk, DECODE_CHUNK)] * full
        if tail:
            self.chunks.append(
                (_Graph(mg, lambda: tokens(self.carry, tail)), tail))

    def __call__(self, inputs, force_length: Optional[int]
                 ) -> Dict[str, torch.Tensor]:
        dev = self.device
        with trace.device_span("decode.inputs", dev):
            for s, t in zip(self.inputs, inputs):
                s.copy_(t)
            if self.force is not None:
                self.force.fill_(force_length)
        with trace.device_span("decode.prologue", dev):
            self.prologue.replay()
        last = len(self.chunks) - 1
        for i, (chunk, n) in enumerate(self.chunks):
            with trace.device_span("decode.chunk", dev):
                chunk.replay()
            trace.count("decode.steps", n)
            if i == last:
                break
            trace.count("decode.host_reads")
            with trace.span("decode.host_read"):
                pending = bool(chunk.out)
            if not pending:
                break
        with trace.device_span("decode.outputs", dev):
            return decode_outputs(self.carry, self.seq_len)


@torch.inference_mode()
def decode(model: CAPE, images, support_coords, support_mask,
           skeleton_edges, max_len: Optional[int] = None,
           force_length: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """`models.cape.autoregressive_decode` on a CUDA model, as replays of
    the captured program of its key (captured at the key's first call).
    The outputs are the eager decode's, bit for bit. The counter
    `decode.host_reads` (`trace`) counts the reads of "has every sample
    finished?"."""
    dev = model.device
    if dev.type != "cuda":
        raise ValueError(f"graphs.decode needs a CUDA model, not {dev}")
    with trace.span("decode"):
        with trace.device_span("decode.inputs", dev):
            inputs = tuple(torch.as_tensor(x, device=dev) for x in
                           (images, support_coords, support_mask,
                            skeleton_edges))
        length = decode_length(model.cfg, max_len)
        mg = _graphs_of(model)
        forced = force_length is not None
        key = ("decode", tuple(_signature(t) for t in inputs), length,
               forced, _selection())
        program = mg.programs.get(key)
        if program is None:
            program = mg.programs[key] = _DecodeProgram(model, mg, inputs,
                                                        length, forced)
        return program(inputs, force_length)


# -- the train step --------------------------------------------------------
def step_route(model: CAPE, cfg: CAPEConfig) -> Optional[str]:
    """None where `train.make_train_step` captures the micro-step, else why
    it stays eager. Decided from the device, the process group and the
    config alone, before any capture."""
    if model.device.type != "cuda":
        return "not on the card"
    if process_count() > 1:
        return ("a process group: its all-reduce runs between the backward "
                "and the optimizer, and gloo cannot be captured")
    if cfg.use_remat_encoder:
        return ("remat_encoder: the recomputed forward saves and restores "
                "the dropout generator's state")
    if cfg.dec_layer_type != "v1" or cfg.dec_attn_concat_src:
        return (f"decoder layer {cfg.dec_layer_type}"
                f"{' with dec_attn_concat_src' if cfg.dec_attn_concat_src else ''}"
                ": only the v1 layer's micro-step is captured")
    return None


def describe_step_route(model: CAPE, cfg: CAPEConfig) -> str:
    why = step_route(model, cfg)
    return ("train step: replays of captured CUDA graphs" if why is None
            else f"train step: eager ({why})")


_INPUTS = ("query_images", "support_coords", "support_mask",
           "skeleton_edges", "targets")


class _StepProgram:
    """The captured micro-step of one key: static batch buffers and, per
    `emit`, a graph and the (metrics,) vector it writes."""

    def __init__(self, model: CAPE, batch,
                 generator: Optional[torch.Generator]):
        self.static = _empty_like(batch, model.device)
        self.generator = generator
        self.graphs: Dict[bool, Tuple[_Graph, Tuple[str, ...]]] = {}

    def run(self, model: CAPE, cfg: CAPEConfig, state, batch, emit: bool
            ) -> Tuple[Tuple[str, ...], torch.Tensor]:
        """Copy `batch` in and replay the graph of `emit` (captured at its
        first use). Returns the metric names and the graph's own (metrics,)
        vector, which its next replay overwrites."""
        from .train.train_step import losses_and_grads, micro_step

        with trace.span("step.copy_in"):
            _copy_into(self.static, batch)
        if emit not in self.graphs:
            gen = self.generator
            # the warm-up draws from a generator of its own: the step's
            # stream of dropout masks stays the eager one's
            warm_gen = (None if gen is None else
                        torch.Generator(device=model.device).manual_seed(0))
            keys = []

            def body():
                m = micro_step(model, cfg, state, self.static, gen, emit)
                keys.extend(m)
                return torch.stack([m[k].float() for k in keys])

            graph = _Graph(_graphs_of(model), body, gen,
                           warm=lambda: losses_and_grads(
                               model, cfg, self.static, warm_gen))
            self.graphs[emit] = (graph, tuple(keys))
        graph, keys = self.graphs[emit]
        with trace.device_span("step.replay", model.device):
            graph.replay()
        return keys, graph.out


def step_program(model: CAPE, state, batch,
                 generator: Optional[torch.Generator]) -> _StepProgram:
    """The captured micro-step for this model, state, batch shapes,
    generator and MSDA selection (made at the key's first call)."""
    mg = _graphs_of(model)
    batch = _tensors({k: batch[k] for k in _INPUTS})
    key = ("step", id(state.opt_state), id(generator), _signature(batch),
           _selection())
    entry = mg.programs.get(key)
    if entry is not None and entry[0]() is state.opt_state:
        return entry[1]
    program = _StepProgram(model, batch, generator)
    mg.programs[key] = (weakref.ref(state.opt_state), program)
    return program
