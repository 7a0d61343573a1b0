"""Multi-scale deformable attention core: the port of `cape_tpu.ops.msda`,
and the one owner of the MSDA selection (the route table below).

Bilinear semantics match `F.grid_sample(mode='bilinear',
padding_mode='zeros', align_corners=False)`: with normalized location
`loc` in [0,1] the continuous pixel coordinate is `loc * size - 0.5`, and
out-of-bounds corners contribute zero.

The default formulation is the JAX package's quad rows: per level, the
2x2 neighbourhood of every grid cell is packed into one 4*Dh-wide row, so
each sample is ONE row gather (`ops.gather.quad_gather`, the hand-written
kernel on the card) followed by a weighted corner/point sum.

- `ms_deform_attn_core`: the quad-row core. Heads fold into the gather's
  batch, so it gathers once per level instead of once per (level, head)
  as the JAX package does: the same function with H x fewer launches.
  `gather_impl` selects another formulation of the same function.
- `ms_deform_attn_core_fused` / `_quadfused`: one kernel per level does
  gather, blend and corner sum (`ops.msda_fused`), over the raw level
  slab or the quad rows.
- `ms_deform_attn_core_flat`: every corner of every level in one gather
  against the value in its own layout; plain tensor code.
- `precompute_quad_slab` + `ms_deform_attn_core_prequad`: the decode step,
  which packs the frozen memory once and samples every (batch, head)'s
  L*P points with one gather per layer and step.
- `ms_deform_attn_core_naive`: the direct 4-corner gather, the test oracle.
- `ms_deform_attn`: the dispatch of the model's sites; the whole op
  (`_MSDeformAttnWholeOp`: the forward kernel of `ops.msda_kernel`, the
  port of `ms_deform_attn_pallas`, and its backward kernel, which save
  only the value, the locations and the weights) or the core.

Every function here is differentiable in the value, the sampling locations
and the attention weights: the gather's backward is the scatter kernel of
`ops.gather`, the fused level samples' backward the kernels of
`ops.msda_fused`, the whole op's `ops.msda_kernel.msda_backward`, and the
bilinear and attention weights are plain PyTorch.

The selection. Three environment variables, read here alone and at every
call, as the JAX package reads them:

- `CAPE_MSDA_GATHER` (`default_gather_impl`): 'auto' (unset), or 'xla' /
  'mxu', which are the quad-row path as 'auto' is (the JAX package has two
  row gathers there, the port one); 'fused', 'fusedq', 'naive', 'flat'
  force those formulations at every site.
- `CAPE_MSDA_TINY`: under 'auto' alone, the formulation of sites of at
  most `_NAIVE_MAX_ROWS` gather rows (`resolve_impl`; the decode step).
- `CAPE_DECODE_PREQUAD` (`decode_prequad`): '0' makes the decode keep each
  layer's plain (B, S, H, Dh) value instead of its quad slab.

`selection()` is their values: the key of every captured program
(`graphs`). A `gather_impl` argument wins over the variables. Within a
route the tensor's device alone picks the kernel (CUDA) or its plain
version (CPU).

Route table: what runs at each kind of site under each selection.

  training site under autograd (`ms_deform_attn` with grad on and an
  input that requires it: the encoder and teacher-forced decoder layers)
    'auto'             the whole op, where `_whole_op_route` finds that
                       the kernels take the shapes and dtypes; else the
                       quad-row core (`quad_gather`, `quad_scatter`)
    'xla', 'mxu'       the quad-row core
    'fused' ... 'flat' that formulation's core
    CAPE_MSDA_TINY     at a tiny site under 'auto': that name's core
    use_pallas=True    the whole op, whatever the selection
  no-grad encoder site (`ms_deform_attn` without autograd: serving, eval
  and the decode's prologue; also the teacher-forced decoder there)
    'auto','xla','mxu' the quad-row core
    'fused' ... 'flat' that formulation's core
    CAPE_MSDA_TINY     at a tiny site under 'auto': that name's core
    use_pallas=True    the whole op (`msda_forward`)
  decode step (`models.decoder.Decoder.forward_step`, Lq = 1)
    'auto', slabs      one `ops.decode_step.layer_step` kernel a layer,
                       the quad gather folded in, where
                       `decode_step.refusal` is None (a CUDA flagship
                       layer in bf16); where it refuses, the chain of
                       modules with `ms_deform_attn_core_prequad`
    any other name     refused (the MSDA selection is not 'auto'): the
                       chain with `ms_deform_attn_core_prequad`, which
                       gathers quad rows whatever the name and warns for
                       a whole-core name
    CAPE_DECODE_PREQUAD=0  refused (no quad slab): the chain against the
                       plain value, where the step is a no-grad site of
                       `ms_deform_attn` as above (4 rows: tiny)
    use_pallas=True    no effect on quad slabs
"""

from __future__ import annotations

import os
import warnings
from typing import Iterator, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import trace
from .gather import quad_gather
from .msda_fused import fused_level_sample, quadfused_level_sample
from .msda_kernel import msda_backward, msda_forward, msda_plan

Shapes = Sequence[Tuple[int, int]]

#: at or below this many gather rows (Lq * P) a call site counts as tiny
#: (the decode step's Lq = 1) and 'auto' consults CAPE_MSDA_TINY
_NAIVE_MAX_ROWS = 256

#: the names that mean the quad-row path (see `default_gather_impl`)
_QUAD_ROW_IMPLS = ("auto", "xla", "mxu")

#: the variables of the selection, the only ones this package reads for it
_VARIABLES = ("CAPE_MSDA_GATHER", "CAPE_MSDA_TINY", "CAPE_DECODE_PREQUAD")


def selection() -> Tuple[Optional[str], ...]:
    """The values of the selection's variables (None where unset), read
    now: what a body captured now would run under."""
    return tuple(os.environ.get(k) for k in _VARIABLES)


def default_gather_impl() -> str:
    """The process-wide MSDA formulation (`CAPE_MSDA_GATHER`), read at
    every call: the counterpart of `cape_tpu/ops/gather_mxu.py:194-219`.
    The names and what they select are in the module's route table."""
    choice = os.environ.get("CAPE_MSDA_GATHER", "auto").lower()
    if choice in ("auto", "xla", "mxu", "fused", "fusedq", "naive", "flat"):
        return choice
    raise ValueError(
        f"CAPE_MSDA_GATHER={choice!r}: expected 'xla', 'mxu', 'fused', "
        "'fusedq', 'naive', 'flat' or 'auto'"
    )


def resolve_impl(n_rows: int) -> str:
    """The formulation of a site of `n_rows` gather rows (Lq * P), the
    counterpart of `cape_tpu/ops/msda.py:69-88`.

    A forced CAPE_MSDA_GATHER wins at every shape; only 'auto' consults
    CAPE_MSDA_TINY, and only at tiny call sites. The JAX package's batch
    rule (CAPE_MSDA_TINY_XLA_BATCH) switches between its two row gathers,
    which are one in the port, so it has no counterpart here.
    """
    impl = default_gather_impl()
    if impl == "auto" and n_rows <= _NAIVE_MAX_ROWS:
        return os.environ.get("CAPE_MSDA_TINY", "").lower() or impl
    return impl


def decode_prequad() -> bool:
    """Whether the decode packs each layer's quad slab once a request
    (`precompute_quad_slab`); False under `CAPE_DECODE_PREQUAD=0`."""
    return os.environ.get("CAPE_DECODE_PREQUAD", "1") != "0"


def _level_offsets(spatial_shapes: Shapes) -> Tuple[int, ...]:
    offs, start = [], 0
    for (h, w) in spatial_shapes:
        offs.append(start)
        start += h * w
    return tuple(offs)


def _quad_rows(level_value: torch.Tensor, Wl: int) -> torch.Tensor:
    """(B, HW, Dh) level slice -> (B, F+HW, 4*Dh) quad rows.

    Row `F + s` holds [v[s], v[s+1], v[s+Wl], v[s+Wl+1]] — the 2x2 bilinear
    neighborhood of flat cell s, contiguous along the last dimension.
    F = Wl+1 front padding keeps base indices down to -Wl-1 (corner cell
    (-1,-1)) in range; every out-of-bounds corner gets zero weight, so the
    wrap-around neighbors a flat index picks up at row edges are harmless.
    """
    B, HW, Dh = level_value.shape
    Fp = Wl + 1
    vp = F.pad(level_value, (0, 0, Fp, Wl + 1))
    n = Fp + HW
    quad = torch.stack(
        [vp[:, 0:n], vp[:, 1:n + 1],
         vp[:, Wl:n + Wl], vp[:, Wl + 1:n + Wl + 1]], dim=2)
    return quad.reshape(B, n, 4 * Dh)


def _quad_bases_and_weights(
        spatial_shapes: Shapes, sampling_locations: torch.Tensor,
        attention_weights: torch.Tensor,
        dtype: torch.dtype) -> Iterator[Tuple[int, torch.Tensor,
                                              torch.Tensor]]:
    """Per level: base row index (F-offset folded in) + 4 corner weights.

    base: (B, Lq, H, P) int32 into the level's quad-row array;
    w4:   (B, Lq, H, P, 4) bilinear * attention weight, zeroed where the
          corner is out of bounds (validity judged on the UNCLIPPED corner
          coordinate — the grid_sample zeros-padding contract).
    """
    for lvl, (Hl, Wl) in enumerate(spatial_shapes):
        loc = sampling_locations[:, :, :, lvl]
        w_attn = attention_weights[:, :, :, lvl]
        x = loc[..., 0] * Wl - 0.5
        y = loc[..., 1] * Hl - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fx = (x - x0).to(dtype)
        fy = (y - y0).to(dtype)
        x0u = x0.to(torch.int32)
        y0u = y0.to(torch.int32)
        x0c = x0u.clamp(-1, Wl - 1)
        y0c = y0u.clamp(-1, Hl - 1)
        base = (Wl + 1) + y0c * Wl + x0c
        ws = []
        for dxi, dyi, wgt in (
            (0, 0, (1 - fx) * (1 - fy)),
            (1, 0, fx * (1 - fy)),
            (0, 1, (1 - fx) * fy),
            (1, 1, fx * fy),
        ):
            cx = x0u + dxi
            cy = y0u + dyi
            valid = (cx >= 0) & (cx < Wl) & (cy >= 0) & (cy < Hl)
            ws.append((wgt * valid.to(dtype) * w_attn).to(dtype))
        yield lvl, base.to(torch.int32), torch.stack(ws, dim=-1)


def ms_deform_attn_core(
    value: torch.Tensor,
    spatial_shapes: Shapes,
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
    gather_impl: Optional[str] = None,
) -> torch.Tensor:
    """Sample multi-level features at fractional locations and blend.

    Args:
        value: (B, S, H, Dh) flattened multi-level features, S = sum(H_l*W_l).
        spatial_shapes: (H_l, W_l) per level.
        sampling_locations: (B, Lq, H, L, P, 2) normalized (x, y) in [0,1].
        attention_weights: (B, Lq, H, L, P) softmax weights over L*P.
        gather_impl: 'auto' | 'xla' | 'mxu' for the quad-row path,
            'fused' / 'fusedq' for the single-kernel formulations, 'naive'
            for the direct 4-corner gather, 'flat' for the single-gather
            form. None = the selection (`resolve_impl`).

    Returns:
        (B, Lq, H * Dh) attended features.
    """
    if gather_impl is None:
        gather_impl = resolve_impl(
            sampling_locations.shape[1] * sampling_locations.shape[4])
    whole_core = {"naive": ms_deform_attn_core_naive,
                  "flat": ms_deform_attn_core_flat,
                  "fused": ms_deform_attn_core_fused,
                  "fusedq": ms_deform_attn_core_quadfused}.get(gather_impl)
    if whole_core is not None:
        return whole_core(value, spatial_shapes, sampling_locations,
                          attention_weights)
    if gather_impl not in _QUAD_ROW_IMPLS:
        raise ValueError(f"unknown gather impl {gather_impl!r}")
    B, S, H, Dh = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    if L != len(spatial_shapes):
        raise ValueError("levels mismatch")

    offs = _level_offsets(spatial_shapes)
    vt = value.transpose(1, 2).reshape(B * H, S, Dh)
    out = None
    for lvl, base, w4 in _quad_bases_and_weights(
            spatial_shapes, sampling_locations, attention_weights,
            value.dtype):
        Hl, Wl = spatial_shapes[lvl]
        quad = _quad_rows(vt[:, offs[lvl]:offs[lvl] + Hl * Wl], Wl)
        gi = base.transpose(1, 2).reshape(B * H, Lq * P)
        g = quad_gather(quad, gi).reshape(B * H, Lq, P * 4, Dh)
        w = w4.transpose(1, 2).reshape(B * H, Lq, P * 4, 1)
        lvl_out = (g * w).sum(dim=2)                     # (B*H, Lq, Dh)
        out = lvl_out if out is None else out + lvl_out
    return out.reshape(B, H, Lq, Dh).transpose(1, 2).reshape(B, Lq, H * Dh)


def _level_sample_core(value, spatial_shapes, sampling_locations,
                       attention_weights, quad: bool) -> torch.Tensor:
    """The two single-kernel formulations: per level one
    `fused_level_sample` over the raw slab or one `quadfused_level_sample`
    over its quad rows; the sums over levels and points stay outside the
    kernels, as in the JAX package."""
    B, S, H, Dh = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    if L != len(spatial_shapes):
        raise ValueError("levels mismatch")

    offs = _level_offsets(spatial_shapes)
    # heads fold into the kernel batch once, up front
    vt = value.transpose(1, 2).reshape(B * H, S, Dh)
    acc = None
    for lvl, base, w4 in _quad_bases_and_weights(
            spatial_shapes, sampling_locations, attention_weights,
            value.dtype):
        Hl, Wl = spatial_shapes[lvl]
        slab = vt[:, offs[lvl]:offs[lvl] + Hl * Wl]
        gi = base.transpose(1, 2).reshape(B * H, Lq * P)
        w = w4.transpose(1, 2).reshape(B * H, Lq * P, 4)
        if quad:
            lvl_out = quadfused_level_sample(_quad_rows(slab, Wl), gi, w)
        else:
            # strip the quad-row front pad: the raw top-left corner index
            lvl_out = fused_level_sample(slab, gi - (Wl + 1), w, Wl)
        acc = lvl_out if acc is None else acc + lvl_out
    out = acc.reshape(B, H, Lq, P, Dh).sum(dim=3)
    return out.transpose(1, 2).reshape(B, Lq, H * Dh)


def ms_deform_attn_core_fused(
    value: torch.Tensor,
    spatial_shapes: Shapes,
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """Single-kernel formulation over the RAW level slabs
    (`gather_impl='fused'`): same function as `ms_deform_attn_core`, with
    no quad-row packing and no gathered rows in device memory."""
    return _level_sample_core(value, spatial_shapes, sampling_locations,
                              attention_weights, quad=False)


def ms_deform_attn_core_quadfused(
    value: torch.Tensor,
    spatial_shapes: Shapes,
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """Quad-row formulation with gather, blend and corner sum in one
    kernel (`gather_impl='fusedq'`): the packing stays in PyTorch, the
    gathered rows never reach device memory."""
    return _level_sample_core(value, spatial_shapes, sampling_locations,
                              attention_weights, quad=True)


def ms_deform_attn_core_flat(
    value: torch.Tensor,
    spatial_shapes: Shapes,
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """Single-gather formulation for tiny query counts (`gather_impl=
    'flat'`): every (level, corner) index is made global into the
    flattened S dimension and all L*4*P samples of a query ride one
    `torch.gather` and one weighted sum against `value` in its own
    (B, S, H, Dh) layout. Plain tensor code on every device."""
    B, S, H, Dh = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    if L != len(spatial_shapes):
        raise ValueError("levels mismatch")

    idxs, ws = zip(*_corner_indices_and_weights(     # each (B, Lq, H, P)
        spatial_shapes, sampling_locations, attention_weights, value.dtype))
    K = 4 * L * P
    # (B, Lq, H, 4L, P) -> (B, Lq*4L*P, H): a per-head index on axis 1
    idx = torch.stack(idxs, dim=3).permute(0, 1, 3, 4, 2).reshape(
        B, Lq * K, H)
    w = torch.stack(ws, dim=3).permute(0, 1, 3, 4, 2).reshape(B, Lq * K, H)
    g = torch.gather(value, 1, idx[..., None].expand(-1, -1, -1, Dh))
    out = (g * w[..., None]).reshape(B, Lq, K, H, Dh).sum(dim=2)
    return out.reshape(B, Lq, H * Dh)


def quad_level_offsets(spatial_shapes: Shapes) -> Tuple[int, ...]:
    """Row offset of each level inside the flat quad slab.

    Level l occupies rows [off_l, off_l + (W_l+1) + H_l*W_l) — the
    `_quad_rows` layout (front pad F = W_l+1 included).
    """
    offs, start = [], 0
    for (h, w) in spatial_shapes:
        offs.append(start)
        start += (w + 1) + h * w
    return tuple(offs)


def precompute_quad_slab(value: torch.Tensor,
                         spatial_shapes: Shapes) -> torch.Tensor:
    """(B, S, H, Dh) projected value -> (B*H, S', 4*Dh) flat quad slab.

    Decode-time prepack: the encoder memory is frozen across the
    autoregressive loop, so its quad rows are packed ONCE and each decode
    step's MSDA is one gather from this slab (`..._prequad`).
    S' = sum over levels of (W_l+1) + H_l*W_l.
    """
    B, S, H, Dh = value.shape
    vt = value.transpose(1, 2).reshape(B * H, S, Dh)
    offs = _level_offsets(spatial_shapes)
    return torch.cat([_quad_rows(vt[:, offs[l]:offs[l] + Hl * Wl], Wl)
                      for l, (Hl, Wl) in enumerate(spatial_shapes)], dim=1)


def ms_deform_attn_core_prequad(
    quad_slab: torch.Tensor,
    spatial_shapes: Shapes,
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
    gather_impl: Optional[str] = None,
) -> torch.Tensor:
    """Decode-step core against a precomputed quad slab.

    Same function as `ms_deform_attn_core`, with the packing hoisted out
    (`precompute_quad_slab`) and all L*P samples of every (batch, head) in
    ONE gather.

    Args:
        quad_slab: (B*H, S', 4*Dh) from `precompute_quad_slab`.
        sampling_locations: (B, Lq, H, L, P, 2); attention_weights
            (B, Lq, H, L, P) as in `ms_deform_attn_core`.
        gather_impl: None = the selection (`resolve_impl`). A prequad
            site is a pure row gather from the packed slab, so only the
            quad-row names apply; any other name warns and uses the quad
            gather.
    """
    BH, _, C = quad_slab.shape
    Dh = C // 4
    B, Lq, H, L, P, _ = sampling_locations.shape
    if BH != B * H or L != len(spatial_shapes):
        raise ValueError("quad slab does not match the sampling shapes")
    if gather_impl is None:
        gather_impl = resolve_impl(Lq * L * P)
    if gather_impl not in _QUAD_ROW_IMPLS:
        # 'naive', 'flat', 'fused' and 'fusedq' are whole-core formulations
        # that need the unpacked (B, S, H, Dh) value; say so instead of
        # silently measuring the quad gather
        warnings.warn(
            f"CAPE_MSDA gather impl {gather_impl!r} is not available at "
            "prequad decode sites (only the quad-row gather); using it. "
            "Set CAPE_DECODE_PREQUAD=0 to run other formulations in the "
            "decode step.", stacklevel=2)

    qoffs = quad_level_offsets(spatial_shapes)
    bases, weights = [], []
    for lvl, base, w4 in _quad_bases_and_weights(
            spatial_shapes, sampling_locations, attention_weights,
            quad_slab.dtype):
        bases.append(base + qoffs[lvl])   # (B, Lq, H, P) global rows
        weights.append(w4)                # (B, Lq, H, P, 4)
    gi = torch.stack(bases, dim=3)        # (B, Lq, H, L, P)
    gi = gi.movedim(2, 1).reshape(B * H, Lq * L * P).to(torch.int32)
    w = torch.stack(weights, dim=3)       # (B, Lq, H, L, P, 4)
    w = w.movedim(2, 1).reshape(B * H, Lq, L * P * 4, 1)
    g = quad_gather(quad_slab, gi).reshape(B * H, Lq, L * P * 4, Dh)
    out = (g * w).sum(dim=2)              # (B*H, Lq, Dh)
    return out.reshape(B, H, Lq, Dh).transpose(1, 2).reshape(B, Lq, H * Dh)


def _corner_indices_and_weights(
        spatial_shapes: Shapes, sampling_locations: torch.Tensor,
        attention_weights: torch.Tensor,
        dtype: torch.dtype) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Per (level, bilinear corner), in that order: the clipped row index
    into the flattened S dimension, (B, Lq, H, P) int64, and the bilinear
    * attention weight, zeroed where the unclipped corner is out of
    bounds."""
    level_start = 0
    for lvl, (Hl, Wl) in enumerate(spatial_shapes):
        loc = sampling_locations[:, :, :, lvl]
        w_attn = attention_weights[:, :, :, lvl]
        x = loc[..., 0] * Wl - 0.5
        y = loc[..., 1] * Hl - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fx = (x - x0).to(dtype)
        fy = (y - y0).to(dtype)
        x0i = x0.to(torch.int64)
        y0i = y0.to(torch.int64)
        for dxi, dyi, wgt in (
            (0, 0, (1 - fx) * (1 - fy)),
            (1, 0, fx * (1 - fy)),
            (0, 1, (1 - fx) * fy),
            (1, 1, fx * fy),
        ):
            cx = x0i + dxi
            cy = y0i + dyi
            valid = (cx >= 0) & (cx < Wl) & (cy >= 0) & (cy < Hl)
            idx = level_start + cy.clamp(0, Hl - 1) * Wl + cx.clamp(0, Wl - 1)
            yield idx, (wgt * valid.to(dtype) * w_attn).to(dtype)
        level_start += Hl * Wl


def ms_deform_attn_core_naive(
    value: torch.Tensor,
    spatial_shapes: Shapes,
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """Direct 4-corner-gather formulation — the numerical oracle of the
    tests (one narrow gather per bilinear corner)."""
    B, S, H, Dh = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    if L != len(spatial_shapes):
        raise ValueError("levels mismatch")

    value_bh = value.transpose(1, 2)                       # (B, H, S, Dh)
    out = torch.zeros((B, H, Lq, Dh), dtype=value.dtype, device=value.device)
    for idx, w in _corner_indices_and_weights(
            spatial_shapes, sampling_locations, attention_weights,
            value.dtype):
        idx_bh = idx.transpose(1, 2).reshape(B, H, Lq * P, 1)
        gathered = torch.gather(value_bh, 2, idx_bh.expand(-1, -1, -1, Dh))
        w_bh = w.transpose(1, 2).reshape(B, H, Lq * P, 1)
        out = out + (gathered * w_bh).reshape(B, H, Lq, P, Dh).sum(dim=3)
    return out.transpose(1, 2).reshape(B, Lq, H * Dh)


class _MSDeformAttnWholeOp(torch.autograd.Function):
    """The whole op: `msda_forward` forward, `msda_backward` backward (one
    kernel each on the card). Saves only the value, the locations and the
    weights: nothing of the (rows x 4 * Dh) gathered rows of the quad-row
    core reaches device memory."""

    @staticmethod
    def forward(ctx, value, sampling_locations, attention_weights,
                spatial_shapes):
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        ctx.spatial_shapes = spatial_shapes
        return msda_forward(value, spatial_shapes, sampling_locations,
                            attention_weights)

    @staticmethod
    def backward(ctx, grad_out):
        need = ctx.needs_input_grad[:3]
        if not any(need):
            return None, None, None, None
        value, loc, attn = ctx.saved_tensors
        grads = msda_backward(value, ctx.spatial_shapes, loc, attn,
                              grad_out.to(value.dtype).contiguous())
        return tuple(g if n else None for g, n in zip(grads, need)) + (None,)


def _whole_op_route(value, sampling_locations, attention_weights) -> bool:
    """Whether a call without `use_pallas` takes the whole-op function:
    autograd records it (grad mode on and an input that requires grad),
    the selection resolves to 'auto' (`resolve_impl`), and the
    kernels take its shapes and dtypes (the same answer on every
    device)."""
    if not (torch.is_grad_enabled() and any(
            t.requires_grad for t in (value, sampling_locations,
                                      attention_weights))):
        return False
    B, S, H, Dh = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    if resolve_impl(Lq * P) != "auto" \
            or value.dtype not in (torch.float32, torch.bfloat16) \
            or attention_weights.dtype != value.dtype \
            or sampling_locations.dtype != torch.float32:
        return False
    try:
        msda_plan(B, S, Lq, H, Dh, L, value.element_size())
    except ValueError:
        return False
    return True


def ms_deform_attn(value, spatial_shapes, sampling_locations,
                   attention_weights, use_pallas: bool = False):
    """Backend dispatch; every route computes the same function (the
    module's route table). The whole op, counted by the `msda.whole_op`
    trace counter, takes the call with `use_pallas=True` and where
    `_whole_op_route` says so: there the quad-row core's saved gathered
    rows and the backward of its blend are the cost. Every other call is
    `ms_deform_attn_core` in the selected formulation."""
    if not (use_pallas or _whole_op_route(value, sampling_locations,
                                          attention_weights)):
        return ms_deform_attn_core(
            value, spatial_shapes, sampling_locations, attention_weights)
    trace.count("msda.whole_op")
    shapes = tuple(tuple(s) for s in spatial_shapes)
    return _MSDeformAttnWholeOp.apply(value, sampling_locations,
                                      attention_weights, shapes)
