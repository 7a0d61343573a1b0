"""Whole-op MSDA forward: the port of `cape_tpu.ops.msda_pallas`.

`msda_forward(value, spatial_shapes, sampling_locations, attention_weights)`
computes the function of `ms_deform_attn_pallas`
(`cape_tpu/ops/msda_pallas.py:76-153`): for every (batch, query, head) the
attention-weighted sum, over levels, points and the four bilinear corners
(grid_sample's `align_corners=False` zeros padding), of the value rows:

- CUDA tensors: the hand-written kernel `csrc/msda.cu`, which replaces the
  Pallas `_msda_kernel` (`cape_tpu/ops/msda_pallas.py:48`). One launch goes
  from the sampling locations to the output: the corners are computed in
  the kernel, the value is read in its `(B, S, H, Dh)` layout and the
  output written as `(B, Lq, H*Dh)`. It is bound by bytes; see the source
  for the design. Its launch geometry is `msda_plan` (pure Python).
- CPU tensors: `msda_forward_plain`, the same function in plain PyTorch:
  `prepare_corners` (the clipped flat corner rows, bilinear x attention
  weights and validity mask of `msda_pallas.py:89-123`) followed by a
  gather and a weighted sum in fp32.

`msda_backward(value, spatial_shapes, sampling_locations,
attention_weights, grad_out)` gives the op's three gradients
`(grad_value, grad_loc, grad_attn)`:

- CUDA tensors: the hand-written kernel `csrc/msda_bwd.cu`, one launch
  that recomputes the corners as the forward does and writes the three
  gradients once (grad_value summed by the owner of each value row on the
  row lists of `csrc/rowlist.cuh`: the same bits every run). It replaces
  no Pallas kernel: the JAX package differentiates its quad-row core. It
  is bound by bytes; see the source for the design. Its launch is
  `msda_bwd_plan` (pure Python).
- CPU tensors: `msda_backward_plain`, the explicit formula in plain
  PyTorch (fp32, a masked `index_add_` for the value), the one the kernel
  is held against on the card.

`ops.msda.ms_deform_attn` pairs the two in one autograd function.
`msda_forward.launches` and `msda_backward.launches` count kernel
launches (never plain calls).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import torch

from . import _build
from .gather import SHARED_PER_BLOCK, _SHARED_TWO_BLOCKS
from .msda_fused import _ENTRIES_PER_GROUP, _list_bytes

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: levels the kernel's level table holds (`kMaxLevels` in `csrc/msda.cu`)
MAX_LEVELS = 8
#: bytes a lane of the kernel holds of an output row
LANE_BYTES = 16
#: the most threads of a block (`kThreads` in `csrc/msda.cu`), and the
#: fewest blocks a launch should have (two an SM of the H100's 132) before
#: the plan takes smaller blocks
_THREADS = 256
_FILL_BLOCKS = 2 * 132


def prepare_corners(
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,       # (B, Lq, H, L, P, 2)
    attention_weights: torch.Tensor,        # (B, Lq, H, L, P)
):
    """Flat clipped corner rows, bilinear x attention weights and the 0/1
    in-bounds mask, each (B*H, Lq, K4) — `msda_pallas.py:89-123`."""
    B, Lq, H, L, P, _ = sampling_locations.shape
    idx_parts, w_parts, v_parts = [], [], []
    level_start = 0
    for lvl, (Hl, Wl) in enumerate(spatial_shapes):
        loc = sampling_locations[:, :, :, lvl]            # (B, Lq, H, P, 2)
        wa = attention_weights[:, :, :, lvl]              # (B, Lq, H, P)
        x = loc[..., 0] * Wl - 0.5
        y = loc[..., 1] * Hl - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fx = x - x0
        fy = y - y0
        x0i = x0.to(torch.int32)
        y0i = y0.to(torch.int32)
        for dxi, dyi, wgt in ((0, 0, (1 - fx) * (1 - fy)),
                              (1, 0, fx * (1 - fy)),
                              (0, 1, (1 - fx) * fy),
                              (1, 1, fx * fy)):
            cx = x0i + dxi
            cy = y0i + dyi
            ok = (cx >= 0) & (cx < Wl) & (cy >= 0) & (cy < Hl)
            idx_parts.append(level_start + cy.clamp(0, Hl - 1) * Wl
                             + cx.clamp(0, Wl - 1))
            w_parts.append(wgt * wa)
            v_parts.append(ok.to(torch.float32))
        level_start += Hl * Wl

    K4 = L * P * 4

    def bh(parts, dtype):
        x = torch.stack(parts, dim=-1).reshape(B, Lq, H, K4)
        return x.transpose(1, 2).reshape(B * H, Lq, K4).to(dtype)

    return (bh(idx_parts, torch.int32), bh(w_parts, torch.float32),
            bh(v_parts, torch.float32))


def msda_forward_plain(value: torch.Tensor,
                       spatial_shapes: Sequence[Tuple[int, int]],
                       sampling_locations: torch.Tensor,
                       attention_weights: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `msda_forward`: the prepared corners, a
    gather of their value rows and the weighted sum in fp32, returned in
    the value's dtype."""
    B, S, H, Dh = value.shape
    Lq = sampling_locations.shape[1]
    idx, w, valid = prepare_corners(spatial_shapes, sampling_locations,
                                    attention_weights)
    K4 = idx.shape[-1]
    value_bh = value.transpose(1, 2).reshape(B * H, S, Dh)
    g = torch.gather(value_bh, 1,
                     idx.reshape(B * H, Lq * K4, 1).long().expand(-1, -1, Dh))
    wv = (w * valid).reshape(B * H, Lq, K4, 1)
    out = (g.reshape(B * H, Lq, K4, Dh).float() * wv).sum(dim=2)
    return out.to(value.dtype).reshape(B, H, Lq, Dh).transpose(1, 2).reshape(
        B, Lq, H * Dh)


class MsdaPlan(NamedTuple):
    """The launch of `csrc/msda.cu`: lane t of the grid owns the 16-byte
    unit t of the `(B, Lq, H*Dh)` output, that is unit `t % lanes_per_head`
    of head `t // lanes_per_head % H` of query `t // lanes_per_query`;
    `blocks` blocks of `threads` threads cover the `lanes` lanes."""
    lanes_per_head: int
    lanes_per_query: int
    lanes: int
    threads: int
    blocks: int


@functools.lru_cache(maxsize=64)
def msda_plan(B: int, S: int, Lq: int, H: int, Dh: int, L: int,
              elt: int) -> MsdaPlan:
    """The kernel's launch for B batches of Lq queries, H heads of Dh
    values in `elt`-byte elements (4 fp32, 2 bf16), S value rows over L
    levels. Blocks of 256 threads, halved (down to 64) while the launch
    would have fewer than two blocks an SM. Raises ValueError for a shape
    the kernel does not take: a head whose Dh values are not a power of two
    of 16-byte units up to 32 (the lanes of a head share a warp), more
    than `MAX_LEVELS` levels, or offsets past 32 bits."""
    if elt not in (2, 4):
        raise ValueError(f"msda_forward kernel: {elt}-byte elements "
                         "(float32 or bfloat16 only)")
    if not 1 <= L <= MAX_LEVELS:
        raise ValueError(f"msda_forward kernel: {L} levels (1 to "
                         f"{MAX_LEVELS})")
    G = Dh * elt // LANE_BYTES
    if Dh < 1 or Dh * elt % LANE_BYTES or G & (G - 1) or G > 32:
        raise ValueError(f"msda_forward kernel: a head of Dh = {Dh} values "
                         f"of {elt} bytes is not 1, 2, 4, ... or 32 "
                         f"{LANE_BYTES}-byte units")
    lanes = B * Lq * H * G
    if lanes + _THREADS > 2 ** 31 - 1 or S * H * G > 2 ** 31 - 1:
        raise ValueError(f"msda_forward kernel: B = {B}, S = {S}, Lq = {Lq},"
                         f" H * Dh = {H * Dh}: offsets past 32 bits")
    threads = _THREADS
    while threads > 64 and -(-lanes // threads) < _FILL_BLOCKS:
        threads //= 2
    return MsdaPlan(G, H * G, lanes, threads, -(-lanes // threads))


def _lib() -> ctypes.CDLL:
    lib = _build.load("msda")
    fn = lib.msda_forward_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_int)]
                       + [ctypes.c_int] * 9
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check(value, spatial_shapes, loc, attn) -> None:
    if value.dim() != 4 or loc.dim() != 6 or loc.shape[-1] != 2:
        raise ValueError(f"msda_forward: value (B, S, H, Dh) and sampling "
                         f"locations (B, Lq, H, L, P, 2) expected, got "
                         f"{tuple(value.shape)} and {tuple(loc.shape)}")
    B, S, H, _ = value.shape
    _, Lq, _, L, P, _ = loc.shape
    if loc.shape[0] != B or loc.shape[2] != H \
            or attn.shape != (B, Lq, H, L, P):
        raise ValueError(f"msda_forward: value {tuple(value.shape)}, "
                         f"locations {tuple(loc.shape)} and attention "
                         f"weights {tuple(attn.shape)} do not agree")
    if len(spatial_shapes) != L \
            or sum(h * w for h, w in spatial_shapes) > S:
        raise ValueError(f"msda_forward: levels {list(spatial_shapes)} are "
                         f"not {L} levels within {S} value rows")
    if loc.dtype != torch.float32:
        raise TypeError(f"msda_forward: sampling locations must be float32,"
                        f" got {loc.dtype}")
    if attn.dtype != value.dtype:
        raise TypeError(f"msda_forward: attention weights are {attn.dtype}, "
                        f"the value {value.dtype}")
    if loc.device != value.device or attn.device != value.device:
        raise ValueError("msda_forward: value, locations and attention "
                         "weights on different devices")


def msda_forward(value: torch.Tensor,
                 spatial_shapes: Sequence[Tuple[int, int]],
                 sampling_locations: torch.Tensor,
                 attention_weights: torch.Tensor) -> torch.Tensor:
    """Whole-op MSDA forward: kernel on CUDA, plain on CPU.

    Args:
        value: (B, S, H, Dh), the layout `project_value` returns.
        spatial_shapes: the L levels' (H_l, W_l), level l starting at
            the sum of the cells before it (at most S cells in all).
        sampling_locations: (B, Lq, H, L, P, 2) fp32, normalised (x, y).
        attention_weights: (B, Lq, H, L, P) in the value's dtype.

    Returns:
        (B, Lq, H*Dh) in the value's dtype, summed in fp32.
    """
    _check(value, spatial_shapes, sampling_locations, attention_weights)
    if value.device.type == "cpu":
        return msda_forward_plain(value, spatial_shapes, sampling_locations,
                                  attention_weights)
    if value.device.type != "cuda":
        raise ValueError(f"msda_forward: unsupported device {value.device}")
    if value.dtype not in _DTYPE_CODE:
        raise TypeError(f"msda_forward kernel: value dtype {value.dtype} "
                        "(float32 or bfloat16 only)")
    if value.device.index != torch.cuda.current_device():
        raise ValueError("kernel inputs must be on the current CUDA device")
    B, S, H, Dh = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    levels = [(int(h), int(w)) for h, w in spatial_shapes]
    plan = msda_plan(B, S, Lq, H, Dh, L, value.element_size())
    value, loc, attn = (t.contiguous() for t in (
        value, sampling_locations, attention_weights))
    out = torch.empty((B, Lq, H * Dh), dtype=value.dtype, device=value.device)
    if value.data_ptr() % 16 or loc.data_ptr() % 8:
        raise ValueError("msda_forward kernel: the value must lie on a "
                         "16-byte boundary and the locations on an 8-byte "
                         "one")
    shapes = (ctypes.c_int * (2 * L))(*(n for hw in levels for n in hw))
    err = _lib().msda_forward_launch(
        value.data_ptr(), loc.data_ptr(), attn.data_ptr(), out.data_ptr(),
        shapes, B, S, Lq, H, L, P, Dh, plan.lanes_per_head, plan.threads,
        plan.blocks, _DTYPE_CODE[value.dtype],
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"msda_forward kernel launch failed: CUDA error "
                           f"{err}")
    msda_forward.launches += 1
    return out


msda_forward.launches = 0


def ms_deform_attn_pallas(
    value: torch.Tensor,                    # (B, S, H, Dh)
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,       # (B, Lq, H, L, P, 2)
    attention_weights: torch.Tensor,        # (B, Lq, H, L, P)
) -> torch.Tensor:
    """Whole-op MSDA forward -> (B, Lq, H*Dh); same function as
    `ops.msda.ms_deform_attn_core`. On the card one kernel launch."""
    return msda_forward(value, spatial_shapes, sampling_locations,
                        attention_weights)


# -- the backward -----------------------------------------------------------
def msda_backward_plain(value: torch.Tensor,
                        spatial_shapes: Sequence[Tuple[int, int]],
                        sampling_locations: torch.Tensor,
                        attention_weights: torch.Tensor,
                        grad_out: torch.Tensor):
    """Plain PyTorch version of `msda_backward`: the gradients of the
    forward's function for the cotangent `grad_out` (B, Lq, H*Dh), by the
    explicit formula in fp32 (not autograd), each rounded once to its
    input's dtype. `floor` passes no gradient and a corner outside its
    level adds nothing."""
    B, S, H, Dh = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    v = value.float().transpose(1, 2).reshape(B * H, S, Dh)
    go = grad_out.float().reshape(B, Lq, H, Dh).transpose(1, 2).reshape(
        B * H, Lq, 1, Dh)
    a = attention_weights.float()
    grad_value = torch.zeros((B * H * S, Dh), dtype=torch.float32,
                             device=value.device)
    grad_attn = torch.zeros_like(a)
    grad_loc = torch.zeros_like(sampling_locations, dtype=torch.float32)
    slab = (torch.arange(B * H, device=value.device) * S)[:, None]

    def bh(t):                                   # (B, Lq, H, P) -> (BH, Lq*P)
        return t.transpose(1, 2).reshape(B * H, Lq * P)

    level_start = 0
    for lvl, (Hl, Wl) in enumerate(spatial_shapes):
        loc = sampling_locations[:, :, :, lvl].float()    # (B, Lq, H, P, 2)
        wa = a[:, :, :, lvl]
        x = loc[..., 0] * Wl - 0.5
        y = loc[..., 1] * Hl - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fx = x - x0
        fy = y - y0
        gx = 1 - fx
        gy = 1 - fy
        x0i = x0.to(torch.int64)
        y0i = y0.to(torch.int64)
        g_attn = g_x = g_y = 0
        for dxi, dyi, bil, dfx, dfy in ((0, 0, gx * gy, -gy, -gx),
                                        (1, 0, fx * gy, gy, -fx),
                                        (0, 1, gx * fy, -fy, gx),
                                        (1, 1, fx * fy, fy, fx)):
            cx = x0i + dxi
            cy = y0i + dyi
            ok = (cx >= 0) & (cx < Wl) & (cy >= 0) & (cy < Hl)
            idx = bh(level_start + cy.clamp(0, Hl - 1) * Wl
                     + cx.clamp(0, Wl - 1))
            rows = torch.gather(v, 1, idx[..., None].expand(-1, -1, Dh))
            dot = (rows.reshape(B * H, Lq, P, Dh) * go).sum(-1)
            dot = dot.reshape(B, H, Lq, P).transpose(1, 2) * ok
            g_attn = g_attn + bil * dot
            g_x = g_x + dfx * dot
            g_y = g_y + dfy * dot
            w = bh(bil * wa * ok).reshape(B * H, Lq, P, 1)
            keep = bh(ok).reshape(-1)
            grad_value.index_add_(
                0, (slab + idx).reshape(-1)[keep],
                (w * go).reshape(-1, Dh)[keep])
        grad_attn[:, :, :, lvl] = g_attn
        grad_loc[:, :, :, lvl, :, 0] = wa * Wl * g_x
        grad_loc[:, :, :, lvl, :, 1] = wa * Hl * g_y
        level_start += Hl * Wl
    grad_value = grad_value.reshape(B, H, S, Dh).transpose(1, 2)
    return (grad_value.to(value.dtype).contiguous(), grad_loc,
            grad_attn.to(attention_weights.dtype))


#: threads of a block of `csrc/msda_bwd.cu` (`kThreads`)
_BWD_THREADS = 256
#: the most entries a value-row block lists in one pass (more take passes
#: through an fp32 tile in shared memory)
_BWD_MAX_CAP = 24_576
#: corners a value-row block should take in all (the tiling's target),
#: and the most rows a tile should have (so that a site of few entries,
#: the teacher-forced decoder's, still has blocks enough to fill the card)
BWD_CORNERS_PER_BLOCK = 24_576
BWD_MAX_ROWS = 512


class MsdaBwdPlan(NamedTuple):
    """The launch of `csrc/msda_bwd.cu`: `G` lanes a head; value-row
    blocks, per level, `tiling[3 l]` rows a tile, `tiling[3 l + 1]` tiles
    a (batch, head) slab and `tiling[3 l + 2]` groups of G lanes a row;
    each lists up to `cap` entries a pass, through an fp32 tile in shared
    memory where `use_tile`; `smem_bytes` of shared memory a block (the
    most any level needs); then `point_blocks` blocks of the point role;
    `threads` a block."""
    G: int
    tiling: Tuple[int, ...]
    cap: int
    use_tile: int
    threads: int
    smem_bytes: int
    point_blocks: int


@functools.lru_cache(maxsize=64)
def msda_bwd_plan(B: int, Lq: int, H: int, Dh: int, P: int,
                  levels: Tuple[Tuple[int, int], ...],
                  elt: int) -> MsdaBwdPlan:
    """The backward's launch for B batches of Lq queries, H heads of Dh
    values in `elt`-byte elements, P points at each of the `levels`.

    A level's rows get, from their expected corners (4 * Lq * P / HW a
    row), the groups of lanes a row as `sample_bwd_plan` gives them, and
    tiles of about `BWD_CORNERS_PER_BLOCK` corners and at most
    `BWD_MAX_ROWS` rows, never fewer rows than give each warp of the block
    a row; shorter where the lists and the halo (W_l + 1 cells) must fit
    shared memory. Every tile scans all of its level's entries, so fewer,
    longer tiles scan less and walk longer lists. Raises ValueError for a
    shape the kernel does not take (as `msda_plan`)."""
    msda_plan(B, sum(h * w for h, w in levels), Lq, H, Dh, len(levels), elt)
    G = Dh * elt // LANE_BYTES
    N = Lq * P
    share = -(-N // 32) * 32
    cap = min(share, _BWD_MAX_CAP)
    use_tile = share > cap
    threads = _BWD_THREADS
    warps = threads // 32
    tiling, need = [], 0
    for Hl, Wl in levels:
        HW, halo = Hl * Wl, Wl + 1
        per_row = 4 * N / HW
        split = 1
        while split < 32 // G and 2 * split * _ENTRIES_PER_GROUP <= per_row:
            split *= 2
        teams = 32 // (G * split)          # rows a warp takes at a time
        rows = max(warps * teams,
                   -(-BWD_CORNERS_PER_BLOCK // max(1, int(per_row))))
        for budget in (_SHARED_TWO_BLOCKS, SHARED_PER_BLOCK):
            fit = (budget - _list_bytes(0, cap, Dh, use_tile, halo, threads)
                   - 14) // (warps * 2 + (4 * Dh if use_tile else 0))
            if fit >= 1:
                break
        if fit < 1 or halo >= 65_535 - 1:
            raise ValueError(f"msda_backward kernel: a level {Hl} x {Wl} "
                             f"with {N} entries does not fit a block")
        rows = min(rows, HW, fit, 65_534 - halo,
                   max(warps * teams, BWD_MAX_ROWS))
        tiles = -(-HW // rows)
        rows = -(-HW // tiles)               # evened out over the level
        tiles = -(-HW // rows)
        tiling += [rows, tiles, split]
        need = max(need, _list_bytes(rows, cap, Dh, use_tile, halo, threads))
    lanes = B * Lq * H * G
    return MsdaBwdPlan(G, tuple(tiling), cap, int(use_tile), threads, need,
                       -(-lanes // threads))


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("msda_bwd")
    fn = lib.msda_backward_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7
                       + [ctypes.POINTER(ctypes.c_int)] * 2
                       + [ctypes.c_int] * 14 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def msda_backward(value: torch.Tensor,
                  spatial_shapes: Sequence[Tuple[int, int]],
                  sampling_locations: torch.Tensor,
                  attention_weights: torch.Tensor,
                  grad_out: torch.Tensor):
    """Gradients of `msda_forward` for the cotangent `grad_out`
    (B, Lq, H*Dh): `(grad_value, grad_loc, grad_attn)` in the value's
    layout and dtype, fp32 and the weights' dtype, summed in fp32. Kernel
    on CUDA (one launch, on the current stream, no sync), plain on CPU."""
    _check(value, spatial_shapes, sampling_locations, attention_weights)
    B, S, H, Dh = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    if grad_out.shape != (B, Lq, H * Dh) or grad_out.dtype != value.dtype \
            or grad_out.device != value.device:
        raise ValueError(f"msda_backward: grad_out {tuple(grad_out.shape)} "
                         f"{grad_out.dtype} does not match the output")
    if value.device.type == "cpu":
        return msda_backward_plain(value, spatial_shapes, sampling_locations,
                                   attention_weights, grad_out)
    if value.device.type != "cuda":
        raise ValueError(f"msda_backward: unsupported device {value.device}")
    if value.dtype not in _DTYPE_CODE:
        raise TypeError(f"msda_backward kernel: value dtype {value.dtype} "
                        "(float32 or bfloat16 only)")
    if value.device.index != torch.cuda.current_device():
        raise ValueError("kernel inputs must be on the current CUDA device")
    levels = tuple((int(h), int(w)) for h, w in spatial_shapes)
    if B * Lq == 0:
        return (torch.zeros_like(value),
                torch.zeros_like(sampling_locations),
                torch.zeros_like(attention_weights))
    plan = msda_bwd_plan(B, Lq, H, Dh, P, levels, value.element_size())
    value, loc, attn, dout = (t.contiguous() for t in (
        value, sampling_locations, attention_weights, grad_out))
    grad_value = torch.empty_like(value)
    cells = sum(h * w for h, w in levels)
    if cells < S:
        grad_value[:, cells:].zero_()       # rows of no level
    grad_loc = torch.empty_like(loc)
    grad_attn = torch.empty_like(attn)
    for t in (value, dout, grad_value):
        if t.data_ptr() % 16:
            raise ValueError("msda_backward kernel: operands must lie on "
                             "16-byte boundaries")
    if loc.data_ptr() % 8:
        raise ValueError("msda_backward kernel: the locations must lie on "
                         "an 8-byte boundary")
    shapes = (ctypes.c_int * (2 * L))(*(n for hw in levels for n in hw))
    tiling = (ctypes.c_int * len(plan.tiling))(*plan.tiling)
    err = _bwd_lib().msda_backward_launch(
        value.data_ptr(), loc.data_ptr(), attn.data_ptr(), dout.data_ptr(),
        grad_value.data_ptr(), grad_loc.data_ptr(), grad_attn.data_ptr(),
        shapes, tiling, B, S, Lq, H, L, P, Dh, plan.G, plan.cap,
        plan.use_tile, plan.threads, plan.smem_bytes, plan.point_blocks,
        _DTYPE_CODE[value.dtype], torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"msda_backward kernel launch failed: CUDA error "
                           f"{err}")
    msda_backward.launches += 1
    return grad_value, grad_loc, grad_attn


msda_backward.launches = 0
