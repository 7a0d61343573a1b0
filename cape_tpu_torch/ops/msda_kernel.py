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

This module is the forward only; `ops.msda.ms_deform_attn(use_pallas=True)`
wraps it in an autograd function whose backward is the quad-row core's
VJP, as the JAX package does. `msda_forward.launches` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import torch

from . import _build

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
