"""Whole-op MSDA forward: the port of `cape_tpu.ops.msda_pallas`.

`ms_deform_attn_pallas` prepares, in PyTorch, the same clipped flat corner
indices, bilinear x attention weights and validity mask as the Pallas path
(`cape_tpu/ops/msda_pallas.py:89-123`), then `msda_forward` does the
gather and the weighted sum over the K4 = L*P*4 corners of every
(batch*head, query):

- CUDA tensors: the hand-written kernel `csrc/msda.cu`, which replaces the
  Pallas `_msda_kernel` (`cape_tpu/ops/msda_pallas.py:48`). It is bound by
  the bytes of the prepared idx/w/valid (12 bytes a corner); one warp per
  (bh, query) with lanes over Dh; see the source for the design.
- CPU tensors: `msda_forward_plain`, the same function in plain PyTorch.

This module is the forward only; `ops.msda.ms_deform_attn(use_pallas=True)`
wraps it in an autograd function whose backward is the quad-row core's
VJP, as the JAX package does. `msda_forward.launches` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def msda_forward_plain(value_bh: torch.Tensor, idx: torch.Tensor,
                       w: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (BH, S, Dh) value, (BH, Lq, K4) idx/w/valid
    -> (BH, Lq, Dh), summed in fp32 and returned in the value dtype."""
    BH, S, Dh = value_bh.shape
    _, Lq, K4 = idx.shape
    g = torch.gather(value_bh, 1,
                     idx.reshape(BH, Lq * K4, 1).long().expand(-1, -1, Dh))
    wv = (w * valid).reshape(BH, Lq, K4, 1)
    out = (g.reshape(BH, Lq, K4, Dh).float() * wv).sum(dim=2)
    return out.to(value_bh.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("msda")
    fn = lib.msda_forward_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def msda_forward(value_bh: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """sum_k w*valid*value[idx] per (bh, query): kernel on CUDA, plain on CPU."""
    BH, S, Dh = value_bh.shape
    if idx.dim() != 3 or idx.shape[0] != BH or w.shape != idx.shape \
            or valid.shape != idx.shape:
        raise ValueError(f"msda_forward: value (BH, S, Dh) and idx/w/valid "
                         f"(BH, Lq, K4) expected, got {tuple(value_bh.shape)}"
                         f", {tuple(idx.shape)}, {tuple(w.shape)}, "
                         f"{tuple(valid.shape)}")
    if idx.dtype != torch.int32 or w.dtype != torch.float32 \
            or valid.dtype != torch.float32:
        raise TypeError("msda_forward: idx int32, w and valid float32")
    if value_bh.device.type == "cpu":
        return msda_forward_plain(value_bh, idx, w, valid)
    if value_bh.device.type != "cuda":
        raise ValueError(f"msda_forward: unsupported device {value_bh.device}")
    if value_bh.dtype not in _DTYPE_CODE:
        raise TypeError(f"msda_forward kernel: value dtype {value_bh.dtype} "
                        "(float32 or bfloat16 only)")
    value_bh, idx, w, valid = (t.contiguous() for t in (value_bh, idx, w,
                                                        valid))
    Lq, K4 = idx.shape[1], idx.shape[2]
    if value_bh.device.index != torch.cuda.current_device():
        raise ValueError("kernel inputs must be on the current CUDA device")
    out = torch.empty((BH, Lq, Dh), dtype=value_bh.dtype,
                      device=value_bh.device)
    err = _lib().msda_forward_launch(
        value_bh.data_ptr(), idx.data_ptr(), w.data_ptr(), valid.data_ptr(),
        out.data_ptr(), BH, S, Lq, K4, Dh, _DTYPE_CODE[value_bh.dtype],
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"msda_forward kernel launch failed: CUDA error "
                           f"{err}")
    msda_forward.launches += 1
    return out


msda_forward.launches = 0


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


def ms_deform_attn_pallas(
    value: torch.Tensor,                    # (B, S, H, Dh)
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,       # (B, Lq, H, L, P, 2)
    attention_weights: torch.Tensor,        # (B, Lq, H, L, P)
) -> torch.Tensor:
    """Whole-op MSDA forward -> (B, Lq, H*Dh); same function as
    `ops.msda.ms_deform_attn_core`."""
    B, S, H, Dh = value.shape
    Lq = sampling_locations.shape[1]
    idx, w, valid = prepare_corners(spatial_shapes, sampling_locations,
                                    attention_weights)
    value_bh = value.transpose(1, 2).reshape(B * H, S, Dh)
    out = msda_forward(value_bh, idx, w, valid)
    return out.reshape(B, H, Lq, Dh).transpose(1, 2).reshape(B, Lq, H * Dh)
