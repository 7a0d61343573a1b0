"""Row gather of quad rows and its backward: the port of
`cape_tpu.ops.gather_mxu`.

`quad_gather(quad, gi)` computes `out[b, i, :] = quad[b, gi[b, i], :]`,
with zeros where `gi[b, i]` lies outside `[0, n)` (the one-hot semantics
of the TPU kernel: an index with no hit selects nothing). It is a
`torch.autograd.Function`: the gradient to `quad` is the scatter-add
`quad_scatter(d_out, gi, n)`, accumulated in fp32 and cast to the slab's
dtype (`gather_mxu.py:151-152`); the indices get no gradient.

- CUDA tensors: the hand-written kernels `csrc/gather.cu`, which replaces
  the Pallas `_gather_fwd_kernel` (`cape_tpu/ops/gather_mxu.py:57`), and
  `csrc/scatter.cu`, which replaces `_scatter_bwd_kernel` (`:68`). Both
  are bound by bytes; see the sources for the designs.
- CPU tensors: `quad_gather_plain` and `quad_scatter_plain`, the same
  functions in plain PyTorch.

`quad_gather.launches` and `quad_scatter.launches` count kernel launches
(never plain calls), so a run can show that the main path went through the
kernels.

`default_gather_impl()` reads the process-wide MSDA formulation from
`CAPE_MSDA_GATHER`, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import os

import torch

from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def default_gather_impl() -> str:
    """The process-wide MSDA formulation (`CAPE_MSDA_GATHER`), read at
    every call: the counterpart of `cape_tpu/ops/gather_mxu.py:194-219`.

    'fused' | 'fusedq' | 'naive' | 'flat' select those formulations of
    `ops.msda.ms_deform_attn_core`. 'auto' (the default), 'xla' and 'mxu'
    all mean the quad-row path: the JAX package has two row gathers there
    (`take_along_axis` and the one-hot kernel), the port has one, and the
    tensor's device picks its kernel or its plain version. Sites with few
    gather rows are resolved in `ops.msda._resolve_impl_for_shape`.
    """
    choice = os.environ.get("CAPE_MSDA_GATHER", "auto").lower()
    if choice in ("auto", "xla", "mxu", "fused", "fusedq", "naive", "flat"):
        return choice
    raise ValueError(
        f"CAPE_MSDA_GATHER={choice!r}: expected 'xla', 'mxu', 'fused', "
        "'fusedq', 'naive', 'flat' or 'auto'"
    )


def quad_gather_plain(quad: torch.Tensor, gi: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: clamped `torch.gather` plus the zero fill."""
    B, n, C = quad.shape
    valid = (gi >= 0) & (gi < n)
    idx = gi.clamp(0, n - 1).long()[..., None].expand(-1, -1, C)
    g = torch.gather(quad, 1, idx)
    return torch.where(valid[..., None], g, torch.zeros((), dtype=quad.dtype,
                                                        device=quad.device))


def quad_scatter_plain(dg: torch.Tensor, gi: torch.Tensor,
                       n: int) -> torch.Tensor:
    """Plain PyTorch version: a masked `index_add_` into fp32, cast to the
    dtype of `dg`."""
    B, N, C = dg.shape
    valid = (gi >= 0) & (gi < n)
    rows = (torch.arange(B, device=gi.device)[:, None] * n + gi.long())[valid]
    out = torch.zeros((B * n, C), dtype=torch.float32, device=dg.device)
    out.index_add_(0, rows, dg[valid].float())
    return out.reshape(B, n, C).to(dg.dtype)


def _lib(name: str, fn_name: str, n_int: int) -> ctypes.CDLL:
    lib = _build.load(name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * n_int + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(rows: torch.Tensor, gi: torch.Tensor, what: str) -> None:
    if rows.dim() != 3 or gi.dim() != 2 or gi.shape[0] != rows.shape[0]:
        raise ValueError(f"{what}: rows (B, n|N, C) and gi (B, N) expected, "
                         f"got {tuple(rows.shape)} and {tuple(gi.shape)}")
    if gi.dtype != torch.int32:
        raise TypeError(f"{what}: gi must be int32, got {gi.dtype}")
    if gi.device != rows.device:
        raise ValueError(f"{what}: rows and gi on different devices")


def _kernel_inputs(rows: torch.Tensor, gi: torch.Tensor, what: str):
    """Contiguous kernel operands on the current CUDA device, 16-byte rows."""
    if rows.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {rows.device}")
    rows, gi = rows.contiguous(), gi.contiguous()
    row_bytes = rows.shape[2] * rows.element_size()
    if row_bytes % 16 or rows.data_ptr() % 16:
        raise ValueError(f"{what} kernel: rows of {row_bytes} bytes must be "
                         "a 16-byte multiple on a 16-byte boundary")
    if rows.device.index != torch.cuda.current_device():
        raise ValueError("kernel inputs must be on the current CUDA device")
    return rows, gi, row_bytes


def _gather(quad: torch.Tensor, gi: torch.Tensor) -> torch.Tensor:
    if quad.device.type == "cpu":
        return quad_gather_plain(quad, gi)
    quad, gi, row_bytes = _kernel_inputs(quad, gi, "quad_gather")
    B, n, C = quad.shape
    N = gi.shape[1]
    out = torch.empty((B, N, C), dtype=quad.dtype, device=quad.device)
    err = _lib("gather", "quad_gather_launch", 4).quad_gather_launch(
        quad.data_ptr(), gi.data_ptr(), out.data_ptr(), B, n, N, row_bytes,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"quad_gather kernel launch failed: CUDA error "
                           f"{err}")
    quad_gather.launches += 1
    return out


def quad_scatter(dg: torch.Tensor, gi: torch.Tensor, n: int) -> torch.Tensor:
    """Scatter-add rows `dg` (B, N, C) to `gi` (B, N) int32 -> (B, n, C)
    in the dtype of `dg`, summed in fp32; indices outside `[0, n)` add
    nothing. Kernel on CUDA, plain version on CPU."""
    _check(dg, gi, "quad_scatter")
    if gi.shape[1] != dg.shape[1]:
        raise ValueError(f"quad_scatter: dg has {dg.shape[1]} rows per "
                         f"slab, gi {gi.shape[1]} indices")
    if dg.device.type == "cpu":
        return quad_scatter_plain(dg, gi, n)
    if dg.dtype not in _DTYPE_CODE:
        raise TypeError(f"quad_scatter kernel: dtype {dg.dtype} "
                        "(float32 or bfloat16 only)")
    dg, gi, row_bytes = _kernel_inputs(dg, gi, "quad_scatter")
    B, N, C = dg.shape
    out = torch.zeros((B, n, C), dtype=torch.float32, device=dg.device)
    err = _lib("scatter", "quad_scatter_launch", 5).quad_scatter_launch(
        dg.data_ptr(), gi.data_ptr(), out.data_ptr(), B, n, N, row_bytes,
        _DTYPE_CODE[dg.dtype], torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"quad_scatter kernel launch failed: CUDA error "
                           f"{err}")
    quad_scatter.launches += 1
    return out.to(dg.dtype)


class _QuadGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, quad, gi):
        ctx.save_for_backward(gi)
        ctx.n = quad.shape[1]
        return _gather(quad, gi)

    @staticmethod
    def backward(ctx, d_out):
        if not ctx.needs_input_grad[0]:
            return None, None
        (gi,) = ctx.saved_tensors
        return quad_scatter(d_out, gi, ctx.n), None


def quad_gather(quad: torch.Tensor, gi: torch.Tensor) -> torch.Tensor:
    """Gather rows `gi` (B, N) int32 from `quad` (B, n, C) -> (B, N, C);
    differentiable in `quad`."""
    _check(quad, gi, "quad_gather")
    return _QuadGather.apply(quad, gi)


quad_gather.launches = 0
quad_scatter.launches = 0
