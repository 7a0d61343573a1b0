"""Row gather of quad rows: the port of `cape_tpu.ops.gather_mxu`.

`quad_gather(quad, gi)` computes `out[b, i, :] = quad[b, gi[b, i], :]`,
with zeros where `gi[b, i]` lies outside `[0, n)` (the one-hot semantics
of the TPU kernel: an index with no hit selects nothing).

- CUDA tensors: the hand-written kernel `csrc/gather.cu`, which replaces
  the Pallas `_gather_fwd_kernel` (`cape_tpu/ops/gather_mxu.py:57`). It is
  bound by bytes (2*B*N*C*elt + 4*B*N) and moves each row as coalesced
  16-byte vectors; see the source for the design.
- CPU tensors: `quad_gather_plain`, the same function in plain PyTorch.

`quad_gather.launches` counts kernel launches (never plain calls), so a run
can show that the main path went through the kernel. The backward
(`_scatter_bwd_kernel`) waits for the training slice.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build


def quad_gather_plain(quad: torch.Tensor, gi: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: clamped `torch.gather` plus the zero fill."""
    B, n, C = quad.shape
    valid = (gi >= 0) & (gi < n)
    idx = gi.clamp(0, n - 1).long()[..., None].expand(-1, -1, C)
    g = torch.gather(quad, 1, idx)
    return torch.where(valid[..., None], g, torch.zeros((), dtype=quad.dtype,
                                                        device=quad.device))


def _lib() -> ctypes.CDLL:
    lib = _build.load("gather")
    fn = lib.quad_gather_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(quad: torch.Tensor, gi: torch.Tensor) -> None:
    if quad.dim() != 3 or gi.dim() != 2 or gi.shape[0] != quad.shape[0]:
        raise ValueError(f"quad_gather: quad (B, n, C) and gi (B, N) "
                         f"expected, got {tuple(quad.shape)} and "
                         f"{tuple(gi.shape)}")
    if gi.dtype != torch.int32:
        raise TypeError(f"quad_gather: gi must be int32, got {gi.dtype}")
    if gi.device != quad.device:
        raise ValueError("quad_gather: quad and gi on different devices")


def quad_gather(quad: torch.Tensor, gi: torch.Tensor) -> torch.Tensor:
    """Gather rows `gi` (B, N) int32 from `quad` (B, n, C) -> (B, N, C)."""
    _check(quad, gi)
    if quad.device.type == "cpu":
        return quad_gather_plain(quad, gi)
    if quad.device.type != "cuda":
        raise ValueError(f"quad_gather: unsupported device {quad.device}")
    B, n, C = quad.shape
    N = gi.shape[1]
    row_bytes = C * quad.element_size()
    quad = quad.contiguous()
    gi = gi.contiguous()
    if row_bytes % 16 or quad.data_ptr() % 16:
        raise ValueError(f"quad_gather kernel: rows of {row_bytes} bytes "
                         "must be a 16-byte multiple on a 16-byte boundary")
    if quad.device.index != torch.cuda.current_device():
        raise ValueError("kernel inputs must be on the current CUDA device")
    out = torch.empty((B, N, C), dtype=quad.dtype, device=quad.device)
    err = _lib().quad_gather_launch(quad.data_ptr(), gi.data_ptr(),
                                    out.data_ptr(), B, n, N, row_bytes,
                                    torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"quad_gather kernel launch failed: CUDA error "
                           f"{err}")
    quad_gather.launches += 1
    return out


quad_gather.launches = 0
