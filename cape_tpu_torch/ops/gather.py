"""Row gather of quad rows and its backward: the port of
`cape_tpu.ops.gather_mxu`.

`quad_gather(quad, gi)` computes `out[b, i, :] = quad[b, gi[b, i], :]`,
with zeros where `gi[b, i]` lies outside `[0, n)` (the one-hot semantics
of the TPU kernel: an index with no hit selects nothing). Its gradient to
`quad` is the scatter-add `quad_scatter(d_out, gi, n)`, accumulated in
fp32 and cast to the slab's dtype (`gather_mxu.py:151-152`); the indices
get no gradient.

- CUDA tensors: the hand-written kernels `csrc/gather.cu`, which replaces
  the Pallas `_gather_fwd_kernel` (`cape_tpu/ops/gather_mxu.py:57`), and
  `csrc/scatter.cu`, which replaces `_scatter_bwd_kernel` (`:68`). Both
  are bound by bytes; see the sources for the designs.
- CPU tensors: `quad_gather_plain` and `quad_scatter_plain`, the same
  functions in plain PyTorch.

A decode step on the chain of modules (every step the layer-step kernel
of `ops.decode_step` does not take) calls the gather once a layer on half
a megabyte, so the wrapper is written for many tiny launches. Where no
gradient can flow (`torch.no_grad()`, `torch.inference_mode()`, or a
`quad` that does not require one) `quad_gather` launches the kernel
directly; only otherwise does it go through the `torch.autograd.Function`
that records the scatter as its backward. The launch functions are
resolved once per process, operands are copied only if they are not
contiguous, and the launch goes to the current stream of the tensor's own
device (a tensor on another device than the current one is refused by the
CUDA runtime, and the wrapper raises).

The scatter's tiling is decided by `scatter_plan`, a pure function that the
CPU tests reach; the kernel is handed its result as plain ints.

`quad_gather.launches` and `quad_scatter.launches` count kernel launches
(never plain calls), so a run can show that the main path went through the
kernels.

`default_gather_impl()` reads the process-wide MSDA formulation from
`CAPE_MSDA_GATHER`, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple

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


#: ctypes launch functions, resolved at first use: name -> function
_launchers = {}


def _launcher(name: str, n_int: int):
    """`quad_<name>_launch` of `csrc/<name>.cu`: 3 pointers, `n_int` ints
    and the stream. Built and bound once per process."""
    fn = getattr(_build.load(name), f"quad_{name}_launch")
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * n_int + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _launchers[name] = fn
    return fn


def _check(rows: torch.Tensor, gi: torch.Tensor, what: str):
    """Raise on operands the functions do not take; returns the two shapes
    (read once: every attribute of a tensor costs the host a fraction of
    a microsecond, and a decode on the chain pays it once a layer and
    token)."""
    rs, gs = rows.shape, gi.shape
    if len(rs) != 3 or len(gs) != 2 or gs[0] != rs[0]:
        raise ValueError(f"{what}: rows (B, n|N, C) and gi (B, N) expected, "
                         f"got {tuple(rs)} and {tuple(gs)}")
    if gi.dtype is not torch.int32:
        raise TypeError(f"{what}: gi must be int32, got {gi.dtype}")
    # device ordinals (-1 on the CPU) are plain ints: cheaper to compare
    # than two `torch.device` objects
    if gi.get_device() != rows.get_device() or gi.is_cuda != rows.is_cuda:
        raise ValueError(f"{what}: rows and gi on different devices")
    return rs, gs


def _kernel_inputs(rows: torch.Tensor, gi: torch.Tensor, what: str):
    """Contiguous kernel operands with 16-byte rows: `(rows, gi, address
    of rows, row bytes, raw handle of their device's current stream)`."""
    if not rows.is_cuda:
        raise ValueError(f"{what}: unsupported device {rows.device}")
    if not rows.is_contiguous():
        rows = rows.contiguous()
    if not gi.is_contiguous():
        gi = gi.contiguous()
    row_bytes = rows.shape[2] * rows.element_size()
    ptr = rows.data_ptr()
    if row_bytes % 16 or ptr % 16:
        raise ValueError(f"{what} kernel: rows of {row_bytes} bytes must be "
                         "a 16-byte multiple on a 16-byte boundary")
    return rows, gi, ptr, row_bytes, torch._C._cuda_getCurrentRawStream(
        rows.get_device())


def _gather(quad: torch.Tensor, gi: torch.Tensor, shapes) -> torch.Tensor:
    if quad.is_cpu:
        return quad_gather_plain(quad, gi)
    quad, gi, ptr, row_bytes, stream = _kernel_inputs(quad, gi, "quad_gather")
    (B, n, C), (_, N) = shapes
    out = quad.new_empty((B, N, C))
    launch = _launchers.get("gather") or _launcher("gather", 4)
    err = launch(ptr, gi.data_ptr(), out.data_ptr(), B, n, N, row_bytes,
                 stream)
    if err:
        raise RuntimeError(f"quad_gather kernel launch failed: CUDA error "
                           f"{err}")
    quad_gather.launches += 1
    return out


#: what one block may use of an H100 SM's shared memory, and what is left
#: for each of two blocks that share an SM (1 KiB a block is the system's)
SHARED_PER_BLOCK = 232_448
_SHARED_TWO_BLOCKS = (228 * 1024) // 2 - 1024
#: the scatter's block; the blocks that fill the card's 132 SMs two to an
#: SM (a power of two, so that the usual 32 or 64 slabs divide it); the
#: fewest rows worth a tile (two per 16-lane group of the block) and the
#: most (their chain heads take 4 bytes each); the fewest indices worth a
#: block of their own; the most indices a block chains in one pass
_THREADS, _FULL_GRID = 512, 256
_MIN_ROWS, _MAX_ROWS, _MIN_SHARE, _MAX_CHAIN = 64, 4096, 512, 24_576


class ScatterPlan(NamedTuple):
    """How `csrc/scatter.cu` tiles one call: `tiles` tiles of
    `rows_per_tile` consecutive slab rows cover `[0, n)`; a cluster of
    `cluster` blocks of `threads` threads works on each tile, the N
    indices split among its blocks, each block chaining up to `chain`
    indices a pass to the tile's rows. `use_tile` is 1 where the sums of
    several blocks or passes meet in an fp32 tile in shared memory, 0
    where a block sums a row in registers and stores it.
    `shared_bytes` per block."""
    rows_per_tile: int
    tiles: int
    cluster: int
    chain: int
    use_tile: int
    threads: int
    shared_bytes: int


def _plan_bytes(rows: int, chain: int, C: int, use_tile: bool) -> int:
    """Shared memory of a block: chain heads (padded to 16 bytes), the row
    counter (16 bytes), links, and the fp32 tile where there is one."""
    return 4 * (-(-rows // 4) * 4) + 16 + 4 * chain + (
        4 * rows * C if use_tile else 0)


@functools.lru_cache(maxsize=256)
def scatter_plan(B: int, n: int, N: int, C: int) -> ScatterPlan:
    """The tiling of `quad_scatter` for `B` slabs of `n` rows of `C` values
    and `N` indices a slab. Sums are fp32 whatever the dtype, so the plan
    does not depend on it.

    Tiles are cut so that `B * tiles` blocks fill the card, but not below
    `_MIN_ROWS` rows. Where that leaves the card unfilled (few slab rows),
    the indices are split over a cluster of blocks per tile, as long as
    each block keeps `_MIN_SHARE` indices: up to 4 blocks to fill the
    card, 8 only while there is less than a block per SM (measured: more
    copies of the tile to zero and to add up cost more than the blocks
    bring). A block chains its whole share of the indices in one pass if
    it is at most `_MAX_CHAIN`. With one block per tile and one pass the
    sums never leave the registers; otherwise they meet in an fp32 tile in
    shared memory, which bounds the tile's rows."""
    if min(B, n, C) < 1 or N < 0:
        raise ValueError(f"scatter_plan: B={B}, n={n}, N={N}, C={C}")
    tiles = min(-(-_FULL_GRID // B), max(1, n // _MIN_ROWS))
    rows = min(-(-n // tiles), _MAX_ROWS)
    tiles = -(-n // rows)
    cluster = 1
    while cluster < 8 and N >= 2 * cluster * _MIN_SHARE and B * tiles \
            * cluster < (_FULL_GRID if cluster < 4 else _FULL_GRID // 2):
        cluster *= 2
    share = -(-(-(-N // 32)) // cluster) * 32    # runs of 32, in turns
    chain = min(_MAX_CHAIN, max(32, share))
    use_tile = cluster > 1 or share > chain
    if use_tile:
        # the fp32 tile has to fit beside the chains: two blocks to an SM
        # if a tile of _MIN_ROWS rows allows it, else one; then shorter
        # chains (more passes); then fewer rows than _MIN_ROWS
        budget = _SHARED_TWO_BLOCKS
        if _plan_bytes(min(rows, _MIN_ROWS), chain, C, True) > budget:
            budget = SHARED_PER_BLOCK
        if _plan_bytes(1, chain, C, True) > budget:
            chain = min(chain, 4096)
        fit = (budget - 4 * chain - 32) // (4 * C + 4)
        if fit < 1:
            raise ValueError(f"quad_scatter kernel: a row of {C} values "
                             "does not fit a block's shared memory")
        rows = min(rows, fit)
        tiles = -(-n // rows)
    rows = -(-n // tiles)                      # evened out over the slab
    tiles = -(-n // rows)
    return ScatterPlan(rows, tiles, cluster, chain, int(use_tile), _THREADS,
                       _plan_bytes(rows, chain, C, use_tile))


def quad_scatter(dg: torch.Tensor, gi: torch.Tensor, n: int) -> torch.Tensor:
    """Scatter-add rows `dg` (B, N, C) to `gi` (B, N) int32 -> (B, n, C)
    in the dtype of `dg`, summed in fp32; indices outside `[0, n)` add
    nothing. Kernel on CUDA (one launch that writes every slab row once),
    plain version on CPU."""
    (B, N, C), (_, n_idx) = _check(dg, gi, "quad_scatter")
    if n_idx != N:
        raise ValueError(f"quad_scatter: dg has {N} rows per slab, gi "
                         f"{n_idx} indices")
    if dg.is_cpu:
        return quad_scatter_plain(dg, gi, n)
    if dg.dtype not in _DTYPE_CODE:
        raise TypeError(f"quad_scatter kernel: dtype {dg.dtype} "
                        "(float32 or bfloat16 only)")
    dg, gi, ptr, row_bytes, stream = _kernel_inputs(dg, gi, "quad_scatter")
    out = dg.new_empty((B, n, C))
    if B == 0 or n == 0:
        return out
    launch = _launchers.get("scatter") or _launcher("scatter", 12)
    err = launch(ptr, gi.data_ptr(), out.data_ptr(), B, n, N, row_bytes,
                 _DTYPE_CODE[dg.dtype], *scatter_plan(B, n, N, C), stream)
    if err:
        raise RuntimeError(f"quad_scatter kernel launch failed: CUDA error "
                           f"{err}")
    quad_scatter.launches += 1
    return out


class _QuadGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, quad, gi):
        ctx.save_for_backward(gi)
        ctx.n = quad.shape[1]
        return _gather(quad, gi, (quad.shape, gi.shape))

    @staticmethod
    def backward(ctx, d_out):
        if not ctx.needs_input_grad[0]:
            return None, None
        (gi,) = ctx.saved_tensors
        # resolved through the module at call time, so that a caller can
        # put another scatter in its place
        return quad_scatter(d_out, gi, ctx.n), None


def quad_gather(quad: torch.Tensor, gi: torch.Tensor) -> torch.Tensor:
    """Gather rows `gi` (B, N) int32 from `quad` (B, n, C) -> (B, N, C);
    differentiable in `quad`. Where no gradient can flow the kernel (or,
    on the CPU, the plain version) is called directly."""
    shapes = _check(quad, gi, "quad_gather")
    if quad.requires_grad and torch.is_grad_enabled():
        return _QuadGather.apply(quad, gi)
    return _gather(quad, gi, shapes)


quad_gather.launches = 0
quad_scatter.launches = 0
