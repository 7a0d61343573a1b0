"""Fused MSDA level samples: the port of `cape_tpu.ops.msda_fused`.

Gather, bilinear x attention blend and corner sum of one feature level in
one kernel, so the `(BH, N, 4*Dh)` gathered rows of the quad-row path
(`ops.gather.quad_gather` + a weighted sum in PyTorch) never pass through
device memory:

- `fused_level_sample(slab, gi, w4, Wl)` samples the RAW level slab
  `(BH, HW, Dh)`: `out[b, r] = sum_c w4[b, r, c] * slab[b, gi[b, r] +
  shift_c]` with shifts `(0, 1, Wl, Wl+1)`. A corner whose index lies
  outside `[0, HW)` contributes nothing.
- `quadfused_level_sample(slab, gi, w4)` samples the QUAD slab
  `(BH, n, 4*Dh)` (`ops.msda._quad_rows`): `out[b, r, d] = sum_c
  w4[b, r, c] * slab[b, gi[b, r], c*Dh + d]`. A row index outside `[0, n)`
  gives a zero row.

Both are `torch.autograd.Function`s with gradients to `slab` and `w4`
(none to `gi`): `dslab` is the weighted scatter-add of `dout`, summed in
fp32 and cast to the slab dtype, and `dw4[b, r, c]` the dot product of
`dout[b, r]` with the corner's slab row (0 off-range; a corner in range
with zero weight gets its true `dw4`).

- CUDA tensors: the hand-written kernels of `csrc/fused.cu`, which replace
  the Pallas `_fused_fwd_kernel` and `_fused_bwd_kernel`
  (`cape_tpu/ops/msda_fused.py:88`, `:99`), and of `csrc/quadfused.cu`,
  which replace `_quadfused_fwd_kernel` and `_quadfused_bwd_kernel`
  (`:231`, `:249`). All four are bound by bytes; see the sources for the
  designs. They take fp32 and bf16, `Dh / 4` a power of two up to 32
  (Dh = 32 is the model's), and a slab whose batch stride is a whole
  number of rows (a level slice of the folded value needs no copy). The
  raw slab's forward takes a thread per 16 bytes of an output row, its
  launch worked out by `sample_fwd_plan` (pure Python). The
  backwards are row-list kernels (`csrc/rowlist.cuh`) tiled by
  `sample_bwd_plan`: one launch writes `dslab` and `dw4` whole in the
  slab's dtype, with no fp32 buffer, zero fill or cast, and the same bits
  every run.
- CPU tensors: `*_plain` and `*_bwd_plain`, the same functions in plain
  PyTorch. The backward is the explicit formula (a masked `index_add_`
  into fp32 and a row dot), the one the kernels are held against on the
  card, not autograd of the plain forward.

Sums are fp32 with one rounding of the result, where the TPU kernels also
round single terms to the slab dtype (`msda_fused.py:242-246`, `:276`): in
bf16 the two differ by bf16 roundings of single terms.

`fused_level_sample.launches` / `.bwd_launches` and
`quadfused_level_sample.launches` / `.bwd_launches` count kernel launches
(never plain calls).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from . import _build
from .gather import SHARED_PER_BLOCK, _SHARED_TWO_BLOCKS, scatter_plan

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# -- plain PyTorch versions -------------------------------------------------
def _corners(slab: torch.Tensor, gi: torch.Tensor, Wl: Optional[int]):
    """Both formulations as 4 corner rows of a (BH, R, Dh) view of the
    slab: the view, the (BH, N, 4) row index of every corner and whether
    it is in range. `Wl=None` is the quad slab, whose row `gi` is the 4
    rows `4*gi + c` of the view."""
    BH = slab.shape[0]
    g64 = gi.long()[..., None]
    if Wl is None:
        n, Dh = slab.shape[1], slab.shape[2] // 4
        idx = g64 * 4 + torch.arange(4, device=gi.device)
        valid = ((g64 >= 0) & (g64 < n)).expand(-1, -1, 4)
        return slab.reshape(BH, n * 4, Dh), idx, valid
    c = torch.arange(4, device=gi.device)     # corner shifts 0, 1, Wl, Wl+1
    idx = g64 + c % 2 + c // 2 * Wl
    return slab, idx, (idx >= 0) & (idx < slab.shape[1])


def _corner_values(rows, idx, valid) -> torch.Tensor:
    """(BH, N, 4, Dh) fp32 corner rows, zeros where out of range."""
    BH, R, Dh = rows.shape
    N = idx.shape[1]
    flat = idx.clamp(0, R - 1).reshape(BH, N * 4, 1).expand(-1, -1, Dh)
    g = torch.gather(rows, 1, flat).reshape(BH, N, 4, Dh).float()
    return torch.where(valid[..., None], g, g.new_zeros(()))


def _sample_plain(slab, gi, w4, Wl):
    rows, idx, valid = _corners(slab, gi, Wl)
    g = _corner_values(rows, idx, valid)
    return (g * w4.float()[..., None]).sum(dim=2).to(slab.dtype)


def _sample_bwd_plain(slab, gi, w4, Wl, dout):
    rows, idx, valid = _corners(slab, gi, Wl)
    BH, R, Dh = rows.shape
    d = dout.float()[:, :, None, :]                       # (BH, N, 1, Dh)
    dw4 = (_corner_values(rows, idx, valid) * d).sum(dim=-1).to(w4.dtype)
    target = (torch.arange(BH, device=gi.device)[:, None, None] * R
              + idx)[valid]
    dslab = torch.zeros((BH * R, Dh), dtype=torch.float32, device=slab.device)
    dslab.index_add_(0, target, (w4.float()[..., None] * d)[valid])
    return dslab.reshape(slab.shape).to(slab.dtype), dw4


def fused_level_sample_plain(slab: torch.Tensor, gi: torch.Tensor,
                             w4: torch.Tensor, Wl: int) -> torch.Tensor:
    """Plain PyTorch version of `fused_level_sample`: a clamped gather of
    the 4 corner rows, masked, blended in fp32."""
    return _sample_plain(slab, gi, w4, Wl)


def fused_level_sample_bwd_plain(
        slab: torch.Tensor, gi: torch.Tensor, w4: torch.Tensor, Wl: int,
        dout: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward: `(dslab, dw4)`."""
    return _sample_bwd_plain(slab, gi, w4, Wl, dout)


def quadfused_level_sample_plain(slab: torch.Tensor, gi: torch.Tensor,
                                 w4: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `quadfused_level_sample`."""
    return _sample_plain(slab, gi, w4, None)


def quadfused_level_sample_bwd_plain(
        slab: torch.Tensor, gi: torch.Tensor, w4: torch.Tensor,
        dout: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward: `(dslab, dw4)`."""
    return _sample_bwd_plain(slab, gi, w4, None, dout)


# -- the backwards' tiling --------------------------------------------------
#: list entries a group of lanes should have to itself before a row is
#: given more groups
_ENTRIES_PER_GROUP = 8


class SampleBwdPlan(NamedTuple):
    """How `csrc/rowlist.cuh` tiles one backward call: `tiles` tiles of
    `rows_per_tile` output rows cover the slab; a cluster of `cluster`
    blocks of `threads` threads works on each tile, the entries split
    among its blocks, each block listing up to `chain` entries a pass by
    key; `use_tile` is 1 where the sums of several blocks or passes meet
    in an fp32 tile in shared memory; `shared_bytes` per block; `split`
    groups of lanes work on one output row."""
    rows_per_tile: int
    tiles: int
    cluster: int
    chain: int
    use_tile: int
    threads: int
    shared_bytes: int
    split: int


def _list_bytes(rows: int, chain: int, C: int, use_tile: bool, halo: int,
                threads: int) -> int:
    """Shared memory of a block (`shared_need` in `csrc/rowlist.cuh`): the
    counters and the warps' totals (144 bytes), a 2-byte count per key (the
    rows and the halo) and warp, padded to 16 bytes, 2 bytes a slot for
    the slots each warp keeps (rounded up to whole rounds of the block)
    and 2 for the list, the fp32 tile where there is one, and a row of C
    fp32 values a warp (its share of a row that all the warps take)."""
    warps = threads // 32
    return 144 + 2 * (-(-warps * (rows + halo) // 8) * 8) + 2 * (
        -(-chain // threads) * threads) + 2 * chain + (
        4 * rows * C if use_tile else 0) + 4 * warps * C


@functools.lru_cache(maxsize=256)
def sample_bwd_plan(B: int, n: int, N: int, C: int, halo: int,
                    corners: int) -> SampleBwdPlan:
    """The tiling of a level sample's backward for `B` slabs of `n` output
    rows of `C` values and `N` entries a slab, each reaching `corners`
    rows (4 for the raw slab, whose blocks also list the `halo = Wl + 1`
    cells below their tile; 1 for the quad slab, `C = 4 * Dh`).

    The policy is `quad_scatter`'s (`ops.gather.scatter_plan`: tiles that
    fill the card two blocks to an SM, the entries split over a cluster
    where rows are few, passes where a block's share is long); tiles are
    then cut shorter where the lists and the halo need it to fit shared
    memory. `split`: one group of lanes a row where a block's rows get
    fewer than `2 * _ENTRIES_PER_GROUP` list entries on average (about 5
    at the encoder's quad level 0), more groups, up to a warp, where they
    get more (21 at its raw level 0, hundreds at levels 2-3)."""
    if min(B, n, C) < 1 or N < 0 or halo < 0 or corners < 1:
        raise ValueError(f"sample_bwd_plan: B={B}, n={n}, N={N}, C={C}, "
                         f"halo={halo}, corners={corners}")
    base = scatter_plan(B, n, N, C)
    threads, rows, cluster = base.threads, base.rows_per_tile, base.cluster
    chain, use_tile = base.chain, bool(base.use_tile)
    # two blocks to an SM where the scatter has them
    budget = _SHARED_TWO_BLOCKS \
        if base.shared_bytes <= _SHARED_TWO_BLOCKS else SHARED_PER_BLOCK

    def fit(budget):
        """The most rows whose counts (and tile) fit beside the lists."""
        return (budget - _list_bytes(0, chain, C, use_tile, halo, threads)
                - 14) // (threads // 16 + (4 * C if use_tile else 0))

    # then one block to an SM; then shorter lists (more passes)
    if fit(budget) < 1:
        budget = SHARED_PER_BLOCK
    if fit(budget) < 1 and chain > 4096:
        chain, use_tile = 4096, True
    if fit(budget) < 1:
        raise ValueError(f"a row of {C} values with a halo of {halo} rows "
                         "does not fit a block's shared memory")
    rows = min(rows, fit(budget))
    tiles = -(-n // rows)
    rows = -(-n // tiles)                      # evened out over the slab
    tiles = -(-n // rows)
    per_row = N * corners // max(1, n * cluster)
    split = 1
    while split < 32 and 2 * split * _ENTRIES_PER_GROUP <= per_row:
        split *= 2
    return SampleBwdPlan(rows, tiles, cluster, chain, int(use_tile), threads,
                         _list_bytes(rows, chain, C, use_tile, halo, threads),
                         split)


# -- the forward's launch -----------------------------------------------------
#: threads of a block of the forward
_FWD_THREADS = 256


class SampleFwdPlan(NamedTuple):
    """How `csrc/fused.cu`'s forward covers the `BH * N` output rows: a
    row is `units` lanes of `unit_bytes` (16, or 8 where a bf16 row is 8
    bytes), lane u of row r is thread `r * units + u` of the grid, and
    `blocks` blocks of `threads` threads cover the rows."""
    units: int
    unit_bytes: int
    threads: int
    blocks: int


@functools.lru_cache(maxsize=256)
def sample_fwd_plan(BH: int, N: int, Dh: int, elt: int) -> SampleFwdPlan:
    """The forward's launch for `BH` slabs of `N` rows of `Dh` values of
    `elt` bytes. Dh / 4 must be a power of two up to 32 and the lanes
    fewer than 2^31 (ValueError otherwise)."""
    groups = Dh // 4
    if Dh % 4 or groups < 1 or groups & (groups - 1) or groups > 32 \
            or elt not in (2, 4) or BH < 0 or N < 0:
        raise ValueError(f"sample_fwd_plan: BH={BH}, N={N}, Dh={Dh}, "
                         f"elt={elt}")
    row_bytes = Dh * elt
    unit_bytes = 16 if row_bytes % 16 == 0 else 8
    units = row_bytes // unit_bytes
    blocks = -(-BH * N * units // _FWD_THREADS)
    if blocks * _FWD_THREADS > 2 ** 31 - 1:
        raise ValueError(f"sample_fwd_plan: {BH * N} rows of {units} lanes:"
                         " lane indices past 32 bits")
    return SampleFwdPlan(units, unit_bytes, _FWD_THREADS, blocks)


# -- kernel wrappers --------------------------------------------------------
def _fn(name: str, n_ptr: int, n_int: int):
    """`<name>_launch` of its library: `n_ptr` pointers, `n_int` ints, the
    slab's batch stride (64-bit), the dtype code and the stream."""
    lib = _build.load("quadfused" if name.startswith("quad") else "fused")
    fn = getattr(lib, f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(slab, gi, w4, Wl, what: str) -> None:
    if slab.dim() != 3 or gi.dim() != 2 or gi.shape[0] != slab.shape[0] \
            or w4.shape != (*gi.shape, 4):
        raise ValueError(
            f"{what}: slab (BH, rows, C), gi (BH, N) and w4 (BH, N, 4) "
            f"expected, got {tuple(slab.shape)}, {tuple(gi.shape)} and "
            f"{tuple(w4.shape)}")
    if gi.dtype != torch.int32:
        raise TypeError(f"{what}: gi must be int32, got {gi.dtype}")
    if w4.dtype != slab.dtype:
        raise TypeError(f"{what}: w4 is {w4.dtype}, the slab {slab.dtype}")
    if gi.device != slab.device or w4.device != slab.device:
        raise ValueError(f"{what}: slab, gi and w4 on different devices")
    if Wl is None and slab.shape[2] % 4:
        raise ValueError(f"{what}: quad rows of {slab.shape[2]} values are "
                         "not 4 corner bands")
    if Wl is not None and Wl < 1:
        raise ValueError(f"{what}: level width {Wl}")


def _kernel_operands(what: str, slab, gi, w4, Wl, dout=None):
    """Kernel operands on the current CUDA device: the slab with contiguous
    rows and a batch stride of whole rows (copied only if it is not), the
    rest contiguous, all on 16-byte boundaries. Returns them with the
    launch's ints `(BH, rows, N[, Wl], Dh)` and the batch stride in rows."""
    if slab.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {slab.device}")
    if slab.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what} kernel: dtype {slab.dtype} (float32 or "
                        "bfloat16 only)")
    if slab.device.index != torch.cuda.current_device():
        raise ValueError("kernel inputs must be on the current CUDA device")
    BH, rows, width = slab.shape
    Dh = width if Wl is not None else width // 4
    groups = Dh // 4
    if Dh % 4 or groups & (groups - 1) or not 1 <= groups <= 32:
        raise ValueError(f"{what} kernel: Dh = {Dh}; Dh / 4 must be a power "
                         "of two up to 32")
    if slab.stride(2) != 1 or slab.stride(1) != width \
            or slab.stride(0) % width or slab.data_ptr() % 16:
        slab = slab.contiguous()
    others = [t.contiguous() for t in (gi, w4) + (() if dout is None
                                                  else (dout,))]
    if dout is not None and (others[2].dtype != slab.dtype
                             or others[2].shape != (BH, gi.shape[1], Dh)):
        raise ValueError(f"{what}: dout {tuple(dout.shape)} {dout.dtype} "
                         "does not match the output")
    for t in (slab, *others):
        if t.data_ptr() % 16:
            raise ValueError(f"{what} kernel: operands must lie on 16-byte "
                             "boundaries")
    ints = (BH, rows, gi.shape[1]) + (() if Wl is None else (Wl,)) + (Dh,)
    return slab, others, ints, slab.stride(0) // width


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _sample(public: Callable, slab, gi, w4, Wl):
    """Forward: kernel on CUDA tensors, plain version on CPU tensors."""
    what = public.__name__
    if slab.device.type == "cpu":
        return _sample_plain(slab, gi, w4, Wl)
    slab, (gi, w4), ints, stride = _kernel_operands(what, slab, gi, w4, Wl)
    out = torch.empty((ints[0], ints[2], ints[-1]), dtype=slab.dtype,
                      device=slab.device)
    if Wl is not None:
        plan = sample_fwd_plan(ints[0], ints[2], ints[-1],
                               slab.element_size())
        ints += (plan.units, plan.threads, plan.blocks)
    name = "fused_fwd" if Wl is not None else "quadfused_fwd"
    _raise_on(_fn(name, 4, len(ints))(
        slab.data_ptr(), gi.data_ptr(), w4.data_ptr(), out.data_ptr(), *ints,
        stride, _DTYPE_CODE[slab.dtype],
        torch.cuda.current_stream().cuda_stream), what)
    public.launches += 1
    return out


def _sample_bwd(public: Callable, slab, gi, w4, Wl, dout):
    """Backward `(dslab, dw4)`: kernel on CUDA tensors (one launch that
    writes both outputs whole, in the slab's dtype), plain version on CPU
    tensors."""
    what = public.__name__ + " backward"
    if slab.device.type == "cpu":
        return _sample_bwd_plain(slab, gi, w4, Wl, dout)
    shape = slab.shape
    slab, (gi, w4, dout), ints, stride = _kernel_operands(
        what, slab, gi, w4, Wl, dout)
    BH, rows, N, Dh = ints[0], ints[1], ints[2], ints[-1]
    dslab = torch.empty(shape, dtype=slab.dtype, device=slab.device)
    if BH == 0 or rows == 0:
        # no row to own: every corner is out of range
        return dslab, torch.zeros_like(w4)
    try:
        plan = sample_bwd_plan(BH, rows, N, shape[2],
                               0 if Wl is None else Wl + 1,
                               1 if Wl is None else 4)
    except ValueError as e:
        raise ValueError(f"{what} kernel: slab {tuple(shape)}, N = {N}: "
                         f"{e}") from None
    dw4 = torch.empty_like(w4)
    name = "fused_bwd" if Wl is not None else "quadfused_bwd"
    _raise_on(_fn(name, 6, len(ints) + len(plan))(
        slab.data_ptr(), gi.data_ptr(), w4.data_ptr(), dout.data_ptr(),
        dslab.data_ptr(), dw4.data_ptr(), *ints, *plan, stride,
        _DTYPE_CODE[slab.dtype], torch.cuda.current_stream().cuda_stream),
        what)
    public.bwd_launches += 1
    return dslab, dw4


class _LevelSample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, public, slab, gi, w4, Wl):
        ctx.save_for_backward(slab, gi, w4)
        ctx.public, ctx.Wl = public, Wl
        return _sample(public, slab, gi, w4, Wl)

    @staticmethod
    def backward(ctx, dout):
        need_slab, need_w4 = ctx.needs_input_grad[1], ctx.needs_input_grad[3]
        if not (need_slab or need_w4):
            return None, None, None, None, None
        slab, gi, w4 = ctx.saved_tensors
        dslab, dw4 = _sample_bwd(ctx.public, slab, gi, w4, ctx.Wl, dout)
        return (None, dslab if need_slab else None, None,
                dw4 if need_w4 else None, None)


def fused_level_sample(slab: torch.Tensor, gi: torch.Tensor,
                       w4: torch.Tensor, Wl: int) -> torch.Tensor:
    """Blend the 4 bilinear corners of one feature level in one kernel.

    Args:
        slab: (BH, HW, Dh) one level's features, heads folded into batch.
        gi:   (BH, N) int32 flat index of the top-left corner (row-major,
              level-local; may be negative or past the end).
        w4:   (BH, N, 4) combined bilinear * attention weight per corner
              in shift order (0, 1, Wl, Wl+1), zeroed where the corner is
              out of bounds; the slab's dtype.
        Wl:   level width.

    Returns:
        (BH, N, Dh) = sum_c w4[..., c] * slab[gi + shift_c]; rows are
        (query, point) pairs, the point sum is the caller's.
    """
    _check(slab, gi, w4, Wl, "fused_level_sample")
    return _LevelSample.apply(fused_level_sample, slab, gi, w4, Wl)


def quadfused_level_sample(slab: torch.Tensor, gi: torch.Tensor,
                           w4: torch.Tensor) -> torch.Tensor:
    """Gather, blend and corner sum over a QUAD slab in one kernel.

    Args:
        slab: (BH, n, 4*Dh) quad rows (`ops.msda._quad_rows` layout).
        gi:   (BH, N) int32 base row index into the quad slab.
        w4:   (BH, N, 4) corner weights (quad band order), zeroed where
              the corner is out of bounds; the slab's dtype.

    Returns:
        (BH, N, Dh) = sum_c w4[..., c] * slab[gi][c*Dh:(c+1)*Dh].
    """
    _check(slab, gi, w4, None, "quadfused_level_sample")
    return _LevelSample.apply(quadfused_level_sample, slab, gi, w4, None)


def fused_level_sample_bwd(
        slab: torch.Tensor, gi: torch.Tensor, w4: torch.Tensor, Wl: int,
        dout: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """`(dslab, dw4)` of `fused_level_sample` for the cotangent `dout`
    (BH, N, Dh): what its autograd backward calls. Kernel on CUDA, plain
    version on CPU."""
    _check(slab, gi, w4, Wl, "fused_level_sample")
    return _sample_bwd(fused_level_sample, slab, gi, w4, Wl, dout)


def quadfused_level_sample_bwd(
        slab: torch.Tensor, gi: torch.Tensor, w4: torch.Tensor,
        dout: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """`(dslab, dw4)` of `quadfused_level_sample` for the cotangent `dout`
    (BH, N, Dh). Kernel on CUDA, plain version on CPU."""
    _check(slab, gi, w4, None, "quadfused_level_sample")
    return _sample_bwd(quadfused_level_sample, slab, gi, w4, None, dout)


for _f in (fused_level_sample, quadfused_level_sample):
    _f.launches = 0
    _f.bwd_launches = 0
