"""The scatter kernel's tiling and the gather's no-gradient path
(`cape_tpu_torch.ops.gather`), on the CPU.

The CUDA kernel `csrc/scatter.cu` cannot run here; what surrounds it can.
`scatter_plan` (tiles, cluster, passes, shared memory) is a pure function
and is held to its invariants over random shapes. `_emulate` below walks
a plan exactly as the kernel does (per slab, per tile, per block of the
cluster its share of the indices in runs of 32 taken in turns, per pass
the rows' sums, then the cluster's copies added in rank order) in plain
PyTorch, and is held against `quad_scatter_plain` and against the JAX
package's Pallas `_scatter_bwd_kernel` in interpret mode: fp32 to 1e-6
(order of summation only), bf16 to one ulp after the one rounding.
`quad_gather` under `torch.inference_mode()` and `torch.no_grad()` skips
the autograd function and must equal the grad-mode result and the JAX
kernel; with a `quad` that requires a gradient it still records the
scatter as its backward.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from cape_tpu.ops import gather_mxu as jax_gather

from cape_tpu_torch.ops import gather as port_gather
from cape_tpu_torch.ops.gather import SHARED_PER_BLOCK, ScatterPlan

#: the flagship training shapes: 32 slabs, C = 128, the four levels' quad
#: rows, the encoder's and the teacher-forced decoder's indices per slab
LEVEL_ROWS = (4161, 1057, 273, 73)


def _passes(plan: ScatterPlan, N: int) -> int:
    share = -(-(-(-N // 32)) // plan.cluster) * 32
    return max(1, -(-share // plan.chain))


@settings(max_examples=300, deadline=None)
@given(B=st.integers(1, 400), n=st.integers(1, 200_000),
       N=st.integers(0, 300_000), C=st.sampled_from(
           [4, 8, 12, 32, 96, 128, 256, 512, 1000, 4096, 20_000]))
def test_scatter_plan_invariants(B, n, N, C):
    plan = port_gather.scatter_plan(B, n, N, C)
    # the tiles cover [0, n) exactly once, none of them empty
    assert plan.rows_per_tile >= 1
    assert (plan.tiles - 1) * plan.rows_per_tile < n \
        <= plan.tiles * plan.rows_per_tile
    assert 1 <= plan.cluster <= 8
    assert plan.chain >= 4 and plan.chain % 4 == 0
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 512
    assert plan.use_tile in (0, 1)
    # sums leave the registers only through the fp32 tile
    if plan.cluster > 1 or _passes(plan, N) > 1:
        assert plan.use_tile == 1
    need = 4 * (-(-plan.rows_per_tile // 4) * 4) + 16 + 4 * plan.chain \
        + (4 * plan.rows_per_tile * C if plan.use_tile else 0)
    assert need <= plan.shared_bytes <= SHARED_PER_BLOCK
    # every block of a cluster has indices to scan
    assert plan.cluster == 1 or N >= plan.cluster * 512


@pytest.mark.parametrize("N", [21_760, 800])
@pytest.mark.parametrize("n", LEVEL_ROWS)
def test_scatter_plan_at_the_training_shapes(n, N):
    plan = port_gather.scatter_plan(32, n, N, 128)
    blocks = 32 * plan.tiles * plan.cluster
    if n >= 1057 or N == 800:
        # one block a tile, one pass: rows summed in registers and stored
        assert (plan.cluster, plan.use_tile, _passes(plan, N)) == (1, 0, 1)
    else:
        # few slab rows, many indices: N split over a cluster, fp32 tile
        assert plan.cluster > 1 and plan.use_tile == 1
        assert blocks >= 128
    assert blocks <= 256
    assert plan.shared_bytes <= (228 * 1024) // 2 - 1024   # two to an SM


def test_scatter_plan_rejects_a_row_too_wide_for_shared_memory():
    # a single block with a single pass needs no tile: any width goes
    assert port_gather.scatter_plan(2, 10, 5, 100_000).use_tile == 0
    with pytest.raises(ValueError, match="does not fit"):
        port_gather.scatter_plan(2, 10, 5000, 100_000)
    with pytest.raises(ValueError):
        port_gather.scatter_plan(0, 10, 5, 128)


def _emulate(dg: torch.Tensor, gi: torch.Tensor, n: int,
             plan: ScatterPlan) -> torch.Tensor:
    """`csrc/scatter.cu` step by step in plain PyTorch, for any plan."""
    B, N, C = dg.shape
    K = plan.cluster
    share = -(-(-(-N // 32)) // K) * 32
    out = torch.full((B, n, C), float("nan"), dtype=dg.dtype)
    for b in range(B):
        seen = torch.zeros(N, dtype=torch.int32)
        for t in range(plan.tiles):
            row0 = t * plan.rows_per_tile
            rows = min(plan.rows_per_tile, n - row0)
            assert rows >= 1
            copies = []
            for rank in range(K):
                tile = torch.zeros(rows, C, dtype=torch.float32)
                for s0 in range(0, max(share, 1), plan.chain):
                    slot = torch.arange(s0, min(share, s0 + plan.chain))
                    idx = ((slot // 32) * K + rank) * 32 + slot % 32
                    idx = idx[idx < N]
                    if t == 0:
                        seen[idx] += 1
                    r = gi[b, idx].long() - row0
                    hit = (r >= 0) & (r < rows)
                    # each row's chain summed on its own, then added
                    tile += torch.zeros(rows, C).index_add_(
                        0, r[hit], dg[b, idx[hit]].float())
                copies.append(tile)
            if not plan.use_tile:
                assert K == 1 and share <= plan.chain
            total = copies[0]
            for other in copies[1:]:                 # rank order
                total = total + other
            out[b, row0:row0 + rows] = total.to(dg.dtype)
        assert bool((seen == 1).all()), "an index is not scanned exactly once"
    return out


def _case(seed, B, n, N, C, dtype):
    rng = np.random.default_rng(seed)
    dg = rng.normal(size=(B, N, C)).astype(np.float32)
    gi = rng.integers(0, n, (B, N)).astype(np.int32)
    k = min(40, N // 3)
    gi[:, :k] = min(3, n - 1)                       # duplicates of one row
    gi[:, k:k + 4] = [-1, -n, n, n + 100][:max(0, min(4, N - k))]
    jd = jnp.asarray(dg, dtype)
    td = torch.from_numpy(np.array(jd.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return jd, td, gi


#: (B, n, N, C) with None for the port's own plan, else a plan that forces
#: what small shapes would not reach: ragged tiles, a cluster of 3 or 8
#: with a ragged share, several passes, several of all at once
EMULATED = [
    (3, 37, 300, 128, None),
    (2, 273, 2100, 32, None),                           # a cluster, a tile
    (2, 100, 700, 16, ScatterPlan(13, 8, 1, 704, 0, 512, 0)),
    (2, 100, 700, 16, ScatterPlan(100, 1, 8, 96, 1, 512, 0)),
    (2, 41, 500, 8, ScatterPlan(7, 6, 3, 64, 1, 64, 0)),     # 3 passes
    (1, 5, 0, 4, None),                                      # no indices
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,n,N,C,plan", EMULATED)
def test_emulated_tiling_matches_plain_and_pallas(B, n, N, C, plan, dtype):
    jd, td, gi = _case(7, B, n, N, C, dtype)
    plan = plan or port_gather.scatter_plan(B, n, N, C)
    got = _emulate(td, torch.from_numpy(gi), n, plan)
    assert got.dtype == td.dtype and not got.isnan().any()
    plain = port_gather.quad_scatter_plain(td, torch.from_numpy(gi), n)
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(),
                               atol=tol, rtol=tol)
    if N:
        want = np.asarray(jax_gather._scatter_mxu_impl(
            jd, jnp.asarray(gi), n).astype(jd.dtype).astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                                   rtol=tol)
    else:
        assert not got.any()


def _gather_inputs(dtype):
    rng = np.random.default_rng(11)
    B, n, C, N = 3, 37, 128, 50
    quad = jnp.asarray(rng.normal(size=(B, n, C)).astype(np.float32), dtype)
    gi = rng.integers(0, n, (B, N)).astype(np.int32)
    gi[:, :4] = 5
    gi[:, 4:8] = [-1, -7, n, n + 100]
    tq = torch.from_numpy(np.array(quad.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return quad, tq, gi


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", [torch.inference_mode, torch.no_grad])
def test_quad_gather_without_gradient_equals_grad_mode_and_pallas(mode, dtype):
    quad, tq, gi = _gather_inputs(dtype)
    tgi = torch.from_numpy(gi)
    with_grad = port_gather.quad_gather(tq.clone().requires_grad_(True), tgi)
    assert with_grad.grad_fn is not None
    with mode():
        got = port_gather.quad_gather(tq, tgi)
        # a quad that asks for a gradient cannot get one here either
        same = port_gather.quad_gather(tq.clone().requires_grad_(True), tgi)
    assert got.grad_fn is None and not got.requires_grad
    assert same.grad_fn is None
    assert torch.equal(got, with_grad.detach()) and torch.equal(got, same)
    want = np.asarray(jax_gather.quad_gather(quad, jnp.asarray(gi),
                                             impl="mxu").astype(jnp.float32))
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_quad_gather_of_a_constant_skips_autograd():
    """Grad mode on, but nothing to differentiate: the direct path."""
    _, tq, gi = _gather_inputs("float32")
    out = port_gather.quad_gather(tq, torch.from_numpy(gi))
    assert out.grad_fn is None and not out.requires_grad


def test_quad_gather_gradient_is_the_scatter_resolved_at_call_time(
        monkeypatch):
    _, tq, gi = _gather_inputs("float32")
    tgi = torch.from_numpy(gi)
    tq.requires_grad_(True)
    cot = torch.from_numpy(np.random.default_rng(12).normal(
        size=(3, 50, 128)).astype(np.float32))
    (grad,) = torch.autograd.grad(port_gather.quad_gather(tq, tgi), tq, cot)
    assert torch.equal(grad, port_gather.quad_scatter(cot, tgi, 37))
    # a scatter put in the module's place is the one the backward calls
    calls = []

    def recording(dg, idx, n):
        calls.append((tuple(dg.shape), n))
        return torch.zeros(dg.shape[0], n, dg.shape[2])

    monkeypatch.setattr(port_gather, "quad_scatter", recording)
    (zero,) = torch.autograd.grad(port_gather.quad_gather(tq, tgi), tq, cot)
    assert calls == [((3, 50, 128), 37)] and not zero.any()
