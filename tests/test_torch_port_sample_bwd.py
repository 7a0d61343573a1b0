"""The backwards of the fused level samples as the card computes them
(`csrc/fused.cu`, `csrc/quadfused.cu` on `csrc/rowlist.cuh`), on the CPU.

The CUDA kernels cannot run here; their tiling and their walks can.
`sample_bwd_plan` (the raw slab's tiles also list the `Wl + 1` cells below
them) is held to its invariants over random shapes. `_emulate` below walks
a plan as the kernels do: per slab, per tile, per block of the cluster its
share of the entries in runs of 32 taken in turns, per pass the lists of
the tile's keys (quad rows; or cells of the tile and its halo, read by
row s as cells s, s - 1, s - Wl, s - Wl - 1 for corners 0-3), the sums of
each block's copy, then the copies added in rank order; dw4 from whichever
block reads the entry, and dw4 = 0 from tile 0's scan for every corner no
row owns. It asserts that every (entry, corner) is given its dw4 exactly
once, and is held against `*_bwd_plain` and against the JAX package's
Pallas kernels in interpret mode: fp32 to 1e-5 (the same terms in another
order), bf16 as `tests/test_torch_port_fused.py` states.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from cape_tpu.ops import msda_fused as jax_fused

from cape_tpu_torch.ops import msda_fused as port_fused
from cape_tpu_torch.ops.gather import SHARED_PER_BLOCK, scatter_plan
from cape_tpu_torch.ops.msda_fused import SampleBwdPlan as Plan, \
    sample_bwd_plan

from test_torch_port_fused import BF16_TOL

#: the flagship level grids (512 px)
LEVELS = ((64, 64), (32, 32), (16, 16), (8, 8))


def _passes(plan: Plan, N: int) -> int:
    share = -(-(-(-N // 32)) // plan.cluster) * 32
    return max(1, -(-share // plan.chain))


@settings(max_examples=300, deadline=None)
@given(B=st.integers(1, 400), n=st.integers(1, 100_000),
       N=st.integers(0, 300_000), C=st.sampled_from([4, 8, 16, 32, 64, 128,
                                                     256, 512]),
       halo=st.integers(0, 1025), corners=st.sampled_from([1, 4]))
def test_plan_invariants(B, n, N, C, halo, corners):
    plan = sample_bwd_plan(B, n, N, C, halo, corners)
    # every output row is owned by exactly one tile, none of them empty
    assert plan.rows_per_tile >= 1
    assert (plan.tiles - 1) * plan.rows_per_tile < n \
        <= plan.tiles * plan.rows_per_tile
    # a cluster the card can launch (8 blocks is the portable limit)
    assert 1 <= plan.cluster <= 8
    assert plan.chain >= 8 and plan.chain % 8 == 0 and plan.chain < 2 ** 16
    assert plan.threads == 512
    assert plan.split in (1, 2, 4, 8, 16, 32)
    if plan.cluster > 1 or _passes(plan, N) > 1:
        assert plan.use_tile == 1
    # the lists of the tile's rows and of its halo fit the shared bytes
    need = 144 + 32 * (plan.rows_per_tile + halo) + 4 * plan.chain \
        + (4 * plan.rows_per_tile * C if plan.use_tile else 0) + 64 * C
    assert need <= plan.shared_bytes <= SHARED_PER_BLOCK
    assert plan.rows_per_tile + halo < 2 ** 16
    assert B * plan.tiles * plan.cluster < 2 ** 31
    # the scatter's policy: its cluster, and its passes unless the lists
    # need shorter ones
    base = scatter_plan(B, n, N, C)
    assert plan.cluster == base.cluster
    assert (plan.chain, plan.use_tile) in (
        (base.chain, base.use_tile), (4096, 1))


@pytest.mark.parametrize("N", [21_760, 800])
@pytest.mark.parametrize("Hl,Wl", LEVELS)
def test_plans_at_the_training_shapes(Hl, Wl, N):
    """32 slabs (4 images x 8 heads), Dh = 32: the raw slab with its halo
    and the quad slab fill the card with one block a tile at the large
    levels and split the entries over a cluster at the small ones, two
    blocks to an SM; a row gets more groups of lanes where it gets many
    entries."""
    for plan, n, corners in (
            (sample_bwd_plan(32, Hl * Wl, N, 32, Wl + 1, 4), Hl * Wl, 4),
            (sample_bwd_plan(32, (Wl + 1) + Hl * Wl, N, 128, 0, 1),
             (Wl + 1) + Hl * Wl, 1)):
        blocks = 32 * plan.tiles * plan.cluster
        assert blocks <= 256
        if n >= 1024 or N == 800:
            assert (plan.cluster, plan.use_tile, _passes(plan, N)) == (1, 0, 1)
        else:
            assert plan.cluster > 1 and plan.use_tile == 1
            assert blocks >= 128
        assert plan.shared_bytes <= (228 * 1024) // 2 - 1024
        # one group a row where a block's rows get few entries, more where
        # they get many
        per_row = N * corners // (n * plan.cluster)
        assert plan.split == 1 if per_row < 16 else plan.split >= 2
        assert plan.split * 8 <= max(8, per_row)


def test_plan_rejects_what_shared_memory_cannot_hold():
    with pytest.raises(ValueError, match="does not fit"):
        sample_bwd_plan(2, 10, 5000, 100_000, 3, 4)
    with pytest.raises(ValueError, match="halo"):
        sample_bwd_plan(1, 10, 10, 32, 60_000, 4)
    with pytest.raises(ValueError):
        sample_bwd_plan(1, 10, 10, 32, -1, 4)


def _emulate(slab, gi, w4, dout, Wl, plan: Plan):
    """`fused_bwd_kernel` (Wl given) or `quadfused_bwd_kernel` (Wl None)
    step by step in plain PyTorch: `(dslab, dw4)` in the slab's dtype."""
    BH, n, width = slab.shape
    N = gi.shape[1]
    quad = Wl is None
    Dh = width // 4 if quad else width
    halo = 0 if quad else Wl + 1
    shifts = (0, 0, 0, 0) if quad else (0, 1, Wl, Wl + 1)
    K = plan.cluster
    share = -(-(-(-N // 32)) // K) * 32
    s32, w32, d32 = slab.float(), w4.float(), dout.float()
    dslab = torch.full((BH, n, width), float("nan"))
    dw4 = torch.full((BH, N, 4), float("nan"))
    for b in range(BH):
        given = torch.zeros(N, 4, dtype=torch.int32)
        for t in range(plan.tiles):
            row0 = t * plan.rows_per_tile
            rows = min(plan.rows_per_tile, n - row0)
            assert rows >= 1
            copies = []
            for rank in range(K):
                tile = torch.zeros(rows, width)
                for s0 in range(0, max(share, 1), plan.chain):
                    slot = torch.arange(s0, min(share, s0 + plan.chain))
                    idx = ((slot // 32) * K + rank) * 32 + slot % 32
                    idx = idx[idx < N]
                    g = gi[b, idx].long()
                    if t == 0:                     # the scan's dw4 = 0
                        for c in range(4):
                            off = (g + shifts[c] < 0) | (g + shifts[c] >= n)
                            dw4[b, idx[off], c] = 0.0
                            given[idx[off], c] += 1
                    # listed: the key (row or cell) in the tile or halo
                    key = g - (row0 - halo)
                    listed = (key >= 0) & (key < rows + halo)
                    for c in range(4):
                        # row r reads the list of key r + halo - shift_c
                        r = key - halo + shifts[c]
                        m = listed & (r >= 0) & (r < rows)
                        e, rm = idx[m], r[m]
                        d = d32[b, e]                      # (M, Dh)
                        srow = s32[b, row0 + rm]           # (M, width)
                        if quad:
                            band = slice(c * Dh, (c + 1) * Dh)
                            tile[:, band].index_add_(
                                0, rm, w32[b, e, c, None] * d)
                            dw4[b, e, c] = (d * srow[:, band]).sum(-1)
                        else:
                            tile.index_add_(0, rm, w32[b, e, c, None] * d)
                            dw4[b, e, c] = (d * srow).sum(-1)
                        given[e, c] += 1
                copies.append(tile)
            if not plan.use_tile:
                assert K == 1 and share <= plan.chain
            total = copies[0]
            for other in copies[1:]:                 # rank order
                total = total + other
            dslab[b, row0:row0 + rows] = total
        assert bool((given == 1).all()), \
            "a corner's dw4 is not given exactly once"
    return dslab.to(slab.dtype), dw4.to(slab.dtype)


def _inputs(kind, Hl, Wl, N, Dh, BH=2, seed=0):
    """Seeded numpy (slab, w4, dout, gi) of one level: indices below and
    past both ends (with non-zero weights), duplicates, row-edge cells,
    zero weights in range."""
    rng = np.random.default_rng(seed)
    HW = Hl * Wl
    if kind == "fused":
        lo, hi = -(Wl + 1), HW                 # the raw top-left corner
        slab = rng.normal(size=(BH, HW, Dh))
    else:
        lo, hi = 0, (Wl + 1) + HW              # quad rows
        slab = rng.normal(size=(BH, hi, 4 * Dh))
    gi = rng.integers(lo, hi, (BH, N)).astype(np.int32)
    special = [3, 3, 3, -1, lo - 3, -1000, hi, hi + 9, hi - 1, Wl - 1,
               2 * Wl - 1, lo, lo + 1]
    gi[:, :len(special)] = special
    gi[:, 20:28] = hi // 2                      # duplicates mid-slab
    w4 = rng.uniform(size=(BH, N, 4))
    w4[:, 28:32] = 0.0
    w4[:, 32, 1:3] = 0.0
    dout = rng.normal(size=(BH, N, Dh))
    return tuple(a.astype(np.float32) for a in (slab, w4, dout)) + (gi,)


#: (kind, Hl, Wl, N, Dh, plan): None is the port's own plan; the others
#: force what small shapes would not reach: tiles whose halo crosses into
#: the tile below, Wl = 1 (corners 1 and 2 share a list), clusters of 3
#: and 8 with a ragged share, several passes, all at once
EMULATED = [
    ("fused", 7, 5, 64, 8, None),
    ("fused", 7, 5, 64, 8, Plan(6, 6, 1, 64, 0, 512, 0, 1)),
    ("fused", 9, 1, 50, 4, Plan(4, 3, 1, 64, 0, 512, 0, 2)),
    ("fused", 6, 6, 300, 8, Plan(10, 4, 3, 32, 1, 64, 0, 8)),
    ("fused", 5, 8, 700, 16, Plan(40, 1, 8, 64, 1, 512, 0, 1)),
    ("fusedq", 7, 5, 64, 8, None),
    ("fusedq", 7, 5, 64, 8, Plan(7, 6, 1, 64, 0, 512, 0, 1)),
    ("fusedq", 4, 4, 300, 4, Plan(5, 5, 3, 32, 1, 64, 0, 4)),
    ("fusedq", 3, 3, 700, 8, Plan(13, 1, 8, 64, 1, 512, 0, 2)),
]


def _jax_bwd(kind, slab, gi, w4, dout, Wl, dtype):
    js, jw, jd = (jnp.asarray(a, dtype) for a in (slab, w4, dout))
    if kind == "fused":
        f = lambda s, w: jax_fused.fused_level_sample(  # noqa: E731
            s, jnp.asarray(gi), w, Wl)
    else:
        f = lambda s, w: jax_fused.quadfused_level_sample(  # noqa: E731
            s, jnp.asarray(gi), w)
    _, vjp = jax.vjp(f, js, jw)
    return [np.asarray(a.astype(jnp.float32)) for a in vjp(jd)], (js, jw, jd)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,Hl,Wl,N,Dh,plan", EMULATED)
def test_emulated_walk_matches_plain_and_pallas(kind, Hl, Wl, N, Dh, plan,
                                                dtype):
    slab, w4, dout, gi = _inputs(kind, Hl, Wl, N, Dh)
    (want_ds, want_dw), jax_in = _jax_bwd(kind, slab, gi, w4, dout, Wl,
                                          dtype)
    tdt = getattr(torch, dtype)
    ts, tw, td = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
                  for a in jax_in)
    tg = torch.from_numpy(gi)
    lvl = None if kind == "fusedq" else Wl
    width = ts.shape[2]
    plan = plan or sample_bwd_plan(ts.shape[0], ts.shape[1], N, width,
                                   0 if lvl is None else Wl + 1,
                                   1 if lvl is None else 4)
    got_ds, got_dw = _emulate(ts, tg, tw, td, lvl, plan)
    assert got_ds.dtype == tdt and got_dw.dtype == tdt
    assert not got_ds.isnan().any() and not got_dw.isnan().any()
    if lvl is None:
        plain = port_fused.quadfused_level_sample_bwd_plain(ts, tg, tw, td)
    else:
        plain = port_fused.fused_level_sample_bwd_plain(ts, tg, tw, Wl, td)
    f32 = dict(atol=1e-5, rtol=1e-5)
    one_ulp = dict(atol=2 ** -7, rtol=2 ** -7)
    for got, p, want, name in ((got_ds, plain[0], want_ds, "dslab"),
                               (got_dw, plain[1], want_dw, "dw4")):
        np.testing.assert_allclose(
            got.float().numpy(), p.float().numpy(), err_msg=name,
            **(f32 if dtype == "float32" else one_ulp))
        np.testing.assert_allclose(
            got.float().numpy(), want, err_msg=name,
            **(f32 if dtype == "float32" else BF16_TOL[kind]))


@pytest.mark.parametrize("kind", ["fused", "fusedq"])
def test_off_range_corners_get_exactly_zero(kind):
    """dw4 is exactly 0 for every corner outside the slab, written by the
    scan of tile 0 and never by a walk."""
    Hl, Wl, N = 6, 5, 120
    slab, w4, dout, gi = _inputs(kind, Hl, Wl, N, 8, seed=3)
    ts, tw, td = (torch.from_numpy(a) for a in (slab, w4, dout))
    tg = torch.from_numpy(gi)
    lvl = None if kind == "fusedq" else Wl
    plan = Plan(4, -(-ts.shape[1] // 4), 2, 32, 1, 64, 0, 1)
    _, dw = _emulate(ts, tg, tw, td, lvl, plan)
    g = tg.long()[..., None]
    if lvl is None:
        off = ((g < 0) | (g >= ts.shape[1])).expand(-1, -1, 4)
    else:
        t = g + torch.tensor([0, 1, Wl, Wl + 1])
        off = (t < 0) | (t >= ts.shape[1])
    assert off.any() and (~off).any()
    assert torch.equal(dw[off], torch.zeros(int(off.sum())))
    assert dw[~off].abs().min() > 0
