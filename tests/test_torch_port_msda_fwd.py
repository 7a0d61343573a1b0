"""The whole-op MSDA forward (`cape_tpu_torch.ops.msda_kernel`) as the card
computes it, on the CPU.

`csrc/msda.cu` cannot run here; its function and its mapping can:

- `msda_forward_plain` (what the wrapper runs on CPU tensors, and what the
  kernel is held against on the card) against the JAX package's Pallas
  `ms_deform_attn_pallas` in interpret mode, at 2e-5 abs / 1e-5 rel in fp32
  (the same terms summed in another order), over 1-4 levels, non-square
  levels, `Lq` not a multiple of the Pallas block, locations outside
  [0, 1], exactly on cell boundaries and at -0.5 / W;
- `_emulate` walks `msda_plan`'s lanes as the kernel does (lane t: query
  t // (H*G), head, 16-byte unit; points in rounds of min(G, 4), level by
  level, each point's corner math done by lane `point % R` of its head and
  read by all; the corner math rounded as PyTorch rounds it; a corner
  loaded only when it lies inside its level and its weight is not 0) and
  asserts that every
  output value is written once and every in-range corner of non-zero
  weight added once per lane of its head, for the head widths and dtypes
  the wrapper takes (hypothesis); `msda_plan` raises for the rest;
- the dispatch `ms_deform_attn(use_pallas=True)` against the core.

The backward, `msda_backward`, is `tests/test_torch_port_msda_bwd.py`'s.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from cape_tpu.ops.msda_pallas import ms_deform_attn_pallas as jax_msda_pallas

from cape_tpu_torch.ops import msda as port_msda
from cape_tpu_torch.ops import msda_kernel as mk

#: level grids as (H_l, W_l): square and not, down to one cell a row
LEVELS = ((6, 5), (3, 7), (2, 2), (1, 3))
#: points whose corners the kernel loads together (`kChunk`)
CHUNK = 4


def _inputs(seed, levels, B=2, Lq=11, H=2, Dh=8, P=3, lo=-0.3, hi=1.3):
    """Seeded value, fp32 locations and normalised attention weights; the
    first queries sample exactly on cell boundaries (x = loc * W - 0.5 an
    integer), at -0.5 / W (x = -1: only the right corner is in range,
    with weight 0) and at 1 + 0.5 / W (both corners past the edge)."""
    rng = np.random.default_rng(seed)
    L = len(levels)
    S = sum(h * w for h, w in levels)
    value = rng.normal(size=(B, S, H, Dh)).astype(np.float32)
    loc = rng.uniform(lo, hi, size=(B, Lq, H, L, P, 2)).astype(np.float32)
    for lvl, (h, w) in enumerate(levels):
        size = np.array([w, h], np.float32)
        special = [(np.arange(P)[:, None] % size + 0.5) / size,
                   -0.5 / size, 1 + 0.5 / size]
        for k, where in enumerate(special[:Lq]):
            loc[:, k, :, lvl] = where
        if Lq > 3:
            loc[:, 3, :, lvl, :, 0] = -0.5 / size[0]   # one axis only
    attn = rng.uniform(size=(B, Lq, H, L, P)).astype(np.float32)
    attn /= attn.reshape(B, Lq, H, -1).sum(-1)[..., None, None]
    return value, loc, attn


@pytest.mark.parametrize("levels,Lq,lo,hi", [
    (LEVELS[:1], 11, -0.3, 1.3), (LEVELS[:2], 9, -0.3, 1.3),
    (LEVELS[:3], 17, -0.3, 1.3), (LEVELS, 13, -0.3, 1.3),
    (((4, 4),), 8, -0.3, 1.3), (LEVELS[:2], 11, -1.5, 2.5),
    (LEVELS[:2], 11, 0.1, 0.9)])
def test_plain_matches_pallas_interpret(levels, Lq, lo, hi):
    """Lq = 9, 11, 13, 17 are not multiples of the Pallas block of 8;
    [-1.5, 2.5] puts most corners far outside their level."""
    value, loc, attn = _inputs(len(levels) + Lq, levels, Lq=Lq, lo=lo, hi=hi)
    got = mk.msda_forward(torch.from_numpy(value), levels,
                          torch.from_numpy(loc), torch.from_numpy(attn))
    want = np.asarray(jax_msda_pallas(
        jnp.asarray(value), levels, jnp.asarray(loc), jnp.asarray(attn),
        block_q=8, interpret=True))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-5)


def _f32(x):
    return np.float32(x)


def _emulate(value, levels, loc, attn, plan):
    """The kernel's walk over `plan`, vectorised over lanes: returns the
    (B, Lq, H*Dh) fp32 sums, how often each output value was written and
    how often each (query, head, level, point, corner) was added."""
    B, S, H, Dh = value.shape
    _, Lq, _, L, P, _ = loc.shape
    G, Q = plan.lanes_per_head, plan.lanes_per_query
    V = Dh // G
    assert plan.threads * plan.blocks >= plan.lanes
    assert (plan.blocks - 1) * plan.threads < plan.lanes
    # lanes past the end only take part in the exchanges of their warp;
    # their heads are whole (lanes is a multiple of G), so none of the
    # lanes below reads their corners
    t = np.arange(plan.lanes)
    j, b, q = t % Q, t // Q // Lq, t // Q % Lq
    h, unit = j // G, j % G
    flat_v = value.reshape(B, S, H * G, V)
    acc = np.zeros((t.size, V), np.float32)
    added = np.zeros((B, Lq, H, L, P, 4), np.int64)
    start = np.cumsum([0] + [hh * ww for hh, ww in levels])
    R = min(G, CHUNK)                    # points a round
    first = t - unit                     # the head's first lane
    for lvl in range(L):
        Hl, Wl = levels[lvl]
        for p0 in range(0, P, R):
            # each lane's corner math for its own point p0 + unit % R
            p = p0 + unit % R
            ok = p < P
            xy = loc[b, q, h, lvl, np.minimum(p, P - 1)]
            a = np.where(ok, attn[b, q, h, lvl, np.minimum(p, P - 1)],
                         0).astype(np.float32)
            xy = np.where(ok[:, None], xy, _f32(0))
            x = xy[:, 0] * _f32(Wl) - _f32(0.5)
            y = xy[:, 1] * _f32(Hl) - _f32(0.5)
            x0, y0 = np.floor(x), np.floor(y)
            fx, fy = x - x0, y - y0
            gx, gy = _f32(1) - fx, _f32(1) - fy
            xi = np.clip(x0, -2, Wl).astype(np.int64)
            yi = np.clip(y0, -2, Hl).astype(np.int64)
            base = start[lvl] + yi * Wl + xi
            wts = []
            for dx, dy, wgt in ((0, 0, gx * gy), (1, 0, fx * gy),
                                (0, 1, gx * fy), (1, 1, fx * fy)):
                cx, cy = xi + dx, yi + dy
                inside = (cx >= 0) & (cx < Wl) & (cy >= 0) & (cy < Hl)
                wts.append(np.where(inside, wgt * a, _f32(0)))
            # every lane of the head reads the R points' corners
            for i in range(R):
                src = first + i
                assert (p[src] == p0 + i).all()
                for c, shift in enumerate((0, 1, Wl, Wl + 1)):
                    w = wts[c][src]
                    load = w != 0
                    if p0 + i >= P:          # past the head's points
                        assert not load.any()
                        continue
                    v = flat_v[b[load], base[src][load] + shift, j[load]]
                    acc[load] += w[load, None] * v
                    np.add.at(added, (b[load], q[load], h[load], lvl,
                                      p0 + i, c), 1)
    out = np.zeros((B * Lq * H * G, V), np.float32)
    written = np.zeros(B * Lq * H * G, np.int64)
    out[t] = acc                        # lane t's unit of the output
    np.add.at(written, t, 1)
    return (out.reshape(B, Lq, H * Dh), written, added)


def _in_range_nonzero(levels, loc, attn):
    """(B, Lq, H, L, P, 4): corners inside their level with weight != 0,
    from the plain version's own corner preparation."""
    B, Lq, H, L, P, _ = loc.shape
    _, w, valid = mk.prepare_corners(levels, torch.from_numpy(loc),
                                     torch.from_numpy(attn))
    # its corners are ordered (point, level, corner)
    keep = ((w * valid) != 0).numpy().reshape(B, H, Lq, P, L, 4)
    return keep.transpose(0, 2, 1, 4, 3, 5)


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 16), H=st.integers(1, 4),
       Dh=st.sampled_from([2, 4, 6, 8, 12, 16, 24, 32]),
       bf16=st.booleans(), L=st.integers(1, 4), P=st.integers(1, 6),
       B=st.integers(1, 2), Lq=st.integers(1, 9))
def test_emulated_kernel_covers_every_value_and_corner_once(
        seed, H, Dh, bf16, L, P, B, Lq):
    levels = LEVELS[:L]
    S = sum(h * w for h, w in levels)
    elt = 2 if bf16 else 4
    G = Dh * elt // 16
    if Dh * elt % 16 or G & (G - 1):
        with pytest.raises(ValueError):
            mk.msda_plan(B, S, Lq, H, Dh, L, elt)
        return
    plan = mk.msda_plan(B, S, Lq, H, Dh, L, elt)
    assert plan.lanes_per_head * 16 == Dh * elt
    value, loc, attn = _inputs(seed, levels, B=B, Lq=Lq, H=H, Dh=Dh, P=P)
    dtype = torch.bfloat16 if bf16 else torch.float32
    tv, ta = (torch.from_numpy(x).to(dtype) for x in (value, attn))
    got, written, added = _emulate(tv.float().numpy(), levels, loc,
                                   ta.float().numpy(), plan)
    assert (written == 1).all()
    # each lane of the head adds each corner it needs once
    keep = _in_range_nonzero(levels, loc, ta.float().numpy())
    assert np.array_equal(added, keep * plan.lanes_per_head)
    want = mk.msda_forward_plain(tv, levels, torch.from_numpy(loc), ta)
    got_t = torch.from_numpy(got).to(dtype)
    # fp32: the same terms in another order; bf16: one rounding of them
    tol = dict(atol=1e-5, rtol=1e-5) if not bf16 else dict(atol=1e-5,
                                                         rtol=2 ** -7)
    np.testing.assert_allclose(got_t.float().numpy(), want.float().numpy(),
                               **tol)


@pytest.mark.parametrize("B,Lq,elt,threads,blocks", [
    (8, 5440, 2, 256, 5440), (4, 5440, 2, 256, 2720), (4, 200, 2, 64, 400),
    (8, 5440, 4, 256, 10880), (4, 200, 4, 128, 400), (1, 1, 2, 64, 1)])
def test_plans_at_the_flagship_sites(B, Lq, elt, threads, blocks):
    """H = 8, Dh = 32, 4 levels of 5440 cells: one warp a query in bf16,
    two in fp32; blocks halve while there would be fewer than two an SM."""
    plan = mk.msda_plan(B, 5440, Lq, 8, 32, 4, elt)
    assert plan.lanes_per_query == 8 * 32 * elt // 16
    assert (plan.threads, plan.blocks) == (threads, blocks)


@pytest.mark.parametrize("args", [
    dict(L=9), dict(L=0), dict(Dh=4), dict(Dh=6, elt=4), dict(Dh=24),
    dict(elt=8), dict(B=2 ** 16, Lq=2 ** 12), dict(S=2 ** 27)])
def test_plan_refuses_what_the_kernel_does_not_take(args):
    kw = dict(B=2, S=100, Lq=10, H=8, Dh=32, L=4, elt=2) | args
    with pytest.raises(ValueError):
        mk.msda_plan(**kw)


def test_wrapper_refuses_other_devices():
    value, loc, attn = (torch.from_numpy(a).to("meta")
                        for a in _inputs(0, LEVELS[:1]))
    with pytest.raises(ValueError, match="unsupported device"):
        mk.msda_forward(value, LEVELS[:1], loc, attn)


@pytest.mark.parametrize("L", [1, 4])
def test_dispatch_use_pallas_matches_core(L):
    """`ms_deform_attn(use_pallas=True)` on the awkward locations, forward
    and gradients (the whole-op function's explicit backward), against
    autograd of the quad-row core (fp32, summation order)."""
    value, loc, attn = (torch.from_numpy(a) for a in _inputs(
        9, LEVELS[:L], Lq=7))
    cot = torch.from_numpy(np.random.default_rng(10).normal(
        size=(2, 7, value.shape[2] * value.shape[3])).astype(np.float32))
    outs, grads = [], []
    for use_pallas in (True, False):
        v, lc, a = (x.clone().requires_grad_(True) for x in
                    (value, loc, attn))
        out = (port_msda.ms_deform_attn(v, LEVELS[:L], lc, a,
                                        use_pallas=True) if use_pallas
               else port_msda.ms_deform_attn_core(v, LEVELS[:L], lc, a,
                                                  gather_impl="xla"))
        outs.append(out.detach())
        grads.append(torch.autograd.grad(out, (v, lc, a), cot))
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), atol=1e-5,
                               rtol=1e-5)
    for ga, gb in zip(*grads):
        torch.testing.assert_close(ga, gb, atol=2e-5, rtol=1e-5)
