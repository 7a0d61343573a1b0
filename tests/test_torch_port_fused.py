"""Parity of the port's fused MSDA formulations (`cape_tpu_torch.ops.
msda_fused`, and the `gather_impl` selection of `cape_tpu_torch.ops.msda`)
with the JAX package on the CPU.

On CPU tensors the port runs the plain PyTorch versions of its kernels,
forward and backward (the explicit backward formula, not autograd of the
forward). They are held against the JAX package's Pallas kernels in
interpret mode, as `tests/test_msda_core.py` runs them off-TPU, and against
the direct 4-corner oracle. fp32 tolerances are 1e-5 (the same terms
summed in another order); the bf16 cases state theirs. The raw slab's
forward kernel (`csrc/fused.cu`) is launched by `sample_fwd_plan`: its
invariants are checked over random shapes, and `_emulate_fwd` walks a
plan as the kernel does, against the plain version and the Pallas kernel.
"""

import warnings

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from cape_tpu.ops import msda as jax_msda
from cape_tpu.ops import msda_fused as jax_fused

from cape_tpu_torch.ops import gather as port_gather
from cape_tpu_torch.ops import msda as port_msda
from cape_tpu_torch.ops import msda_fused as port_fused

from test_torch_port_ops import LOC_RANGES, SHAPES, _core_grads, _msda_inputs

#: level geometry of the level-sample cases: a 5-wide, 7-high level
WL, HL = 5, 7


def _level_inputs(kind, seed=0, BH=3, N=50, Dh=8):
    """Seeded (slab, gi, w4, dout) of one level with the awkward entries:
    negative and past-the-end indices (with NON-zero weights: they must
    add nothing), duplicates, row-edge cells and zero weights."""
    rng = np.random.default_rng(seed)
    HW = WL * HL
    if kind == "fused":
        slab = rng.normal(size=(BH, HW, Dh))
        lo, hi = -(WL + 1), HW            # raw top-left corner range
    else:
        hi = (WL + 1) + HW                # quad rows
        slab = rng.normal(size=(BH, hi, 4 * Dh))
        lo = 0
    gi = rng.integers(lo, hi, (BH, N)).astype(np.int32)
    gi[:, :6] = 7                                     # duplicates
    gi[:, 6:12] = [-1, lo - 3, -1000, hi, hi + 9, hi - 1]   # off-range / edge
    gi[:, 12:14] = [WL - 1, 2 * WL - 1]               # last cell of a row
    gi[:, 14:18] = [8, 9, 10, 11]                     # interior cells
    w4 = rng.uniform(size=(BH, N, 4))
    w4[:, 14:18] = 0.0                                # zero weights, in range
    w4[:, 18, 1:3] = 0.0
    dout = rng.normal(size=(BH, N, Dh))
    return tuple(a.astype(np.float32) for a in (slab, w4, dout)) + (gi,)


def _jax_sample(kind, slab, gi, w4):
    if kind == "fused":
        return jax_fused.fused_level_sample(slab, gi, w4, WL)
    return jax_fused.quadfused_level_sample(slab, gi, w4)


def _port_sample(kind, slab, gi, w4):
    if kind == "fused":
        return port_fused.fused_level_sample(slab, gi, w4, WL)
    return port_fused.quadfused_level_sample(slab, gi, w4)


#: bf16: the port sums in fp32 and rounds the result once. `fused` on the
#: TPU does the same (one bf16 ulp, 2^-7 relative). `fusedq` there rounds
#: each of the 4 w*g terms to bf16 before the corner sum and each w*dout
#: term before the scatter (up to 8 duplicates of |term| < 4 here), so it
#: may sit 2^-9 of every term off: 2^-4 absolute covers both.
BF16_TOL = {"fused": dict(atol=2 ** -7, rtol=2 ** -7),
            "fusedq": dict(atol=2 ** -4, rtol=2 ** -7)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["fused", "fusedq"])
def test_level_sample_matches_pallas(kind, dtype):
    """Forward, dslab and dw4 against the Pallas kernels and their
    `jax.vjp`, awkward indices included."""
    slab, w4, dout, gi = _level_inputs(kind)
    js, jw, jd = (jnp.asarray(a, dtype) for a in (slab, w4, dout))
    want, vjp = jax.vjp(lambda s, w: _jax_sample(kind, s, jnp.asarray(gi), w),
                        js, jw)
    want_ds, want_dw = vjp(jd)
    tdt = getattr(torch, dtype)
    ts, tw, td = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
                  for a in (js, jw, jd))
    ts.requires_grad_(True)
    tw.requires_grad_(True)
    got = _port_sample(kind, ts, torch.from_numpy(gi), tw)
    got_ds, got_dw = torch.autograd.grad(got, (ts, tw), td)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else BF16_TOL[kind]
    for g, w, name in ((got, want, "out"), (got_ds, want_ds, "dslab"),
                       (got_dw, want_dw, "dw4")):
        assert g.dtype == tdt and g.shape == w.shape, name
        np.testing.assert_allclose(
            g.detach().float().numpy(), np.asarray(w.astype(jnp.float32)),
            err_msg=name, **tol)
    # off-range rows: zero output for the quad slab's single index; for the
    # raw slab only where all four corners are off
    dead = slice(7, 11) if kind == "fused" else slice(6, 11)
    assert not got[:, dead].any() and not got_dw[:, dead].any()
    # an in-range corner with zero weight still gets its true dw4
    assert got_dw[:, 14:18].abs().min() > 0


@pytest.mark.parametrize("kind", ["fused", "fusedq"])
def test_level_sample_backward_is_the_explicit_formula(kind):
    """The autograd function's backward equals `*_bwd_plain`, which equals
    autograd of the plain forward: the formula the card's kernels are held
    against is the forward's true gradient."""
    slab, w4, dout, gi = _level_inputs(kind, seed=1)
    ts, tw, td = (torch.from_numpy(a) for a in (slab, w4, dout))
    tg = torch.from_numpy(gi)
    if kind == "fused":
        ds, dw = port_fused.fused_level_sample_bwd_plain(ts, tg, tw, WL, td)
        plain = lambda s, w: port_fused.fused_level_sample_plain(  # noqa: E731
            s, tg, w, WL)
    else:
        ds, dw = port_fused.quadfused_level_sample_bwd_plain(ts, tg, tw, td)
        plain = lambda s, w: port_fused.quadfused_level_sample_plain(  # noqa: E731
            s, tg, w)
    s2, w2 = ts.clone().requires_grad_(True), tw.clone().requires_grad_(True)
    a_ds, a_dw = torch.autograd.grad(plain(s2, w2), (s2, w2), td)
    torch.testing.assert_close(ds, a_ds, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(dw, a_dw, atol=1e-5, rtol=1e-5)
    s3, w3 = ts.clone().requires_grad_(True), tw.clone().requires_grad_(True)
    f_ds, f_dw = torch.autograd.grad(_port_sample(kind, s3, tg, w3),
                                     (s3, w3), td)
    assert torch.equal(f_ds, ds) and torch.equal(f_dw, dw)
    # a slab that needs no gradient gets none, w4 still does
    (only_dw,) = torch.autograd.grad(_port_sample(kind, ts, tg, w3), (w3,),
                                     td)
    assert torch.equal(only_dw, dw)


def test_level_sample_takes_a_strided_level_slice():
    """The fused core hands over a level slice of the folded value: rows
    contiguous, batch stride longer than the slab."""
    slab, w4, dout, gi = _level_inputs("fused", seed=2)
    BH, HW, Dh = slab.shape
    big = np.random.default_rng(3).normal(size=(BH, HW + 11, Dh)).astype(
        np.float32)
    big[:, 4:4 + HW] = slab
    view = torch.from_numpy(big)[:, 4:4 + HW]
    assert not view.is_contiguous()
    got = port_fused.fused_level_sample(view, torch.from_numpy(gi),
                                        torch.from_numpy(w4), WL)
    want = port_fused.fused_level_sample(*(torch.from_numpy(a) for a in
                                           (slab, gi, w4)), WL)
    assert torch.equal(got, want)


def test_level_sample_checks_its_inputs():
    slab = torch.zeros(2, 35, 8)
    gi = torch.zeros(2, 5, dtype=torch.int32)
    w4 = torch.zeros(2, 5, 4)
    with pytest.raises(TypeError, match="int32"):
        port_fused.fused_level_sample(slab, gi.long(), w4, 5)
    with pytest.raises(TypeError, match="w4"):
        port_fused.fused_level_sample(slab, gi, w4.bfloat16(), 5)
    with pytest.raises(ValueError):
        port_fused.fused_level_sample(slab, gi, w4[:, :4], 5)
    with pytest.raises(ValueError):
        port_fused.fused_level_sample(slab, gi[:1], w4[:1], 5)
    with pytest.raises(ValueError, match="width"):
        port_fused.fused_level_sample(slab, gi, w4, 0)
    with pytest.raises(ValueError, match="bands"):
        port_fused.quadfused_level_sample(torch.zeros(2, 35, 10), gi, w4)


# -- the forward's launch (csrc/fused.cu) -------------------------------------
@settings(max_examples=300, deadline=None)
@given(BH=st.integers(0, 400), N=st.integers(0, 300_000),
       Dh=st.sampled_from([4, 8, 16, 32, 64, 128]), elt=st.sampled_from([2, 4]))
def test_fwd_plan_invariants(BH, N, Dh, elt):
    units = Dh * elt // (8 if Dh * elt == 8 else 16)
    if BH * N * units > 2 ** 31 - 256:      # lane indices past 32 bits
        with pytest.raises(ValueError):
            port_fused.sample_fwd_plan(BH, N, Dh, elt)
        return
    plan = port_fused.sample_fwd_plan(BH, N, Dh, elt)
    # a row is whole units of 16 bytes (8 where a bf16 row is 8 bytes), a
    # power of two of them, at most a warp
    assert plan.units * plan.unit_bytes == Dh * elt
    assert plan.unit_bytes == (8 if Dh * elt == 8 else 16)
    assert plan.units & (plan.units - 1) == 0 and plan.units <= 32
    # whole warps, and just enough blocks for every lane of every row
    assert plan.threads % 32 == 0 and plan.threads % plan.units == 0
    lanes = BH * N * plan.units
    assert (plan.blocks - 1) * plan.threads < lanes \
        <= plan.blocks * plan.threads or lanes == plan.blocks == 0
    assert plan.blocks * plan.threads < 2 ** 31


def _emulate_fwd(slab, gi, w4, Wl, plan):
    """`csrc/fused.cu`'s forward over `plan`: thread i of the grid holds
    unit i % units of row i // units (rows of all slabs in one range, row
    r of slab r // N); corners 0-3 added in that order in fp32, a corner
    outside [0, HW) read as zeros. Returns the (BH, N, Dh) sums and how
    often each (row, unit) was written."""
    BH, HW, Dh = slab.shape
    N = gi.shape[1]
    units = plan.units
    V = Dh // units
    rows = slab.reshape(BH, HW, units, V).astype(np.float32)
    g, w = gi.reshape(-1).astype(np.int64), w4.reshape(-1, 4)
    out = np.zeros((BH * N, units, V), np.float32)
    written = np.zeros((BH * N, units), np.int64)
    i = np.arange(plan.blocks * plan.threads)
    r, u = i // units, i % units
    live = r < BH * N                   # the rest return at once
    r, u = r[live], u[live]
    acc = np.zeros((r.size, V), np.float32)
    for c, shift in enumerate((0, 1, Wl, Wl + 1)):
        idx = g[r] + shift
        ok = (idx >= 0) & (idx < HW)
        v = np.where(ok[:, None], rows[r // N, np.clip(idx, 0, HW - 1), u],
                     np.float32(0))
        acc += w[r, c, None].astype(np.float32) * v
    out[r, u] = acc
    np.add.at(written, (r, u), 1)
    return out.reshape(BH, N, Dh), written


def _fwd_inputs(seed, BH, N, Dh, Hl=7, Wl=5):
    rng = np.random.default_rng(seed)
    HW = Hl * Wl
    slab = rng.normal(size=(BH, HW, Dh)).astype(np.float32)
    gi = rng.integers(-(Wl + 1), HW, (BH, N)).astype(np.int32)
    gi[:, :3] = [-1000, HW + 9, HW - 1][:N]        # off range / last cell
    w4 = rng.uniform(size=(BH, N, 4)).astype(np.float32)
    return slab, gi, w4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Dh", [16, 32])
@pytest.mark.parametrize("N", [4, 800, 1003, 21_760])
def test_emulated_fwd_covers_every_row_once(N, Dh, dtype):
    """The plan's walk at the decode step's, the decoder's, a ragged and
    the encoder's row counts: every (row, unit) written once, and the sums
    equal `fused_level_sample_plain` and the Pallas `_fused_fwd_kernel` in
    interpret mode (fp32 1e-5: another order; bf16: one rounding of the
    fp32 sums, against the TPU kernel as `BF16_TOL` states)."""
    BH = 2
    slab, gi, w4 = _fwd_inputs(N + Dh, BH, N, Dh)
    tdt = getattr(torch, dtype)
    ts, tw = (torch.from_numpy(a).to(tdt) for a in (slab, w4))
    plan = port_fused.sample_fwd_plan(BH, N, Dh, ts.element_size())
    got, written = _emulate_fwd(ts.float().numpy(), gi, tw.float().numpy(),
                                WL, plan)
    assert (written == 1).all()
    got_t = torch.from_numpy(got).to(tdt)
    plain = port_fused.fused_level_sample_plain(ts, torch.from_numpy(gi), tw,
                                                WL)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else dict(
        atol=1e-5, rtol=2 ** -7)
    np.testing.assert_allclose(got_t.float().numpy(), plain.float().numpy(),
                               **tol)
    js, jw = (jnp.asarray(a.float().numpy(), dtype) for a in (ts, tw))
    want = np.asarray(jax_fused.fused_level_sample(js, jnp.asarray(gi), jw,
                                                   WL).astype(jnp.float32))
    np.testing.assert_allclose(
        got_t.float().numpy(), want,
        **(dict(atol=1e-5, rtol=1e-5) if dtype == "float32"
           else BF16_TOL["fused"]))


# -- the cores ---------------------------------------------------------------
@pytest.mark.parametrize("lo,hi", LOC_RANGES)
@pytest.mark.parametrize("impl", ["fused", "fusedq", "flat"])
def test_core_gather_impl_matches_jax_and_naive(impl, lo, hi):
    """`ms_deform_attn_core(gather_impl=...)`: values and the gradients to
    value, locations and attention against the JAX core with the same
    `gather_impl` (Pallas in interpret mode) and against the port's naive
    oracle, far-out-of-bounds locations included; fp32, 1e-5."""
    value, loc, w = _msda_inputs(31, lo=lo, hi=hi)
    cot = np.random.default_rng(32).normal(
        size=(value.shape[0], loc.shape[1], value.shape[2] * value.shape[3])
    ).astype(np.float32)
    tol = dict(atol=1e-5, rtol=1e-5)
    want, vjp = jax.vjp(lambda v, l, a: jax_msda.ms_deform_attn_core(
        v, SHAPES, l, a, gather_impl=impl), value, loc, w)
    got = port_msda.ms_deform_attn_core(
        *(torch.from_numpy(a) for a in (value,)), SHAPES,
        *(torch.from_numpy(a) for a in (loc, w)), gather_impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    naive = port_msda.ms_deform_attn_core_naive(
        torch.from_numpy(value), SHAPES, torch.from_numpy(loc),
        torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), naive.numpy(), **tol)
    g_got = _core_grads(port_msda.ms_deform_attn_core, value, loc, w, cot,
                        impl)
    g_naive = _core_grads(port_msda.ms_deform_attn_core_naive, value, loc, w,
                          cot)
    for g, jw, nv in zip(g_got, vjp(jnp.asarray(cot)), g_naive):
        np.testing.assert_allclose(g.numpy(), np.asarray(jw), **tol)
        np.testing.assert_allclose(g.numpy(), nv.numpy(), **tol)


@pytest.mark.parametrize("impl", ["auto", "xla", "mxu", "naive"])
def test_core_other_gather_impl_names(impl):
    """'auto', 'xla' and 'mxu' are the quad-row path, bit for bit; 'naive'
    is the oracle; 'zero' returns zeros; an unknown name raises."""
    value, loc, w = (torch.from_numpy(a) for a in _msda_inputs(33))
    got = port_msda.ms_deform_attn_core(value, SHAPES, loc, w,
                                        gather_impl=impl)
    if impl == "naive":
        want = port_msda.ms_deform_attn_core_naive(value, SHAPES, loc, w)
    else:
        want = port_msda.ms_deform_attn_core(value, SHAPES, loc, w)
    assert torch.equal(got, want)
    zero = port_msda.ms_deform_attn_core(value, SHAPES, loc, w,
                                         gather_impl="zero")
    assert zero.shape == got.shape and zero.dtype == got.dtype
    assert not zero.any() and got.abs().max() > 0
    with pytest.raises(ValueError, match="unknown gather impl"):
        port_msda.ms_deform_attn_core(value, SHAPES, loc, w,
                                      gather_impl="bogus")


# -- the selection -------------------------------------------------------------
def _clear_env(monkeypatch):
    for k in ("CAPE_MSDA_GATHER", "CAPE_MSDA_TINY"):
        monkeypatch.delenv(k, raising=False)


@pytest.mark.parametrize("name", ["xla", "mxu", "fused", "fusedq", "naive",
                                  "flat", "auto", "FUSED"])
def test_default_gather_impl_names(monkeypatch, name):
    """The names of the JAX package; 'auto' stays 'auto' (the quad-row
    path), where the JAX package resolves it to one of its two gathers."""
    from cape_tpu.ops.gather_mxu import default_gather_impl as jax_default

    monkeypatch.setenv("CAPE_MSDA_GATHER", name)
    got = port_gather.default_gather_impl()
    assert got == name.lower()
    if name != "auto":
        assert got == jax_default()


def test_default_gather_impl_unknown_name_raises_as_jax(monkeypatch):
    from cape_tpu.ops.gather_mxu import default_gather_impl as jax_default

    _clear_env(monkeypatch)
    assert port_gather.default_gather_impl() == "auto"
    monkeypatch.setenv("CAPE_MSDA_GATHER", "bogus")
    with pytest.raises(ValueError) as jax_err:
        jax_default()
    with pytest.raises(ValueError) as port_err:
        port_gather.default_gather_impl()
    assert str(port_err.value) == str(jax_err.value)


def test_resolve_impl_is_shape_aware(monkeypatch):
    """As `tests/test_msda_core.py::test_auto_impl_is_shape_aware`: only
    'auto' consults CAPE_MSDA_TINY, only at tiny sites; a forced
    CAPE_MSDA_GATHER wins at every shape."""
    resolve, tiny = port_msda._resolve_impl_for_shape, port_msda._NAIVE_MAX_ROWS
    assert tiny == jax_msda._NAIVE_MAX_ROWS
    _clear_env(monkeypatch)
    assert resolve(4) == resolve(tiny + 1) == "auto"
    monkeypatch.setenv("CAPE_MSDA_TINY", "flat")
    assert resolve(4) == resolve(tiny) == "flat"
    assert resolve(tiny + 1) == "auto"
    for forced in ("mxu", "fused"):
        monkeypatch.setenv("CAPE_MSDA_GATHER", forced)
        assert resolve(4) == resolve(tiny + 1) == forced
        assert resolve(4) == jax_msda._resolve_impl_for_shape(4)


def test_env_selects_the_core_and_the_argument_wins(monkeypatch):
    """The variables are read at every call; `gather_impl` wins over them."""
    value, loc, w = (torch.from_numpy(a) for a in _msda_inputs(34))
    calls = []
    for name in ("ms_deform_attn_core_fused", "ms_deform_attn_core_quadfused",
                 "ms_deform_attn_core_flat", "ms_deform_attn_core_naive"):
        real = getattr(port_msda, name)
        monkeypatch.setattr(port_msda, name, lambda *a, _n=name, _r=real:
                            calls.append(_n) or _r(*a))
    _clear_env(monkeypatch)
    port_msda.ms_deform_attn_core(value, SHAPES, loc, w)
    assert calls == []
    monkeypatch.setenv("CAPE_MSDA_GATHER", "fused")
    port_msda.ms_deform_attn_core(value, SHAPES, loc, w)
    port_msda.ms_deform_attn(value, SHAPES, loc, w)
    monkeypatch.setenv("CAPE_MSDA_GATHER", "fusedq")
    port_msda.ms_deform_attn_core(value, SHAPES, loc, w)
    port_msda.ms_deform_attn_core(value, SHAPES, loc, w, gather_impl="flat")
    port_msda.ms_deform_attn_core(value, SHAPES, loc, w, gather_impl="mxu")
    assert calls == ["ms_deform_attn_core_fused"] * 2 + [
        "ms_deform_attn_core_quadfused", "ms_deform_attn_core_flat"]
    # CAPE_MSDA_TINY: tiny sites under 'auto' only (Lq * P = 48 here)
    monkeypatch.setenv("CAPE_MSDA_GATHER", "auto")
    monkeypatch.setenv("CAPE_MSDA_TINY", "naive")
    port_msda.ms_deform_attn_core(value, SHAPES, loc, w)
    assert calls[-1] == "ms_deform_attn_core_naive"
    monkeypatch.setenv("CAPE_MSDA_GATHER", "bogus")
    with pytest.raises(ValueError, match="CAPE_MSDA_GATHER='bogus'"):
        port_msda.ms_deform_attn_core(value, SHAPES, loc, w)


@pytest.mark.parametrize("impl", ["fused", "fusedq"])
def test_use_pallas_backward_follows_the_selection(monkeypatch, impl):
    """`ms_deform_attn(use_pallas=True)`'s backward is the whole-op
    `msda_backward` whatever the process default selects (it no longer
    re-runs the selected core, as the JAX package's `f_bwd` does): the same
    bits as the plain backward, and the selected core's VJP to fp32
    summation order."""
    from cape_tpu_torch.ops import msda_kernel as port_msda_kernel

    value, loc, w = _msda_inputs(35)
    cot = np.random.default_rng(36).normal(
        size=(value.shape[0], loc.shape[1], value.shape[2] * value.shape[3])
    ).astype(np.float32)
    monkeypatch.setenv("CAPE_MSDA_GATHER", impl)
    a = _core_grads(port_msda.ms_deform_attn, value, loc, w, cot, True)
    b = _core_grads(port_msda.ms_deform_attn_core, value, loc, w, cot, impl)
    plain = port_msda_kernel.msda_backward_plain(
        *(torch.from_numpy(x) for x in (value,)), SHAPES,
        torch.from_numpy(loc), torch.from_numpy(w), torch.from_numpy(cot))
    for ga, gb, gp in zip(a, b, plain):
        assert torch.equal(ga, gp)
        torch.testing.assert_close(ga, gb, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("impl", ["fused", "fusedq", "naive", "flat"])
def test_prequad_warns_for_whole_core_formulations(monkeypatch, impl):
    """A whole-core formulation cannot serve a prequad site: the quad
    gather is used, with a warning that names CAPE_DECODE_PREQUAD=0."""
    value, loc, w = (torch.from_numpy(a)
                     for a in _msda_inputs(37, Dh=32, Lq=1))
    slab = port_msda.precompute_quad_slab(value, SHAPES)
    _clear_env(monkeypatch)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        want = port_msda.ms_deform_attn_core_prequad(slab, SHAPES, loc, w)
        for quiet in ("auto", "xla", "mxu"):
            assert torch.equal(want, port_msda.ms_deform_attn_core_prequad(
                slab, SHAPES, loc, w, gather_impl=quiet))
    monkeypatch.setenv("CAPE_MSDA_GATHER", impl)
    with pytest.warns(UserWarning, match="CAPE_DECODE_PREQUAD=0"):
        got = port_msda.ms_deform_attn_core_prequad(slab, SHAPES, loc, w)
    assert torch.equal(got, want)
    with pytest.warns(UserWarning, match=repr(impl)):
        port_msda.ms_deform_attn_core_prequad(slab, SHAPES, loc, w,
                                              gather_impl=impl)
    zero = port_msda.ms_deform_attn_core_prequad(slab, SHAPES, loc, w,
                                                 gather_impl="zero")
    assert zero.shape == want.shape and not zero.any()


def test_cpu_calls_do_not_count_as_launches():
    fns = (port_fused.fused_level_sample, port_fused.quadfused_level_sample)
    before = [(f.launches, f.bwd_launches) for f in fns]
    value, loc, w = _msda_inputs(38)
    for impl in ("fused", "fusedq"):
        v = torch.from_numpy(value).requires_grad_(True)
        out = port_msda.ms_deform_attn_core(
            v, SHAPES, torch.from_numpy(loc), torch.from_numpy(w),
            gather_impl=impl)
        out.sum().backward()
        assert v.grad.abs().sum() > 0
    assert [(f.launches, f.bwd_launches) for f in fns] == before
