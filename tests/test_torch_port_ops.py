"""Parity of the port's MSDA ops (`cape_tpu_torch.ops`) with the JAX
package on the CPU.

On CPU tensors the port's kernel wrappers run their plain PyTorch versions;
they are held here against the JAX package's Pallas kernels in interpret
mode (`quad_gather(impl="mxu")`, `ms_deform_attn_pallas(interpret=True)`)
and against the direct 4-corner oracle. Tolerances: a gather is exact;
the fp32 cores agree to 1e-5 (summation order only). Gradients: the plain
scatter (the gather's backward) against `jax.vjp` through the Pallas
`_scatter_bwd_kernel` in interpret mode, and the cores' gradients against
`jax.grad` of the JAX cores, to 1e-5 in fp32 (summation order only).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cape_tpu.ops import gather_mxu as jax_gather
from cape_tpu.ops import msda as jax_msda
from cape_tpu.ops.msda_pallas import ms_deform_attn_pallas as jax_msda_pallas

from cape_tpu_torch.ops import gather as port_gather
from cape_tpu_torch.ops import msda as port_msda
from cape_tpu_torch.ops import msda_kernel as port_msda_kernel

SHAPES = [(8, 8), (4, 4), (2, 2)]
#: sampling-location ranges of tests/test_msda_core.py, far-OOB included
LOC_RANGES = [(-0.2, 1.2), (-1.5, 2.5), (0.1, 0.9)]


def _msda_inputs(seed, B=2, H=4, Dh=8, Lq=12, P=4, lo=-0.2, hi=1.2):
    rng = np.random.default_rng(seed)
    L = len(SHAPES)
    S = sum(h * w for h, w in SHAPES)
    value = rng.normal(size=(B, S, H, Dh)).astype(np.float32)
    loc = rng.uniform(lo, hi, size=(B, Lq, H, L, P, 2)).astype(np.float32)
    w = rng.uniform(size=(B, Lq, H, L, P)).astype(np.float32)
    w /= w.reshape(B, Lq, H, -1).sum(-1)[..., None, None]
    return value, loc, w


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quad_gather_matches_pallas_mxu(dtype):
    """Exact, with duplicate indices and indices outside [0, n) (zeros)."""
    rng = np.random.default_rng(3)
    B, n, C, N = 3, 37, 128, 50
    quad = rng.normal(size=(B, n, C)).astype(np.float32)
    gi = rng.integers(0, n, (B, N)).astype(np.int32)
    gi[:, :4] = 5                          # duplicates
    gi[:, 4:8] = [-1, -7, n, n + 100]      # out of range -> zero rows
    jq = jnp.asarray(quad, dtype)
    want = np.asarray(jax_gather.quad_gather(jq, jnp.asarray(gi), impl="mxu")
                      .astype(jnp.float32))
    tq = torch.from_numpy(np.array(jq.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = port_gather.quad_gather(tq, torch.from_numpy(gi))
    assert got.dtype == tq.dtype and got.shape == (B, N, C)
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert not got[:, 4:8].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quad_scatter_matches_pallas_mxu_vjp(dtype):
    """The gather's backward against the Pallas `_scatter_bwd_kernel`
    (interpret mode), duplicate and out-of-range indices included: fp32
    sums of the same terms in another order (1e-6), then one bf16
    rounding (one bf16 ulp where a sum lands between two)."""
    rng = np.random.default_rng(4)
    B, n, C, N = 3, 37, 128, 300
    quad = rng.normal(size=(B, n, C)).astype(np.float32)
    gi = rng.integers(0, n, (B, N)).astype(np.int32)
    gi[:, :40] = 5                         # many duplicates of one row
    gi[:, 40:44] = [-1, -7, n, n + 100]    # out of range: no contribution
    dout = rng.normal(size=(B, N, C)).astype(np.float32)
    jq = jnp.asarray(quad, dtype)
    jd = jnp.asarray(dout, dtype)
    _, vjp = jax.vjp(lambda q: jax_gather.quad_gather(q, jnp.asarray(gi),
                                                      impl="mxu"), jq)
    want = np.asarray(vjp(jd)[0].astype(jnp.float32))
    tq = torch.from_numpy(np.array(jq.astype(jnp.float32))).to(
        getattr(torch, dtype)).requires_grad_(True)
    td = torch.from_numpy(np.array(jd.astype(jnp.float32))).to(tq.dtype)
    out = port_gather.quad_gather(tq, torch.from_numpy(gi))
    (got,) = torch.autograd.grad(out, tq, td)
    assert got.dtype == tq.dtype and got.shape == (B, n, C)
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)
    direct = port_gather.quad_scatter(td, torch.from_numpy(gi), n)
    assert torch.equal(direct, got)


def test_quad_scatter_checks_its_inputs():
    dg = torch.zeros(2, 5, 16)
    with pytest.raises(TypeError):
        port_gather.quad_scatter(dg, torch.zeros(2, 5, dtype=torch.int64), 4)
    with pytest.raises(ValueError):
        port_gather.quad_scatter(dg, torch.zeros(3, 5, dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="indices"):   # one index per row
        port_gather.quad_scatter(dg, torch.zeros(2, 4, dtype=torch.int32), 4)


def _core_grads(fn, value, loc, w, cot, *extra):
    """(value, loc, attention) gradients of <fn(...), cot> in torch."""
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (value, loc, w)]
    out = fn(ins[0], SHAPES, ins[1], ins[2], *extra)
    return torch.autograd.grad(out, ins, torch.from_numpy(cot))


@pytest.mark.parametrize("lo,hi", LOC_RANGES)
def test_core_gradients_match_jax_and_naive(lo, hi):
    """Value, location and attention gradients of the quad-row core
    against `jax.vjp` of the JAX `xla` core and against the naive
    oracle's autograd; fp32, 1e-5 (summation order only)."""
    value, loc, w = _msda_inputs(21, lo=lo, hi=hi)
    cot = np.random.default_rng(22).normal(
        size=(value.shape[0], loc.shape[1], value.shape[2] * value.shape[3])
    ).astype(np.float32)
    got = _core_grads(port_msda.ms_deform_attn_core, value, loc, w, cot)
    _, vjp = jax.vjp(lambda v, l, a: jax_msda.ms_deform_attn_core(
        v, SHAPES, l, a, gather_impl="xla"), value, loc, w)
    want = vjp(jnp.asarray(cot))
    naive = _core_grads(port_msda.ms_deform_attn_core_naive, value, loc, w,
                        cot)
    for g, jw, nv in zip(got, want, naive):
        np.testing.assert_allclose(g.numpy(), np.asarray(jw), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(g.numpy(), nv.numpy(), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("lo,hi", LOC_RANGES)
def test_use_pallas_gradients_equal_core(lo, hi):
    """`ms_deform_attn(use_pallas=True)`'s backward (the whole-op
    `msda_backward`) gives the quad-row core's VJP, to fp32 summation
    order."""
    value, loc, w = _msda_inputs(23, lo=lo, hi=hi)
    cot = np.random.default_rng(24).normal(
        size=(value.shape[0], loc.shape[1], value.shape[2] * value.shape[3])
    ).astype(np.float32)
    a = _core_grads(port_msda.ms_deform_attn, value, loc, w, cot, True)
    b = _core_grads(port_msda.ms_deform_attn_core, value, loc, w, cot, "xla")
    for ga, gb in zip(a, b):
        torch.testing.assert_close(ga, gb, atol=2e-5, rtol=1e-5)


def test_quad_gather_checks_its_inputs():
    quad = torch.zeros(2, 5, 16)
    with pytest.raises(TypeError):
        port_gather.quad_gather(quad, torch.zeros(2, 3, dtype=torch.int64))
    with pytest.raises(ValueError):
        port_gather.quad_gather(quad, torch.zeros(3, 3, dtype=torch.int32))


@pytest.mark.parametrize("lo,hi", LOC_RANGES)
def test_core_matches_jax_mxu_and_naive(lo, hi):
    value, loc, w = _msda_inputs(42, lo=lo, hi=hi)
    got = port_msda.ms_deform_attn_core(*_t(value), SHAPES, *_t(loc, w))
    want = np.asarray(jax_msda.ms_deform_attn_core(
        value, SHAPES, loc, w, gather_impl="mxu"))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    naive = port_msda.ms_deform_attn_core_naive(*_t(value), SHAPES,
                                                *_t(loc, w))
    np.testing.assert_allclose(got.numpy(), naive.numpy(), atol=1e-5,
                               rtol=1e-5)
    jax_naive = np.asarray(jax_msda.ms_deform_attn_core_naive(
        value, SHAPES, loc, w))
    np.testing.assert_allclose(naive.numpy(), jax_naive, atol=1e-5, rtol=1e-5)


def test_precompute_quad_slab_equal():
    value, _, _ = _msda_inputs(5, Dh=32)
    got = port_msda.precompute_quad_slab(torch.from_numpy(value), SHAPES)
    want = np.asarray(jax_msda.precompute_quad_slab(value, SHAPES))
    np.testing.assert_array_equal(got.numpy(), want)
    assert port_msda.quad_level_offsets(SHAPES) == \
        jax_msda.quad_level_offsets(SHAPES)


@pytest.mark.parametrize("lo,hi", LOC_RANGES)
def test_prequad_matches_jax_mxu_and_naive(lo, hi):
    """The decode-step shape: Lq = 1, Dh * 4 = 128."""
    value, loc, w = _msda_inputs(7, Dh=32, Lq=1, lo=lo, hi=hi)
    slab = port_msda.precompute_quad_slab(torch.from_numpy(value), SHAPES)
    got = port_msda.ms_deform_attn_core_prequad(slab, SHAPES, *_t(loc, w))
    jslab = jax_msda.precompute_quad_slab(value, SHAPES)
    want = np.asarray(jax_msda.ms_deform_attn_core_prequad(
        jslab, SHAPES, loc, w, gather_impl="mxu"))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    naive = port_msda.ms_deform_attn_core_naive(*_t(value), SHAPES,
                                                *_t(loc, w))
    np.testing.assert_allclose(got.numpy(), naive.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_msda_pallas_plain_matches_jax_interpret():
    """As tests/test_msda_pallas.py: Lq not a multiple of block_q."""
    value, loc, w = _msda_inputs(0, B=2, H=2, Dh=8, Lq=12, P=2,
                                 lo=-0.1, hi=1.1)
    shapes = SHAPES[:2]
    loc, w = loc[:, :, :, :2], w[:, :, :, :2]
    got = port_msda_kernel.ms_deform_attn_pallas(*_t(value), shapes,
                                                 *_t(loc, w))
    want = np.asarray(jax_msda_pallas(
        jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(w),
        block_q=8, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("lo,hi", LOC_RANGES)
def test_dispatch_use_pallas_matches_core(lo, hi):
    value, loc, w = _msda_inputs(11, lo=lo, hi=hi)
    a = port_msda.ms_deform_attn(*_t(value), SHAPES, *_t(loc, w),
                                 use_pallas=True)
    b = port_msda.ms_deform_attn(*_t(value), SHAPES, *_t(loc, w),
                                 use_pallas=False)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)


def test_msda_forward_checks_its_inputs():
    v, loc, w = _t(*_msda_inputs(0))
    with pytest.raises(TypeError):          # locations must be fp32
        port_msda_kernel.msda_forward(v, SHAPES, loc.double(), w)
    with pytest.raises(TypeError):          # weights in the value's dtype
        port_msda_kernel.msda_forward(v, SHAPES, loc, w.bfloat16())
    with pytest.raises(ValueError):
        port_msda_kernel.msda_forward(v, SHAPES, loc, w[:, :2])
    with pytest.raises(ValueError):         # levels that do not match
        port_msda_kernel.msda_forward(v, SHAPES[:2], loc, w)
    with pytest.raises(ValueError):         # more cells than value rows
        port_msda_kernel.msda_forward(v[:, :-1], SHAPES, loc, w)


def test_cpu_calls_do_not_count_as_launches():
    """Forward and backward on the CPU run the plain versions only."""
    counters = (port_gather.quad_gather, port_gather.quad_scatter,
                port_msda_kernel.msda_forward, port_msda_kernel.msda_backward)
    before = [f.launches for f in counters]
    value, loc, w = _msda_inputs(1)
    v = torch.from_numpy(value).requires_grad_(True)
    for use_pallas in (True, False):
        out = port_msda.ms_deform_attn(v, SHAPES, *_t(loc, w),
                                       use_pallas=use_pallas)
        out.sum().backward()
    assert v.grad is not None and v.grad.abs().sum() > 0
    assert [f.launches for f in counters] == before

