"""Parity of the port's MSDA ops (`cape_tpu_torch.ops`) with the JAX
package on the CPU.

On CPU tensors the port's kernel wrappers run their plain PyTorch versions;
they are held here against the JAX package's Pallas kernels in interpret
mode (`quad_gather(impl="mxu")`, `ms_deform_attn_pallas(interpret=True)`)
and against the direct 4-corner oracle. Tolerances: a gather is exact;
the fp32 cores agree to 1e-5 (summation order only).
"""

import numpy as np
import pytest
import torch

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
    v = torch.zeros(2, 10, 8)
    idx = torch.zeros(2, 3, 16, dtype=torch.int32)
    w = torch.zeros(2, 3, 16)
    with pytest.raises(TypeError):
        port_msda_kernel.msda_forward(v, idx.long(), w, w)
    with pytest.raises(ValueError):
        port_msda_kernel.msda_forward(v, idx, w[:, :2], w)


def test_cpu_calls_do_not_count_as_launches():
    before = (port_gather.quad_gather.launches,
              port_msda_kernel.msda_forward.launches)
    value, loc, w = _msda_inputs(1)
    port_msda.ms_deform_attn(*_t(value), SHAPES, *_t(loc, w), use_pallas=True)
    port_msda.ms_deform_attn(*_t(value), SHAPES, *_t(loc, w))
    assert (port_gather.quad_gather.launches,
            port_msda_kernel.msda_forward.launches) == before

