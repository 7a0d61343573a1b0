"""The whole-op MSDA backward (`cape_tpu_torch.ops.msda_kernel.msda_backward`)
and the dispatch that pairs it with the forward, on the CPU.

`csrc/msda_bwd.cu` cannot run here (the card checks it against
`msda_backward_plain` in `chip_smoke.py`); what can:

- `msda_backward_plain`, the kernel's reference, against autograd of
  `ms_deform_attn_core_naive` in fp32, for the gradients of the value, the
  sampling locations and the attention weights: levels of unequal size
  down to 1 x 1, points outside their level, on its border and exactly on
  cell edges, Lq * P on both sides of the tiny-site line (256), the
  flagship's heads (8 x 32) and the tiny config's (4 x 16);
- `msda_bwd_plan`'s tiling at the port's sites;
- `ms_deform_attn`'s routing: under 'auto' every call the kernels take
  takes the whole-op function (the `msda.whole_op` counter moves), with
  or without autograd; under a forced selection, or at a shape the
  kernels do not take, the core runs as before, bit for bit, with or
  without gradients.
"""

import numpy as np
import pytest
import torch

from cape_tpu_torch import trace
from cape_tpu_torch.ops import msda as port_msda
from cape_tpu_torch.ops import msda_kernel as mk

#: level grids as (H_l, W_l): unequal, non-square, down to one cell
LEVELS = ((6, 5), (3, 7), (2, 2), (1, 1))
#: the flagship's four levels at 512 px
FLAGSHIP = ((64, 64), (32, 32), (16, 16), (8, 8))


def _inputs(seed, levels, B=2, Lq=11, H=2, Dh=8, P=4, lo=-0.3, hi=1.3):
    """Seeded value, fp32 locations and normalised attention weights, and a
    cotangent. The first queries sample exactly on cell edges (x = loc * W
    - 0.5 an integer), on the border (-0.5 / W: only the right corner in
    the level) and past it (1 + 0.5 / W), and one axis alone on the border;
    the rest uniform in [lo, hi] (some outside the level)."""
    rng = np.random.default_rng(seed)
    L = len(levels)
    S = sum(h * w for h, w in levels)
    value = rng.normal(size=(B, S, H, Dh)).astype(np.float32)
    loc = rng.uniform(lo, hi, size=(B, Lq, H, L, P, 2)).astype(np.float32)
    for lvl, (h, w) in enumerate(levels):
        size = np.array([w, h], np.float32)
        special = [(np.arange(P)[:, None] % size + 0.5) / size,
                   -0.5 / size, 1 + 0.5 / size, np.float32(1.0)]
        for k, where in enumerate(special[:Lq]):
            loc[:, k, :, lvl] = where
        if Lq > 4:
            loc[:, 4, :, lvl, :, 0] = -0.5 / size[0]   # one axis only
    attn = rng.uniform(size=(B, Lq, H, L, P)).astype(np.float32)
    attn /= attn.reshape(B, Lq, H, -1).sum(-1)[..., None, None]
    cot = rng.normal(size=(B, Lq, H * Dh)).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (value, loc, attn, cot))


@pytest.mark.parametrize("levels,Lq,H,Dh", [
    (LEVELS, 11, 2, 8),             # unequal levels, a 1 x 1 level
    (LEVELS, 50, 8, 32),            # Lq * P = 200: a tiny site; flagship heads
    (LEVELS, 70, 4, 16),            # Lq * P = 280; the tiny config's heads
    (LEVELS[:2], 9, 8, 32),
    (((1, 1),), 5, 2, 8),           # one level of one cell
    (FLAGSHIP, 6, 4, 16),
])
def test_plain_backward_matches_autograd_of_the_naive_core(levels, Lq, H,
                                                           Dh):
    value, loc, attn, cot = _inputs(3 + Lq, levels, Lq=Lq, H=H, Dh=Dh)
    v, lc, a = (x.clone().requires_grad_(True) for x in (value, loc, attn))
    out = port_msda.ms_deform_attn_core_naive(v, levels, lc, a)
    want = torch.autograd.grad(out, (v, lc, a), cot)
    got = mk.msda_backward_plain(value, levels, loc, attn, cot)
    for name, g, w in zip(("value", "loc", "attn"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        torch.testing.assert_close(g, w, atol=2e-5, rtol=1e-5,
                                   msg=lambda m: f"grad_{name}: {m}")
    # the wrapper on CPU tensors is the plain version
    for g, w in zip(mk.msda_backward(value, levels, loc, attn, cot), got):
        assert torch.equal(g, w)


def test_plain_backward_in_bf16_rounds_once():
    """bf16 inputs: the fp32 formula on the bf16 values, each gradient
    rounded once to its input's dtype (the locations' stays fp32)."""
    value, loc, attn, cot = _inputs(5, LEVELS, Lq=9, H=2, Dh=16)
    vb, ab, cb = (x.to(torch.bfloat16) for x in (value, attn, cot))
    gv, gl, ga = mk.msda_backward_plain(vb, LEVELS, loc, ab, cb)
    want = mk.msda_backward_plain(vb.float(), LEVELS, loc, ab.float(),
                                  cb.float())
    assert (gv.dtype, gl.dtype, ga.dtype) == (torch.bfloat16, torch.float32,
                                             torch.bfloat16)
    assert torch.equal(gv, want[0].to(torch.bfloat16))
    assert torch.equal(gl, want[1])
    assert torch.equal(ga, want[2].to(torch.bfloat16))


@pytest.mark.parametrize("B,Lq,elt", [
    (4, 5440, 2),      # the training encoder
    (4, 200, 2),       # the teacher-forced decoder
    (8, 5440, 2),      # the serving encoder's batch
    (4, 5440, 4),      # fp32
    (2, 21760, 2),     # 1024 px: the lists take passes through the tile
])
def test_backward_plan_covers_every_level(B, Lq, elt):
    H, Dh, P = 8, 32, 4
    levels = FLAGSHIP if Lq != 21760 else tuple(
        (2 * h, 2 * w) for h, w in FLAGSHIP)
    plan = mk.msda_bwd_plan(B, Lq, H, Dh, P, levels, elt)
    assert plan.G == Dh * elt // 16 and plan.threads == 256
    share = -(-Lq * P // 32) * 32
    assert plan.cap % 8 == 0 and plan.cap <= 65_535
    assert plan.use_tile == int(share > plan.cap)
    assert 0 < plan.smem_bytes <= 232_448
    assert plan.point_blocks * plan.threads >= B * Lq * H * plan.G
    warps = plan.threads // 32
    for lvl, (h, w) in enumerate(levels):
        rows, tiles, split = plan.tiling[3 * lvl:3 * lvl + 3]
        assert rows * tiles >= h * w > rows * (tiles - 1)
        assert rows + w + 1 < 65_535
        assert split & (split - 1) == 0 and plan.G * split <= 32
        # every warp of a block gets a row where the level has them
        assert rows >= min(h * w, warps * 32 // (plan.G * split))


@pytest.mark.parametrize("args", [
    dict(Dh=4, elt=2),                  # 8 bytes a head: not a 16-byte lane
    dict(Dh=24, elt=4),                 # 6 lanes: not a power of two
    dict(levels=((2, 2),) * 9),         # more levels than the table holds
])
def test_backward_plan_refuses_what_the_kernel_does_not_take(args):
    kw = dict(B=2, Lq=10, H=8, Dh=32, P=4, levels=((4, 4), (2, 2)),
              elt=2) | args
    with pytest.raises(ValueError):
        mk.msda_bwd_plan(**kw)


def _whole_ops():
    return trace.counters().get("msda.whole_op", 0)


def _run(value, loc, attn, cot, levels, **kw):
    v, lc, a = (x.clone().requires_grad_(True) for x in (value, loc, attn))
    out = port_msda.ms_deform_attn(v, levels, lc, a, **kw)
    if not out.requires_grad:
        return out, None
    return out.detach(), torch.autograd.grad(out, (v, lc, a), cot)


def test_auto_under_autograd_takes_the_whole_op(monkeypatch):
    monkeypatch.delenv("CAPE_MSDA_GATHER", raising=False)
    monkeypatch.delenv("CAPE_MSDA_TINY", raising=False)
    value, loc, attn, cot = _inputs(7, LEVELS, Lq=70, H=4, Dh=16)
    n0 = _whole_ops()
    out, grads = _run(value, loc, attn, cot, LEVELS)
    assert _whole_ops() == n0 + 1
    assert torch.equal(out, mk.msda_forward_plain(value, LEVELS, loc, attn))
    for g, w in zip(grads, mk.msda_backward_plain(value, LEVELS, loc, attn,
                                                  cot)):
        assert torch.equal(g, w)
    # the gradients are the quad-row core's, to fp32 summation order
    v, lc, a = (x.clone().requires_grad_(True) for x in (value, loc, attn))
    core = port_msda.ms_deform_attn_core(v, LEVELS, lc, a)
    for g, w in zip(grads, torch.autograd.grad(core, (v, lc, a), cot)):
        torch.testing.assert_close(g, w, atol=2e-5, rtol=1e-5)


def _without_gradients(value, loc, attn, levels):
    """`ms_deform_attn` in each way a call goes unrecorded: under
    `torch.no_grad()` (inputs that require grad), under
    `torch.inference_mode()`, and with grad mode on but no input that
    requires grad."""
    with torch.no_grad():
        v, lc, a = (x.clone().requires_grad_(True)
                    for x in (value, loc, attn))
        got = port_msda.ms_deform_attn(v, levels, lc, a)
    with torch.inference_mode():
        got_inf = port_msda.ms_deform_attn(value, levels, loc, attn)
    got_plain = port_msda.ms_deform_attn(value, levels, loc, attn)
    return got, got_inf, got_plain


def test_auto_without_gradients_takes_the_whole_op(monkeypatch):
    """No autograd under 'auto': the whole op, once a call (the counter
    moves by 3), bit for bit `msda_forward`'s; the core's function to fp32
    summation order; nothing that requires grad comes out."""
    monkeypatch.delenv("CAPE_MSDA_GATHER", raising=False)
    monkeypatch.delenv("CAPE_MSDA_TINY", raising=False)
    value, loc, attn, _ = _inputs(8, LEVELS, Lq=70, H=4, Dh=16)
    want = mk.msda_forward_plain(value, LEVELS, loc, attn)
    core = port_msda.ms_deform_attn_core(value, LEVELS, loc, attn)
    n0 = _whole_ops()
    outs = _without_gradients(value, loc, attn, LEVELS)
    assert _whole_ops() == n0 + 3
    for g in outs:
        assert not g.requires_grad
        assert torch.equal(g, want)
        torch.testing.assert_close(g, core, atol=2e-6, rtol=1e-5)


def test_without_gradients_the_quad_row_core_runs(monkeypatch):
    """A head of 4 bf16 values (8 bytes, not a 16-byte lane), which the
    kernel refuses: under 'auto' and without gradients the quad-row core
    runs as before, bit for bit, and the counter stays."""
    monkeypatch.delenv("CAPE_MSDA_GATHER", raising=False)
    monkeypatch.delenv("CAPE_MSDA_TINY", raising=False)
    value, loc, attn, _ = _inputs(8, LEVELS, Lq=70, H=2, Dh=4)
    value, attn = value.to(torch.bfloat16), attn.to(torch.bfloat16)
    want = port_msda.ms_deform_attn_core(value, LEVELS, loc, attn,
                                         gather_impl="xla")
    n0 = _whole_ops()
    outs = _without_gradients(value, loc, attn, LEVELS)
    assert _whole_ops() == n0
    for g in outs:
        assert torch.equal(g, want)


@pytest.mark.parametrize("impl", ["xla", "mxu", "fused", "naive", "flat"])
def test_forced_selection_keeps_its_formulation_without_grad(monkeypatch,
                                                             impl):
    monkeypatch.setenv("CAPE_MSDA_GATHER", impl)
    value, loc, attn, _ = _inputs(14, LEVELS, Lq=70, H=4, Dh=16)
    want = port_msda.ms_deform_attn_core(value, LEVELS, loc, attn,
                                         gather_impl=impl)
    n0 = _whole_ops()
    outs = _without_gradients(value, loc, attn, LEVELS)
    assert _whole_ops() == n0
    for g in outs:
        assert torch.equal(g, want)


@pytest.mark.parametrize("impl", ["xla", "mxu", "fused", "naive", "flat"])
def test_forced_selection_keeps_its_formulation_under_grad(monkeypatch,
                                                           impl):
    monkeypatch.setenv("CAPE_MSDA_GATHER", impl)
    value, loc, attn, cot = _inputs(9, LEVELS, Lq=70, H=4, Dh=16)
    n0 = _whole_ops()
    out, grads = _run(value, loc, attn, cot, LEVELS)
    assert _whole_ops() == n0
    v, lc, a = (x.clone().requires_grad_(True) for x in (value, loc, attn))
    core = port_msda.ms_deform_attn_core(v, LEVELS, lc, a, gather_impl=impl)
    assert torch.equal(out, core.detach())
    for g, w in zip(grads, torch.autograd.grad(core, (v, lc, a), cot)):
        assert torch.equal(g, w)


def test_tiny_site_follows_cape_msda_tiny(monkeypatch):
    """At a tiny site (Lq * P <= 256) 'auto' consults CAPE_MSDA_TINY: a
    name there is a forced selection; unset, the site stays 'auto'."""
    monkeypatch.delenv("CAPE_MSDA_GATHER", raising=False)
    value, loc, attn, cot = _inputs(10, LEVELS, Lq=50, H=4, Dh=16)
    monkeypatch.setenv("CAPE_MSDA_TINY", "naive")
    n0 = _whole_ops()
    _run(value, loc, attn, cot, LEVELS)
    assert _whole_ops() == n0
    monkeypatch.delenv("CAPE_MSDA_TINY")
    _run(value, loc, attn, cot, LEVELS)
    assert _whole_ops() == n0 + 1


def test_shapes_the_kernels_do_not_take_keep_the_core(monkeypatch):
    """A head of 4 bf16 values (8 bytes, not a 16-byte lane) under
    autograd: the core, as before."""
    monkeypatch.delenv("CAPE_MSDA_GATHER", raising=False)
    value, loc, attn, cot = _inputs(11, LEVELS, Lq=70, H=2, Dh=4)
    value, attn, cot = (x.to(torch.bfloat16) for x in (value, attn, cot))
    n0 = _whole_ops()
    out, grads = _run(value, loc, attn, cot, LEVELS)
    assert _whole_ops() == n0
    v, lc, a = (x.clone().requires_grad_(True) for x in (value, loc, attn))
    core = port_msda.ms_deform_attn_core(v, LEVELS, lc, a)
    assert torch.equal(out, core.detach())


def test_use_pallas_takes_the_whole_op_with_or_without_gradients(
        monkeypatch):
    monkeypatch.setenv("CAPE_MSDA_GATHER", "xla")
    value, loc, attn, cot = _inputs(12, LEVELS, Lq=11, H=2, Dh=8)
    n0 = _whole_ops()
    out, grads = _run(value, loc, attn, cot, LEVELS, use_pallas=True)
    with torch.no_grad():
        out_ng = port_msda.ms_deform_attn(value, LEVELS, loc, attn,
                                          use_pallas=True)
    assert _whole_ops() == n0 + 2
    assert torch.equal(out, out_ng)
    for g, w in zip(grads, mk.msda_backward_plain(value, LEVELS, loc, attn,
                                                  cot)):
        assert torch.equal(g, w)


def test_wrapper_refuses_a_mismatched_cotangent_and_other_devices():
    value, loc, attn, cot = _inputs(13, LEVELS[:1])
    with pytest.raises(ValueError, match="grad_out"):
        mk.msda_backward(value, LEVELS[:1], loc, attn, cot[:, :-1])
    with pytest.raises(ValueError, match="unsupported device"):
        mk.msda_backward(*(x.to("meta") for x in (value,)), LEVELS[:1],
                         loc.to("meta"), attn.to("meta"), cot.to("meta"))
