"""Parity of the port's training slice (`cape_tpu_torch.train`, `losses`,
the teacher-forced `CAPE.forward`, `data.tokenizer`) with the JAX package
on the CPU, at the tiny config in fp32 with dropout 0.

Weights: seeded numpy values in the JAX tree, carried over by
`convert.from_jax_params` (`tests/test_torch_port_util.py`). Tolerances
are fp32 summation order unless stated. Dropout cannot reproduce JAX's
random bits, so it is held to its statistics and to reproducibility from
one generator seed instead.
"""

import functools

import numpy as np
import pytest
import torch

import flax
import jax

from cape_tpu.data import tokenizer as jax_tok
from cape_tpu.losses import cape_criterion as jax_criterion
from cape_tpu.train import state as jax_state
from cape_tpu.train import train_step as jax_step

from cape_tpu_torch.config import CAPEConfig as PortConfig
from cape_tpu_torch.convert import from_jax_train_state, port_key
from cape_tpu_torch.data import tokenizer as port_tok
from cape_tpu_torch.losses import cape_criterion as port_criterion
from cape_tpu_torch.models.cape import CAPE as PortCAPE
from cape_tpu_torch.models.layers import dropout
from cape_tpu_torch.train import state as port_state
from cape_tpu_torch.train import train_step as port_step

from test_torch_port_util import jax_tiny, port_model, train_batch

STEPS_PER_EPOCH = 4
#: the trajectory's config: two micro-steps per update, a warmup so the
#: learning rate moves between updates
TRAJ = dict(accumulation_steps=2, warmup_epochs=1)


def _port_cfg(jax_cfg):
    return PortConfig.from_json(jax_cfg.to_json())


def _flat(tree):
    """JAX param-shaped tree -> {port key: fp32 array in the port layout}."""
    out = {}
    for path, v in flax.traverse_util.flatten_dict(tree, sep="/").items():
        v = np.asarray(v, np.float32)
        if path.endswith("kernel"):
            v = v.T if v.ndim == 2 else v.transpose(3, 2, 0, 1)
        out[port_key(path)] = v
    return out


def _torch_batch(batch):
    return jax.tree_util.tree_map(torch.from_numpy, batch)


# -- tokenizer ------------------------------------------------------------------
@pytest.mark.parametrize("n,nb", [(5, 10), (17, 44), (0, 44)])
def test_tokenize_keypoints_matches_jax(n, nb):
    rng = np.random.default_rng(n)
    kpts = rng.uniform(-20, 540, (n, 2))        # some outside the image
    vis = rng.integers(0, 3, n)
    jt, pt = jax_tok.DiscreteTokenizer(nb, 40), port_tok.DiscreteTokenizer(
        nb, 40)
    want = jax_tok.tokenize_keypoints(jt, kpts, 480, 520, vis, category_id=3)
    got = port_tok.tokenize_keypoints(pt, kpts, 480, 520, vis, category_id=3)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    q = pt.quantize(kpts / 500.0)
    np.testing.assert_array_equal(q, jt.quantize(kpts / 500.0))
    ids = pt.corner_ids(q)
    for a, b in zip(ids, jt.corner_ids(q)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pt.detokenize(ids[0], ids[4], ids[5]),
                                  jt.detokenize(ids[0], ids[4], ids[5]))


# -- criterion ------------------------------------------------------------------
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("sample_mask", [None, (True, False, True),
                                         (False, False, False)])
def test_cape_criterion_matches_jax(smoothing, sample_mask):
    cfg, _, _ = jax_tiny(0)
    cfg = cfg.replace(label_smoothing=smoothing)
    batch = train_batch(cfg, 3, seed=5)
    rng = np.random.default_rng(6)
    B, L = 3, cfg.seq_len
    outputs = {"pred_logits": rng.normal(size=(B, L, 3)) * 2,
               "pred_coords": rng.uniform(size=(B, L, 2)),
               "aux_classes": rng.normal(size=(1, B, L, 3)),
               "aux_coords": rng.uniform(size=(1, B, L, 2))}
    outputs = {k: v.astype(np.float32) for k, v in outputs.items()}
    sm = None if sample_mask is None else np.array(sample_mask)
    want = jax_criterion(outputs, batch["targets"], cfg, sample_mask=sm)
    got = port_criterion(
        {k: torch.from_numpy(v) for k, v in outputs.items()},
        {k: torch.from_numpy(v) for k, v in batch["targets"].items()},
        _port_cfg(cfg), None if sm is None else torch.from_numpy(sm))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


# -- schedules and parameter groups --------------------------------------------
@pytest.mark.parametrize("scheduler,extra", [
    ("cosine_warmrestarts", {}), ("cosine_warmrestarts", {"t_mult": 1}),
    ("multistep", {"lr_drop_epochs": (3, 7)}), ("onecycle", {})])
def test_lr_schedules_match_jax(scheduler, extra):
    cfg, _, _ = jax_tiny(0)
    cfg = cfg.replace(scheduler=scheduler, warmup_epochs=2, t0=2, epochs=12,
                      **extra)
    steps = [0, 1, 3, 7, 8, 9, 11, 15, 16, 23, 24, 40, 47, 55, 100]
    for base in (1e-4, 1e-5):
        js = jax_state.make_lr_schedule(cfg, base, STEPS_PER_EPOCH)
        ps = port_state.make_lr_schedule(_port_cfg(cfg), base,
                                         STEPS_PER_EPOCH)
        got = np.array([ps(s) for s in steps])
        want = np.array([float(js(s)) for s in steps])
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-12)


@pytest.mark.parametrize("freeze", [True, False])
def test_param_labels_match_jax(freeze):
    cfg, _, params = jax_tiny(0)
    want = {port_key(k): v for k, v in flax.traverse_util.flatten_dict(
        jax_state._param_labels(params, freeze), sep="/").items()}
    got = port_state._param_labels(port_model(cfg, params), freeze)
    assert got == want
    assert set(got.values()) == ({"frozen", "backbone", "offsets", "base"}
                                 if freeze else
                                 {"backbone", "offsets", "base"})


# -- the teacher-forced model ---------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_loss_and_grad(seed):
    cfg, jm, params = jax_tiny(seed)

    @jax.jit
    def loss_and_grad(p, batch):
        def loss(p):
            out = jax_step._forward_losses(jm, cfg, p, batch)
            return out["total"], out
        return jax.value_and_grad(loss, has_aux=True)(p)

    return loss_and_grad


@pytest.mark.parametrize("variant", [{}, {"with_poly_refine": False}])
def test_teacher_forced_outputs_match_jax(variant):
    cfg, jm, params = jax_tiny(0, **variant)
    pm = port_model(cfg, params)
    batch = train_batch(cfg, 2, seed=1)
    args = [batch[k] for k in ("query_images", "support_coords",
                               "support_mask", "skeleton_edges", "targets")]
    want = jm.apply({"params": params}, *args)
    got = pm(*_torch_batch(args))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), atol=1e-4, rtol=1e-4,
                                   err_msg=k)


def test_every_parameter_gradient_matches_jax():
    """Loss and the gradient of every parameter against `jax.grad`; the
    error of each tensor is measured against the global gradient norm.
    2e-5 (fp32 summation order) for the transformer; 1e-3 for the backbone
    and input projections, which random weights make ill-conditioned (the
    GroupNorm of the 1x1 extra level normalises 2 values a group): there
    the JAX and the port's fp32 gradients each sit up to 4e-4 of the
    global norm from an fp64 run of the port."""
    cfg, _, params = jax_tiny(0)
    pm = port_model(cfg, params)
    batch = train_batch(cfg, 2, seed=2)
    (loss, _), grads = _jax_loss_and_grad(0)(params, batch)
    want = _flat(grads)
    losses = port_step.forward_losses(pm, _port_cfg(cfg), batch)
    np.testing.assert_allclose(losses["total"].item(), float(loss), rtol=1e-5)
    names = [n for n, _ in pm.named_parameters()]
    got = torch.autograd.grad(losses["total"],
                              [p for _, p in pm.named_parameters()])
    assert set(names) == set(want)
    gnorm = np.sqrt(sum((w.astype(np.float64) ** 2).sum()
                        for w in want.values()))
    value_path = 0.0
    for name, g in zip(names, got):
        err = np.abs(g.numpy() - want[name]).max() / gnorm
        conv = name.startswith(("backbone.", "input_projs."))
        assert err < (1e-3 if conv else 2e-5), (name, err)
        if "value_proj.weight" in name:
            value_path += float(g.abs().sum())
    assert value_path > 0      # the gather's backward reached value_proj


@pytest.mark.parametrize("impl", ["fused", "fusedq"])
def test_gather_impl_outputs_loss_and_gradients_match_jax(monkeypatch, impl):
    """The whole training path under `CAPE_MSDA_GATHER=fused|fusedq`,
    set for both packages (the JAX side runs its Pallas kernels in
    interpret mode, forward and backward): the teacher-forced outputs, the
    loss and every parameter's gradient, with the tolerances of the two
    tests above."""
    from cape_tpu_torch.ops import msda as port_msda

    monkeypatch.setenv("CAPE_MSDA_GATHER", impl)
    cfg, jm, params = jax_tiny(0)
    pm = port_model(cfg, params)
    batch = train_batch(cfg, 2, seed=2)

    @jax.jit                       # a fresh trace: the variable is read in it
    def jax_run(p, batch):
        def loss(p):
            out = jm.apply({"params": p}, *(batch[k] for k in (
                "query_images", "support_coords", "support_mask",
                "skeleton_edges", "targets")))
            return jax_criterion(out, batch["targets"], cfg)["total"], out
        return jax.value_and_grad(loss, has_aux=True)(p)

    (loss, want_out), grads = jax_run(params, batch)
    ran = []
    core = getattr(port_msda, {"fused": "ms_deform_attn_core_fused",
                               "fusedq": "ms_deform_attn_core_quadfused"}[impl])
    monkeypatch.setattr(port_msda, core.__name__,
                        lambda *a: ran.append(1) or core(*a))
    tb = _torch_batch(batch)
    got_out = pm(*(tb[k] for k in ("query_images", "support_coords",
                                   "support_mask", "skeleton_edges",
                                   "targets")))
    assert len(ran) == cfg.enc_layers + cfg.dec_layers
    assert got_out.keys() == want_out.keys()
    for k in want_out:
        np.testing.assert_allclose(got_out[k].detach().numpy(),
                                   np.asarray(want_out[k]), atol=1e-4,
                                   rtol=1e-4, err_msg=k)
    losses = port_criterion(got_out, tb["targets"], _port_cfg(cfg))
    np.testing.assert_allclose(losses["total"].item(), float(loss), rtol=1e-5)
    want = _flat(grads)
    names = [n for n, _ in pm.named_parameters()]
    got = torch.autograd.grad(losses["total"],
                              [p for _, p in pm.named_parameters()])
    gnorm = np.sqrt(sum((w.astype(np.float64) ** 2).sum()
                        for w in want.values()))
    value_path = 0.0
    for name, g in zip(names, got):
        err = np.abs(g.numpy() - want[name]).max() / gnorm
        conv = name.startswith(("backbone.", "input_projs."))
        assert err < (1e-3 if conv else 2e-5), (name, err)
        if "value_proj.weight" in name:
            value_path += float(g.abs().sum())
    assert value_path > 0      # the fused backward reached value_proj


# -- the train step ---------------------------------------------------------------
def _jax_trajectory(n_steps):
    """n JAX train steps from the seeded weights; the state after each."""
    cfg, jm, params = jax_tiny(0, **TRAJ)
    step = jax_step.make_train_step(jm, cfg, STEPS_PER_EPOCH, donate=False)
    st = jax_state.create_train_state(cfg, {"params": params},
                                      STEPS_PER_EPOCH)
    states, metrics = [st], []
    for i in range(n_steps):
        st, m = step(st, train_batch(cfg, 2, seed=10 + i),
                     jax.random.PRNGKey(i))
        states.append(st)
        metrics.append({k: float(v) for k, v in m.items()})
    return cfg, states, metrics


@pytest.fixture(scope="module")
def jax_traj():
    return _jax_trajectory(4)


def _check_update(cfg, before, after, port_before, port_after, acc, count,
                  atol=5e-3):
    """Parameter updates (after - before) of the port against JAX's, in
    units of each group's learning rate at `count`: within `atol`, and 0.1
    for the backbone and input projections, whose fp32 gradients are
    ill-conditioned at random weights (see the gradient test above).

    Adam divides each gradient element by its own size plus eps (1e-8), so
    where the clipped, averaged gradient `acc` is within 100x of eps the
    update amplifies fp32 summation noise (d u / d g ~ 1 / (|g| + eps)).
    No element is excluded; those get 0.1 instead. Returns their count."""
    norm = np.sqrt(sum((a.astype(np.float64) ** 2).sum() for a in acc.values()))
    clip = min(1.0, cfg.clip_max_norm / norm)
    tx = port_state.FusedAdamW(_port_cfg(cfg), STEPS_PER_EPOCH)
    lrs = tx.group_lrs(count)
    labels = port_state._param_labels(
        PortCAPE(_port_cfg(cfg), device="cpu"), tx.freeze_affine)
    near_eps = 0
    for name, b in before.items():
        lr = lrs[labels[name]]
        want = (after[name] - b) / lr
        got = (port_after[name] - port_before[name]) / lr
        small = np.abs(acc[name]) * clip < 100 * port_state.ADAM_EPS
        near_eps += int(small.sum())
        conv = name.startswith(("backbone.", "input_projs."))
        np.testing.assert_allclose(got[~small], want[~small],
                                   atol=0.1 if conv else atol, rtol=0,
                                   err_msg=name)
        np.testing.assert_allclose(got[small], want[small], atol=0.1,
                                   rtol=0, err_msg=name)
    return near_eps


def _port_params(model):
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


def test_train_steps_match_jax(jax_traj):
    """3 micro-steps with accumulation_steps=2 (one real update between
    them): metrics, untouched parameters on micro-steps 1 and 3, and the
    update of step 2 in units of the learning rate."""
    cfg, states, metrics = jax_traj
    _, _, params = jax_tiny(0, **TRAJ)
    pm = port_model(cfg, params)
    pcfg = _port_cfg(cfg)
    st = port_state.create_train_state(pcfg, pm, STEPS_PER_EPOCH)
    step = port_step.make_train_step(pm, pcfg, STEPS_PER_EPOCH)
    gen = torch.Generator().manual_seed(0)
    snapshots = [_port_params(pm)]
    for i in range(3):
        st, m = step(st, train_batch(cfg, 2, seed=10 + i), gen)
        snapshots.append(_port_params(pm))
        assert st.step == i + 1
        assert m.keys() == metrics[i].keys()
        for k, v in m.items():
            np.testing.assert_allclose(v.item(), metrics[i][k], rtol=1e-4,
                                       err_msg=f"step {i + 1} {k}")
    for a, b in ((0, 1), (2, 3)):
        for n in snapshots[a]:
            np.testing.assert_array_equal(snapshots[a][n], snapshots[b][n])
    assert st.opt_state.gradient_step == 1 and st.opt_state.mini_step == 1
    # the gradient average the update was made from, as JAX computes it
    grad = _jax_loss_and_grad(0)
    g1 = _flat(grad(states[0].params, train_batch(cfg, 2, seed=10))[1])
    g2 = _flat(grad(states[0].params, train_batch(cfg, 2, seed=11))[1])
    acc = {n: g1[n] + (g2[n] - g1[n]) / 2 for n in g1}
    near_eps = _check_update(cfg, _flat(states[1].params),
                             _flat(states[2].params), snapshots[1],
                             snapshots[2], acc, count=0)
    # the random tiny model's gradient norm (~38) makes the clip scale
    # 0.1/38, which puts most elements near eps: 6,847,325 of 9,742,586
    assert 0 < near_eps < sum(v.size for v in acc.values())


def test_train_state_carry_over(jax_traj):
    """2 JAX steps, carried into the port (`from_jax_train_state`), then
    steps 3 and 4 in both: the accumulated gradient after step 3 and the
    real update of step 4, made with the carried Adam moments."""
    cfg, states, metrics = jax_traj
    pcfg = _port_cfg(cfg)
    tree = flax.serialization.to_state_dict(jax.device_get(states[2]))
    sd = from_jax_train_state(tree, pcfg)
    assert (sd["step"], sd["adam_count"], sd["sched_count"], sd["mini_step"],
            sd["gradient_step"]) == (2, 1, 1, 0, 1)
    pm = PortCAPE(pcfg, device="cpu")
    st = port_state.create_train_state(pcfg, pm, STEPS_PER_EPOCH)
    st.load_state_dict(sd)
    step = port_step.make_train_step(pm, pcfg, STEPS_PER_EPOCH)
    gen = torch.Generator().manual_seed(0)
    st, m = step(st, train_batch(cfg, 2, seed=12), gen)
    np.testing.assert_allclose(m["total"].item(), metrics[2]["total"],
                               rtol=1e-5)
    acc_want = _flat(flax.serialization.to_state_dict(
        jax.device_get(states[3]))["opt_state"]["acc_grads"])
    gnorm = np.sqrt(sum((a.astype(np.float64) ** 2).sum()
                        for a in acc_want.values()))
    for name, a in zip(st.opt_state.names, st.opt_state.acc_grads):
        err = np.abs(a.numpy() - acc_want[name]).max() / gnorm
        assert err < 2e-5, (name, err)
    before = _port_params(pm)
    g4 = _flat(_jax_loss_and_grad(0)(states[3].params,
                                     train_batch(cfg, 2, seed=13))[1])
    acc = {n: acc_want[n] + (g4[n] - acc_want[n]) / 2 for n in acc_want}
    st, m = step(st, train_batch(cfg, 2, seed=13), gen)
    np.testing.assert_allclose(m["grad_norm"].item(),
                               metrics[3]["grad_norm"], rtol=1e-4)
    assert st.step == 4 and st.opt_state.adam_count == 2
    # a second update's first moment mixes two gradients and can cancel,
    # which amplifies fp32 noise further than the first update's: 2e-2
    _check_update(cfg, _flat(states[3].params), _flat(states[4].params),
                  before, _port_params(pm), acc, count=1, atol=2e-2)
    # the Adam moments after the update, against their global norms
    adam = flax.serialization.to_state_dict(jax.device_get(states[4]))[
        "opt_state"]["inner_opt_state"]["1"]
    for key in ("mu", "nu"):
        want = _flat(adam[key])
        norm = np.sqrt(sum((w.astype(np.float64) ** 2).sum()
                           for w in want.values()))
        for name, t in zip(st.opt_state.names, getattr(st.opt_state, key)):
            err = np.abs(t.numpy() - want[name]).max() / norm
            assert err < 1e-3, (key, name, err)


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_train_state_carry_rejects_bad_trees(jax_traj, fault):
    cfg, states, _ = jax_traj
    tree = flax.serialization.to_state_dict(jax.device_get(states[1]))
    mu = tree["opt_state"]["inner_opt_state"]["1"]["mu"]
    if fault == "missing":
        del mu["level_embed"]
        err, key = KeyError, "level_embed"
    elif fault == "extra":
        tree["opt_state"]["extra_count"] = np.zeros((), np.int32)
        err, key = KeyError, "opt_state/extra_count"
    else:
        mu["level_embed"] = np.zeros((3, 3), np.float32)
        err, key = ValueError, "opt_state/inner_opt_state/1/mu/level_embed"
    with pytest.raises(err, match=key):
        from_jax_train_state(tree, _port_cfg(cfg))


def test_scan_step_equals_repeated_steps():
    cfg, _, params = jax_tiny(0, **TRAJ)
    pcfg = _port_cfg(cfg)
    batches = [train_batch(cfg, 2, seed=30 + i) for i in range(2)]
    stacked = jax.tree_util.tree_map(lambda *x: np.stack(x), *batches)
    runs = []
    for scan in (True, False):
        pm = port_model(cfg, params)
        st = port_state.create_train_state(pcfg, pm, STEPS_PER_EPOCH)
        if scan:
            st, m = port_step.make_scan_train_step(pm, pcfg, STEPS_PER_EPOCH)(
                st, stacked)
        else:
            step = port_step.make_train_step(pm, pcfg, STEPS_PER_EPOCH)
            ms = [step(st, b)[1] for b in batches]
            m = {k: torch.stack([x[k] for x in ms]) for k in ms[0]}
        runs.append((_port_params(pm), m))
    (pa, ma), (pb, mb) = runs
    assert ma["total"].shape == (2,)
    for k in ma:
        assert torch.equal(ma[k], mb[k])
    for n in pa:
        np.testing.assert_array_equal(pa[n], pb[n])


def test_train_step_uses_the_states_optimizer():
    """The step runs the optimizer that `create_train_state` built and
    labelled the state with, and refuses a state built for another
    schedule length or another model."""
    cfg, _, params = jax_tiny(0, **TRAJ)
    pcfg = _port_cfg(cfg)
    pm = port_model(cfg, params)
    st = port_state.create_train_state(pcfg, pm, STEPS_PER_EPOCH)
    assert isinstance(st.tx, port_state.FusedAdamW)
    assert st.opt_state.labels == [
        port_state._param_labels(pm, st.tx.freeze_affine)[n]
        for n in st.opt_state.names]
    batch = train_batch(cfg, 2, seed=60)
    with pytest.raises(ValueError, match="steps_per_epoch"):
        port_step.make_train_step(pm, pcfg, STEPS_PER_EPOCH + 1)(st, batch)
    other = port_state.create_train_state(pcfg, port_model(cfg, params),
                                          STEPS_PER_EPOCH)
    with pytest.raises(ValueError, match="another model"):
        port_step.make_train_step(pm, pcfg, STEPS_PER_EPOCH)(other, batch)
    assert st.step == 0 and st.opt_state.mini_step == 0


def test_eval_loss_honours_sample_valid():
    cfg, jm, params = jax_tiny(0)
    batch = train_batch(cfg, 3, seed=40)
    batch["sample_valid"] = np.array([True, False, True])
    want = jax_step.make_eval_loss_fn(jm, cfg)(params, batch)
    got = port_step.make_eval_loss_fn(port_model(cfg, params),
                                      _port_cfg(cfg))(batch)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, err_msg=k)


# -- dropout --------------------------------------------------------------------
def test_dropout_statistics():
    """Keep rate 1 - p, kept values scaled by 1/(1-p), the identity without
    a generator: 1e6 draws put the keep rate within 5 standard errors."""
    x = torch.ones(1000, 1000)
    for p in (0.1, 0.5):
        y = dropout(x, p, torch.Generator().manual_seed(1))
        kept = y != 0
        se = np.sqrt(p * (1 - p) / x.numel())
        assert abs(kept.float().mean().item() - (1 - p)) < 5 * se
        torch.testing.assert_close(y[kept], torch.full_like(y[kept],
                                                            1 / (1 - p)))
    assert dropout(x, 0.1, None) is x
    assert dropout(x, 0.0, torch.Generator()) is x


def test_dropout_training_is_reproducible_from_one_seed():
    """With dropout 0.1 the same generator seed gives the same losses and
    gradients, another seed other ones, and `generator=None` the
    deterministic forward; remat replays the same masks."""
    cfg, _, params = jax_tiny(0, dropout=0.1)
    batch = train_batch(cfg, 2, seed=50)

    def run(seed, remat=False):
        pm = port_model(cfg, params, remat_encoder=remat)
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        losses = port_step.forward_losses(pm, _port_cfg(cfg), batch, gen)
        grads = torch.autograd.grad(losses["total"], list(pm.parameters()))
        return losses["total"].item(), grads

    a, b, c = run(7), run(7), run(8)
    det = run(None)
    assert a[0] == b[0] and all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
    assert a[0] != c[0] and a[0] != det[0]
    r = run(7, remat=True)
    np.testing.assert_allclose(r[0], a[0], rtol=1e-6)
    for x, y in zip(r[1], a[1]):
        torch.testing.assert_close(x, y, atol=1e-6, rtol=1e-5)


# -- config ----------------------------------------------------------------------
@pytest.mark.parametrize("option", [{"dec_attn_concat_src": True},
                                    {"dec_qkv_proj": False}])
def test_train_only_options_are_rejected(option):
    with pytest.raises(ValueError, match="ROADMAP"):
        PortCAPE(PortConfig().replace(**option), device="cpu")
