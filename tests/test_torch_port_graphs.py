"""The port's compile-once slice on the CPU, at the tiny config in fp32
with dropout 0: the decode split into a prologue and a token body that
carries its position on the device and masks its writes (what
`cape_tpu_torch.graphs` captures into CUDA graphs on the card), the fused
AdamW reading its scalars from a device tensor, the `steps_per_dispatch`
step, and the per-call host tensors made once.

Against the JAX package: `autoregressive_decode` (its `while_loop`) to
the serving tests' tolerance (logits and coords 1e-4; lengths, gen_valid
and unfinished equal), `make_optimizer` (jitted at XLA's backend optimization level 0; fp32
masters within 1e-6) and
`make_scan_train_step` (metrics 1e-4; masters within a tenth of the
group's learning rate, the trajectory test's band for elements near Adam's
eps). Chunked decodes are held to each other bit for bit.
"""

import flax
import jax
import numpy as np
import optax
import pytest
import torch

from cape_tpu.models.cape import autoregressive_decode as jax_decode
from cape_tpu.train import state as jax_state
from cape_tpu.train import train_step as jax_step

from cape_tpu_torch import graphs
from cape_tpu_torch.config import CAPEConfig as PortConfig
from cape_tpu_torch.convert import port_key
from cape_tpu_torch.eval import evaluate as port_evaluate
from cape_tpu_torch.models import cape as port_cape
from cape_tpu_torch.train import state as port_state
from cape_tpu_torch.train import train_step as port_step

from test_torch_port_util import (episode_inputs, few_torch_threads,  # noqa: F401
                                  jax_tiny, port_model, train_batch)

#: decode cases: (force_length, max_len, CAPE_DECODE_PREQUAD)
DECODE_CASES = {"eos_exit": (None, None, None), "force_length": (9, None, None),
                "max_len": (None, 10, None), "no_prequad": (None, None, "0")}


@pytest.fixture(scope="module")
def setup():
    cfg, jm, params = jax_tiny(0)
    return cfg, jm, params, port_model(cfg, params)


@pytest.fixture(scope="module")
def episode(setup):
    return episode_inputs(setup[0], batch=3, seed=1)


def _port_cfg(jax_cfg):
    return PortConfig.from_json(jax_cfg.to_json())


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_chunked_decode_matches_jax(setup, episode, monkeypatch, case):
    """The prologue and token bodies, run with a host read every 1, 3 and
    L tokens: the three runs are bit-equal, each is the JAX decode's, and
    the steps never run keep their defaults."""
    cfg, jm, params, pm = setup
    force, cap, prequad = DECODE_CASES[case]
    monkeypatch.setenv("CAPE_MSDA_GATHER", "mxu")
    if prequad is not None:
        monkeypatch.setenv("CAPE_DECODE_PREQUAD", prequad)
    want = {k: np.asarray(v) for k, v in jax_decode(
        jm, {"params": params}, *episode, force_length=force,
        max_len=cap).items()}
    L = port_cape.decode_length(pm.cfg, cap)
    runs = [port_cape.decode_chunked(pm, *episode, force_length=force,
                                     max_len=cap, chunk=c)
            for c in (1, 3, L)]
    for got in runs[1:]:
        assert got.keys() == runs[0].keys()
        for k in got:
            assert torch.equal(got[k], runs[0][k]), k
    got = runs[0]
    for k in ("lengths", "gen_valid", "unfinished"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    for k in ("pred_logits", "pred_coords"):
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-4,
                                   rtol=1e-4, err_msg=k)
    ran = int(want["lengths"].max())          # tokens the loop ran
    assert got["pred_logits"].shape[1] == cfg.seq_len and ran < cfg.seq_len
    assert not got["pred_logits"][:, ran:].any()
    assert not got["pred_coords"][:, ran:].any()
    assert not got["gen_valid"][:, ran:].any()
    if case == "eos_exit":
        assert len(set(want["lengths"].tolist())) > 1
        assert not want["unfinished"].any()
    if case == "force_length":
        assert (want["lengths"] == force).all()
    if case == "max_len":
        assert want["unfinished"].any() and ran == cap


def test_token_body_past_the_end_writes_nothing(setup, episode):
    """Token bodies run after every sample has finished, and at the cap,
    leave the carry's outputs, position and flags as they were."""
    _, _, _, pm = setup
    inputs = [torch.as_tensor(x) for x in episode]
    for L, force in ((pm.cfg.seq_len, None), (4, 6)):
        with torch.inference_mode():
            carry = port_cape.decode_prologue(pm, *inputs, L)
            while bool(port_cape.decode_pending(carry)):
                port_cape.decode_token(pm, carry, force)
            done = {k: carry[k].clone() for k in
                    ("logits", "coords", "valid", "active", "unfinished",
                     "pos")}
            for _ in range(3):
                port_cape.decode_token(pm, carry, force)
        for k, v in done.items():
            assert torch.equal(carry[k], v), (L, k)
    assert int(carry["pos"]) == 4 and carry["unfinished"].all()


def test_cpu_entry_points_run_eagerly(setup, episode):
    """On the CPU `evaluate.decode` runs the bodies eagerly; the captured
    decode and step refuse or route away from a CPU model."""
    cfg, _, _, pm = setup
    got = port_evaluate.decode(pm, *episode)
    want = port_cape.autoregressive_decode(pm, *episode)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    with pytest.raises(ValueError, match="CUDA model"):
        graphs.decode(pm, *episode)
    assert graphs.step_route(pm, pm.cfg) == "not on the card"
    assert graphs.describe_step_route(pm, pm.cfg) == (
        "train step: eager (not on the card)")
    assert graphs.programs(pm) == []


# -- the optimizer ---------------------------------------------------------------
def _flat(tree):
    """JAX param-shaped tree -> {port key: fp32 array in the port layout}."""
    out = {}
    for path, v in flax.traverse_util.flatten_dict(tree, sep="/").items():
        v = np.asarray(v, np.float32)
        if path.endswith("kernel"):
            v = v.T if v.ndim == 2 else v.transpose(3, 2, 0, 1)
        out[port_key(path)] = v
    return out


def test_optimizer_scalars_from_the_device_match_jax():
    """Four micro-steps of seeded gradients with accumulation_steps=2 (two
    real updates) across an LR drop, every group (frozen affines
    included): the scalars each call writes into `hyper` and the fp32
    masters against the JAX package's optax chain."""
    over = dict(accumulation_steps=2, scheduler="multistep",
                lr_drop_epochs=(1,), freeze_backbone_affine=True)
    cfg, _, params = jax_tiny(0, **over)
    spe = 1
    rng = np.random.default_rng(21)
    grads = [jax.tree_util.tree_map(
        lambda p: rng.normal(size=p.shape).astype(np.float32), params)
        for _ in range(4)]
    tx = jax_state.make_optimizer(cfg, spe)

    def jax_update(g, opt, p):
        updates, opt = tx.update(g, opt, p)
        return optax.apply_updates(p, updates), opt

    p_jax, opt = params, tx.init(params)
    update = jax.jit(jax_update).lower(grads[0], opt, p_jax).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    for g in grads:
        p_jax, opt = update(g, opt, p_jax)
    want = _flat(jax.device_get(p_jax))

    pcfg = _port_cfg(cfg)
    pm = port_model(cfg, params)
    st = port_state.create_train_state(pcfg, pm, spe)
    labels = set(st.opt_state.labels)
    assert labels == set(port_state.GROUPS)
    plist = [p for _, p in pm.named_parameters()]
    hypers = []
    for g in grads:
        flat = _flat(g)
        st.tx.update([torch.from_numpy(flat[n]) for n in st.opt_state.names],
                     st.opt_state, plist)
        hypers.append(st.opt_state.hyper.tolist())
    f32 = np.float32
    lrs = [st.tx.group_lrs(c) for c in (0, 1)]
    assert lrs[1]["base"] == pytest.approx(0.1 * lrs[0]["base"])
    for i, h in enumerate(hypers):
        emit, c = i % 2 == 1, i // 2
        bc1 = float(f32(1) - f32(port_state.ADAM_B1) ** f32(c + 1))
        bc2 = float(f32(1) - f32(port_state.ADAM_B2) ** f32(c + 1))
        assert h[:3] == ([2.0, bc1, bc2] if emit else [1.0, 1.0, 1.0])
        assert h[3:] == ([float(f32(-lrs[c][g])) for g in port_state.GROUPS]
                         if emit else [0.0] * 4)
    assert (st.opt_state.adam_count, st.opt_state.sched_count,
            st.opt_state.mini_step, st.opt_state.gradient_step) == (2, 2, 0, 2)
    assert st.state_dict()["adam_count"] == 2 and "hyper" not in st.state_dict()
    for name, m in zip(st.opt_state.names, st.opt_state.masters):
        np.testing.assert_allclose(m.numpy(), want[name], atol=1e-6, rtol=0,
                                   err_msg=name)


def test_scan_step_matches_jax():
    """`make_scan_train_step` with steps_per_dispatch=2 and
    accumulation_steps=2 (one real update a group): the metrics' (N,)
    layout and values, and the masters after the group, against the JAX
    `lax.scan` step (compiled at XLA's backend optimization level 0)."""
    cfg, jm, params = jax_tiny(0, accumulation_steps=2, steps_per_dispatch=2)
    spe = 4
    batches = [train_batch(cfg, 2, seed=70 + i) for i in range(2)]
    stacked = jax.tree_util.tree_map(lambda *x: np.stack(x), *batches)
    st_jax = jax_state.create_train_state(cfg, {"params": params}, spe)
    rng = jax.random.PRNGKey(0)
    scan = jax_step.make_scan_train_step(jm, cfg, spe).lower(
        st_jax, stacked, rng).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    st_jax, m_jax = jax.device_get(scan(st_jax, stacked, rng))
    want = _flat(st_jax.params)

    pcfg = _port_cfg(cfg)
    pm = port_model(cfg, params)
    st = port_state.create_train_state(pcfg, pm, spe)
    st, m = port_step.make_scan_train_step(pm, pcfg, spe)(
        st, jax.tree_util.tree_map(torch.from_numpy, stacked))
    assert st.step == 2 and st.opt_state.gradient_step == 1
    assert m.keys() == m_jax.keys()
    for k, v in m.items():
        assert v.shape == (2,), k
        np.testing.assert_allclose(v.numpy(), m_jax[k], rtol=1e-4, err_msg=k)
    lrs = st.tx.group_lrs(0)
    for name, label, master in zip(st.opt_state.names, st.opt_state.labels,
                                   st.opt_state.masters):
        np.testing.assert_allclose(master.numpy(), want[name],
                                   atol=0.1 * lrs[label] + 1e-7, rtol=0,
                                   err_msg=name)


# -- the per-call host tensors ---------------------------------------------------
def test_host_tensors_are_made_once(setup, episode):
    """The ImageNet statistics, the encoder's reference points and the
    support encoders' sequence PE tables are made at the first call and
    the same tensors are read at the second."""
    cfg, _, params, _ = setup
    legacy = port_model(cfg, params, image_norm=True)
    imgs, sc, sm, se = (torch.as_tensor(x) for x in episode)

    def cached():
        return (dict(legacy._norm_cache), dict(legacy.encoder._refs),
                dict(legacy.support_encoder._pe_tables))

    legacy.encode_image(imgs)
    legacy.encode_support(sc, sm, se)
    first = cached()
    assert all(len(c) == 1 for c in first)
    legacy.encode_image(imgs)
    legacy.encode_support(sc, sm, se)
    second = cached()
    for a, b in zip(first, second):
        assert a.keys() == b.keys()
        assert all(a[k] is b[k] for k in a)

    jcfg, _, jparams = jax_tiny(0, use_geometric_encoder=False)
    old = port_model(jcfg, jparams)
    old.encode_support(sc, sm, se)
    tables = dict(old.support_encoder._pe_tables)
    old.encode_support(sc, sm, se)
    assert len(tables) == 1 and all(
        old.support_encoder._pe_tables[k] is v for k, v in tables.items())
