"""The port's serving slice against the JAX package on the CPU, at the tiny
config in fp32: `autoregressive_decode` and `CAPEPredictor.predict`.

Weights: seeded numpy values carried over by `convert.from_jax_params`
(the last class head is shifted so coord, sep and EOS all occur and the
samples stop at different steps). Tolerances: logits and coords 1e-4
(fp32 through a deep stack, summation order only); lengths, gen_valid and
unfinished equal; pixel keypoints 1e-3 px.
"""

import copy

import numpy as np
import pytest
import torch

from cape_tpu.models.cape import autoregressive_decode as jax_decode
from cape_tpu.serve import CAPEPredictor as JaxPredictor

from cape_tpu_torch.models.cape import autoregressive_decode as port_decode
from cape_tpu_torch.serve import CAPEPredictor as PortPredictor

from test_torch_port_util import episode_inputs, jax_tiny, port_model

#: decode cases: (force_length, max_len)
CASES = {"default": (None, None), "max_len": (None, 10),
         "force_length": (9, None)}


@pytest.fixture(scope="module")
def setup():
    cfg, jm, params = jax_tiny(0)
    return cfg, jm, params, port_model(cfg, params)


@pytest.fixture(scope="module")
def episode(setup):
    return episode_inputs(setup[0], batch=3, seed=1)


@pytest.fixture(scope="module")
def jax_outputs(setup, episode):
    """JAX decodes through the Pallas one-hot gather (interpret mode), one
    per case; `autoregressive_decode` is called directly so no jit trace
    is cached on the model."""
    _, jm, params, _ = setup
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CAPE_MSDA_GATHER", "mxu")
        for name, (force, cap) in CASES.items():
            o = jax_decode(jm, {"params": params}, *episode,
                           force_length=force, max_len=cap)
            out[name] = {k: np.asarray(v) for k, v in o.items()}
    return out


def _assert_decode_equal(got, want):
    assert set(got) == set(want)
    for k in ("lengths", "gen_valid", "unfinished"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    for k in ("pred_logits", "pred_coords"):
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-4,
                                   rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_autoregressive_decode_matches_jax(setup, episode, jax_outputs, case):
    _, _, _, pm = setup
    force, cap = CASES[case]
    got = port_decode(pm, *episode, force_length=force, max_len=cap)
    want = jax_outputs[case]
    _assert_decode_equal(got, want)
    assert got["pred_logits"].shape[1] == setup[0].seq_len
    if case == "default":
        # the batch stops at different steps, all before seq_len
        lengths = want["lengths"]
        assert len(set(lengths.tolist())) > 1
        assert lengths.max() < setup[0].seq_len and not want["unfinished"].any()
    if case == "max_len":
        assert want["unfinished"].any() and (want["lengths"] <= cap).all()
    if case == "force_length":
        assert (want["lengths"] == force).all()


def test_use_pallas_decode_matches_jax_default(setup, episode, jax_outputs):
    """The port's `use_pallas_msda=True` model (whole-op MSDA kernel in the
    encoder) computes the same function as the JAX default model."""
    cfg, _, params, _ = setup
    pm = port_model(cfg, params, use_pallas_msda=True)
    assert pm.encoder.layers[0].self_attn.use_pallas
    _assert_decode_equal(port_decode(pm, *episode), jax_outputs["default"])


@pytest.mark.parametrize("impl", ["fused", "fusedq"])
def test_unpacked_decode_with_gather_impl_matches_jax(setup, episode,
                                                      monkeypatch, impl):
    """`CAPE_DECODE_PREQUAD=0` with `CAPE_MSDA_GATHER=fused|fusedq`, set
    for both packages: the decode keeps plain per-layer values and every
    step runs the selected formulation (3 steps: the JAX side runs its
    Pallas kernels in interpret mode)."""
    from cape_tpu_torch.ops import msda as port_msda

    cfg, jm, params, pm = setup
    monkeypatch.setenv("CAPE_DECODE_PREQUAD", "0")
    monkeypatch.setenv("CAPE_MSDA_GATHER", impl)
    want = {k: np.asarray(v) for k, v in jax_decode(
        jm, {"params": params}, *episode, force_length=3, max_len=3).items()}
    sites, prequad = [], []
    core = port_msda.ms_deform_attn_core
    monkeypatch.setattr(port_msda, "ms_deform_attn_core", lambda *a, **k:
                        sites.append(a[2].shape[1]) or core(*a, **k))
    monkeypatch.setattr(port_msda, "ms_deform_attn_core_prequad",
                        lambda *a, **k: prequad.append(1))
    mem_values, _ = pm.decode_static(
        torch.zeros(1, sum(h * w for h, w in pm.spatial_shapes),
                    cfg.hidden_dim), torch.zeros(1, 5, cfg.hidden_dim))
    assert all(v.ndim == 4 for v in mem_values)
    got = port_decode(pm, *episode, force_length=3, max_len=3)
    _assert_decode_equal(got, want)
    assert (want["lengths"] == 3).all()
    # 2 encoder sites over the whole memory, then 2 decoder layers x 3
    # single-query steps through the same core; no prequad site
    assert sites[cfg.enc_layers:] == [1] * (cfg.dec_layers * 3)
    assert not prequad


@pytest.fixture
def fresh_jax_decode_trace():
    """The JAX predictor's jitted decode reads the variables while it
    traces and caches the trace by model and shapes: drop it before, so
    the selection is traced, and after, so no later test inherits it."""
    from cape_tpu.eval.evaluate import _decode_jit

    _decode_jit.clear_cache()
    yield
    _decode_jit.clear_cache()


@pytest.mark.parametrize("impl", ["fused", "fusedq"])
def test_predict_unpacked_with_gather_impl_matches_jax(
        setup, monkeypatch, fresh_jax_decode_trace, impl):
    """A served request under the same two variables gives the JAX
    predictor's lengths, generated flags and keypoints (2 decode steps:
    `min_decode_len` of the tiny config)."""
    cfg, _, params, _ = setup
    monkeypatch.setenv("CAPE_DECODE_PREQUAD", "0")
    monkeypatch.setenv("CAPE_MSDA_GATHER", impl)
    # EOS as early as allowed: a large EOS logit on the last class head
    early = copy.deepcopy(params)
    head = early["decoder"][f"class_head_{cfg.dec_layers - 1}"]
    head["bias"] = head["bias"] + np.array([0.0, 0.0, 50.0], np.float32)
    pm = port_model(cfg, early)
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
            for h, w in ((80, 100), (64, 64))]
    proto = rng.uniform(0.1, 0.9, (5, 2))
    kw = dict(skeleton=[[0, 1], [1, 2], [2, 3], [3, 4]],
              bboxes=[None, (4, 8, 40, 50)])
    want = JaxPredictor(cfg, early, batch_size=2).predict(imgs, proto, **kw)
    got = PortPredictor(pm.cfg, pm, batch_size=2, device="cpu").predict(
        imgs, proto, **kw)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["length"] == w["length"] == cfg.min_decode_len + 1
        np.testing.assert_array_equal(g["generated"], w["generated"])
        np.testing.assert_allclose(g["keypoints"], w["keypoints"], atol=1e-3)


def test_predict_matches_jax_predictor(setup):
    cfg, _, params, pm = setup
    rng = np.random.default_rng(2)
    imgs = [rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
            for h, w in ((80, 100), (64, 64), (120, 90))]
    bboxes = [None, (4, 8, 40, 50), (10, 0, 200, 100)]
    proto = rng.uniform(0.1, 0.9, (2, 5, 2))           # 2-shot
    vis = np.array([[2, 2, 0, 2, 2], [2, 1, 2, 2, 0]])
    skel = [[0, 1], [1, 2], [2, 3], [3, 4]]
    kw = dict(skeleton=skel, support_visibility=vis, bboxes=bboxes)
    want = JaxPredictor(cfg, params, batch_size=2).predict(imgs, proto, **kw)
    got = PortPredictor(pm.cfg, pm, batch_size=2, device="cpu").predict(
        imgs, proto, **kw)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g["length"] == w["length"]
        np.testing.assert_array_equal(g["generated"], w["generated"])
        np.testing.assert_allclose(g["keypoints"], w["keypoints"], atol=1e-3)
        assert g["keypoints"].shape == (5, 2)
