"""Parity of the port's model variants with the JAX package on the CPU, at
the tiny config in fp32 with dropout 0: the v2-v6 decoder layers
(`decoder_variants`, `bixattn`, `deformable_points`), the v1 options
`dec_attn_concat_src` and `dec_qkv_proj=False`, the legacy
`SupportPoseGraphEncoder`, their `convert` rules, the decode's refusals
and `hungarian_match`.

Module tests apply a JAX module with seeded numpy weights and the port's
counterpart, loaded through `convert.port_key`, to the same inputs
(atol = rtol = 1e-5). Whole-model tests use
`test_torch_port_util.variant_tiny` and `variant_runs` (one JAX init and
one jitted loss-and-gradient per config); the concat-src family's are in
`test_torch_port_variants_concat.py`.
"""

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from cape_tpu.models import bixattn as jax_bix
from cape_tpu.models import decoder_variants as jax_dv
from cape_tpu.models import deformable_points as jax_dp
from cape_tpu.models import matcher as jax_matcher
from cape_tpu.models.cape import CAPE as JaxCAPE
from cape_tpu.models.cape import autoregressive_decode as jax_decode
from cape_tpu.models.cape import level_shapes
from cape_tpu.models.decoder import DecoderLayer as JaxDecoderLayer
from cape_tpu.models.support_encoder import (
    SupportPoseGraphEncoder as JaxLegacyEncoder)

from cape_tpu_torch.config import CAPEConfig as PortConfig
from cape_tpu_torch.convert import (_to_torch_layout, from_jax_params,
                                    port_key)
from cape_tpu_torch.models import bixattn as port_bix
from cape_tpu_torch.models import decoder_variants as port_dv
from cape_tpu_torch.models import deformable_points as port_dp
from cape_tpu_torch.models import matcher as port_matcher
from cape_tpu_torch.models.cape import autoregressive_decode as port_decode
from cape_tpu_torch.models.decoder import DecoderLayer as PortDecoderLayer
from cape_tpu_torch.models.support_encoder import (
    SupportPoseGraphEncoder as PortLegacyEncoder)
from cape_tpu_torch.serve import CAPEPredictor

from test_torch_port_util import (assert_variant_gradients,
                                  assert_variant_labels,
                                  assert_variant_outputs, episode_inputs,
                                  port_model, random_params, variant_tiny)

TOL = dict(atol=1e-5, rtol=1e-5)
#: the tiny config's widths
D, HEADS, FFN, POINTS = 64, 4, 128, 2
SHAPES = ((8, 8), (4, 4), (2, 2), (1, 1))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want),
                               **(tol or TOL))


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _jax_module(module, seed, *inputs, method=None):
    """Seeded numpy weights for `module` (its init's shapes); the inputs
    that are not arrays (spatial shapes, None) stay static."""
    arrays = [i for i, a in enumerate(inputs) if isinstance(a, np.ndarray)]

    def init(key, *arrs):
        args = list(inputs)
        for i, a in zip(arrays, arrs):
            args[i] = a
        return module.init(key, *args, method=method)

    shapes = jax.eval_shape(init, jax.random.PRNGKey(0),
                            *(inputs[i] for i in arrays))["params"]
    return random_params(shapes, seed)


def _load(port_module, params, jax_prefix):
    """The JAX subtree `params`, found under `jax_prefix` of the model's
    tree, into `port_module` through the model's path rules (strict)."""
    port_prefix = port_key(jax_prefix + "x").rsplit(".", 1)[0] + "."
    sd = {}
    for path, v in flax.traverse_util.flatten_dict(params, sep="/").items():
        key = port_key(jax_prefix + path)
        assert key.startswith(port_prefix), (path, key)
        arr = _to_torch_layout(path.rsplit("/", 1)[-1], np.asarray(v))
        sd[key[len(port_prefix):]] = torch.from_numpy(
            np.array(arr, np.float32, order="C"))
    port_module.load_state_dict(sd)
    return port_module.eval()


# -- BiXAttn ------------------------------------------------------------------
def _masks(rng, with_masks, n, m):
    if not with_masks:
        return None, None
    xm = rng.uniform(size=(2, n)) < 0.3
    ym = rng.uniform(size=(2, m)) < 0.3
    ym[1] = True                                  # one all-masked row
    return xm, ym


@pytest.mark.parametrize("with_masks", [False, True])
def test_bixattn_matches_jax(with_masks):
    rng = np.random.default_rng(0)
    x, y = _rand(rng, 2, 5, D), _rand(rng, 2, 7, D)
    xm, ym = _masks(rng, with_masks, 5, 7)
    jm = jax_bix.BiXAttn(D, HEADS)
    params = _jax_module(jm, 1, x, y, xm, ym)
    want = jm.apply({"params": params}, x, y, xm, ym)
    pm = _load(port_bix.BiXAttn(D, HEADS), params,
               "decoder/layer_0/cross_attn/BiXAttn_0/")
    got = pm(_t(x), _t(y), None if xm is None else _t(xm),
             None if ym is None else _t(ym))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("with_masks", [False, True])
@pytest.mark.parametrize("act", ["gelu", "relu"])
@pytest.mark.parametrize("block", ["BiXAttnBlock", "CAOneSidedBlock"])
def test_bixattn_blocks_match_jax(block, act, with_masks):
    rng = np.random.default_rng(2)
    x, y = _rand(rng, 2, 5, D), _rand(rng, 2, 7, D)
    xm, ym = _masks(rng, with_masks, 5, 7)
    jm = getattr(jax_bix, block)(D, HEADS, act=act)
    params = _jax_module(jm, 3, x, y, xm, ym)
    want = jm.apply({"params": params}, x, y, xm, ym)
    pm = _load(getattr(port_bix, block)(D, HEADS, act=act), params,
               "decoder/layer_1/cross_attn/")
    got = pm(_t(x), _t(y), None if xm is None else _t(xm),
             None if ym is None else _t(ym))
    for g, w in zip(got, want):
        _close(g, w)


# -- MSDeformablePoints --------------------------------------------------------
@pytest.mark.parametrize("shapes", [
    ((32, 32), (16, 16), (8, 8), (4, 4)),
    ((24, 40), (12, 20), (6, 10), (3, 5))])
def test_deformable_points_matches_jax(shapes, monkeypatch):
    """The predicted sampling grids within 1e-5, and the sampled tokens
    within 1e-5 when both sample at JAX's grids. (Sampled at its own
    grids, the port differs by up to 3e-5: the grids' fp32 differences,
    ~5e-7, become (W - 1) / 2 times as many pixels, times the random
    features' slope between neighbouring pixels.)"""
    rng = np.random.default_rng(4)
    x = _rand(rng, 2, sum(h * w for h, w in shapes), D)
    jm = jax_dp.MSDeformablePoints(D, len(shapes), HEADS)
    params = _jax_module(jm, 5, x, shapes)
    grids = []
    sample = jax_dp._bilinear_sample
    monkeypatch.setattr(jax_dp, "_bilinear_sample", lambda img, grid: (
        grids.append(np.asarray(grid)) or sample(img, grid)))
    want = jm.apply({"params": params}, x, shapes)
    pm = _load(port_dp.MSDeformablePoints(D, len(shapes), HEADS), params,
               "decoder/layer_0/point_sampler/")
    port_sample, seen = port_dp._bilinear_sample, []

    def at_jax_grid(img, grid):
        want_grid = grids[len(seen)]
        _close(grid, want_grid)
        seen.append(grid)
        return port_sample(img, torch.from_numpy(want_grid))

    monkeypatch.setattr(port_dp, "_bilinear_sample", at_jax_grid)
    got = pm(_t(x), shapes)
    assert len(seen) == len(shapes) and got.shape == want.shape
    _close(got, want)


# -- decoder layers ------------------------------------------------------------------
def _layer_inputs(seed):
    rng = np.random.default_rng(seed)
    B, L = 2, 6
    causal = np.where(np.triu(np.ones((L, L)), 1) > 0, -1e9, 0.0).astype(
        np.float32)
    return (_rand(rng, B, L, D), _rand(rng, B, L, D),
            rng.uniform(0.1, 0.9, (B, L, len(SHAPES), 2)).astype(np.float32),
            _rand(rng, B, sum(h * w for h, w in SHAPES), D), SHAPES, causal)


LAYERS = (
    [("v2", {}), ("v3", {"is_last": False}), ("v3", {"is_last": True})]
    + [(v, {"attn_concat_src": c, "use_qkv_proj": q})
       for v in ("v4", "v41", "v5", "v6") for c in (True, False)
       for q in (True, False)])


def _layer_pair(variant, kw):
    if variant == "v2":
        return (jax_dv.DecoderLayerV2(D, FFN, 0.0, len(SHAPES), HEADS, POINTS),
                port_dv.DecoderLayerV2(D, FFN, 0.0, len(SHAPES), HEADS, POINTS))
    if variant == "v3":
        return (jax_dv.DecoderLayerV3(D, FFN, 0.0, HEADS, **kw),
                port_dv.DecoderLayerV3(D, FFN, 0.0, HEADS, **kw))
    args = dict(variant=variant, d_model=D, d_ffn=FFN, dropout=0.0,
                n_levels=len(SHAPES), n_heads=HEADS, n_points=POINTS, **kw)
    return jax_dv.DecoderLayerVC(**args), port_dv.DecoderLayerVC(**args)


@pytest.mark.parametrize("variant,kw", LAYERS,
                         ids=[f"{v}-{'-'.join(f'{k}={x}' for k, x in kw.items())}"
                              for v, kw in LAYERS])
def test_decoder_layer_variant_matches_jax(variant, kw):
    inputs = _layer_inputs(6)
    jm, pm = _layer_pair(variant, kw)
    params = _jax_module(jm, 7, *inputs)
    want = jm.apply({"params": params}, *inputs)
    pm = _load(pm, params, "decoder/layer_0/")
    got = pm(*(_t(a) if isinstance(a, np.ndarray) else a for a in inputs))
    if variant == "v3":
        _close(got[0], want[0])
        _close(got[1], want[1])
    else:
        _close(got, want)


@pytest.mark.parametrize("qkv_proj,concat_src",
                         [(False, False), (True, True), (False, True)])
def test_v1_layer_options_match_jax(qkv_proj, concat_src):
    """The v1 layer's teacher-forced call with identity pre-projections
    and with the raw memory prepended to self-attention's K/V; without
    pre-projections the layer has no attn_q/k/v parameters."""
    tgt, qp, ref, mem, shapes, causal = _layer_inputs(8)
    rng = np.random.default_rng(9)
    sup, smask = _rand(rng, 2, 5, D), rng.uniform(size=(2, 5)) < 0.3
    args = (tgt, qp, ref, mem, shapes, causal, sup, smask)
    jm = JaxDecoderLayer(D, FFN, 0.0, len(SHAPES), HEADS, POINTS,
                         qkv_proj=qkv_proj, concat_src=concat_src)
    params = _jax_module(jm, 10, *args, method=JaxDecoderLayer.forward_train)
    want = jm.apply({"params": params}, *args,
                    method=JaxDecoderLayer.forward_train)
    pm = _load(PortDecoderLayer(D, FFN, 0.0, len(SHAPES), HEADS, POINTS,
                                qkv_proj=qkv_proj, concat_src=concat_src),
               params, "decoder/layer_0/")
    names = {n for n, _ in pm.named_parameters()}
    assert ("attn_q.weight" in names) == qkv_proj
    got = pm.forward_train(*(_t(a) if isinstance(a, np.ndarray) else a
                             for a in args))
    _close(got, want)


# -- the legacy support encoder ------------------------------------------------------
@pytest.mark.parametrize("edges", [False, True])
def test_support_pose_graph_encoder_matches_jax(edges):
    """With masked keypoints (one sample all masked) and with or without a
    skeleton; the weights are those of a model that has the edge layers,
    as `CAPE` builds it."""
    rng = np.random.default_rng(11)
    B, N = 3, 12
    coords = rng.uniform(size=(B, N, 2)).astype(np.float32)
    mask = np.zeros((B, N), bool)
    mask[0, 7:] = True
    mask[1, ::3] = True
    mask[2] = True                                # every keypoint masked
    sk = np.full((B, 16, 2), -1, np.int32)
    sk[:, :6] = [[0, 1], [1, 2], [2, 3], [1, 3], [5, 9], [3, 3]]
    sk[1, 6] = [4, 40]                            # out of range: ignored
    jm = JaxLegacyEncoder(D, 2, HEADS, FFN, 0.0)
    params = _jax_module(jm, 12, coords, mask, sk)
    sk = sk if edges else None
    want = jm.apply({"params": params}, coords, mask, sk)
    pm = _load(PortLegacyEncoder(D, 2, HEADS, FFN, 0.0), params,
               "support_encoder/")
    got = pm(_t(coords), _t(mask), None if sk is None else _t(sk))
    _close(got, want)


# -- the whole model ------------------------------------------------------------------
#: the whole-model configs of this file (the concat-src family is in
#: `test_torch_port_variants_concat.py`)
MODEL_CONFIGS = ["v2", "v3", "v1_no_qkv_proj", "legacy_encoder"]


@pytest.mark.parametrize("name", MODEL_CONFIGS)
def test_teacher_forced_outputs_match_jax(name):
    assert_variant_outputs(name)


@pytest.mark.parametrize("name", MODEL_CONFIGS)
def test_every_parameter_gradient_matches_jax(name):
    assert_variant_gradients(name)


@pytest.mark.parametrize("name", MODEL_CONFIGS)
def test_param_labels_match_jax(name):
    assert_variant_labels(name)


# -- the decode ------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["v1_no_qkv_proj", "legacy_encoder"])
def test_decode_matches_jax(name):
    """The KV-cached decode of the options that serve: the same tokens
    (lengths, coordinate steps) and keypoints as the JAX package's."""
    cfg, jm, params = variant_tiny(name)
    episode = episode_inputs(cfg, batch=3, seed=1)
    want = {k: np.asarray(v) for k, v in
            jax_decode(jm, {"params": params}, *episode).items()}
    got = port_decode(port_model(cfg, params), *episode)
    assert set(got) == set(want)
    for k in ("lengths", "gen_valid", "unfinished"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert want["gen_valid"].any()
    for k in ("pred_logits", "pred_coords"):
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-4,
                                   rtol=1e-4, err_msg=k)


REFUSED = ["v2", "v3", "v4", "v41", "v5", "v6", "v1_concat_src"]


@pytest.mark.parametrize("name", REFUSED)
def test_decode_refuses_what_jax_refuses(name):
    """The port's decode (and a predictor's request) raises the JAX
    package's ValueError, word for word, for every teacher-forced-only
    config."""
    cfg, jm, params = variant_tiny(name)
    S = sum(h * w for h, w in level_shapes(
        cfg.image_size, cfg.num_feature_levels, cfg.dilation))
    with pytest.raises(ValueError,
                       match="layer_type='v1'|attn_concat_src") as jax_err:
        jm.apply({"params": params}, jnp.zeros((1, S, cfg.hidden_dim)),
                 jnp.zeros((1, 5, cfg.hidden_dim)),
                 method=JaxCAPE.decode_static)
    pm = port_model(cfg, params)
    episode = episode_inputs(cfg, batch=1, seed=1)
    with pytest.raises(ValueError) as port_err:
        port_decode(pm, *episode)
    assert str(port_err.value) == str(jax_err.value)
    pred = CAPEPredictor(pm.cfg, pm, batch_size=1, device="cpu")
    with pytest.raises(ValueError, match="layer_type='v1'|attn_concat_src"):
        pred.predict([episode[0][0]], episode[1][0, :5])


# -- convert ---------------------------------------------------------------------------
#: (config, a JAX leaf of a tree this slice adds)
NEW_LEAVES = {
    "bixattn": ("v3", "decoder/layer_0/cross_attn/BiXAttn_0/q_x/kernel"),
    "one-sided block": ("v3", "decoder/layer_1/cross_attn/Dense_1/kernel"),
    "v4 sampler": ("v4", "decoder/layer_1/sampling_offsets/kernel"),
    "point sampler": ("v41",
                      "decoder/layer_0/point_sampler/conv_offset_a_2/kernel"),
    "legacy encoder": ("legacy_encoder",
                       "support_encoder/edge_embedding/embedding"),
}


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
@pytest.mark.parametrize("tree", list(NEW_LEAVES))
def test_from_jax_params_rejects_bad_variant_trees(tree, fault):
    name, path = NEW_LEAVES[tree]
    cfg, _, params = variant_tiny(name)
    flat = dict(flax.traverse_util.flatten_dict(params, sep="/"))
    pcfg = PortConfig.from_json(cfg.to_json())
    if fault == "missing":
        del flat[path]
        err, key = KeyError, port_key(path)
    elif fault == "extra":
        path = path.rsplit("/", 1)[0] + "/scale"
        flat[path] = np.ones(3, np.float32)
        err, key = KeyError, path
    else:
        flat[path] = np.zeros((2, 3), np.float32)
        err, key = ValueError, path
    bad = flax.traverse_util.unflatten_dict(flat, sep="/")
    with pytest.raises(err, match=key.replace(".", r"\.")):
        from_jax_params(bad, pcfg)


# -- the matcher -----------------------------------------------------------------------
@pytest.mark.parametrize("as_tensors", [False, True])
def test_hungarian_match_matches_jax(as_tensors):
    rng = np.random.default_rng(13)
    B, Q = 3, 9
    logits = _rand(rng, B, Q, 3)
    coords = rng.uniform(size=(B, Q, 2)).astype(np.float32)
    labels = [rng.integers(0, 3, 5), np.zeros(0, np.int64),
              rng.integers(0, 3, 9)]
    tcoords = [rng.uniform(size=(len(l), 2)) for l in labels]
    want = jax_matcher.hungarian_match(logits, coords, labels, tcoords,
                                       cost_class=2.0, cost_coords=3.0)
    conv = torch.from_numpy if as_tensors else np.asarray
    got = port_matcher.hungarian_match(
        conv(logits), conv(coords), [conv(l) for l in labels],
        [conv(c) for c in tcoords], cost_class=2.0, cost_coords=3.0)
    assert len(got) == len(want)
    for (gr, gc), (wr, wc) in zip(got, want):
        assert gr.dtype == wr.dtype == np.int64
        np.testing.assert_array_equal(gr, wr)
        np.testing.assert_array_equal(gc, wc)
    assert len(got[1][0]) == 0
