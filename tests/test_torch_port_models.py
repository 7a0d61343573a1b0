"""Module parity of the port (`cape_tpu_torch.models`) with the JAX package
on the CPU, at the tiny config in fp32.

Weights: seeded numpy values in the JAX param tree, carried into the port
by `convert.from_jax_params`; each module test applies the JAX module to
its subtree and the port's counterpart to the same inputs. Tolerance 1e-5
(fp32, summation order only) unless stated.
"""

import copy
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cape_tpu.models import cape as jax_cape
from cape_tpu.models import graph as jax_graph
from cape_tpu.models import position_encoding as jax_pe
from cape_tpu.models.attention import MultiHeadAttention as JaxMHA
from cape_tpu.models.backbone import ResNet50 as JaxResNet50
from cape_tpu.models.deformable import DeformableEncoderLayer as JaxEncLayer
from cape_tpu.models.support_encoder import GeometricSupportEncoder as JaxGSE

from cape_tpu_torch import config as port_config
from cape_tpu_torch.convert import from_jax_params
from cape_tpu_torch.models import graph as port_graph
from cape_tpu_torch.models import position_encoding as port_pe
from cape_tpu_torch.models.cape import CAPE as PortCAPE
from cape_tpu_torch.models.deformable import encoder_reference_points

from test_torch_port_util import jax_tiny, port_model

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def tiny():
    cfg, jm, params = jax_tiny(0)
    return cfg, jm, params, port_model(cfg, params)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want),
                               **(tol or TOL))


# -- position encodings ----------------------------------------------------
def test_position_encodings():
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(port_pe.image_sine_pe_2d(5, 7, 64),
                                  jax_pe.image_sine_pe_2d(5, 7, 64))
    np.testing.assert_array_equal(port_pe.interleaved_1d_table(30, 64),
                                  jax_pe.interleaved_1d_table(30, 64))
    xy = rng.uniform(0, 1, (3, 6, 2)).astype(np.float32)
    _close(port_pe.coords_sine_embed(torch.from_numpy(xy), 32),
           jax_pe.coords_sine_embed(jnp.asarray(xy), 32))
    _close(port_pe.query_sine_embed(torch.from_numpy(xy), 32),
           jax_pe.query_sine_embed(jnp.asarray(xy), 32))


# -- attention ---------------------------------------------------------------
def test_multihead_attention_all_masked_row(tiny):
    """An all-masked key row gives uniform weights (finite NEG_INF), not NaN."""
    cfg, _, params, pm = tiny
    rng = np.random.default_rng(1)
    q = rng.normal(size=(2, 3, 64)).astype(np.float32)
    kv = rng.normal(size=(2, 5, 64)).astype(np.float32)
    mask = np.zeros((2, 5), bool)
    mask[0, 3:] = True
    mask[1, :] = True                               # every key masked
    jm = JaxMHA(64, cfg.nheads)
    want = jm.apply({"params": params["decoder"]["layer_0"]["support_attn"]},
                    q, kv, key_padding_mask=mask)
    got = pm.decoder.layers[0].support_attn(
        torch.from_numpy(q), torch.from_numpy(kv),
        key_padding_mask=torch.from_numpy(mask))
    assert torch.isfinite(got).all()
    _close(got, want)


# -- encoder -----------------------------------------------------------------
def test_deformable_encoder_layer(tiny):
    cfg, _, params, pm = tiny
    shapes = jax_cape.level_shapes(cfg.image_size, cfg.num_feature_levels)
    S = sum(h * w for h, w in shapes)
    rng = np.random.default_rng(2)
    src = rng.normal(size=(2, S, 64)).astype(np.float32)
    pos = rng.normal(size=(2, S, 64)).astype(np.float32)
    ref = np.broadcast_to(encoder_reference_points(shapes)[None],
                          (2, S, len(shapes), 2)).copy()
    layer = JaxEncLayer(64, cfg.dim_feedforward, 0.0, cfg.num_feature_levels,
                        cfg.nheads, cfg.enc_n_points)
    want = layer.apply({"params": params["encoder"]["layer_0"]}, src, pos,
                       ref, shapes)
    got = pm.encoder.layers[0](*(torch.from_numpy(a) for a in (src, pos, ref)),
                               shapes)
    _close(got, want)


def test_resnet_tiny_backbone(tiny):
    """NHWC in the JAX package, NCHW in the port: same features."""
    _, _, params, pm = tiny
    x = np.random.default_rng(3).normal(size=(2, 64, 64, 3)).astype(np.float32)
    want = JaxResNet50(block_counts=(1, 1, 1, 1)).apply(
        {"params": params["backbone"]}, x)
    got = pm.backbone(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _close(g.permute(0, 2, 3, 1), w, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("image_norm", [False, True])
def test_encode_image_uint8(image_norm):
    """Backbone + input projections + PE + encoder, from uint8 pixels
    normalized on the device (optionally with the ImageNet mean/std)."""
    cfg, jm, params = jax_tiny(0, image_norm=image_norm)
    pm = port_model(cfg, params)
    imgs = np.random.default_rng(4).integers(0, 255, (2, 64, 64, 3),
                                             dtype=np.uint8)
    want = jm.apply({"params": params}, imgs,
                    method=jax_cape.CAPE.encode_image)
    got = pm.encode_image(torch.from_numpy(imgs))
    # backbone features agree to ~1e-6 relative (fp32 summation order);
    # the random-weight encoder's sampling locations amplify that to ~3e-4
    _close(got, want, atol=1e-3, rtol=1e-3)


def test_encode_image_without_gradients_takes_the_whole_op(tiny,
                                                          monkeypatch):
    """The no-grad encoder (serving's and eval's prologue): under 'auto'
    each of its `enc_layers` MSDA sites takes the whole op, once a call,
    and the memory matches the JAX package's as `test_encode_image_uint8`
    does; under 'xla' none does, and the two encodings agree to fp32
    summation order (~1e-6 at magnitudes ~4)."""
    from cape_tpu_torch import trace

    cfg, jm, params, pm = tiny
    imgs = np.random.default_rng(5).integers(0, 255, (2, 64, 64, 3),
                                             dtype=np.uint8)
    monkeypatch.delenv("CAPE_MSDA_GATHER", raising=False)
    monkeypatch.delenv("CAPE_MSDA_TINY", raising=False)
    n0 = trace.counters().get("msda.whole_op", 0)
    with torch.inference_mode():
        got = pm.encode_image(torch.from_numpy(imgs))
    assert trace.counters().get("msda.whole_op", 0) == n0 + cfg.enc_layers
    want = jm.apply({"params": params}, imgs,
                    method=jax_cape.CAPE.encode_image)
    _close(got, want, atol=1e-3, rtol=1e-3)
    monkeypatch.setenv("CAPE_MSDA_GATHER", "xla")
    with torch.inference_mode():
        core = pm.encode_image(torch.from_numpy(imgs))
    assert trace.counters().get("msda.whole_op", 0) == n0 + cfg.enc_layers
    torch.testing.assert_close(got, core, atol=1e-5, rtol=1e-5)


def test_resnet_dc5_dilation():
    """The DC5 branch: layer4 keeps stride 16, later blocks dilate by 2."""
    import jax

    from cape_tpu_torch.convert import _flatten, _to_torch_layout, port_key
    from cape_tpu_torch.models.backbone import ResNet50 as PortResNet50

    from test_torch_port_util import random_params

    blocks = (1, 1, 1, 2)
    x = np.random.default_rng(8).normal(size=(1, 64, 64, 3)).astype(np.float32)
    jnet = JaxResNet50(block_counts=blocks, dilation=True)
    params = random_params(
        jax.eval_shape(jnet.init, jax.random.PRNGKey(0), x)["params"], 8)
    pnet = PortResNet50(block_counts=blocks, dilation=True)
    sd = {port_key("backbone/" + k).removeprefix("backbone."):
          torch.from_numpy(np.ascontiguousarray(
              _to_torch_layout(k.rsplit("/", 1)[-1], v)))
          for k, v in _flatten(params).items()}
    pnet.load_state_dict(sd)
    want = jnet.apply({"params": params}, x)
    got = pnet(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got[2].shape[-1] == got[1].shape[-1] == 4    # stride 16 kept
    for g, w in zip(got, want):
        _close(g.permute(0, 2, 3, 1), w, atol=1e-4, rtol=1e-4)


def test_tokenizer_special_ids():
    from cape_tpu.data.tokenizer import DiscreteTokenizer as JaxTok

    from cape_tpu_torch.data.tokenizer import DiscreteTokenizer as PortTok

    for nb in (10, 44):
        j, p = JaxTok(nb, 200), PortTok(nb, 200)
        assert (p.bos, p.eos, p.sep, p.pad, p.vocab_size, len(p)) == \
            (j.bos, j.eos, j.sep, j.pad, j.vocab_size, len(j))


# -- support encoder -----------------------------------------------------------
def test_adj_from_skeleton_duplicates_and_out_of_range():
    edges = np.array([[[0, 1], [1, 0], [0, 1], [2, 3], [3, 9], [-1, -1]],
                      [[4, 4], [1, 2], [2, 1], [-1, 2], [0, 5], [-1, -1]]],
                     np.int32)
    mask = np.zeros((2, 6), bool)
    mask[1, 2] = True
    want = jax_graph.adj_from_skeleton(6, jnp.asarray(edges),
                                       jnp.asarray(mask))
    got = port_graph.adj_from_skeleton(6, torch.from_numpy(edges),
                                       torch.from_numpy(mask))
    _close(got, want)


def test_geometric_support_encoder_all_masked_guard(tiny):
    cfg, _, params, pm = tiny
    K, E = cfg.max_support_keypoints, cfg.max_skeleton_edges
    rng = np.random.default_rng(5)
    coords = rng.uniform(0, 1, (3, K, 2)).astype(np.float32)
    mask = np.zeros((3, K), bool)
    mask[0, 6:] = True
    mask[1, :] = True                           # no valid keypoint at all
    mask[2, [1, 4]] = True
    edges = np.full((3, E, 2), -1, np.int32)
    edges[:, :5] = [[0, 1], [1, 2], [2, 3], [3, 4], [1, 0]]
    enc = JaxGSE(cfg.hidden_dim, cfg.support_encoder_layers, cfg.nheads,
                 cfg.dim_feedforward, 0.0, cfg.use_gcn_preenc,
                 cfg.num_gcn_layers, max(cfg.max_support_keypoints, 100))
    want = enc.apply({"params": params["support_encoder"]}, coords, mask,
                     edges)
    got = pm.support_encoder(torch.from_numpy(coords), torch.from_numpy(mask),
                             torch.from_numpy(edges))
    assert not got[1].any()
    _close(got, want)


# -- decoder -----------------------------------------------------------------
DECODER_VARIANTS = {"default": {}, "query_pos_none": {"query_pos_type": "none"},
                    "anchor_refine": {"with_poly_refine": False}}


@pytest.mark.parametrize("variant", list(DECODER_VARIANTS))
def test_decoder_forward_step_with_caches(variant):
    """Several steps of the KV-cached decoder against the JAX decode_step:
    logits, refined coords and the caches themselves."""
    cfg, jm, params = jax_tiny(0, **DECODER_VARIANTS[variant])
    pm = port_model(cfg, params)
    variables = {"params": params}
    shapes = jax_cape.level_shapes(cfg.image_size, cfg.num_feature_levels)
    S = sum(h * w for h, w in shapes)
    B, K, L = 2, cfg.max_support_keypoints, 7
    rng = np.random.default_rng(6)
    memory = rng.normal(size=(B, S, 64)).astype(np.float32)
    support = rng.normal(size=(B, K, 64)).astype(np.float32)
    smask = np.zeros((B, K), bool)
    smask[:, 5:] = True
    j_slabs, j_kvs = jm.apply(variables, memory, support,
                              method=jax_cape.CAPE.decode_static)
    p_slabs, p_kvs = pm.decode_static(torch.from_numpy(memory),
                                      torch.from_numpy(support))
    for a, b in zip(p_slabs, j_slabs):
        _close(a, b)
    dh = cfg.hidden_dim // cfg.nheads
    z = jnp.zeros((B, cfg.nheads, L, dh), jnp.float32)
    j_caches = [jax_cape.LayerCache(z, z) for _ in range(cfg.dec_layers)]
    p_caches = pm.decoder.init_caches(B, L, torch.device("cpu"))
    vocab = cfg.token_vocab_size
    for step in range(4):
        ids = rng.integers(0, vocab, (4, B, 1))
        dx, dy = rng.uniform(0, 1, (2, B, 1)).astype(np.float32)
        state = {"seq11": ids[0], "seq12": ids[1], "seq21": ids[2],
                 "seq22": ids[3], "delta_x1": dx, "delta_x2": 1 - dx,
                 "delta_y1": dy, "delta_y2": 1 - dy}
        j_logits, j_ref, j_caches = jm.apply(
            variables, {k: jnp.asarray(v) for k, v in state.items()}, step,
            j_slabs, j_kvs, smask, j_caches, method=jax_cape.CAPE.decode_step)
        p_logits, p_ref, p_caches = pm.decode_step(
            {k: torch.from_numpy(v) for k, v in state.items()}, step,
            p_slabs, p_kvs, torch.from_numpy(smask), p_caches)
        _close(p_logits, j_logits)
        _close(p_ref, j_ref)
    for pc, jc in zip(p_caches, j_caches):
        _close(pc.k, jc.k)
        _close(pc.v, jc.v)


# -- weights and config --------------------------------------------------------
def test_config_json_reads_in_both_packages():
    from cape_tpu.config import CAPEConfig as JaxConfig
    from cape_tpu.config import tiny_test_config as jax_tiny_config

    cfg = JaxConfig().replace(image_size=256, use_pallas_msda=True)
    port = port_config.CAPEConfig.from_json(cfg.to_json())
    assert port.to_json() == cfg.to_json()
    assert JaxConfig.from_json(port.to_json()) == cfg
    assert port_config.tiny_test_config().to_json() == \
        jax_tiny_config().to_json()


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_from_jax_params_rejects_bad_trees(tiny, fault):
    cfg, _, params, _ = tiny
    bad = copy.deepcopy(params)
    proj = bad["decoder"]["layer_1"]["cross_attn"]["value_proj"]
    if fault == "missing":
        del proj["bias"]
        err, key = KeyError, "decoder.layers.1.cross_attn.value_proj.bias"
    elif fault == "extra":
        proj["scale"] = np.ones(64, np.float32)
        err, key = KeyError, "decoder/layer_1/cross_attn/value_proj/scale"
    else:
        proj["kernel"] = np.zeros((64, 32), np.float32)
        err, key = ValueError, "decoder/layer_1/cross_attn/value_proj/kernel"
    pcfg = port_config.CAPEConfig.from_json(cfg.to_json())
    with pytest.raises(err, match=key.replace(".", r"\.")):
        from_jax_params(bad, pcfg)


# -- package rules ---------------------------------------------------------------
def test_port_imports_neither_jax_nor_cape_tpu():
    """Every submodule imports with jax, flax and optax blocked, the
    training subpackages `losses/` and `train/`, the fused MSDA kernels'
    module, the evaluation path's `data/`, `eval/` and `utils/` modules and
    the training entry point's `native`, `utils.checkpoint`, `train.loop`
    and `cli.*` included, the model variants, the reference-checkpoint
    import and the multi-process `parallel.distributed` too, and no
    `cape_tpu.` module of the JAX package gets loaded."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "sys.modules['optax'] = None\n"
        "import cape_tpu_torch\n"
        "for m in pkgutil.walk_packages(cape_tpu_torch.__path__, "
        "'cape_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "for m in ('losses.criterion', 'train.state', 'train.train_step',\n"
        "          'ops.msda_fused', 'data.episodic', 'data.image',\n"
        "          'eval.audit', 'utils.logging', 'native',\n"
        "          'utils.checkpoint', 'train.loop', 'cli.train',\n"
        "          'cli.evaluate', 'cli.visualize', 'models.bixattn',\n"
        "          'models.deformable_points', 'models.decoder_variants',\n"
        "          'models.matcher', 'utils.torch_import',\n"
        "          'cli.import_checkpoint', 'parallel.distributed'):\n"
        "    assert 'cape_tpu_torch.' + m in sys.modules, m\n"
        "bad = [k for k in sys.modules if k == 'cape_tpu' or "
        "k.startswith('cape_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from cape_tpu_torch.serve import CAPEPredictor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_config.tiny_test_config()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PortCAPE(cfg)
    model = PortCAPE(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CAPEPredictor(cfg, model)
    assert CAPEPredictor(cfg, model, device="cpu").device.type == "cpu"
