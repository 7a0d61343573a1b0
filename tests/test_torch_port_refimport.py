"""The reference-checkpoint import of the port
(`cape_tpu_torch.utils.torch_import`, `cli.import_checkpoint`) against the
JAX package's (`cape_tpu.utils.torch_import`), on the CPU at the tiny
config.

No reference checkpoint is at hand, so `reference_layout` lays a seeded
JAX param tree out under the reference's state-dict keys (the inverse of
the JAX mapping). (a) The JAX importer accepts that dict and returns the
tree it came from, which validates the layout; (b) the port's import of
the same dict equals `convert.from_jax_params` of the JAX import, leaf by
leaf, bit for bit.
"""

import argparse
import dataclasses

import numpy as np
import pytest
import torch

import flax

from cape_tpu.config import CAPEConfig as JaxConfig
from cape_tpu.utils import torch_import as jax_import

from cape_tpu_torch.config import CAPEConfig as PortConfig
from cape_tpu_torch.convert import from_jax_params
from cape_tpu_torch.models.cape import CAPE as PortCAPE
from cape_tpu_torch.utils import torch_import as port_import

from test_torch_port_util import jax_tiny, torchvision_state

#: the configs of the import: the geometric support encoder, the legacy
#: one, and the geometric one with a ResNet-50 (whose BN statistics fold)
CASES = {"geometric": {}, "legacy": {"use_geometric_encoder": False},
         "resnet50": {"backbone": "resnet50"}}


def _port_cfg(jax_cfg):
    return PortConfig.from_json(jax_cfg.to_json())


def _t(kernel):
    return np.ascontiguousarray(np.asarray(kernel).T)


def _linear(sd, key, tree):
    sd[f"{key}.weight"] = _t(tree["kernel"])
    if "bias" in tree:
        sd[f"{key}.bias"] = np.asarray(tree["bias"])


def _norm(sd, key, tree):
    sd[f"{key}.weight"] = np.asarray(tree["scale"])
    sd[f"{key}.bias"] = np.asarray(tree["bias"])


def _mha(sd, key, tree):
    sd[f"{key}.in_proj_weight"] = np.concatenate(
        [_t(tree[n]["kernel"]) for n in ("q_proj", "k_proj", "v_proj")])
    sd[f"{key}.in_proj_bias"] = np.concatenate(
        [np.asarray(tree[n]["bias"]) for n in ("q_proj", "k_proj", "v_proj")])
    _linear(sd, f"{key}.out_proj", tree["out_proj"])


def reference_layout(p, cfg, backbone_sd=None):
    """A v1 CAPE param tree `p` under the reference's state-dict keys, as
    `CAPEModel.state_dict()` lays them out, with the per-layer head aliases
    and the reference's trained-but-unused tensors."""
    sd, tr = {}, "base_model.transformer"
    for k, v in (backbone_sd or {}).items():
        sd[f"base_model.backbone.0.body.{k}"] = v
    for i in range(cfg.num_feature_levels):
        proj = p[f"input_proj_{i}"]
        sd[f"base_model.input_proj.{i}.0.weight"] = np.ascontiguousarray(
            np.asarray(proj["layers_0"]["kernel"]).transpose(3, 2, 0, 1))
        sd[f"base_model.input_proj.{i}.0.bias"] = np.asarray(
            proj["layers_0"]["bias"])
        _norm(sd, f"base_model.input_proj.{i}.1", proj["layers_1"])
    sd[f"{tr}.level_embed"] = np.asarray(p["level_embed"])
    for i in range(cfg.enc_layers):
        e, el = p["encoder"][f"layer_{i}"], f"{tr}.encoder.layers.{i}"
        for n in ("sampling_offsets", "attention_weights", "value_proj",
                  "output_proj"):
            _linear(sd, f"{el}.self_attn.{n}", e["self_attn"][n])
        _norm(sd, f"{el}.norm1", e["norm1"])
        _linear(sd, f"{el}.linear1", e["Dense_0"])
        _linear(sd, f"{el}.linear2", e["Dense_1"])
        _norm(sd, f"{el}.norm2", e["norm2"])
    d, dec = p["decoder"], f"{tr}.decoder"
    sd[f"{dec}.token_embed.weight"] = np.asarray(d["token_embed"]["embedding"])
    sd["base_model.query_embed.weight"] = np.asarray(d["query_embed"])
    _linear(sd, f"{dec}.pos_trans", d["pos_trans"])
    _norm(sd, f"{dec}.pos_trans_norm", d["pos_trans_norm"])
    for i in range(cfg.dec_layers):
        l, dl = d[f"layer_{i}"], f"{dec}.layers.{i}"
        for n in ("attn_q", "attn_k", "attn_v"):
            _linear(sd, f"{dl}.{n}", l[n])
        _mha(sd, f"{dl}.self_attn", l["self_attn"])
        _mha(sd, f"{dl}.support_attn", l["support_attn"])
        for n in ("sampling_offsets", "attention_weights", "value_proj",
                  "output_proj"):
            _linear(sd, f"{dl}.cross_attn.{n}", l["cross_attn"][n])
        for n in ("norm1", "norm2", "norm3", "norm_support"):
            _norm(sd, f"{dl}.{n}", l[n])
        _linear(sd, f"{dl}.linear1", l["linear1"])
        _linear(sd, f"{dl}.linear2", l["linear2"])
        # the heads sit at base_model level and, aliased, in the decoder
        for where in ("base_model", dec):
            _linear(sd, f"{where}.class_embed.{i}", d[f"class_head_{i}"])
            for j in range(3):
                _linear(sd, f"{where}.coords_embed.{i}.layers.{j}",
                        d[f"coords_head_{i}"][f"Dense_{j}"])
    s, se = p["support_encoder"], "support_encoder"
    if cfg.use_geometric_encoder:
        _linear(sd, f"{se}.coord_mlp.0", s["coord_mlp_0"])
        _linear(sd, f"{se}.coord_mlp.2", s["coord_mlp_1"])
        for i in range(cfg.num_gcn_layers):
            g = s[f"gcn_{i}"]["Dense_0"]
            sd[f"{se}.gcn_layers.{i}.conv.weight"] = _t(g["kernel"])[:, :, None]
            sd[f"{se}.gcn_layers.{i}.conv.bias"] = np.asarray(g["bias"])
    else:
        _linear(sd, f"{se}.coord_embedding.0", s["coord_mlp_0"])
        _linear(sd, f"{se}.coord_embedding.2", s["coord_mlp_1"])
        sd[f"{se}.edge_embedding.weight"] = np.asarray(
            s["edge_embedding"]["embedding"])
        _linear(sd, f"{se}.coord_edge_proj", s["coord_edge_proj"])
        _norm(sd, f"{se}.norm", s["final_norm"])
    for i in range(cfg.support_encoder_layers):
        l, sl = s[f"layer_{i}"], f"{se}.transformer_encoder.layers.{i}"
        _mha(sd, f"{sl}.self_attn", l["MultiHeadAttention_0"])
        _norm(sd, f"{sl}.norm1", l["LayerNorm_0"])
        _linear(sd, f"{sl}.linear1", l["Dense_0"])
        _linear(sd, f"{sl}.linear2", l["Dense_1"])
        _norm(sd, f"{sl}.norm2", l["LayerNorm_1"])
    D = cfg.hidden_dim
    sd["support_cross_attention_layers.0.in_proj_weight"] = np.zeros(
        (3 * D, D), np.float32)
    sd["support_attn_layer_norms.0.weight"] = np.ones(D, np.float32)
    sd["support_proj.weight"] = np.zeros((D, D), np.float32)
    return sd


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """The reference dict of seed-0 weights, the seed-1 tree that plays the
    freshly initialised model, and both imports."""
    overrides = CASES[request.param]
    cfg, _, params = jax_tiny(0, **overrides)
    _, _, base = jax_tiny(1, **overrides)
    pcfg = _port_cfg(cfg)
    backbone = None
    if cfg.backbone == "resnet50":
        backbone = torchvision_state(
            PortCAPE(pcfg, device="cpu").backbone, seed=2)
    sd = reference_layout(params, cfg, backbone)
    jax_out = jax_import.import_reference_state_dict(
        sd, {"params": base}, cfg)["params"]
    port_out = port_import.import_reference_state_dict(
        sd, pcfg, base=from_jax_params(base, pcfg))
    return dict(name=request.param, cfg=cfg, pcfg=pcfg, params=params,
                sd=sd, jax_out=jax_out, port_out=port_out)


def _flat(tree):
    return flax.traverse_util.flatten_dict(tree, sep="/")


def test_jax_import_accepts_the_layout(case):
    """(a): the JAX importer reads the dict back into the tree it was laid
    out from (the backbone, absent from the dict except in the ResNet-50
    case, stays the initialised one)."""
    got, want = _flat(case["jax_out"]), _flat(case["params"])
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k.startswith("backbone/"):
            continue
        np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)


def test_port_import_equals_the_jax_import(case):
    """(b): bit for bit, every tensor of the port's state_dict."""
    want = from_jax_params(case["jax_out"], case["pcfg"])
    got = case["port_out"]
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k], v), k


def _errors():
    """(label, edit of (cfg overrides, sd), match) of the refused imports."""
    def drop(sd, key):
        sd = dict(sd)
        del sd[key]
        return sd

    def reshape(sd, key):
        sd = dict(sd)
        sd[key] = np.zeros((3, 3), np.float32)
        return sd

    return {
        "missing key": (lambda sd: ({}, drop(sd, "base_model.query_embed.weight")),
                        "query_embed"),
        "shape": (lambda sd: ({}, reshape(
            sd, "base_model.transformer.encoder.layers.0.norm1.weight")),
            "shape mismatch"),
        "non-v1": (lambda sd: ({"dec_layer_type": "v2"}, sd), "v1"),
        "encoder kind": (lambda sd: ({"use_geometric_encoder": False}, sd),
                         "use_geometric_encoder"),
    }


@pytest.mark.parametrize("label", list(_errors()))
def test_refused_imports_match_the_jax_package(label):
    edit, match = _errors()[label]
    cfg, _, params = jax_tiny(0)
    overrides, sd = edit(reference_layout(params, cfg))
    jcfg = cfg.replace(**overrides)
    with pytest.raises(jax_import.CheckpointImportError, match=match):
        jax_import.import_reference_state_dict(sd, {"params": params}, jcfg)
    with pytest.raises(port_import.CheckpointImportError, match=match):
        port_import.import_reference_state_dict(sd, _port_cfg(jcfg))


def test_config_from_reference_args_matches_jax():
    args = {"hidden_dim": 128, "enc_layers": 3, "dec_layers": 4,
            "image_size": 256, "dec_layer_type": "v1", "lr": 2e-4,
            "use_gcn_preenc": False, "seq_len": None, "unknown": 5}
    want = jax_import.config_from_reference_args(args, nheads=4)
    got = port_import.config_from_reference_args(args, nheads=4)
    assert got.to_json() == want.to_json()


def test_import_cli_writes_a_checkpoint_from_checkpoint_reads(tmp_path):
    """`cli.import_checkpoint` on a `.pth` written by `torch.save`: the
    checkpoint's config is the tiny one, and `from_checkpoint` loads the
    imported weights."""
    from cape_tpu_torch.cli import import_checkpoint
    from cape_tpu_torch.serve import CAPEPredictor

    cfg, _, params = jax_tiny(0)
    pcfg = _port_cfg(cfg)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in
          reference_layout(params, cfg).items()}
    mapped = ("hidden_dim", "nheads", "enc_layers", "dec_layers",
              "dim_feedforward", "dropout", "image_size", "seq_len",
              "vocab_size", "num_gcn_layers", "support_encoder_layers")
    args = argparse.Namespace(**{f: getattr(cfg, f) for f in mapped})
    default = JaxConfig()
    sets = [f"{f.name}={getattr(cfg, f.name)}".replace("True", "true")
            .replace("False", "false")
            for f in dataclasses.fields(cfg)
            if f.name not in mapped
            and getattr(cfg, f.name) != getattr(default, f.name)]
    pth = tmp_path / "checkpoint_best.pth"
    torch.save({"model": sd, "args": args, "epoch": 7, "best_pck": 0.25},
               pth)
    argv = ["--torch_checkpoint", str(pth), "--output_dir",
            str(tmp_path / "imported"), "--device", "cpu"]
    for s in sets:
        argv += ["--set", s]
    out = import_checkpoint.main(argv)
    assert out.endswith("epoch_7")
    pred = CAPEPredictor.from_checkpoint(out, device="cpu")
    assert pred.model.cfg.to_json() == pcfg.to_json()
    want = port_import.import_reference_state_dict(sd, pcfg)
    got = pred.model.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k


class _NotAllowed:
    """A class a reference checkpoint never pickles."""


def test_import_cli_refuses_a_pth_with_other_classes(tmp_path):
    """`cli.import_checkpoint` reads with `weights_only=True`: a `.pth`
    whose pickle needs a class other than `argparse.Namespace` is refused
    before anything is built or written."""
    import pickle

    from cape_tpu_torch.cli import import_checkpoint

    pth = tmp_path / "checkpoint_best.pth"
    torch.save({"model": {}, "args": argparse.Namespace(hidden_dim=32),
                "extra": _NotAllowed()}, pth)
    with pytest.raises(pickle.UnpicklingError, match="_NotAllowed"):
        import_checkpoint.main(["--torch_checkpoint", str(pth),
                                "--output_dir", str(tmp_path / "out"),
                                "--device", "cpu"])
    assert not (tmp_path / "out").exists()
