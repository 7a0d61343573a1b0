"""Backbone weights and the learned position embedding of the port against
the JAX package's on the CPU.

- `models.backbone.load_torch_resnet50_state` / `_npz` fold a seeded
  state_dict under torchvision's key names (no download) into the port's
  ResNet-50; the JAX loader's result, carried over by
  `convert.from_jax_params`, must equal it leaf by leaf (both fold in
  float32 numpy, so bit for bit).
- `position_embedding='learned'` / `'v3'`: `encode_image` and the
  teacher-forced forward at the tiny config in fp32, within the 1e-3 of
  `test_torch_port_models.py::test_encode_image_uint8` (the random-weight
  encoder's sampling locations amplify fp32 summation order).
"""

import numpy as np
import pytest
import torch

import jax

from cape_tpu.models import backbone as jax_backbone
from cape_tpu.models import cape as jax_cape

from cape_tpu_torch.config import tiny_test_config
from cape_tpu_torch.convert import from_jax_params
from cape_tpu_torch.models import backbone as port_backbone
from cape_tpu_torch.models.cape import CAPE
from cape_tpu_torch.train import create_train_state

from test_torch_port_util import few_torch_threads  # noqa: F401
from test_torch_port_util import (jax_model_inputs, jax_tiny, port_model,
                                  random_params, torchvision_state,
                                  train_batch)


@pytest.mark.parametrize("in_channels", [3, 4])
def test_load_torch_resnet50_state_matches_jax(in_channels):
    """Full ResNet-50 blocks (3, 4, 6, 3); with 4 input channels the
    3-channel checkpoint's `conv1` is left out by both loaders."""
    from cape_tpu.config import tiny_test_config as jax_tiny_config
    from cape_tpu.models import CAPE as JaxCAPE

    jcfg = jax_tiny_config(backbone="resnet50", input_channels=in_channels)
    inputs = list(jax_model_inputs(jcfg))
    inputs[0] = np.zeros(inputs[0].shape[:-1] + (in_channels,), np.uint8)
    shapes = jax.eval_shape(JaxCAPE(jcfg).init, jax.random.PRNGKey(0),
                            *inputs)["params"]
    params = random_params(shapes, 5)
    pm = port_model(jcfg, params)
    sd = torchvision_state(pm.backbone, 11)

    loaded = dict(params)
    loaded["backbone"] = jax_backbone.load_torch_resnet50_state(
        params["backbone"], sd)
    want = from_jax_params(loaded, pm.cfg)
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    values = port_backbone.load_torch_resnet50_state(pm.backbone, sd)
    got = pm.state_dict()
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k
    changed = {k for k in got if not torch.equal(got[k], before[k])}
    assert changed == {f"backbone.{k}" for k in values}
    assert ("backbone.conv1.weight" in changed) == (in_channels == 3)
    assert "backbone.layer4.0.downsample_bn.scale" in changed


def test_npz_loader_and_shape_errors(tmp_path):
    backbone = port_backbone.ResNet50()
    sd = torchvision_state(backbone, 3)
    path = tmp_path / "resnet50.npz"
    np.savez(path, **sd)
    a = port_backbone.load_torch_resnet50_npz(backbone, str(path))
    b = port_backbone.resnet50_state_from_torchvision(backbone, sd)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    for name, m in backbone.named_modules():
        if isinstance(m, port_backbone.FrozenAffine):
            assert f"{name}.scale" in a, name
    sd["layer2.0.conv2.weight"] = sd["layer2.0.conv2.weight"][:, :64]
    with pytest.raises(ValueError, match="layer2.0.conv2.weight"):
        port_backbone.load_torch_resnet50_state(backbone, sd)
    del sd["layer1.0.bn1.running_var"]
    with pytest.raises(KeyError, match="layer1.0.bn1.running_var"):
        port_backbone.load_torch_resnet50_state(backbone, sd)


def test_bf16_model_keeps_fp32_masters_of_loaded_weights():
    """Loaded into a bf16 model, the weights keep their fp32 values as the
    masters (`create_train_state(masters=...)`), the model their cast, and
    with `resnet_weights` set the affines are frozen."""
    cfg = tiny_test_config(bf16=True, resnet_weights="given.npz")
    model = CAPE(cfg, device="cpu")
    values = port_backbone.load_torch_resnet50_state(
        model.backbone, torchvision_state(model.backbone, 4))
    masters = {f"backbone.{k}": v for k, v in values.items()}
    state = create_train_state(cfg, model, 4, masters=masters)
    params = dict(model.named_parameters())
    st = state.opt_state
    for name, m, label in zip(st.names, st.masters, st.labels):
        if name in masters:
            assert torch.equal(m, masters[name]), name
            assert torch.equal(params[name], m.to(params[name].dtype)), name
        if name.endswith(("bn1.scale", "downsample_bn.bias")):
            assert label == "frozen", name
    assert sum(not torch.equal(m, params[n].float()) for n, m in
               zip(st.names, st.masters) if n in masters) > 0
    with pytest.raises(KeyError, match="nope"):
        create_train_state(cfg, model, 4, masters={"nope": torch.zeros(1)})


# -- learned position embedding -------------------------------------------------
@pytest.mark.parametrize("pe", ["learned", "v3"])
def test_learned_position_embedding(pe):
    cfg, jm, params = jax_tiny(0, position_embedding=pe)
    max_hw = cfg.image_size // 8
    assert params["row_embed"].shape == params["col_embed"].shape == (
        max_hw, cfg.hidden_dim // 2)
    pm = port_model(cfg, params)
    assert torch.equal(pm.row_embed, torch.from_numpy(params["row_embed"]))
    b = train_batch(cfg, 2, seed=6)
    want = jm.apply({"params": params}, b["query_images"],
                    method=jax_cape.CAPE.encode_image)
    got = pm.encode_image(torch.from_numpy(b["query_images"]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-3, rtol=1e-3)
    want = jm.apply({"params": params}, b["query_images"],
                    b["support_coords"], b["support_mask"],
                    b["skeleton_edges"], b["targets"])
    tb = {k: torch.from_numpy(v) for k, v in b["targets"].items()}
    got = pm(*(torch.from_numpy(b[k]) for k in (
        "query_images", "support_coords", "support_mask", "skeleton_edges")),
        tb)
    for k in ("pred_logits", "pred_coords"):
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), atol=1e-3, rtol=1e-3)
    # the tables get gradients (they are trained)
    got["pred_coords"].sum().backward()
    assert pm.row_embed.grad.abs().sum() > 0
    assert pm.col_embed.grad.abs().sum() > 0


def test_learned_embedding_seeded_init():
    """flax's `uniform(1.0)`: the tables start in [0, 1)."""
    m = CAPE(tiny_test_config(position_embedding="learned"), device="cpu")
    for t in (m.row_embed, m.col_embed):
        assert t.shape == (8, 32) and 0 <= t.min() and t.max() < 1
        assert t.std() > 0.2
