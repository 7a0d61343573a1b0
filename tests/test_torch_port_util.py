"""Shared fixtures of the port's parity tests: seeded JAX weights for the
tiny config, and their conversion into the port."""

from __future__ import annotations

import functools
import re

import jax
import numpy as np
import pytest
import torch

from cape_tpu.config import tiny_test_config as jax_tiny_config

#: torch threads of a test module that imports `few_torch_threads`
TORCH_THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """At most `TORCH_THREADS` torch threads while the importing module
    runs: the tier-1 run has several workers on the same cores, and eight
    threads a worker oversubscribe them (a tiny training loop then takes
    20x as long)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, TORCH_THREADS))
    yield
    torch.set_num_threads(n)


#: (coord, sep, eos) logit shift of the last class head, see `jax_tiny`
CLASS_BIAS_SHIFT = (1.0, 0.0, 2.2)


def jax_model_inputs(cfg, batch: int = 1):
    """Zero-valued example inputs with the model's static shapes."""
    S, K = cfg.image_size, cfg.max_support_keypoints
    L = cfg.seq_len
    targets = {k: np.zeros((batch, L), np.int32)
               for k in ("seq11", "seq12", "seq21", "seq22")}
    targets.update({k: np.zeros((batch, L), np.float32) for k in
                    ("delta_x1", "delta_x2", "delta_y1", "delta_y2")})
    return (np.zeros((batch, S, S, 3), np.uint8),
            np.zeros((batch, K, 2), np.float32),
            np.zeros((batch, K), bool),
            np.full((batch, cfg.max_skeleton_edges, 2), -1, np.int32),
            targets)


def random_params(shapes, seed: int):
    """Fill a param-shape tree with seeded numpy values: fan-in scaled
    kernels, small biases, norm scales near one (every leaf non-trivial,
    unlike the zero-initialised heads of a fresh model)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            gain = 2.0 if len(shape) == 4 else 1.0
            v = rng.normal(size=shape) * np.sqrt(gain / fan_in)
        elif name in ("scale", "frozen_affine_scale"):
            v = 1.0 + 0.1 * rng.normal(size=shape)
        elif name == "embedding":
            v = rng.normal(size=shape) * shape[-1] ** -0.5
        elif name in ("level_embed", "query_embed"):
            v = rng.normal(size=shape)
        else:  # biases
            v = 0.1 * rng.normal(size=shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@functools.lru_cache(maxsize=None)
def jax_tiny(seed: int = 0, **overrides):
    """(cfg, CAPE module, params) of the JAX package at the tiny config."""
    from cape_tpu.models import CAPE

    cfg = jax_tiny_config(**overrides)
    model = CAPE(cfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            *jax_model_inputs(cfg))["params"]
    params = random_params(shapes, seed)
    # shift the last class head so coord, sep and EOS all get predicted and
    # the samples of a batch stop at different steps
    head = params["decoder"][f"class_head_{cfg.dec_layers - 1}"]
    head["bias"] = head["bias"] + np.array(CLASS_BIAS_SHIFT, np.float32)
    return cfg, model, params


def episode_inputs(cfg, batch: int, n_kpts: int = 5, seed: int = 0):
    """Seeded uint8 images and a support prototype with a skeleton."""
    rng = np.random.default_rng(seed)
    S, K = cfg.image_size, cfg.max_support_keypoints
    imgs = rng.integers(0, 255, (batch, S, S, 3), dtype=np.uint8)
    sc = rng.uniform(0, 1, (batch, K, 2)).astype(np.float32)
    sm = np.zeros((batch, K), bool)
    sm[:, n_kpts:] = True
    se = np.full((batch, cfg.max_skeleton_edges, 2), -1, np.int32)
    se[:, :n_kpts - 1] = [[i, i + 1] for i in range(n_kpts - 1)]
    return imgs, sc, sm, se


def port_model(jax_cfg, params, **overrides):
    """The port's CAPE on the CPU with the JAX weights carried over."""
    from cape_tpu_torch.config import CAPEConfig
    from cape_tpu_torch.convert import from_jax_params
    from cape_tpu_torch.models.cape import CAPE

    cfg = CAPEConfig.from_json(jax_cfg.to_json()).replace(**overrides)
    model = CAPE(cfg, device="cpu")
    model.load_state_dict(from_jax_params(params, cfg))
    return model


def train_batch(cfg, batch: int, seed: int = 0, n_kpts: int = 5):
    """A seeded teacher-forced batch in the JAX train step's layout:
    images, a support prototype and tokenized keypoint targets, numpy."""
    from cape_tpu.data.tokenizer import DiscreteTokenizer, tokenize_keypoints

    imgs, sc, sm, se = episode_inputs(cfg, batch, n_kpts, seed)
    rng = np.random.default_rng(seed + 1000)
    tok = DiscreteTokenizer(cfg.num_bins, cfg.seq_len)
    S = cfg.image_size
    tg = []
    for _ in range(batch):
        vis = rng.integers(0, 3, n_kpts)
        vis[0] = 2
        tg.append(tokenize_keypoints(tok, rng.uniform(0, S, (n_kpts, 2)),
                                     S, S, vis))
    targets = {k: np.stack([t[k] for t in tg]) for k in tg[0]}
    return {"query_images": imgs, "support_coords": sc, "support_mask": sm,
            "skeleton_edges": se, "targets": targets}


def torchvision_state(backbone, seed, in_channels=3):
    """A seeded resnet50 state_dict under torchvision's names, shaped like
    `backbone` (a port `ResNet50`), with the `fc` head and the BN counters
    a real one carries."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(key, w):
        shape = tuple(w.shape)
        if key == "conv1.weight":
            shape = (shape[0], in_channels) + shape[2:]
        fan_in = int(np.prod(shape[1:]))
        sd[key] = (rng.normal(size=shape) * np.sqrt(2 / fan_in)).astype(
            np.float32)

    def bn(prefix, n):
        sd[f"{prefix}.weight"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
        sd[f"{prefix}.bias"] = rng.normal(0, 0.1, n).astype(np.float32)
        sd[f"{prefix}.running_mean"] = rng.normal(0, 0.2, n).astype(np.float32)
        sd[f"{prefix}.running_var"] = rng.uniform(0.3, 2.0, n).astype(
            np.float32)
        sd[f"{prefix}.num_batches_tracked"] = np.array(1000, np.int64)

    conv("conv1.weight", backbone.conv1.weight)
    bn("bn1", backbone.bn1.scale.numel())
    for li in range(4):
        for bi, blk in enumerate(getattr(backbone, f"layer{li + 1}")):
            t = f"layer{li + 1}.{bi}"
            for c in ("conv1", "conv2", "conv3"):
                conv(f"{t}.{c}.weight", getattr(blk, c).weight)
                bn(f"{t}.bn{c[-1]}", getattr(blk, c).weight.shape[0])
            if blk.downsample_conv is not None:
                conv(f"{t}.downsample.0.weight", blk.downsample_conv.weight)
                bn(f"{t}.downsample.1", blk.downsample_conv.weight.shape[0])
    sd["fc.weight"] = rng.normal(size=(1000, 2048)).astype(np.float32)
    sd["fc.bias"] = np.zeros(1000, np.float32)
    return sd


def record_loop(mp, loop_mod, to_host):
    """Record every train batch (where the loop validates it, on the host)
    and every step's metrics of `loop_mod.train_loop`."""
    from cape_tpu_torch.train import loop as port_loop

    rec = {"batches": [], "metrics": [], "init": None}

    def step(inner, state, batch, rng):
        state, m = inner(state, batch, rng)
        host = {k: np.atleast_1d(to_host(v)) for k, v in m.items()}
        for j in range(len(host["total"])):   # per micro-step
            rec["metrics"].append({k: float(v[j]) for k, v in host.items()})
        return state, m

    for name, stand_in in port_loop.instrumented(
            rec["batches"].append, step, loop_mod).items():
        mp.setattr(loop_mod, name, stand_in)
    return rec


def same_bytes(a, b, where=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            same_bytes(a[k], b[k], f"{where}/{k}")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, where
    assert a.tobytes() == b.tobytes(), where


# -- the model variants (test_torch_port_variants*.py) -------------------------
#: the configs of the whole-model variant tests, by name
VARIANTS = {
    "v2": {"dec_layer_type": "v2"},
    "v3": {"dec_layer_type": "v3"},
    "v4": {"dec_layer_type": "v4", "dec_attn_concat_src": True},
    "v41": {"dec_layer_type": "v41", "dec_attn_concat_src": True},
    "v5": {"dec_layer_type": "v5", "dec_attn_concat_src": True},
    "v6": {"dec_layer_type": "v6", "dec_attn_concat_src": True},
    "v1_concat_src": {"dec_attn_concat_src": True},
    "v1_no_qkv_proj": {"dec_qkv_proj": False},
    "legacy_encoder": {"use_geometric_encoder": False},
}


@functools.lru_cache(maxsize=None)
def variant_tiny(name):
    """(cfg, JAX module, params) of a variant: the default tiny model's
    seed-0 leaves wherever the variant has the same leaf, its own seeded
    ones elsewhere. The shared leaves keep the suite's weights, whose tiny
    backbone is well-conditioned in fp32: other draws make the GroupNorm
    of the 1x1 extra level (2 values a group) amplify fp32 summation order
    to 1e-3 in the encoder memory."""
    import flax

    cfg, jm, params = jax_tiny(0, **VARIANTS[name])
    base = flax.traverse_util.flatten_dict(jax_tiny(0)[2])
    flat = flax.traverse_util.flatten_dict(params)
    merged = {k: base[k] if k in base and base[k].shape == v.shape else v
              for k, v in flat.items()}
    return cfg, jm, flax.traverse_util.unflatten_dict(merged)


_MODEL_ARGS = ("query_images", "support_coords", "support_mask",
               "skeleton_edges", "targets")


@functools.lru_cache(maxsize=None)
def variant_runs(name):
    """The JAX and the port's teacher-forced runs of one batch (the batch
    of `test_torch_port_train`'s output test): JAX's outputs from the
    eager apply, its loss and gradients from one jitted step (JAX's eager
    and jitted forwards differ by up to 1.6e-3 on other batches of these
    random weights: fp32 conditioning, not the port), compiled at XLA's
    backend optimization level 0, which halves the compile time at this
    size and moves the gradients by under 4e-6 of their norm; the port's
    outputs, loss and gradients (zeros where a parameter is unused)."""
    from cape_tpu.losses import cape_criterion as jax_criterion
    from cape_tpu_torch.config import CAPEConfig
    from cape_tpu_torch.losses import cape_criterion as port_criterion

    cfg, jm, params = variant_tiny(name)
    batch = train_batch(cfg, 2, seed=1)
    args = [batch[k] for k in _MODEL_ARGS]
    jax_out = {k: np.asarray(v)
               for k, v in jm.apply({"params": params}, *args).items()}

    def loss_and_grad(p, batch):
        def loss(p):
            out = jm.apply({"params": p}, *(batch[k] for k in _MODEL_ARGS))
            return jax_criterion(out, batch["targets"], cfg)["total"]
        return jax.value_and_grad(loss)(p)

    step = jax.jit(loss_and_grad).lower(params, batch).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    loss, grads = jax.device_get(step(params, batch))
    pm = port_model(cfg, params)
    tb = jax.tree_util.tree_map(torch.from_numpy, batch)
    out = pm(*(tb[k] for k in _MODEL_ARGS))
    port_loss = port_criterion(out, tb["targets"],
                               CAPEConfig.from_json(cfg.to_json()))["total"]
    named = list(pm.named_parameters())
    got = torch.autograd.grad(port_loss, [p for _, p in named],
                              allow_unused=True)
    port_grads = {n: torch.zeros_like(p) if g is None else g
                  for (n, p), g in zip(named, got)}
    return dict(batch=batch, jax_out=jax_out, jax_loss=float(loss),
                jax_grads=grads, model=pm, out={k: v.detach()
                                                for k, v in out.items()},
                loss=port_loss.item(), grads=port_grads)


def _flat_port_layout(tree):
    """A JAX param-shaped tree by port key, in the port's layout."""
    import flax

    from cape_tpu_torch.convert import _to_torch_layout, port_key

    return {port_key(k): np.asarray(_to_torch_layout(k.rsplit("/", 1)[-1],
                                                     np.asarray(v)))
            for k, v in flax.traverse_util.flatten_dict(tree, sep="/").items()}


def assert_variant_outputs(name):
    """Every teacher-forced output (the aux outputs too) within 1e-5."""
    r = variant_runs(name)
    assert r["out"].keys() == r["jax_out"].keys() and "aux_classes" in r["out"]
    for k, want in r["jax_out"].items():
        assert r["out"][k].dtype == torch.float32
        np.testing.assert_allclose(r["out"][k].numpy(), want, atol=1e-5,
                                   rtol=1e-5, err_msg=k)


def assert_variant_gradients(name):
    """The loss, and every parameter's gradient through the criterion
    against `jax.grad`, the error over the global gradient norm: 1e-4, and
    1e-3 for the backbone and the input projections (random weights make
    them ill-conditioned, see `test_torch_port_train`). A variant's unused
    parameters (the support encoder under v2-v6) get zeros in both."""
    r = variant_runs(name)
    np.testing.assert_allclose(r["loss"], r["jax_loss"], rtol=1e-5)
    want = _flat_port_layout(r["jax_grads"])
    assert set(r["grads"]) == set(want)
    gnorm = np.sqrt(sum((w.astype(np.float64) ** 2).sum()
                        for w in want.values()))
    for n, g in r["grads"].items():
        err = np.abs(g.numpy() - want[n]).max() / gnorm
        conv = n.startswith(("backbone.", "input_projs."))
        assert err < (1e-3 if conv else 1e-4), (n, err)
    # what gets no gradient at all: v2-v6 leave the support encoder out,
    # and the tiny model's 1x1 level 3 makes v41's sampling position there
    # a constant (align_corners on one pixel), so its offset branch gets
    # none either
    unused = sorted(n for n, w in want.items() if not w.any())
    one_pixel = re.compile(r"decoder\.layers\.\d+\.point_sampler\.\w+\.3\.")
    support = [n for n in unused if n.startswith("support_encoder.")]
    assert bool(support) == (VARIANTS[name].get("dec_layer_type", "v1")
                             != "v1"), unused
    assert all(n.startswith("support_encoder.") or one_pixel.match(n)
               for n in unused), unused


def assert_variant_labels(name):
    """The parameter groups of the optimizer match the JAX package's."""
    import flax

    from cape_tpu.train import state as jax_state
    from cape_tpu_torch.convert import port_key
    from cape_tpu_torch.train import state as port_state

    _, _, params = variant_tiny(name)
    want = {port_key(k): v for k, v in flax.traverse_util.flatten_dict(
        jax_state._param_labels(params), sep="/").items()}
    assert port_state._param_labels(variant_runs(name)["model"]) == want
