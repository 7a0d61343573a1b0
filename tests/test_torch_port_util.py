"""Shared fixtures of the port's parity tests: seeded JAX weights for the
tiny config, and their conversion into the port."""

from __future__ import annotations

import functools

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
