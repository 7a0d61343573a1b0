"""Carry JAX weights into the port: `from_jax_params(params, cfg)`, and a
whole JAX train state (parameters, Adam moments, counts, accumulated
gradients): `from_jax_train_state(state, cfg)`.

`params` is the JAX package's parameter tree (`variables["params"]`) as
nested dicts of numpy arrays. Every leaf is used exactly once; a missing or
an extra leaf, or a shape mismatch, raises with the key. Dense kernels
`(in, out)` become `Linear.weight` `(out, in)`; conv kernels HWIO become
OIHW; norm scales become `weight`. Flax's automatic names map to the
port's attribute names:

    input_proj_i/layers_0|layers_1           -> input_projs.i.0|1
    encoder/layer_i/Dense_0|Dense_1          -> encoder.layers.i.linear1|2
    support_encoder/layer_i/MultiHeadAttention_0|LayerNorm_0|LayerNorm_1|
        Dense_0|Dense_1                      -> ...layers.i.self_attn|norm1|
                                                norm2|linear1|linear2
    support_encoder/gcn_i/Dense_0            -> support_encoder.gcn.i.linear
    decoder/coords_head_i/Dense_k            -> decoder.coords_heads.i.layers.k
    backbone/layerL_blockB/...               -> backbone.layerL.B....
    row_embed|col_embed (learned PE tables)   -> row_embed|col_embed

and inside a decoder layer, for the variants (v3's `cross_attn` is a
`BiXAttnBlock`, its last layer's a `CAOneSidedBlock` with the block's x
side names):

    cross_attn/BiXAttn_0|MultiHeadAttention_0 -> cross_attn.attn
    cross_attn/LayerNorm_0|1|2|3             -> cross_attn.norm_x|norm_y|
                                                mlp_x_norm|mlp_y_norm
    cross_attn/Dense_0|Dense_1               -> cross_attn.mlp_x_fc1|mlp_x_fc2
    point_sampler/proj_q_i (and conv_offset_a_i, offset_norm_i,
        conv_offset_b_i)                     -> point_sampler.proj_q.i (...)
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

from .config import CAPEConfig

_PATH_RULES = (
    (r"^backbone/layer(\d)_block(\d+)/", r"backbone/layer\1/\2/"),
    (r"^input_proj_(\d+)/layers_(\d+)/", r"input_projs/\1/\2/"),
    (r"^encoder/layer_(\d+)/Dense_0/", r"encoder/layers/\1/linear1/"),
    (r"^encoder/layer_(\d+)/Dense_1/", r"encoder/layers/\1/linear2/"),
    (r"^encoder/layer_(\d+)/", r"encoder/layers/\1/"),
    (r"^support_encoder/layer_(\d+)/MultiHeadAttention_0/",
     r"support_encoder/layers/\1/self_attn/"),
    (r"^support_encoder/layer_(\d+)/LayerNorm_0/",
     r"support_encoder/layers/\1/norm1/"),
    (r"^support_encoder/layer_(\d+)/LayerNorm_1/",
     r"support_encoder/layers/\1/norm2/"),
    (r"^support_encoder/layer_(\d+)/Dense_0/",
     r"support_encoder/layers/\1/linear1/"),
    (r"^support_encoder/layer_(\d+)/Dense_1/",
     r"support_encoder/layers/\1/linear2/"),
    (r"^support_encoder/gcn_(\d+)/Dense_0/", r"support_encoder/gcn/\1/linear/"),
    (r"^decoder/layer_(\d+)/", r"decoder/layers/\1/"),
    (r"^decoder/class_head_(\d+)/", r"decoder/class_heads/\1/"),
    (r"^decoder/coords_head_(\d+)/Dense_(\d+)/",
     r"decoder/coords_heads/\1/layers/\2/"),
)

#: rules applied after the first-match rules above, each wherever it matches
_INNER_RULES = (
    (r"/cross_attn/(?:BiXAttn_0|MultiHeadAttention_0)/", "/cross_attn/attn/"),
    (r"/cross_attn/LayerNorm_0/", "/cross_attn/norm_x/"),
    (r"/cross_attn/LayerNorm_1/", "/cross_attn/norm_y/"),
    (r"/cross_attn/LayerNorm_2/", "/cross_attn/mlp_x_norm/"),
    (r"/cross_attn/LayerNorm_3/", "/cross_attn/mlp_y_norm/"),
    (r"/cross_attn/Dense_0/", "/cross_attn/mlp_x_fc1/"),
    (r"/cross_attn/Dense_1/", "/cross_attn/mlp_x_fc2/"),
    (r"/point_sampler/(proj_q|conv_offset_a|offset_norm|conv_offset_b)_(\d+)/",
     r"/point_sampler/\1/\2/"),
)

_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias",
               "embedding": "weight", "frozen_affine_scale": "scale",
               "frozen_affine_bias": "bias"}


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, path + "/"))
        else:
            out[path] = np.asarray(v)
    return out


def port_key(jax_path: str) -> str:
    """The port's state_dict key of one JAX leaf path ("a/b/kernel")."""
    path = jax_path
    for pat, rep in _PATH_RULES:
        path, n = re.subn(pat, rep, path)
        if n:
            break
    for pat, rep in _INNER_RULES:
        path = re.sub(pat, rep, path)
    *parents, leaf = path.split("/")
    if parents:
        leaf = _LEAF_NAMES.get(leaf, leaf)
    return ".".join(parents + [leaf])


def _to_torch_layout(leaf: str, value: np.ndarray) -> np.ndarray:
    if leaf == "kernel" and value.ndim == 2:
        return value.T                           # (in, out) -> (out, in)
    if leaf == "kernel" and value.ndim == 4:
        return value.transpose(3, 2, 0, 1)       # HWIO -> OIHW
    return value


def _expected(cfg: CAPEConfig) -> Dict[str, torch.Tensor]:
    from .models.cape import CAPE

    return CAPE(cfg.replace(bf16=False), device="cpu").state_dict()


def _convert_tree(tree: Mapping, expected: Mapping[str, torch.Tensor],
                  where: str = "") -> Dict[str, torch.Tensor]:
    """One param-shaped JAX tree -> fp32 tensors by port key; `where`
    prefixes the JAX paths in errors."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(tree).items():
        key = port_key(path)
        if key not in expected:
            raise KeyError(f"JAX leaf {where + path!r} has no counterpart in "
                           f"the port (mapped to {key!r})")
        if key in out:
            raise KeyError(f"JAX leaf {where + path!r} maps to {key!r} twice")
        arr = _to_torch_layout(path.rsplit("/", 1)[-1], value)
        if tuple(arr.shape) != tuple(expected[key].shape):
            raise ValueError(f"shape mismatch for {where + path!r} -> "
                             f"{key!r}: {tuple(arr.shape)} vs "
                             f"{tuple(expected[key].shape)}")
        out[key] = torch.from_numpy(np.array(arr, np.float32, order="C"))
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"port weights missing from the JAX tree "
                       f"{where or 'params'}: {missing}")
    return out


def from_jax_params(params: Mapping, cfg: CAPEConfig) -> Dict[str, torch.Tensor]:
    """JAX param tree -> the port's fp32 `state_dict` for `CAPE(cfg)`."""
    return _convert_tree(params, _expected(cfg))


def from_jax_train_state(state: Mapping, cfg: CAPEConfig) -> Dict:
    """The JAX package's `TrainState` -> the dict that
    `train.state.TrainState.load_state_dict` takes.

    `state` is `flax.serialization.to_state_dict(jax.device_get(state))`:
    nested dicts of numpy arrays with `step`, `params` and `opt_state`,
    the optax state of the JAX `make_optimizer(cfg)` (`MultiSteps` around
    the chain clip -> Adam -> weight decay -> group LR when
    `cfg.accumulation_steps > 1`, the bare chain otherwise). Every leaf is
    used exactly once; a missing or extra leaf, or a shape mismatch, raises
    with the key.
    """
    flat = _flatten(state)
    expected = _expected(cfg)
    multi = cfg.accumulation_steps > 1
    chain = "opt_state/inner_opt_state/" if multi else "opt_state/"

    def scalar(path: str) -> int:
        if path not in flat:
            raise KeyError(f"JAX train state has no leaf {path!r}")
        return int(flat.pop(path))

    def tree(prefix: str) -> Dict[str, torch.Tensor]:
        sub = {}
        for path in [p for p in flat if p.startswith(prefix)]:
            node, parts = sub, path[len(prefix):].split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = flat.pop(path)
        return _convert_tree(sub, expected, prefix)

    out = {"step": scalar("step"), "params": tree("params/"),
           "mu": tree(chain + "1/mu/"), "nu": tree(chain + "1/nu/"),
           "adam_count": scalar(chain + "1/count"),
           "sched_count": scalar(chain + "3/count")}
    if multi:
        out["acc_grads"] = tree("opt_state/acc_grads/")
        out["mini_step"] = scalar("opt_state/mini_step")
        out["gradient_step"] = scalar("opt_state/gradient_step")
    else:
        out["acc_grads"] = {k: torch.zeros_like(v)
                            for k, v in out["params"].items()}
        out["mini_step"] = 0
        out["gradient_step"] = out["adam_count"]
    if flat:
        raise KeyError(f"JAX train state leaves with no counterpart in the "
                       f"port: {sorted(flat)}")
    return out
