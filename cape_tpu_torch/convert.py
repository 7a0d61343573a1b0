"""Carry JAX weights into the port: `from_jax_params(params, cfg)`.

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


def from_jax_params(params: Mapping, cfg: CAPEConfig) -> Dict[str, torch.Tensor]:
    """JAX param tree -> the port's fp32 `state_dict` for `CAPE(cfg)`."""
    from .models.cape import CAPE

    expected = CAPE(cfg.replace(bf16=False), device="cpu").state_dict()
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(params).items():
        key = port_key(path)
        if key not in expected:
            raise KeyError(f"JAX leaf {path!r} has no counterpart in the "
                           f"port (mapped to {key!r})")
        if key in out:
            raise KeyError(f"JAX leaf {path!r} maps to {key!r} twice")
        arr = _to_torch_layout(path.rsplit("/", 1)[-1], value)
        if tuple(arr.shape) != tuple(expected[key].shape):
            raise ValueError(f"shape mismatch for {path!r} -> {key!r}: "
                             f"{tuple(arr.shape)} vs "
                             f"{tuple(expected[key].shape)}")
        out[key] = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"port weights missing from the JAX tree: {missing}")
    return out
