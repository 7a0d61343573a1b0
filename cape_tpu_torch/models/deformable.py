"""Multi-scale deformable attention module + encoder stack: the port of
`cape_tpu.models.deformable`.

Spatial shapes are static tuples, every image is a fixed square (all-valid
masks, valid_ratios == 1), and `project_value` is exposed separately so the
decode projects (and quad-packs) the encoder memory once. The sampling
offsets are computed in fp32 on an fp32 query, and the attention softmax
in fp32, as in the JAX package. Training passes a dropout generator down;
`remat=True` recomputes each encoder layer in the backward
(`torch.utils.checkpoint`) with the same dropout masks.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops import msda as ops_msda
from .layers import Dense, LayerNorm, dropout, xavier_uniform_, zeros_


def _offset_bias_init(n_heads: int, n_levels: int, n_points: int) -> np.ndarray:
    """Radial-grid bias init (`deformable_transformer.py:61-70`)."""
    thetas = np.arange(n_heads, dtype=np.float64) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1).astype(np.float32)


class MSDeformAttn(nn.Module):
    def __init__(self, d_model: int = 256, n_levels: int = 4,
                 n_heads: int = 8, n_points: int = 4,
                 use_pallas: bool = False):
        super().__init__()
        self.d_model, self.n_levels = d_model, n_levels
        self.n_heads, self.n_points = n_heads, n_points
        self.use_pallas = use_pallas
        hlp = n_heads * n_levels * n_points
        self.sampling_offsets = Dense(d_model, hlp * 2)  # kept in fp32
        self.attention_weights = Dense(d_model, hlp)
        self.value_proj = Dense(d_model, d_model)
        self.output_proj = Dense(d_model, d_model)
        self._normalizers: Dict[Tuple, torch.Tensor] = {}

    def init_weights(self, g: torch.Generator) -> None:
        zeros_(self.sampling_offsets.weight)
        with torch.no_grad():
            self.sampling_offsets.bias.copy_(torch.from_numpy(
                _offset_bias_init(self.n_heads, self.n_levels,
                                  self.n_points)))
        zeros_(self.attention_weights.weight)
        zeros_(self.attention_weights.bias)
        xavier_uniform_(self.value_proj.weight, g)
        xavier_uniform_(self.output_proj.weight, g)

    def project_value(self, src: torch.Tensor) -> torch.Tensor:
        """(B, S, D) -> (B, S, H, Dh). Cacheable across decode steps."""
        b, s, _ = src.shape
        v = self.value_proj(src)
        return v.reshape(b, s, self.n_heads, self.d_model // self.n_heads)

    def project_value_quads(self, src: torch.Tensor,
                            spatial_shapes) -> torch.Tensor:
        """(B, S, D) -> (B*H, S', 4*Dh) decode-time quad slab."""
        return ops_msda.precompute_quad_slab(
            self.project_value(src), spatial_shapes)

    def _normalizer(self, spatial_shapes, device) -> torch.Tensor:
        """(L, 2) as (W, H) per level, cached per shapes and device (made
        outside inference mode, so that a model decoded first still
        trains)."""
        key = (tuple(map(tuple, spatial_shapes)), device)
        t = self._normalizers.get(key)
        if t is None:
            with torch.inference_mode(False):
                t = torch.tensor([[w_, h_] for h_, w_ in spatial_shapes],
                                 dtype=torch.float32, device=device)
            self._normalizers[key] = t
        return t

    def _sampling_inputs(self, query, reference_points, spatial_shapes):
        """Offsets/attention-softmax/location block shared by `forward`
        and `step_call`.

        Returns (loc fp32 (B, Lq, H, L, P, 2), attn fp32 (B, Lq, H, L, P)).
        """
        b, lq, _ = query.shape
        h, l, p = self.n_heads, self.n_levels, self.n_points
        offsets = self.sampling_offsets(query.float()).reshape(
            b, lq, h, l, p, 2)
        attn = self.attention_weights(query).reshape(b, lq, h, l * p)
        attn = torch.softmax(attn.float(), dim=-1).reshape(b, lq, h, l, p)
        # offsets normalized per level by (W, H) (`deformable_transformer.py:102-105`)
        normalizer = self._normalizer(spatial_shapes, query.device)
        loc = reference_points[:, :, None, :, None, :] + \
            offsets / normalizer[None, None, None, :, None, :]
        return loc.float(), attn

    def step_call(self, query, reference_points, quad_slab, spatial_shapes):
        """`forward` against a precomputed quad slab (decode step)."""
        loc, attn = self._sampling_inputs(
            query, reference_points, spatial_shapes)
        out = ops_msda.ms_deform_attn_core_prequad(
            quad_slab, spatial_shapes, loc, attn.to(quad_slab.dtype))
        return self.output_proj(out)

    def forward(self, query, reference_points, value, spatial_shapes):
        """Args:
            query: (B, Lq, D).
            reference_points: (B, Lq, L, 2) normalized (x, y).
            value: (B, S, H, Dh) — output of `project_value`.
        """
        loc, attn = self._sampling_inputs(
            query, reference_points, spatial_shapes)
        out = ops_msda.ms_deform_attn(
            value, spatial_shapes, loc, attn.to(value.dtype),
            use_pallas=self.use_pallas)
        return self.output_proj(out)


class DeformableEncoderLayer(nn.Module):
    """MSDeformAttn self-attention + FFN (`deformable_transformer.py:155-231`)."""

    def __init__(self, d_model: int = 256, d_ffn: int = 1024,
                 dropout: float = 0.1, n_levels: int = 4, n_heads: int = 8,
                 n_points: int = 4, use_pallas: bool = False):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points,
                                      use_pallas=use_pallas)
        self.norm1 = LayerNorm(d_model)
        self.linear1 = Dense(d_model, d_ffn)
        self.linear2 = Dense(d_ffn, d_model)
        self.norm2 = LayerNorm(d_model)

    def forward(self, src, pos, reference_points, spatial_shapes,
                generator: Optional[torch.Generator] = None):
        p = self.dropout
        value = self.self_attn.project_value(src)
        src2 = self.self_attn(src + pos, reference_points, value,
                              spatial_shapes)
        src = self.norm1(src + dropout(src2, p, generator))
        y = dropout(F.relu(self.linear1(src)), p, generator)
        y = self.linear2(y)
        return self.norm2(src + dropout(y, p, generator))


def encoder_reference_points(
        spatial_shapes: Sequence[Tuple[int, int]]) -> np.ndarray:
    """Dense per-pixel reference points over all levels, all-valid masks.

    (S, L, 2): each token's normalized center, broadcast across target
    levels (`deformable_transformer.py:248-271` with valid_ratios == 1).
    """
    refs = []
    for h, w in spatial_shapes:
        ry, rx = np.meshgrid(
            (np.arange(h, dtype=np.float32) + 0.5) / h,
            (np.arange(w, dtype=np.float32) + 0.5) / w,
            indexing="ij",
        )
        refs.append(np.stack([rx.reshape(-1), ry.reshape(-1)], -1))
    pts = np.concatenate(refs, 0)  # (S, 2)
    return np.tile(pts[:, None, :], (1, len(spatial_shapes), 1))


def _remat(layer: nn.Module, generator: Optional[torch.Generator], *args):
    """`layer(*args, generator)` under `torch.utils.checkpoint`, whose
    backward recomputation replays the forward's dropout masks: it restores
    the generator state the forward started from, then puts back the state
    the training call has reached by then."""
    start = None if generator is None else generator.get_state()
    ran = []

    def run(*a):
        if not ran or generator is None:
            ran.append(True)
            return layer(*a, generator)
        now = generator.get_state()
        generator.set_state(start)
        try:
            return layer(*a, generator)
        finally:
            generator.set_state(now)

    return checkpoint(run, *args, use_reentrant=False)


class DeformableEncoder(nn.Module):
    def __init__(self, num_layers: int = 6, d_model: int = 256,
                 d_ffn: int = 1024, dropout: float = 0.1, n_levels: int = 4,
                 n_heads: int = 8, n_points: int = 4, remat: bool = False,
                 use_pallas: bool = False):
        super().__init__()
        self.remat = remat
        self._refs: Dict[Tuple, torch.Tensor] = {}
        self.layers = nn.ModuleList([
            DeformableEncoderLayer(d_model, d_ffn, dropout, n_levels, n_heads,
                                   n_points, use_pallas=use_pallas)
            for _ in range(num_layers)])

    def _reference_points(self, spatial_shapes, device) -> torch.Tensor:
        """`encoder_reference_points` on `device`, made once per shapes and
        device (outside inference mode, so that a model decoded first still
        trains; a copy from host memory cannot run while a CUDA graph
        captures)."""
        key = (tuple(map(tuple, spatial_shapes)), device)
        t = self._refs.get(key)
        if t is None:
            with torch.inference_mode(False):
                t = torch.as_tensor(encoder_reference_points(spatial_shapes),
                                    device=device)
            self._refs[key] = t
        return t

    def forward(self, src, pos, spatial_shapes,
                generator: Optional[torch.Generator] = None):
        """`remat` (the JAX package's `nn.remat` per layer) applies only
        where autograd records: it trades the layers' saved activations for
        a second forward in the backward."""
        ref = self._reference_points(spatial_shapes, src.device)[None]
        ref = ref.expand(src.shape[0], *ref.shape[1:])
        remat = self.remat and torch.is_grad_enabled()
        out = src
        for layer in self.layers:
            if remat:
                out = _remat(layer, generator, out, pos, ref, spatial_shapes)
            else:
                out = layer(out, pos, ref, spatial_shapes, generator)
        return out
