"""Support encoders: the port of `cape_tpu.models.support_encoder`.

`GeometricSupportEncoder`, the shipped path: coordinate MLP + 2D sine PE
of (x, y) + 1D sequence PE -> optional GCN pre-encoding over the skeleton
adjacency -> N post-LN transformer encoder layers with key-padding
masking. A sample whose keypoints are all masked gets zeros (the finite
NEG_INF masking keeps its rows finite until then).

`SupportPoseGraphEncoder`, the legacy encoder (`use_geometric_encoder=
False`): coordinate MLP, a binary edge-presence embedding scaled by the
node degree / 10, 1D PE, transformer layers, final LayerNorm.

Dropout (attention weights, residual branches, FFN) acts when a training
call passes a generator.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .attention import MultiHeadAttention
from .graph import GCNLayer, adj_from_skeleton
from .layers import Dense, LayerNorm, dropout
from .position_encoding import coords_sine_embed, interleaved_1d_table


def _sequence_pe(cache: Dict[Tuple, torch.Tensor], rows: int, n: int,
                 dim: int, dtype: torch.dtype, device) -> torch.Tensor:
    """The first `n` rows of the (rows, dim) 1D sequence PE table in
    `dtype` on `device`, the table made once per (rows, dtype, device) and
    kept in `cache` (outside inference mode, so that a model decoded first
    still trains; a copy from host memory cannot run while a CUDA graph
    captures)."""
    key = (rows, dtype, device)
    table = cache.get(key)
    if table is None:
        with torch.inference_mode(False):
            table = torch.as_tensor(interleaved_1d_table(rows, dim),
                                    dtype=dtype, device=device)
        cache[key] = table
    return table[:n]


class TransformerEncoderLayer(nn.Module):
    """Post-LN encoder layer (torch `nn.TransformerEncoderLayer` semantics)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout)
        self.norm1 = LayerNorm(d_model)
        self.linear1 = Dense(d_model, dim_feedforward)
        self.linear2 = Dense(dim_feedforward, d_model)
        self.norm2 = LayerNorm(d_model)

    def forward(self, x: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        p = self.dropout
        attn = self.self_attn(x, x, key_padding_mask=key_padding_mask,
                              generator=generator)
        x = self.norm1(x + dropout(attn, p, generator))
        y = dropout(F.relu(self.linear1(x)), p, generator)
        y = self.linear2(y)
        return self.norm2(x + dropout(y, p, generator))


class GeometricSupportEncoder(nn.Module):
    """Encode support keypoints + skeleton into (B, N, D) features.

    Mask convention: True = INVALID keypoint, throughout the framework.
    """

    def __init__(self, hidden_dim: int = 256, num_layers: int = 3,
                 nhead: int = 8, dim_feedforward: int = 1024,
                 dropout: float = 0.1, use_gcn: bool = True,
                 num_gcn_layers: int = 2, max_seq_pe: int = 100):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.use_gcn = use_gcn
        self.max_seq_pe = max_seq_pe
        self._pe_tables: Dict[Tuple, torch.Tensor] = {}
        self.coord_mlp_0 = Dense(2, hidden_dim)
        self.coord_mlp_1 = Dense(hidden_dim, hidden_dim)
        self.gcn = nn.ModuleList(
            [GCNLayer(hidden_dim, hidden_dim)
             for _ in range(num_gcn_layers if use_gcn else 0)])
        self.layers = nn.ModuleList(
            [TransformerEncoderLayer(hidden_dim, nhead, dim_feedforward,
                                     dropout)
             for _ in range(num_layers)])

    def forward(self, coords: torch.Tensor, mask: torch.Tensor,
                skeleton_edges: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """coords: (B, N, 2) in [0,1]; mask: (B, N) True=invalid;
        skeleton_edges: (B, E, 2) int, -1 padded; generator: dropout masks,
        None = deterministic."""
        B, N, _ = coords.shape
        dtype = self.coord_mlp_0.weight.dtype
        coords = coords.to(dtype)

        # 1-2. coordinate MLP + 2D spatial sine PE
        h = self.coord_mlp_1(F.relu(self.coord_mlp_0(coords)))
        h = h + coords_sine_embed(coords, self.hidden_dim // 2).to(h.dtype)

        # 3. 1D sequence PE (which keypoint in the ordering)
        h = h + _sequence_pe(self._pe_tables, self.max_seq_pe, N,
                             self.hidden_dim, h.dtype, h.device)

        # 4. optional GCN pre-encoding over the skeleton
        if self.use_gcn and skeleton_edges is not None:
            adj = adj_from_skeleton(N, skeleton_edges, mask)
            for layer in self.gcn:
                h = layer(h, adj)

        # 5. transformer self-attention with key-padding mask
        for layer in self.layers:
            h = layer(h, key_padding_mask=mask, generator=generator)

        # zero out fully-masked samples (invalid data guard,
        # geometric_support_encoder.py:197-226)
        all_masked = mask.all(dim=1)
        return torch.where(all_masked[:, None, None],
                           torch.zeros((), dtype=h.dtype, device=h.device), h)


class SupportPoseGraphEncoder(nn.Module):
    """Legacy support encoder (`models/support_encoder.py:8-133`), selected
    by the reference when `--use_geometric_encoder` is off.

    Mask polarity: the reference inverted the support mask before using it
    as the key-padding mask, so it attended to INVALID keypoints. The JAX
    package (and the port) apply the framework's convention instead: True =
    invalid = ignored.
    """

    def __init__(self, hidden_dim: int = 256, num_layers: int = 3,
                 nhead: int = 8, dim_feedforward: int = 1024,
                 dropout: float = 0.1):
        super().__init__()
        self.hidden_dim = hidden_dim
        self._pe_tables: Dict[Tuple, torch.Tensor] = {}
        self.coord_mlp_0 = Dense(2, hidden_dim)
        self.coord_mlp_1 = Dense(hidden_dim, hidden_dim)
        self.edge_embedding = nn.Embedding(2, hidden_dim)
        self.coord_edge_proj = Dense(2 * hidden_dim, hidden_dim)
        self.layers = nn.ModuleList(
            [TransformerEncoderLayer(hidden_dim, nhead, dim_feedforward,
                                     dropout)
             for _ in range(num_layers)])
        self.final_norm = LayerNorm(hidden_dim)

    def forward(self, coords: torch.Tensor, mask: torch.Tensor,
                skeleton_edges: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """coords: (B, N, 2); mask: (B, N) True=invalid; skeleton_edges:
        (B, E, 2) int, -1 padded, 0-indexed (the data layer normalizes
        COCO's 1-indexed skeletons at load, so nothing shifts here)."""
        B, N, _ = coords.shape
        h = self.coord_mlp_1(F.relu(self.coord_mlp_0(coords)))

        if skeleton_edges is not None:
            adj = adj_from_skeleton(N, skeleton_edges, torch.zeros_like(mask))
            # the row-normalized channel is > 0 exactly where an edge is
            binary = (adj[:, 1] > 0).float()
            degree = binary.sum(dim=2)
            edge_emb = self.edge_embedding((degree > 0).long())
            scale = degree.clamp(min=1.0)[..., None] / 10.0
            combined = torch.cat([h, edge_emb * scale.to(h.dtype)], dim=-1)
            h = self.coord_edge_proj(combined)

        h = h + _sequence_pe(self._pe_tables, max(N, 64), N,
                             self.hidden_dim, h.dtype, h.device)
        for layer in self.layers:
            h = layer(h, key_padding_mask=mask, generator=generator)
        return self.final_norm(h)
