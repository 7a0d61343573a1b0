"""Geometric support encoder: the port of `cape_tpu.models.support_encoder`.

Coordinate MLP + 2D sine PE of (x, y) + 1D sequence PE -> optional GCN
pre-encoding over the skeleton adjacency -> N post-LN transformer encoder
layers with key-padding masking. A sample whose keypoints are all masked
gets zeros (the finite NEG_INF masking keeps its rows finite until then).
Dropout (attention weights, residual branches, FFN) acts when a training
call passes a generator. The legacy `SupportPoseGraphEncoder` waits for a
later slice.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .attention import MultiHeadAttention
from .graph import GCNLayer, adj_from_skeleton
from .layers import Dense, LayerNorm, dropout
from .position_encoding import coords_sine_embed, interleaved_1d_table


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
        pe = interleaved_1d_table(self.max_seq_pe, self.hidden_dim)[:N]
        h = h + torch.as_tensor(pe, dtype=h.dtype, device=h.device)

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
