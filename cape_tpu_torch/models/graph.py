"""Skeleton-graph utilities: the port of `cape_tpu.models.graph`.

Edges arrive as a static-shape (B, E, 2) int32 tensor padded with -1; the
whole batch adjacency is one scatter. Semantics: symmetrization,
out-of-range edge filtering, visibility masking, row normalization and
dual-channel [self-loops, neighbors] stacking (`graph_utils.py:83-186`).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Dense


def adj_from_skeleton(num_pts: int, edges: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """Build the dual-channel normalized adjacency.

    Args:
        num_pts: number of (padded) keypoints N.
        edges: (B, E, 2) int edge list, -1-padded. Edges with any index
            outside [0, N) are ignored.
        mask: (B, N) boolean, True = invalid/invisible keypoint.

    Returns:
        (B, 2, N, N) float32: channel 0 = diag(~mask), channel 1 =
        row-normalized symmetric adjacency with masked rows/cols zeroed.
    """
    B, E, _ = edges.shape
    e0, e1 = edges[..., 0].long(), edges[..., 1].long()
    valid = (e0 >= 0) & (e0 < num_pts) & (e1 >= 0) & (e1 < num_pts)
    e0c = e0.clamp(0, num_pts - 1)
    e1c = e1.clamp(0, num_pts - 1)

    b_idx = torch.arange(B, device=edges.device)[:, None]
    flat = (b_idx * num_pts + e0c) * num_pts + e1c          # (B, E)
    adj = torch.zeros(B * num_pts * num_pts, dtype=torch.float32,
                      device=edges.device)
    # max-scatter: duplicate edges (and padding aliasing a real edge) are safe
    adj = adj.scatter_reduce(0, flat.reshape(-1),
                             valid.reshape(-1).float(), reduce="amax")
    adj = adj.reshape(B, num_pts, num_pts)
    adj = torch.maximum(adj, adj.transpose(1, 2))  # symmetric (undirected)

    keep = (~mask).float()
    adj = adj * keep[:, :, None] * keep[:, None, :]

    row_sum = adj.sum(dim=-1, keepdim=True)
    adj = torch.where(row_sum > 0,
                      adj / torch.where(row_sum > 0, row_sum, 1.0), 0.0)
    self_loops = torch.diag_embed(keep)
    return torch.stack([self_loops, adj], dim=1)


class GCNLayer(nn.Module):
    """Dual-channel graph convolution: a Dense to kernel_size * out
    features, then per-channel aggregation over the adjacency."""

    def __init__(self, in_features: int, out_features: int,
                 kernel_size: int = 2):
        super().__init__()
        self.out_features = out_features
        self.kernel_size = kernel_size
        self.linear = Dense(in_features, out_features * kernel_size)

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        """x: (B, N, C), adj: (B, K, N, N) -> (B, N, out_features)."""
        if adj.shape[1] != self.kernel_size:
            raise ValueError("adjacency channels != kernel_size")
        h = self.linear(x)
        B, N, _ = h.shape
        h = h.reshape(B, N, self.kernel_size, self.out_features)
        h = h.transpose(1, 2)  # (B, K, N, C_out)
        # out[w] = sum_k sum_v h[k, v] * adj[k, v, w]  (graph_utils.py:166)
        out = torch.einsum("bkvc,bkvw->bwc", h, adj.to(h.dtype))
        return F.relu(out)
