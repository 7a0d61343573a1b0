"""MSDeformablePoints, learned content-based sampling of encoder memory:
the port of `cape_tpu.models.deformable_points` (the sampler behind the
experimental decoder variant v41).

Per feature level, a grouped conv head predicts a coarse grid of 2D
offsets from the 1x1-projected features; the features are then sampled
bilinearly at `reference + offset` per attention head, and the per-level
sample grids are concatenated into a compact token set.

The layout is the JAX package's: channels-last end to end (each conv
permutes to NCHW and back), and the value tensor is split per head
properly. The reference grid-samples a raw reshape of its channels-last
memory, which scrambles the values; the JAX package fixes that and so
does the port. The sample is `align_corners=True` bilinear with clamped
corners, a plain gather (`_bilinear_sample`).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv2d, LayerNorm


def _bilinear_sample(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Sample (B, H, W, C) at the normalized grid (B, Hk, Wk, 2) in
    [-1, 1] ((x, y) order) with `align_corners=True` semantics and corners
    clamped into the image; computed in the grid's dtype."""
    B, H, W, C = img.shape
    x = (grid[..., 0] + 1.0) * 0.5 * (W - 1)
    y = (grid[..., 1] + 1.0) * 0.5 * (H - 1)
    x0 = torch.floor(x).clamp(0, W - 1)
    y0 = torch.floor(y).clamp(0, H - 1)
    x1 = (x0 + 1).clamp(0, W - 1)
    y1 = (y0 + 1).clamp(0, H - 1)
    fx = (x - x0).clamp(0.0, 1.0)[..., None]
    fy = (y - y0).clamp(0.0, 1.0)[..., None]
    x0i, x1i, y0i, y1i = (t.long() for t in (x0, x1, y0, y1))
    flat = img.reshape(B, H * W, C)

    def take(yy, xx):
        idx = (yy * W + xx).reshape(B, -1, 1).expand(-1, -1, C)
        return torch.gather(flat, 1, idx).reshape(*yy.shape, C)

    top = take(y0i, x0i) * (1 - fx) + take(y0i, x1i) * fx
    bot = take(y1i, x0i) * (1 - fx) + take(y1i, x1i) * fx
    return top * (1 - fy) + bot * fy


def _nchw(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A conv on a channels-last (N, H, W, C) tensor."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class MSDeformablePoints(nn.Module):
    """Per-level learned sampling grids (reference
    `deformable_points.py:31-130`)."""

    def __init__(self, embed_dim: int, n_levels: int, n_heads: int):
        super().__init__()
        self.embed_dim, self.n_levels, self.n_heads = embed_dim, n_levels, n_heads
        hc = embed_dim // n_heads
        ks = [(n_levels - 1 - i) * 2 + 1 for i in range(n_levels)]
        st = [2 ** (n_levels - i) for i in range(n_levels)]
        groups = n_heads if hc % n_heads == 0 else 1
        self.proj_q = nn.ModuleList(
            [Conv2d(embed_dim, embed_dim, 1) for _ in range(n_levels)])
        # grouped offset conv: heads are the group dim; conv + LN + GELU +
        # 1x1 -> 2 offset channels per head-position
        self.conv_offset_a = nn.ModuleList(
            [Conv2d(hc, hc, k, stride=s, padding=k // 2, groups=groups)
             for k, s in zip(ks, st)])
        self.offset_norm = nn.ModuleList(
            [LayerNorm(hc) for _ in range(n_levels)])
        self.conv_offset_b = nn.ModuleList(
            [Conv2d(hc, 2, 1, bias=False) for _ in range(n_levels)])

    @staticmethod
    def _ref_points(hk: int, wk: int, device) -> torch.Tensor:
        """(Hk, Wk, 2) normalized (y, x) reference grid in [-1, 1]
        (reference `_get_ref_points`)."""
        ys = torch.linspace(0.5, hk - 0.5, hk, device=device) / hk * 2.0 - 1.0
        xs = torch.linspace(0.5, wk - 0.5, wk, device=device) / wk * 2.0 - 1.0
        ry, rx = torch.meshgrid(ys, xs, indexing="ij")
        return torch.stack([ry, rx], dim=-1)

    def forward(self, x: torch.Tensor,
                spatial_shapes: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """x: (B, sum(Hl*Wl), C) flattened multi-level features ->
        (B, sum(Hk*Wk), C) sampled tokens."""
        B, _, C = x.shape
        g = self.n_heads
        hc = self.embed_dim // g
        outs, start = [], 0
        for i, (H, W) in enumerate(spatial_shapes):
            cur = x[:, start:start + H * W].reshape(B, H, W, C)
            start += H * W
            q = _nchw(self.proj_q[i], cur)                   # (B, H, W, C)
            # (B*g, H, W, hc): per-head offset prediction
            qg = q.reshape(B, H, W, g, hc).movedim(3, 1).reshape(
                B * g, H, W, hc)
            o = _nchw(self.conv_offset_a[i], qg)
            o = F.gelu(self.offset_norm[i](o))
            offset = _nchw(self.conv_offset_b[i], o)         # (B*g, Hk, Wk, 2)
            hk, wk = offset.shape[1], offset.shape[2]
            ref = self._ref_points(hk, wk, offset.device).to(offset.dtype)
            pos = (offset + ref[None]).clamp(-1.0, 1.0)      # (y, x)
            vg = cur.reshape(B, H, W, g, hc).movedim(3, 1).reshape(
                B * g, H, W, hc)
            # the sample wants (x, y)
            samp = _bilinear_sample(vg, pos.flip(-1))        # (B*g, hk, wk, hc)
            samp = samp.reshape(B, g, hk * wk, hc).movedim(1, 2)
            outs.append(samp.reshape(B, hk * wk, C))
        return torch.cat(outs, dim=1)
