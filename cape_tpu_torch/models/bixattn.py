"""Bidirectional cross-attention (BiXAttn) blocks: the port of
`cape_tpu.models.bixattn`.

One shared QK logit matrix, in fp32, is softmaxed along both axes, so
modality x attends to y and y attends to x with a single matmul. In the
reference this powers decoder variant v3, an experimental path that is
not CAPE-complete (no support conditioning). The blocks carry no dropout,
as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .attention import NEG_INF, MultiHeadAttention
from .layers import Dense, LayerNorm


def _activation(name: str):
    """Mlp activation by name. 'gelu' is exact (erf), torch `nn.GELU`'s
    default, which the reference's timm `Mlp` blocks use."""
    if name == "gelu":
        return F.gelu
    if name == "relu":
        return F.relu
    raise ValueError(f"unsupported activation {name!r}")


class BiXAttn(nn.Module):
    """Shared-logit bidirectional cross-attention (`bixattn.py:32-84`)."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.q_x = Dense(dim, dim, bias=qkv_bias)
        self.v_x = Dense(dim, dim, bias=qkv_bias)
        self.k_y = Dense(dim, dim, bias=qkv_bias)
        self.v_y = Dense(dim, dim, bias=qkv_bias)
        self.proj_x = Dense(dim, dim)
        self.proj_y = Dense(dim, dim)

    def _split(self, z: torch.Tensor) -> torch.Tensor:
        b, l, _ = z.shape
        h = self.num_heads
        return z.reshape(b, l, h, self.dim // h).transpose(1, 2)

    def _merge(self, z: torch.Tensor) -> torch.Tensor:
        b, _, l, _ = z.shape
        return z.transpose(1, 2).reshape(b, l, self.dim)

    def forward(self, x: torch.Tensor, y: torch.Tensor,
                x_mask: Optional[torch.Tensor] = None,
                y_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, N, D), y: (B, M, D); masks (B, N) / (B, M), True =
        ignore. Returns the updates of x and of y."""
        dh = self.dim // self.num_heads
        qx, vx = self._split(self.q_x(x)), self._split(self.v_x(x))
        ky, vy = self._split(self.k_y(y)), self._split(self.v_y(y))

        logits = torch.matmul(qx, ky.transpose(-1, -2)).float() * (dh ** -0.5)
        if y_mask is not None:
            logits = logits.masked_fill(y_mask[:, None, None, :], NEG_INF)
        attn_x2y = torch.softmax(logits, dim=-1)         # x attends over y
        logits_t = logits
        if x_mask is not None:
            logits_t = logits_t.masked_fill(x_mask[:, None, :, None], NEG_INF)
        attn_y2x = torch.softmax(logits_t, dim=-2)       # y attends over x

        out_x = torch.matmul(attn_x2y.to(vy.dtype), vy)
        out_y = torch.matmul(attn_y2x.to(vx.dtype).transpose(-1, -2), vx)
        return self.proj_x(self._merge(out_x)), self.proj_y(self._merge(out_y))


class BiXAttnBlock(nn.Module):
    """Pre-LN bidirectional block with per-modality MLPs
    (`bixattn.py:85-180`)."""

    def __init__(self, dim: int, num_heads: int = 8, mlp_ratio: float = 4.0,
                 act: str = "gelu"):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.act = _activation(act)
        self.norm_x = LayerNorm(dim)
        self.norm_y = LayerNorm(dim)
        self.attn = BiXAttn(dim, num_heads)
        self.mlp_x_norm = LayerNorm(dim)
        self.mlp_x_fc1 = Dense(dim, hidden)
        self.mlp_x_fc2 = Dense(hidden, dim)
        self.mlp_y_norm = LayerNorm(dim)
        self.mlp_y_fc1 = Dense(dim, hidden)
        self.mlp_y_fc2 = Dense(hidden, dim)

    def forward(self, x, y, x_mask=None, y_mask=None):
        dx, dy = self.attn(self.norm_x(x), self.norm_y(y), x_mask, y_mask)
        x = x + dx
        y = y + dy
        x = x + self.mlp_x_fc2(self.act(self.mlp_x_fc1(self.mlp_x_norm(x))))
        y = y + self.mlp_y_fc2(self.act(self.mlp_y_fc1(self.mlp_y_norm(y))))
        return x, y


class CAOneSidedBlock(nn.Module):
    """One-sided cross-attention block (last-layer variant,
    `bixattn.py:181-235`): x attends to y; y passes through. Its names
    are `BiXAttnBlock`'s x side."""

    def __init__(self, dim: int, num_heads: int = 8, mlp_ratio: float = 4.0,
                 act: str = "gelu"):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.act = _activation(act)
        self.norm_x = LayerNorm(dim)
        self.norm_y = LayerNorm(dim)
        self.attn = MultiHeadAttention(dim, num_heads)
        self.mlp_x_norm = LayerNorm(dim)
        self.mlp_x_fc1 = Dense(dim, hidden)
        self.mlp_x_fc2 = Dense(hidden, dim)

    def forward(self, x, y, x_mask=None, y_mask=None):
        x = x + self.attn(self.norm_x(x), self.norm_y(y),
                          key_padding_mask=y_mask)
        x = x + self.mlp_x_fc2(self.act(self.mlp_x_fc1(self.mlp_x_norm(x))))
        return x, y
