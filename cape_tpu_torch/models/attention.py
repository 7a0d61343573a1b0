"""Multi-head attention with split projections and precomputable K/V: the
port of `cape_tpu.models.attention`.

Projections are exposed separately (`project_kv`, `project_kv_pre`,
`attend`) so decoding projects static keys/values (support features) once.
Masking adds the FINITE `NEG_INF = -1e9`, as the JAX package does: a row
whose keys are all masked gets uniform weights instead of NaN, which the
support encoder's all-masked guard relies on. So the logits and softmax
are written out in fp32 here, not left to `scaled_dot_product_attention`.
Dropout acts on the attention weights when a generator is passed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from .layers import Dense, dropout

NEG_INF = -1e9  # large-negative mask value (finite: avoids NaN on all-masked rows)


class MultiHeadAttention(nn.Module):
    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        if d_model % num_heads:
            raise ValueError("d_model must be divisible by num_heads")
        self.d_model = d_model
        self.num_heads = num_heads
        self.dropout = dropout
        self.q_proj = Dense(d_model, d_model)
        self.k_proj = Dense(d_model, d_model)
        self.v_proj = Dense(d_model, d_model)
        self.out_proj = Dense(d_model, d_model)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, l, _ = x.shape
        h = self.num_heads
        return x.reshape(b, l, h, self.d_model // h).transpose(1, 2)

    def project_kv(self, kv_in: torch.Tensor) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
        """Project keys/values once; reuse across decode steps."""
        return self._split(self.k_proj(kv_in)), self._split(self.v_proj(kv_in))

    def project_kv_pre(self, k_in: torch.Tensor, v_in: torch.Tensor):
        """Like `project_kv` but with distinct key/value inputs."""
        return self._split(self.k_proj(k_in)), self._split(self.v_proj(v_in))

    def attend(
        self,
        q_in: torch.Tensor,
        k: torch.Tensor,
        v: torch.Tensor,
        attn_mask: Optional[torch.Tensor] = None,
        key_padding_mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Attention with pre-projected K/V.

        Args:
            q_in: (B, Lq, D) query inputs (projected here).
            k, v: (B, H, Lk, Dh) pre-projected keys/values.
            attn_mask: additive (Lq, Lk) or (B, Lq, Lk) float mask, or a
                boolean mask where True = MASKED (torch convention).
            key_padding_mask: (B, Lk) boolean, True = ignore key.
            generator: dropout masks on the weights; None = deterministic.
        """
        b, lq, _ = q_in.shape
        dh = self.d_model // self.num_heads
        q = self._split(self.q_proj(q_in)) * (dh ** -0.5)
        logits = torch.matmul(q, k.transpose(-1, -2)).float()

        if attn_mask is not None:
            if attn_mask.dtype == torch.bool:
                add = torch.where(attn_mask, NEG_INF, 0.0)
            else:
                add = attn_mask
            if add.dim() == 2:
                add = add[None, None]
            elif add.dim() == 3:
                add = add[:, None]
            logits = logits + add.float()
        if key_padding_mask is not None:
            logits = logits.masked_fill(key_padding_mask[:, None, None, :],
                                        NEG_INF)

        weights = torch.softmax(logits, dim=-1).to(v.dtype)
        weights = dropout(weights, self.dropout, generator)
        out = torch.matmul(weights, v)
        out = out.transpose(1, 2).reshape(b, lq, self.d_model)
        return self.out_proj(out)

    def forward(self, q_in, kv_in, attn_mask=None, key_padding_mask=None,
                generator=None):
        k, v = self.project_kv(kv_in)
        return self.attend(q_in, k, v, attn_mask, key_padding_mask, generator)
