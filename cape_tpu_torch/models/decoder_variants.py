"""Experimental decoder-layer variants v2-v6: the port of
`cape_tpu.models.decoder_variants`.

- v2: deformable cross-attention BEFORE self-attention, no extra q/k/v
  pre-projections (`dtv2:814-878`).
- v3: self-attention + bidirectional cross-attention (`BiXAttnBlock`): the
  tokens and the encoder memory update each other; the last layer is
  one-sided (`dtv2:881-948`). The updated memory threads through the
  stack.
- v4: self-attention over [sampled src; tokens]: a learned offset head
  samples `n_heads*n_levels*n_points` projected memory values into a
  token prefix of self-attention's K/V (`dtv2:579-725`).
- v41: the same, with the content-based `MSDeformablePoints` sampler.
- v5: the same, prefix = per-level mean (`dtv2:373-475`).
- v6: the same, prefix = the last level's tokens (`dtv2:478-576`).

As in the JAX package (and the reference), none of them attends to the
support set, and they run teacher-forced only: `Decoder.precompute_static`
refuses them. The prefixes and v4's sampling are plain gathers (no
kernel); every MSDA cross-attention runs the port's MSDA path.

Parity notes: v4's sampling offsets are computed in fp32 and its
attention weights are softmaxed over the QUERY axis (`dtv2:667`), both as
in the JAX package; v41 uses the layout-fixed sampler.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .attention import MultiHeadAttention
from .bixattn import BiXAttnBlock, CAOneSidedBlock
from .deformable import MSDeformAttn, _offset_bias_init
from .deformable_points import MSDeformablePoints
from .layers import Dense, LayerNorm, dropout, xavier_uniform_, zeros_


def _grid_sample_zeros(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sample (B, H, W, C) at the normalized (x, y) grid (B, Q, 2)
    in [-1, 1] with `F.grid_sample`'s default semantics
    (align_corners=False, padding_mode='zeros'), as v4's
    `_sample_reference_points` uses it (`dtv2:681-682`)."""
    B, H, W, C = img.shape
    x = ((grid[..., 0] + 1.0) * W - 1.0) * 0.5
    y = ((grid[..., 1] + 1.0) * H - 1.0) * 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    flat = img.reshape(B, H * W, C)
    out = None
    for dy in (0.0, 1.0):
        for dx in (0.0, 1.0):
            xi, yi = x0 + dx, y0 + dy
            w = (1.0 - (x - xi).abs()) * (1.0 - (y - yi).abs())
            valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).long()
            v = torch.gather(flat, 1, idx[..., None].expand(-1, -1, C))
            term = v * torch.where(valid, w, 0.0)[..., None]
            out = term if out is None else out + term
    return out


def _split_levels(memory: torch.Tensor,
                  spatial_shapes: Sequence[Tuple[int, int]]):
    """(B, S, D) -> [(B, Hl*Wl, D)] per level."""
    outs, start = [], 0
    for h, w in spatial_shapes:
        outs.append(memory[:, start:start + h * w])
        start += h * w
    return outs


def _prefix_mask(causal_mask: torch.Tensor, n: int) -> torch.Tensor:
    """The causal mask with `n` always-attendable columns in front."""
    zeros = torch.zeros((causal_mask.shape[0], n), dtype=causal_mask.dtype,
                        device=causal_mask.device)
    return torch.cat([zeros, causal_mask], dim=1)


class _FFN(nn.Module):
    """Post-LN residual FFN shared by every variant (`dtv2:421-425`)."""

    def __init__(self, d_model: int, d_ffn: int, dropout: float):
        super().__init__()
        self.dropout = dropout
        self.linear1 = Dense(d_model, d_ffn)
        self.linear2 = Dense(d_ffn, d_model)
        self.norm3 = LayerNorm(d_model)

    def forward(self, x, generator=None):
        p = self.dropout
        y = dropout(F.relu(self.linear1(x)), p, generator)
        y = self.linear2(y)
        return self.norm3(x + dropout(y, p, generator))


class DecoderLayerV2(nn.Module):
    """Cross-attention-first layer (`dtv2:814-878`): MSDA cross-attention,
    then causal self-attention WITHOUT pre-projections (q = tgt +
    query_pos, k = v = tgt), then the FFN."""

    def __init__(self, d_model: int = 256, d_ffn: int = 1024,
                 dropout: float = 0.1, n_levels: int = 4, n_heads: int = 8,
                 n_points: int = 4, use_pallas: bool = False):
        super().__init__()
        self.dropout = dropout
        self.cross_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points,
                                       use_pallas=use_pallas)
        self.norm1 = LayerNorm(d_model)
        self.self_attn = MultiHeadAttention(d_model, n_heads, dropout)
        self.norm2 = LayerNorm(d_model)
        self.ffn = _FFN(d_model, d_ffn, dropout)

    def forward(self, tgt, query_pos, reference_points, memory,
                spatial_shapes, causal_mask,
                generator: Optional[torch.Generator] = None):
        p = self.dropout
        c2 = self.cross_attn(tgt + query_pos, reference_points,
                             self.cross_attn.project_value(memory),
                             spatial_shapes)
        tgt = self.norm1(tgt + dropout(c2, p, generator))
        k, v = self.self_attn.project_kv(tgt)
        t2 = self.self_attn.attend(tgt + query_pos, k, v,
                                   attn_mask=causal_mask, generator=generator)
        tgt = self.norm2(tgt + dropout(t2, p, generator))
        return self.ffn(tgt, generator)


class DecoderLayerV3(nn.Module):
    """Bidirectional cross-attention layer (`dtv2:881-948`): causal
    self-attention (no pre-projections), then a `BiXAttnBlock` that updates
    both tokens and memory (`CAOneSidedBlock` on the last layer; both with
    ReLU, `dtv2:894-900`), then the FFN. Returns (tgt, memory). The BiX
    block's residual runs on tgt + query_pos, baking the query PE into the
    stream, as in the reference (`dtv2:943`)."""

    def __init__(self, d_model: int = 256, d_ffn: int = 1024,
                 dropout: float = 0.1, n_heads: int = 8,
                 is_last: bool = False):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiHeadAttention(d_model, n_heads, dropout)
        self.norm2 = LayerNorm(d_model)
        block = CAOneSidedBlock if is_last else BiXAttnBlock
        self.cross_attn = block(d_model, n_heads, mlp_ratio=4.0, act="relu")
        self.ffn = _FFN(d_model, d_ffn, dropout)

    def forward(self, tgt, query_pos, reference_points, memory,
                spatial_shapes, causal_mask,
                generator: Optional[torch.Generator] = None):
        k, v = self.self_attn.project_kv(tgt)
        t2 = self.self_attn.attend(tgt + query_pos, k, v,
                                   attn_mask=causal_mask, generator=generator)
        tgt = self.norm2(tgt + dropout(t2, self.dropout, generator))
        tgt, memory_out = self.cross_attn(tgt + query_pos, memory)
        return self.ffn(tgt, generator), memory_out


class DecoderLayerVC(nn.Module):
    """Concat-src layer family v4/v41/v5/v6 (`dtv2:373-811`): causal
    self-attention over [src-derived prefix; tokens], MSDA cross-attention,
    FFN. The variants differ only in the prefix:

    - 'v4': learned offset sampling of the projected memory
      (`_sample_reference_points`, `dtv2:661-687`), n_levels*n_points
      tokens;
    - 'v41': `MSDeformablePoints` content-based sampling (`dtv2:790`);
    - 'v5': per-level mean, n_levels tokens (`dtv2:441-448`);
    - 'v6': the last level's tokens (`dtv2:547-551`).

    With `attn_concat_src=False` every variant is v1 without support, as
    in the reference; `use_qkv_proj` adds the bias-free q/k/v
    pre-projections."""

    def __init__(self, variant: str = "v5", d_model: int = 256,
                 d_ffn: int = 1024, dropout: float = 0.1, n_levels: int = 4,
                 n_heads: int = 8, n_points: int = 4,
                 attn_concat_src: bool = True, use_qkv_proj: bool = False,
                 use_pallas: bool = False):
        super().__init__()
        if variant not in ("v4", "v41", "v5", "v6"):
            raise ValueError(f"unknown concat-src variant {variant!r}")
        self.variant, self.attn_concat_src = variant, attn_concat_src
        self.d_model, self.n_levels = d_model, n_levels
        self.n_heads, self.n_points = n_heads, n_points
        self.dropout = dropout
        self.use_qkv_proj = use_qkv_proj
        if use_qkv_proj:
            self.attn_q = Dense(d_model, d_model, bias=False)
            self.attn_k = Dense(d_model, d_model, bias=False)
            self.attn_v = Dense(d_model, d_model, bias=False)
        self.self_attn = MultiHeadAttention(d_model, n_heads, dropout)
        self.norm2 = LayerNorm(d_model)
        if attn_concat_src and variant == "v4":
            hlp = n_heads * n_levels * n_points
            self.sampling_offsets = Dense(d_model, hlp * 2)  # kept in fp32
            self.attention_weights = Dense(d_model, hlp)
            self.source_proj = Dense(d_model, d_model)
        if attn_concat_src and variant == "v41":
            self.point_sampler = MSDeformablePoints(d_model, n_levels, n_heads)
        self.cross_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points,
                                       use_pallas=use_pallas)
        self.norm1 = LayerNorm(d_model)
        self.ffn = _FFN(d_model, d_ffn, dropout)

    def init_weights(self, g: torch.Generator) -> None:
        if hasattr(self, "sampling_offsets"):
            zeros_(self.sampling_offsets.weight)
            with torch.no_grad():
                self.sampling_offsets.bias.copy_(torch.from_numpy(
                    _offset_bias_init(self.n_heads, self.n_levels,
                                      self.n_points)))
            zeros_(self.attention_weights.weight)
            zeros_(self.attention_weights.bias)
            xavier_uniform_(self.source_proj.weight, g)

    # ------------------------------------------------------------------
    def _sample_src_v4(self, query, memory, spatial_shapes):
        """`_sample_reference_points` (`dtv2:661-687`): offsets normalized
        per level by (W, H) with NO reference-point base; weights softmaxed
        over the query axis; one token per (level, point)."""
        B, Lq, _ = query.shape
        h, l, p = self.n_heads, self.n_levels, self.n_points
        dh = self.d_model // h
        offsets = self.sampling_offsets(query.float()).reshape(
            B, Lq, h, l, p, 2)
        normalizer = torch.tensor([[w_, h_] for h_, w_ in spatial_shapes],
                                  dtype=torch.float32, device=query.device)
        loc = offsets / normalizer[None, None, None, :, None, :]
        attn = self.attention_weights(query).reshape(B, Lq, h, l * p)
        attn = torch.softmax(attn.float(), dim=1)          # over queries!
        attn = attn.reshape(B, Lq, h, l, p)
        levels = _split_levels(self.source_proj(memory), spatial_shapes)
        per_level = []
        for lid, (hl, wl) in enumerate(spatial_shapes):
            vl = levels[lid].reshape(B, hl * wl, h, dh)
            vl = vl.transpose(1, 2).reshape(B * h, hl, wl, dh)
            grid = 2.0 * loc[:, :, :, lid] - 1.0            # (B, Lq, h, p, 2)
            grid = grid.transpose(1, 2).reshape(B * h, Lq * p, 2)
            samp = _grid_sample_zeros(vl, grid).reshape(B, h, Lq, p, dh)
            w = attn[:, :, :, lid].transpose(1, 2)          # (B, h, Lq, p)
            per_level.append((samp * w[..., None].to(samp.dtype)).sum(dim=2))
        out = torch.stack(per_level, dim=2)                 # (B, h, l, p, dh)
        # (B, h, l, p, dh) -> (B, l*p, h*dh)  (`dtv2:686-687`)
        return out.permute(0, 2, 3, 1, 4).reshape(B, l * p, self.d_model)

    def _prefix(self, tgt, memory, spatial_shapes):
        if self.variant == "v4":
            return self._sample_src_v4(tgt, memory, spatial_shapes)
        if self.variant == "v41":
            return self.point_sampler(memory, spatial_shapes)
        levels = _split_levels(memory, spatial_shapes)
        if self.variant == "v5":
            return torch.stack([lv.mean(dim=1) for lv in levels], dim=1)
        return levels[-1]                                   # v6

    # ------------------------------------------------------------------
    def forward(self, tgt, query_pos, reference_points, memory,
                spatial_shapes, causal_mask,
                generator: Optional[torch.Generator] = None):
        p = self.dropout
        if self.use_qkv_proj:
            q_in = self.attn_q(tgt) + query_pos
            k_in, v_in = self.attn_k(tgt), self.attn_v(tgt)
        else:
            q_in = tgt + query_pos
            k_in = v_in = tgt
        mask = causal_mask
        if self.attn_concat_src:
            prefix = self._prefix(tgt, memory, spatial_shapes)
            k_in = torch.cat([prefix, k_in], dim=1)
            v_in = torch.cat([prefix, v_in], dim=1)
            # prefix columns always attendable (`dtv2:451-452`)
            mask = _prefix_mask(causal_mask, prefix.shape[1])
        k, v = self.self_attn.project_kv_pre(k_in, v_in)
        t2 = self.self_attn.attend(q_in, k, v, attn_mask=mask,
                                   generator=generator)
        tgt = self.norm2(tgt + dropout(t2, p, generator))
        c2 = self.cross_attn(tgt + query_pos, reference_points,
                             self.cross_attn.project_value(memory),
                             spatial_shapes)
        tgt = self.norm1(tgt + dropout(c2, p, generator))
        return self.ffn(tgt, generator)
