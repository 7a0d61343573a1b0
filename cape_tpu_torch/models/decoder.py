"""Causal token decoder with support cross-attention and deformable image
cross-attention, plus iterative coordinate refinement: the port of the v1
decode path of `cape_tpu.models.decoder`.

Per layer (`deformable_transformer_v2.py:320-370`): pre-projections
attn_q/k/v (no bias) -> causal self-attention over a KV cache (+query_pos
on q only) -> support cross-attention with key-padding mask -> deformable
cross-attention at the refined reference point (+query_pos) against the
layer's precomputed quad slab -> FFN; post-LN residuals throughout.
Refinement: ref = sigmoid(offset + inv_sigmoid(ref)) per layer, anchors =
sigmoid(learned query_embed), both in fp32.

Two paths share one parameter set: `forward_train`, the teacher-forced
full sequence under an additive causal mask (training, with dropout when a
generator is passed), and `forward_step`, one token against the KV caches
(serving). On the card a flagship layer's step is one hand-written kernel
(`ops.decode_step.layer_step`), wherever `ops.decode_step.refusal` finds
nothing against it; every other step runs the chain of modules
(`ops.decode_step.layer_step_plain`); `ops.msda`'s route table says which
runs under each MSDA selection.

`Decoder(layer_type=...)` also builds the experimental layers v2-v6 of
`decoder_variants.py`, and the v1 options `attn_concat_src` (the raw
encoder memory prepended to self-attention's K/V) and `qkv_proj=False`
(identity pre-projections). v2-v6 and `attn_concat_src` run
teacher-forced only: the decode refuses them with the JAX package's
`ValueError`.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import decode_step
from ..ops import msda as ops_msda
from .attention import MultiHeadAttention
from .decoder_variants import (DecoderLayerV2, DecoderLayerV3,
                               DecoderLayerVC, _prefix_mask)
from .deformable import MSDeformAttn
from .layers import Dense, LayerNorm, dropout, normal_, zeros_
from .position_encoding import query_sine_embed

#: decoder-layer variants (`deformable_transformer_v2.py:76-115` dispatch).
#: v1 is the flagship CAPE layer; v2-v6 are the reference's experimental,
#: support-free layers (see `decoder_variants.py`).
LAYER_TYPES = ("v1", "v2", "v3", "v4", "v41", "v5", "v6")


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Parity with `util/misc.py:436-440`."""
    x = x.clamp(0.0, 1.0)
    x1 = x.clamp(min=eps)
    x2 = (1.0 - x).clamp(min=eps)
    return torch.log(x1 / x2)


class MLPHead(nn.Module):
    """3-layer MLP coords head with a zero-init final layer."""

    def __init__(self, hidden_dim: int, out_dim: int):
        super().__init__()
        self.layers = nn.ModuleList([Dense(hidden_dim, hidden_dim),
                                     Dense(hidden_dim, hidden_dim),
                                     Dense(hidden_dim, out_dim)])

    def init_weights(self, g: torch.Generator) -> None:
        zeros_(self.layers[2].weight)
        zeros_(self.layers[2].bias)

    def forward(self, x):
        x = F.relu(self.layers[0](x))
        x = F.relu(self.layers[1](x))
        return self.layers[2](x)


class LayerCache(NamedTuple):
    """Self-attention KV cache of one decoder layer, updated in place."""

    k: torch.Tensor  # (B, H, L, Dh)
    v: torch.Tensor  # (B, H, L, Dh)


class DecoderLayer(nn.Module):
    def __init__(self, d_model: int = 256, d_ffn: int = 1024,
                 dropout: float = 0.1, n_levels: int = 4, n_heads: int = 8,
                 n_points: int = 4, use_pallas: bool = False,
                 qkv_proj: bool = True, concat_src: bool = False):
        super().__init__()
        self.dropout = dropout
        # q/k/v pre-projections before self-attention; identities without
        # parameters when disabled, as the reference builds them
        # (`dtv2:276-282`)
        def proj():
            return (Dense(d_model, d_model, bias=False) if qkv_proj
                    else nn.Identity())

        self.attn_q, self.attn_k, self.attn_v = proj(), proj(), proj()
        # prepend the raw encoder memory to self-attention's K/V
        # (`--dec_attn_concat_src`, `dtv2:333-337`); teacher-forced only
        self.concat_src = concat_src
        self.self_attn = MultiHeadAttention(d_model, n_heads, dropout)
        self.norm2 = LayerNorm(d_model)
        self.support_attn = MultiHeadAttention(d_model, n_heads, dropout)
        self.norm_support = LayerNorm(d_model)
        self.cross_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points,
                                       use_pallas=use_pallas)
        self.norm1 = LayerNorm(d_model)
        self.linear1 = Dense(d_model, d_ffn)
        self.linear2 = Dense(d_ffn, d_model)
        self.norm3 = LayerNorm(d_model)

    # -- static-input projections (decode-time caching) ----------------
    def support_kv(self, support_features):
        return self.support_attn.project_kv(support_features)

    def memory_value(self, memory):
        return self.cross_attn.project_value(memory)

    def memory_quads(self, memory, spatial_shapes):
        return self.cross_attn.project_value_quads(memory, spatial_shapes)

    def _ffn(self, x, generator):
        y = dropout(F.relu(self.linear1(x)), self.dropout, generator)
        y = self.linear2(y)
        return self.norm3(x + dropout(y, self.dropout, generator))

    def _post_self(self, tgt, memory_value, spatial_shapes, query_pos,
                   reference_points, support_k, support_v, support_mask,
                   generator=None, prequad=False):
        """Support cross-attn + deformable cross-attn + FFN (shared).

        prequad=True: `memory_value` is the (B*H, S', 4*Dh) quad slab of
        the KV-cached decode step; else the (B, S, H, Dh) projected value
        of the teacher-forced sequence."""
        p = self.dropout
        s2 = self.support_attn.attend(tgt, support_k, support_v,
                                      key_padding_mask=support_mask,
                                      generator=generator)
        tgt = self.norm_support(tgt + dropout(s2, p, generator))
        if prequad:
            c2 = self.cross_attn.step_call(tgt + query_pos, reference_points,
                                           memory_value, spatial_shapes)
        else:
            c2 = self.cross_attn(tgt + query_pos, reference_points,
                                 memory_value, spatial_shapes)
        tgt = self.norm1(tgt + dropout(c2, p, generator))
        return self._ffn(tgt, generator)

    def forward_train(
        self,
        tgt: torch.Tensor,                 # (B, L, D)
        query_pos: torch.Tensor,           # (B, L, D)
        reference_points: torch.Tensor,    # (B, L, n_levels, 2)
        memory: torch.Tensor,              # (B, S, D)
        spatial_shapes: Sequence[Tuple[int, int]],
        causal_mask: torch.Tensor,         # (L, L) additive float
        support_features: torch.Tensor,    # (B, N, D)
        support_mask: torch.Tensor,        # (B, N) True = ignore
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """The full teacher-forced sequence under the causal mask."""
        q = self.attn_q(tgt) + query_pos
        k_in, v_in = self.attn_k(tgt), self.attn_v(tgt)
        if self.concat_src:
            # the RAW memory goes in before the attention's own input
            # projections (`dtv2:333-337`); the prefix is always attendable
            k_in = torch.cat([memory, k_in], dim=1)
            v_in = torch.cat([memory, v_in], dim=1)
            causal_mask = _prefix_mask(causal_mask, memory.shape[1])
        k, v = self.self_attn.project_kv_pre(k_in, v_in)
        t2 = self.self_attn.attend(q, k, v, attn_mask=causal_mask,
                                   generator=generator)
        tgt = self.norm2(tgt + dropout(t2, self.dropout, generator))
        sk, sv = self.support_kv(support_features)
        return self._post_self(
            tgt, self.memory_value(memory), spatial_shapes, query_pos,
            reference_points, sk, sv, support_mask, generator)

    def forward_step(
        self,
        tgt_t: torch.Tensor,               # (B, 1, D)
        query_pos_t: torch.Tensor,         # (B, 1, D)
        reference_points_t: torch.Tensor,  # (B, 1, n_levels, 2)
        memory_value: torch.Tensor,        # (B*H, S', 4*Dh) quad slab, or
        #                                    (B, S, H, Dh) plain value
        #                                    (CAPE_DECODE_PREQUAD=0)
        spatial_shapes: Sequence[Tuple[int, int]],
        cache: LayerCache,
        pos_index: torch.Tensor,
        support_k: torch.Tensor,
        support_v: torch.Tensor,
        support_mask: torch.Tensor,
    ) -> Tuple[torch.Tensor, LayerCache]:
        """One token against the KV cache. The cache is written in place at
        `pos_index`, a 0-d int64 tensor on the device (the JAX package
        returns an updated copy), so that no host value enters the step."""
        q = self.attn_q(tgt_t) + query_pos_t
        k_t, v_t = self.self_attn.project_kv_pre(
            self.attn_k(tgt_t), self.attn_v(tgt_t))      # (B, H, 1, Dh)
        at = pos_index.reshape(1)
        cache.k.index_copy_(2, at, k_t)
        cache.v.index_copy_(2, at, v_t)
        # mask future (unwritten) cache slots
        L = cache.k.shape[2]
        future = torch.arange(L, device=q.device)[None, :] > pos_index
        t2 = self.self_attn.attend(q, cache.k, cache.v,
                                   attn_mask=future[None])
        tgt = self.norm2(tgt_t + t2)
        out = self._post_self(tgt, memory_value, spatial_shapes, query_pos_t,
                              reference_points_t, support_k, support_v,
                              support_mask, prequad=memory_value.ndim == 3)
        return out, cache


class Decoder(nn.Module):
    """Token embedding + N decoder layers + per-layer refinement heads."""

    def __init__(self, num_layers: int = 6, d_model: int = 256,
                 d_ffn: int = 1024, dropout: float = 0.1, n_levels: int = 4,
                 n_heads: int = 8, n_points: int = 4, vocab_size: int = 1940,
                 seq_len: int = 200, num_classes: int = 3,
                 pad_id: int = 1939, use_pallas: bool = False,
                 layer_type: str = "v1", attn_concat_src: bool = False,
                 qkv_proj: bool = True, query_pos_type: str = "sine",
                 poly_refine: bool = True):
        super().__init__()
        if query_pos_type not in ("sine", "none"):
            raise ValueError(
                f"query_pos_type={query_pos_type!r}: the reference decoder "
                "supports 'sine' and 'none' only")
        if layer_type not in LAYER_TYPES:
            raise ValueError(f"layer_type={layer_type!r}: expected one of "
                             f"{LAYER_TYPES} (dtv2:76-115)")
        self.layer_type, self.attn_concat_src = layer_type, attn_concat_src
        self.num_layers, self.d_model = num_layers, d_model
        self.n_levels, self.n_heads = n_levels, n_heads
        self.pad_id = pad_id
        self.query_pos_type = query_pos_type
        self.poly_refine = poly_refine
        # no padding_idx: the JAX package trains the pad row, it is only
        # zero at initialisation
        self.token_embed = nn.Embedding(vocab_size, d_model)
        # learned coordinate anchors, kept in fp32
        self.query_embed = nn.Parameter(torch.zeros(seq_len, 2))
        if query_pos_type == "sine":
            self.pos_trans = Dense(d_model, d_model)
            self.pos_trans_norm = LayerNorm(d_model)
        # the reference builder drops the pre-projections whenever a prefix
        # is prepended (`dtv2:80`)
        use_qkv = qkv_proj and not attn_concat_src
        attn = (d_model, d_ffn, dropout, n_levels, n_heads, n_points)
        if layer_type == "v1":
            layers = [DecoderLayer(*attn, use_pallas=use_pallas,
                                   qkv_proj=use_qkv,
                                   concat_src=attn_concat_src)
                      for _ in range(num_layers)]
        elif layer_type == "v2":
            layers = [DecoderLayerV2(*attn, use_pallas=use_pallas)
                      for _ in range(num_layers)]
        elif layer_type == "v3":
            layers = [DecoderLayerV3(d_model, d_ffn, dropout, n_heads,
                                     is_last=(i == num_layers - 1))
                      for i in range(num_layers)]
        else:
            layers = [DecoderLayerVC(layer_type, *attn,
                                     attn_concat_src=attn_concat_src,
                                     use_qkv_proj=use_qkv,
                                     use_pallas=use_pallas)
                      for _ in range(num_layers)]
        self.layers = nn.ModuleList(layers)
        self.class_heads = nn.ModuleList(
            [Dense(d_model, num_classes) for _ in range(num_layers)])
        # without poly_refine only the last layer's head exists (the JAX
        # package creates a head's parameters only where it is applied)
        self.coords_heads = nn.ModuleDict(
            {str(i): MLPHead(d_model, 2) for i in range(num_layers)
             if poly_refine or i == num_layers - 1})

    def init_weights(self, g: torch.Generator) -> None:
        normal_(self.token_embed.weight, self.d_model ** -0.5, g)
        zeros_(self.token_embed.weight[self.pad_id])
        normal_(self.query_embed, 1.0, g)
        bias = -math.log((1 - 0.01) / 0.01)
        for head in self.class_heads:
            with torch.no_grad():
                head.bias.fill_(bias)

    @property
    def dtype(self) -> torch.dtype:
        return self.token_embed.weight.dtype

    # ------------------------------------------------------------------
    def seq_embed(self, seq11, seq12, seq21, seq22,
                  delta_x1, delta_x2, delta_y1, delta_y2) -> torch.Tensor:
        """Bilinear 4-corner token embedding (`dtv2:984-997`); fp32 deltas
        promote the result to fp32, as in the JAX package."""
        e11 = self.token_embed(seq11)
        e21 = self.token_embed(seq21)
        e12 = self.token_embed(seq12)
        e22 = self.token_embed(seq22)
        return (e11 * (delta_x2 * delta_y2)[..., None]
                + e21 * (delta_x1 * delta_y2)[..., None]
                + e12 * (delta_x2 * delta_y1)[..., None]
                + e22 * (delta_x1 * delta_y1)[..., None])

    def anchors(self) -> torch.Tensor:
        return torch.sigmoid(self.query_embed.float())

    def _query_pos(self, ref: torch.Tensor) -> torch.Tensor:
        if self.query_pos_type == "none":
            return torch.zeros(ref.shape[:-1] + (self.d_model,),
                               dtype=self.dtype, device=ref.device)
        pe = query_sine_embed(ref, self.d_model // 2).to(self.dtype)
        return self.pos_trans_norm(self.pos_trans(pe))

    def _refine(self, lid: int, x: torch.Tensor,
                ref: torch.Tensor) -> torch.Tensor:
        """Layer-lid coordinate refinement of the reference point (fp32).

        poly_refine: every layer refines. Otherwise only the final layer
        applies its offset to the anchor (use_anchor branch).
        """
        if not self.poly_refine and lid != self.num_layers - 1:
            return ref
        offset = self.coords_heads[str(lid)](x).float()
        return torch.sigmoid(offset + inverse_sigmoid(ref))

    # ------------------------------------------------------------------
    def forward_train(
        self,
        seq_kwargs: Dict[str, torch.Tensor],
        memory: torch.Tensor,
        spatial_shapes,
        support_features: torch.Tensor,
        support_mask: torch.Tensor,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced full-sequence decode.

        Returns:
            classes: (num_layers, B, L, num_classes)
            refs:    (num_layers, B, L, 2), fp32
        """
        ids = [seq_kwargs[k].long()
               for k in ("seq11", "seq12", "seq21", "seq22")]
        x = self.seq_embed(*ids, seq_kwargs["delta_x1"],
                           seq_kwargs["delta_x2"], seq_kwargs["delta_y1"],
                           seq_kwargs["delta_y2"])
        B, L, _ = x.shape
        causal = torch.triu(torch.full((L, L), -1e9, dtype=torch.float32,
                                       device=x.device), diagonal=1)
        ref = self.anchors()[None, :L].expand(B, L, 2)

        classes, refs = [], []
        for lid, layer in enumerate(self.layers):
            query_pos = self._query_pos(ref)
            ref_input = ref[:, :, None, :].expand(B, L, self.n_levels, 2)
            if self.layer_type == "v1":
                x = layer.forward_train(x, query_pos, ref_input, memory,
                                        spatial_shapes, causal,
                                        support_features, support_mask,
                                        generator)
            elif self.layer_type == "v3":
                # v3 updates the memory too; it threads through the stack
                # (`dtv2:1092-1093`)
                x, memory = layer(x, query_pos, ref_input, memory,
                                  spatial_shapes, causal, generator)
            else:
                x = layer(x, query_pos, ref_input, memory, spatial_shapes,
                          causal, generator)
            ref = self._refine(lid, x, ref)
            classes.append(self.class_heads[lid](x))
            refs.append(ref)
        return torch.stack(classes), torch.stack(refs)

    def _require_v1(self, what: str):
        """The JAX package's refusal (`cape_tpu/models/decoder.py:432-447`),
        with its messages."""
        if self.layer_type != "v1":
            raise ValueError(
                f"{what} requires layer_type='v1': the v2-v6 variants are "
                "teacher-forced-only experimental layers, as in the "
                "reference (they crash on its CAPE/decode path — "
                "dtv2:1085-1091 passes support kwargs their forwards do "
                "not accept; v2/v3 also lack KV caches)")
        if self.attn_concat_src:
            raise ValueError(
                f"{what} does not support attn_concat_src: prepending the "
                "full encoder memory to every self-attention step would "
                "grow each decode step's keys from L to S+L (the reference "
                "pays this, dtv2:333-337); train/eval this experimental "
                "flag teacher-forced only")

    def precompute_static(self, memory, support_features, spatial_shapes):
        """Per-layer quad slabs of the projected memory, and support K/V:
        the decode-time-constant inputs, computed once per request.

        A quad slab holds each value row 4 times. Where
        `ops.msda.decode_prequad()` is False the plain per-layer (B, S, H,
        Dh) value is kept instead: a quarter of the cache, a repack per
        step on the quad-row path."""
        self._require_v1("autoregressive decode (precompute_static)")
        if ops_msda.decode_prequad():
            mem_values = [l.memory_quads(memory, spatial_shapes)
                          for l in self.layers]
        else:
            mem_values = [l.memory_value(memory) for l in self.layers]
        support_kvs = [l.support_kv(support_features) for l in self.layers]
        return mem_values, support_kvs

    def init_caches(self, batch: int, length: int,
                    device: torch.device) -> List[LayerCache]:
        dh = self.d_model // self.n_heads
        shape = (batch, self.n_heads, length, dh)
        return [LayerCache(torch.zeros(shape, dtype=self.dtype, device=device),
                           torch.zeros(shape, dtype=self.dtype, device=device))
                for _ in self.layers]

    def forward_step(
        self,
        token_inputs: Dict[str, torch.Tensor],   # (B, 1) tensors
        pos_index,                                # int or 0-d int64 tensor
        mem_values: List[torch.Tensor],          # quad slabs, or plain
        #                                          values (precompute_static)
        spatial_shapes,
        support_kvs,                              # list[(k, v)]
        support_mask: torch.Tensor,
        caches: List[LayerCache],
    ):
        """One autoregressive step at `pos_index`: a Python int, or a 0-d
        int64 tensor on the device, as the decode loop carries it (the JAX
        `while_loop` carries `i` so).

        Returns:
            logits: (B, 1, num_classes) — final layer class head
            coords: (B, 1, 2) — final refined reference point (fp32)
            caches (updated in place)
        """
        x = self.seq_embed(
            token_inputs["seq11"], token_inputs["seq12"],
            token_inputs["seq21"], token_inputs["seq22"],
            token_inputs["delta_x1"], token_inputs["delta_x2"],
            token_inputs["delta_y1"], token_inputs["delta_y2"],
        )
        B = x.shape[0]
        if not isinstance(pos_index, torch.Tensor):
            pos_index = torch.tensor(pos_index, device=x.device)
        pos_index = pos_index.long()
        anchor = self.anchors().index_select(0, pos_index.reshape(1))  # (1, 2)
        ref = anchor[None].expand(B, 1, 2)

        for lid in range(self.num_layers):
            # one kernel a layer where `decode_step.refusal` finds none
            sk, sv = support_kvs[lid]
            step = decode_step.layer_step if decode_step.refusal(
                self, x, mem_values[lid], caches[lid], sk) is None \
                else decode_step.layer_step_plain
            x, ref = step(self, lid, x, ref, mem_values[lid], spatial_shapes,
                          caches[lid], pos_index, sk, sv, support_mask)
        # only the last layer's class head is read at decode time
        logits = self.class_heads[-1](x)
        return logits, ref, caches
