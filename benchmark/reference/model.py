"""Plain float32 CAPE: the benchmark's reference for the port's forward,
decode and training.

The backbone the configuration names (`reference/backbones/`), 1x1/3x3
input projections with GroupNorm, the deformable encoder with multi-scale
deformable attention written as `F.grid_sample` per level (bilinear, zero
padding, half-pixel centres), the geometric or the legacy support encoder,
and the v1 decoder run teacher-forced under a causal mask. Parameter names follow the program's
`state_dict`, so that the benchmark hands both the same weights. Nothing
here imports the program: it is written from the model's equations.

Precision: every parameter and activation is float32. With `qdtype` set
(the control), every linear and convolution reads its input and weight
rounded to that dtype with a per-tensor scale, as an fp8 GEMM would (the
gradient passes the rounding straight through).

Dropout is flax's: keep with probability 1 - p, drawn as
`torch.rand(x.shape, generator=g, device=x.device) < 1 - p`, in the order
the forward meets the sites, so that one seeded generator gives the same
masks wherever the same sites are met in the same order.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from reference import backbones

NEG_INF = -1e9


def fake_quant(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """`x` rounded to `dtype` with a per-tensor scale (amax to the dtype's
    largest finite value), returned in float32."""
    if dtype is None:
        return x
    top = torch.finfo(dtype).max
    scale = x.detach().abs().amax().clamp(min=1e-30) / top
    q = (x.detach() / scale).to(dtype).float() * scale
    return x + (q - x.detach())          # the gradient passes straight


class Linear(nn.Linear):
    qdtype: Optional[torch.dtype] = None

    def forward(self, x):
        return F.linear(fake_quant(x, self.qdtype),
                        fake_quant(self.weight, self.qdtype), self.bias)


class Conv2d(nn.Conv2d):
    qdtype: Optional[torch.dtype] = None

    def forward(self, x):
        return self._conv_forward(fake_quant(x, self.qdtype),
                                  fake_quant(self.weight, self.qdtype),
                                  self.bias)


def dropout(x, p: float, g: Optional[torch.Generator]):
    if g is None or p == 0.0:
        return x
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=g, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class MHA(nn.Module):
    def __init__(self, d: int, h: int, p: float):
        super().__init__()
        self.h, self.p = h, p
        self.q_proj, self.k_proj = Linear(d, d), Linear(d, d)
        self.v_proj, self.out_proj = Linear(d, d), Linear(d, d)

    def _split(self, x):
        b, n, d = x.shape
        return x.reshape(b, n, self.h, d // self.h).transpose(1, 2)

    def forward(self, q_in, k_in, v_in, add_mask=None, kpm=None, g=None):
        b, lq, d = q_in.shape
        q = self._split(self.q_proj(q_in)) * (d // self.h) ** -0.5
        k, v = self._split(self.k_proj(k_in)), self._split(self.v_proj(v_in))
        logits = q @ k.transpose(-1, -2)
        if add_mask is not None:
            logits = logits + add_mask
        if kpm is not None:
            logits = logits.masked_fill(kpm[:, None, None, :], NEG_INF)
        w = dropout(torch.softmax(logits, -1), self.p, g)
        out = (w @ v).transpose(1, 2).reshape(b, lq, d)
        return self.out_proj(out)


def grid_sample_msda(value, shapes, loc, attn):
    """value (B, S, H, Dh); loc (B, Lq, H, L, P, 2) in [0, 1]; attn
    (B, Lq, H, L, P) -> (B, Lq, H*Dh). The bilinear sample of
    `F.grid_sample(align_corners=False, padding_mode='zeros')`."""
    B, S, H, Dh = value.shape
    _, Lq, _, L, P, _ = loc.shape
    out = 0
    start = 0
    for lvl, (h, w) in enumerate(shapes):
        v = value[:, start:start + h * w].permute(0, 2, 3, 1).reshape(
            B * H, Dh, h, w)
        start += h * w
        grid = loc[:, :, :, lvl].permute(0, 2, 1, 3, 4).reshape(
            B * H, Lq, P, 2) * 2 - 1
        s = F.grid_sample(v, grid, mode="bilinear", padding_mode="zeros",
                          align_corners=False)          # (B*H, Dh, Lq, P)
        a = attn[:, :, :, lvl].permute(0, 2, 1, 3).reshape(B * H, 1, Lq, P)
        out = out + (s * a).sum(-1)                     # (B*H, Dh, Lq)
    return out.reshape(B, H, Dh, Lq).permute(0, 3, 1, 2).reshape(
        B, Lq, H * Dh)


class MSDeformAttn(nn.Module):
    #: where set, the sampling locations are rounded to this type before
    #: the sample, the gradient passing straight (a diagnostic of how the
    #: bilinear sample's gradient meets rounding of its locations)
    loc_dtype: Optional[torch.dtype] = None

    def __init__(self, d: int, levels: int, h: int, points: int):
        super().__init__()
        self.h, self.l, self.p = h, levels, points
        self.sampling_offsets = Linear(d, h * levels * points * 2)
        self.attention_weights = Linear(d, h * levels * points)
        self.value_proj = Linear(d, d)
        self.output_proj = Linear(d, d)

    def forward(self, query, ref, src, shapes):
        """query (B, Lq, D); ref (B, Lq, 2) normalized (x, y); src the
        (B, S, D) memory the values are projected from."""
        b, lq, d = query.shape
        h, l, p = self.h, self.l, self.p
        value = self.value_proj(src).reshape(b, src.shape[1], h, d // h)
        off = self.sampling_offsets(query).reshape(b, lq, h, l, p, 2)
        attn = torch.softmax(self.attention_weights(query).reshape(
            b, lq, h, l * p), -1).reshape(b, lq, h, l, p)
        norm = torch.tensor([[w, hh] for hh, w in shapes],
                            dtype=torch.float32, device=query.device)
        loc = ref[:, :, None, None, None, :] + off / norm[None, None, None,
                                                          :, None, :]
        if self.loc_dtype is not None:
            loc = loc + (loc.detach().to(self.loc_dtype).float()
                         - loc.detach())
        return self.output_proj(grid_sample_msda(value, shapes, loc, attn))


class EncoderLayer(nn.Module):
    def __init__(self, d, f, p, levels, h, points):
        super().__init__()
        self.p = p
        self.self_attn = MSDeformAttn(d, levels, h, points)
        self.norm1 = nn.LayerNorm(d)
        self.linear1, self.linear2 = Linear(d, f), Linear(f, d)
        self.norm2 = nn.LayerNorm(d)

    def forward(self, src, pos, ref, shapes, g):
        s2 = self.self_attn(src + pos, ref, src, shapes)
        src = self.norm1(src + dropout(s2, self.p, g))
        y = self.linear2(dropout(F.relu(self.linear1(src)), self.p, g))
        return self.norm2(src + dropout(y, self.p, g))


class SupportLayer(nn.Module):
    def __init__(self, d, h, f, p):
        super().__init__()
        self.p = p
        self.self_attn = MHA(d, h, p)
        self.norm1 = nn.LayerNorm(d)
        self.linear1, self.linear2 = Linear(d, f), Linear(f, d)
        self.norm2 = nn.LayerNorm(d)

    def forward(self, x, kpm, g):
        x = self.norm1(x + dropout(self.self_attn(x, x, x, kpm=kpm, g=g),
                                   self.p, g))
        y = self.linear2(dropout(F.relu(self.linear1(x)), self.p, g))
        return self.norm2(x + dropout(y, self.p, g))


def sine_1d_table(n: int, d: int, device) -> torch.Tensor:
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32,
                                 device=device) * (-math.log(10000.0) / d))
    pe = torch.zeros(n, d, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def _dim_t(n: int, device) -> torch.Tensor:
    i = torch.arange(n, dtype=torch.float32, device=device)
    return 10000.0 ** (2 * torch.div(i, 2, rounding_mode="floor") / n)


def _sin_cos(p):
    return torch.stack([p[..., 0::2].sin(), p[..., 1::2].cos()],
                       -1).reshape(p.shape)


def coords_sine(c, n: int):
    """(..., 2) -> (..., 2n): [pe(y) | pe(x)]."""
    t = _dim_t(n, c.device)
    px = (c[..., 0] * 2 * math.pi)[..., None] / t
    py = (c[..., 1] * 2 * math.pi)[..., None] / t
    return torch.cat([_sin_cos(py), _sin_cos(px)], -1)


def query_sine(ref, n: int):
    """(..., 2) -> (..., 2n): [pe(x) | pe(y)]."""
    p = (ref * 2 * math.pi)[..., None] / _dim_t(n, ref.device)
    return _sin_cos(p).reshape(*ref.shape[:-1], 2 * n)


def image_sine(h: int, w: int, d: int, device) -> torch.Tensor:
    """(h*w, d) sine encoding of an all-valid map: [pe(y) | pe(x)]."""
    n = d // 2
    scale, eps = 2 * math.pi, 1e-6
    y = (torch.arange(1, h + 1, dtype=torch.float32, device=device) - 0.5) \
        / (h + eps) * scale
    x = (torch.arange(1, w + 1, dtype=torch.float32, device=device) - 0.5) \
        / (w + eps) * scale
    t = _dim_t(n, device)
    py = _sin_cos(y[:, None] / t)[:, None, :].expand(h, w, n)
    px = _sin_cos(x[:, None] / t)[None, :, :].expand(h, w, n)
    return torch.cat([py, px], -1).reshape(h * w, d)


def skeleton_adjacency(n: int, edges, mask):
    """(B, 2, n, n): [diag(~mask), row-normalized symmetric adjacency]."""
    B = edges.shape[0]
    adj = torch.zeros(B, n, n)
    for b, pairs in enumerate(edges.tolist()):
        for e0, e1 in pairs:
            if 0 <= e0 < n and 0 <= e1 < n:
                adj[b, e0, e1] = adj[b, e1, e0] = 1.0
    adj = adj.to(edges.device)
    keep = (~mask).float()
    adj = adj * keep[:, :, None] * keep[:, None, :]
    rs = adj.sum(-1, keepdim=True)
    adj = torch.where(rs > 0, adj / rs.clamp(min=1e-30), torch.zeros_like(adj))
    return torch.stack([torch.diag_embed(keep), adj], 1)


class GCN(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.linear = Linear(d, 2 * d)

    def forward(self, x, adj):
        b, n, d = x.shape
        hk = self.linear(x).reshape(b, n, 2, d).transpose(1, 2)
        return F.relu(torch.einsum("bkvc,bkvw->bwc", hk, adj))


class GeometricSupport(nn.Module):
    def __init__(self, c):
        super().__init__()
        d = c["hidden_dim"]
        self.d = d
        self.max_pe = max(c["max_support_keypoints"], 100)
        self.coord_mlp_0, self.coord_mlp_1 = Linear(2, d), Linear(d, d)
        self.gcn = nn.ModuleList([GCN(d) for _ in range(
            c["num_gcn_layers"] if c["use_gcn_preenc"] else 0)])
        self.layers = nn.ModuleList(
            [SupportLayer(d, c["nheads"], c["dim_feedforward"], c["dropout"])
             for _ in range(c["support_encoder_layers"])])

    def forward(self, coords, mask, edges, g):
        B, N, _ = coords.shape
        h = self.coord_mlp_1(F.relu(self.coord_mlp_0(coords)))
        h = h + coords_sine(coords, self.d // 2)
        h = h + sine_1d_table(self.max_pe, self.d, coords.device)[:N]
        if len(self.gcn):
            adj = skeleton_adjacency(N, edges, mask)
            for layer in self.gcn:
                h = layer(h, adj)
        for layer in self.layers:
            h = layer(h, mask, g)
        return torch.where(mask.all(1)[:, None, None], torch.zeros_like(h), h)


class LegacySupport(nn.Module):
    def __init__(self, c):
        super().__init__()
        d = c["hidden_dim"]
        self.d = d
        self.coord_mlp_0, self.coord_mlp_1 = Linear(2, d), Linear(d, d)
        self.edge_embedding = nn.Embedding(2, d)
        self.coord_edge_proj = Linear(2 * d, d)
        self.layers = nn.ModuleList(
            [SupportLayer(d, c["nheads"], c["dim_feedforward"], c["dropout"])
             for _ in range(c["support_encoder_layers"])])
        self.final_norm = nn.LayerNorm(d)

    def forward(self, coords, mask, edges, g):
        B, N, _ = coords.shape
        h = self.coord_mlp_1(F.relu(self.coord_mlp_0(coords)))
        adj = skeleton_adjacency(N, edges, torch.zeros_like(mask))
        degree = (adj[:, 1] > 0).float().sum(2)
        emb = self.edge_embedding((degree > 0).long())
        h = self.coord_edge_proj(torch.cat(
            [h, emb * degree.clamp(min=1.0)[..., None] / 10.0], -1))
        h = h + sine_1d_table(max(N, 64), self.d, coords.device)[:N]
        for layer in self.layers:
            h = layer(h, mask, g)
        return self.final_norm(h)


class DecoderLayer(nn.Module):
    def __init__(self, d, f, p, levels, h, points):
        super().__init__()
        self.p = p
        self.attn_q = Linear(d, d, bias=False)
        self.attn_k = Linear(d, d, bias=False)
        self.attn_v = Linear(d, d, bias=False)
        self.self_attn = MHA(d, h, p)
        self.norm2 = nn.LayerNorm(d)
        self.support_attn = MHA(d, h, p)
        self.norm_support = nn.LayerNorm(d)
        self.cross_attn = MSDeformAttn(d, levels, h, points)
        self.norm1 = nn.LayerNorm(d)
        self.linear1, self.linear2 = Linear(d, f), Linear(f, d)
        self.norm3 = nn.LayerNorm(d)

    def forward(self, x, qpos, ref, memory, shapes, causal, sup, smask, g):
        p = self.p
        t2 = self.self_attn(self.attn_q(x) + qpos, self.attn_k(x),
                            self.attn_v(x), add_mask=causal, g=g)
        x = self.norm2(x + dropout(t2, p, g))
        s2 = self.support_attn(x, sup, sup, kpm=smask, g=g)
        x = self.norm_support(x + dropout(s2, p, g))
        c2 = self.cross_attn(x + qpos, ref, memory, shapes)
        x = self.norm1(x + dropout(c2, p, g))
        y = self.linear2(dropout(F.relu(self.linear1(x)), p, g))
        return self.norm3(x + dropout(y, p, g))


class MLPHead(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.layers = nn.ModuleList([Linear(d, d), Linear(d, d),
                                     Linear(d, 2)])

    def forward(self, x):
        return self.layers[2](F.relu(self.layers[1](F.relu(
            self.layers[0](x)))))


def inverse_sigmoid(x, eps: float = 1e-5):
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


class Decoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        d = c["hidden_dim"]
        nb = int(math.isqrt(c["vocab_size"]))
        self.token_embed = nn.Embedding(nb * nb + 4, d)
        self.query_embed = nn.Parameter(torch.zeros(c["seq_len"], 2))
        self.pos_trans = Linear(d, d)
        self.pos_trans_norm = nn.LayerNorm(d)
        self.layers = nn.ModuleList([DecoderLayer(
            d, c["dim_feedforward"], c["dropout"], c["num_feature_levels"],
            c["nheads"], c["dec_n_points"]) for _ in range(c["dec_layers"])])
        self.class_heads = nn.ModuleList([Linear(d, 3)
                                          for _ in range(c["dec_layers"])])
        self.coords_heads = nn.ModuleDict({str(i): MLPHead(d)
                                           for i in range(c["dec_layers"])})
        self.d = d

    def forward(self, seq, memory, shapes, sup, smask, g):
        """Teacher-forced: (classes, refs) of every layer, (layers, B, L,
        ...)."""
        e, s = self.token_embed, seq
        x = (e(s["seq11"]) * (s["delta_x2"] * s["delta_y2"])[..., None]
             + e(s["seq21"]) * (s["delta_x1"] * s["delta_y2"])[..., None]
             + e(s["seq12"]) * (s["delta_x2"] * s["delta_y1"])[..., None]
             + e(s["seq22"]) * (s["delta_x1"] * s["delta_y1"])[..., None])
        B, L, _ = x.shape
        causal = torch.triu(torch.full((L, L), NEG_INF, device=x.device), 1)
        ref = torch.sigmoid(self.query_embed)[None, :L].expand(B, L, 2)
        classes, refs = [], []
        for i, layer in enumerate(self.layers):
            qpos = self.pos_trans_norm(self.pos_trans(
                query_sine(ref, self.d // 2)))
            x = layer(x, qpos, ref, memory, shapes, causal, sup, smask, g)
            ref = torch.sigmoid(self.coords_heads[str(i)](x)
                                + inverse_sigmoid(ref))
            classes.append(self.class_heads[i](x))
            refs.append(ref)
        return torch.stack(classes), torch.stack(refs)


def level_shapes(image_size: int, levels: int) -> List[Tuple[int, int]]:
    return [(image_size // s, image_size // s) for s in (8, 16, 32, 64)][
        :levels]


def encoder_reference(shapes, device) -> torch.Tensor:
    pts = []
    for h, w in shapes:
        y, x = torch.meshgrid(
            (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h,
            (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w,
            indexing="ij")
        pts.append(torch.stack([x.reshape(-1), y.reshape(-1)], -1))
    return torch.cat(pts, 0)                               # (S, 2)


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class RefCAPE(nn.Module):
    """The whole model, float32. `c` is the configuration as a dict of the
    fields of the configuration file."""

    def __init__(self, c: Dict, qdtype: Optional[torch.dtype] = None):
        super().__init__()
        self.c = c
        d = c["hidden_dim"]
        backbone = backbones.module(c["backbone"])
        self.backbone = backbone.build(c)
        chans = backbone.channels(c)
        self.input_projs = nn.ModuleList(
            [nn.Sequential(Conv2d(ch, d, 1), nn.GroupNorm(32, d))
             for ch in chans]
            + [nn.Sequential(Conv2d(chans[-1], d, 3, 2, 1),
                             nn.GroupNorm(32, d))])
        self.level_embed = nn.Parameter(torch.zeros(c["num_feature_levels"],
                                                    d))
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList([EncoderLayer(
            d, c["dim_feedforward"], c["dropout"], c["num_feature_levels"],
            c["nheads"], c["enc_n_points"]) for _ in range(c["enc_layers"])])
        self.decoder = Decoder(c)
        self.support_encoder = (GeometricSupport(c)
                                if c["use_geometric_encoder"]
                                else LegacySupport(c))
        self.shapes = level_shapes(c["image_size"], c["num_feature_levels"])
        for m in self.modules():
            if isinstance(m, (Linear, Conv2d)):
                m.qdtype = qdtype

    def encode_image(self, images, g=None):
        """(B, S, S, 3) uint8 -> (B, sum(h*w), D) memory."""
        x = images.float() / 255.0
        if self.c["image_norm"]:
            x = (x - torch.tensor(IMAGENET_MEAN, device=x.device)) / \
                torch.tensor(IMAGENET_STD, device=x.device)
        feats = self.backbone(x.permute(0, 3, 1, 2))
        srcs = [self.input_projs[i](feats[i]) for i in range(3)]
        if len(self.shapes) > 3:
            srcs.append(self.input_projs[3](feats[2]))
        flat, pos = [], []
        for lvl, s in enumerate(srcs):
            b, d, h, w = s.shape
            flat.append(s.flatten(2).transpose(1, 2))
            pos.append((image_sine(h, w, d, s.device)
                        + self.level_embed[lvl]).expand(b, h * w, d))
        src, pos = torch.cat(flat, 1), torch.cat(pos, 1)
        ref = encoder_reference(self.shapes, src.device)[None].expand(
            src.shape[0], -1, -1)
        for layer in self.encoder.layers:
            src = layer(src, pos, ref, self.shapes, g)
        return src

    def forward(self, images, coords, mask, edges, seq, g=None):
        memory = self.encode_image(images, g)
        sup = self.support_encoder(coords.float(), mask, edges, g)
        return self.decoder(seq, memory, self.shapes, sup, mask, g)
