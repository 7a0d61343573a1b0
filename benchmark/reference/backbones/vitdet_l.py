"""ViTDet-L: the plain Vision Transformer backbone of ViTDet (Li, Mao,
Girshick, He, 2022, arXiv:2203.16527) with its simple feature pyramid, as
detectron2 builds it (`projects/ViTDet/configs/COCO/
mask_rcnn_vitdet_l_100ep.py` over `configs/common/models/
mask_rcnn_vitdet.py`; the code in `modeling/backbone/vit.py` and
`modeling/backbone/utils.py`), written from those equations in plain
float32 torch: a 16 x 16 patch embedding with bias, the absolute position
embedding of the 224-px pretraining grid (197 rows with the class row)
resized bicubically to the token grid (`get_abs_pos`), 24 blocks of 1,024
channels, 16 heads of 64, MLP ratio 4, GELU, qkv with bias, LayerNorms
with eps 1e-6, no final norm; blocks 5, 11, 17 and 23 attend over the
whole grid, the others in 14 x 14 windows (`window_partition`: the normed
tokens zero-padded at the bottom and right, so a padded token's q, k and
v are the qkv bias; `window_unpartition` crops), each with the decomposed
relative-position bias of its `rel_pos_h` and `rel_pos_w`
(`get_rel_pos`, resampled linearly where the length differs;
`add_decomposed_rel_pos`). Then `SimpleFeaturePyramid` on the stride-16
map at scales 2, 1 and 0.5: a 2 x 2, stride-2 transposed convolution to
512 channels, the map itself, a 2 x 2 max pool; each followed by a 1 x 1
and a 3 x 3 convolution to 256 channels without bias, each with a
LayerNorm over the channels (eps 1e-6).

Departures from the source: the scale-4 branch and `LastLevelMaxPool` are
not built (CAPE reads strides 8-32); no stochastic depth (drop path 0);
the transposed convolution is the reference's `Linear` (1,024 -> 4 x 512)
followed by depth to space, which is the same arithmetic since its 2 x 2
taps at stride 2 do not overlap, so that the control's rounding reaches
it; with gradients on, each block is recomputed in the backward
(`torch.utils.checkpoint`): the same arithmetic, so that the float32 step
at 1,024 px fits on the card (a global block's scores alone are 4.3 GB at
4 images).

Linear layers and convolutions are the reference's own, so that the
control's rounding reaches them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from reference.model import Conv2d, Linear, fake_quant

EMBED = 1024
DEPTH = 24
HEADS = 16
WINDOW = 14
GLOBAL_BLOCKS = (5, 11, 17, 23)
IMG_SIZE = 1024
PRETRAIN_IMG_SIZE = 224
PATCH = 16
MLP_RATIO = 4
EPS = 1e-6
OUT_CHANNELS = 256
#: the first names of the backbone's parameters (`init` refuses others)
NAMES = ("net.", "simfp_3.", "simfp_4.", "simfp_5.")


def window_partition(x: torch.Tensor, ws: int):
    """(B, H, W, C) -> windows (B * nW, ws, ws, C), zero-padded, and the
    padded size."""
    B, H, W, C = x.shape
    pad_h, pad_w = (ws - H % ws) % ws, (ws - W % ws) % ws
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.view(B, Hp // ws, ws, Wp // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, C), (Hp, Wp)


def window_unpartition(windows: torch.Tensor, ws: int, pad_hw, hw):
    Hp, Wp = pad_hw
    H, W = hw
    B = windows.shape[0] // (Hp * Wp // ws // ws)
    x = windows.view(B, Hp // ws, Wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, -1)
    return x[:, :H, :W]


def get_rel_pos(q_size: int, k_size: int,
                rel_pos: torch.Tensor) -> torch.Tensor:
    """(q_size, k_size, C): the table's row for each query and key position
    (the source's `get_rel_pos`)."""
    max_rel_dist = int(2 * max(q_size, k_size) - 1)
    if rel_pos.shape[0] != max_rel_dist:
        resized = F.interpolate(
            rel_pos.reshape(1, rel_pos.shape[0], -1).permute(0, 2, 1),
            size=max_rel_dist, mode="linear")
        resized = resized.reshape(-1, max_rel_dist).permute(1, 0)
    else:
        resized = rel_pos
    q_coords = torch.arange(q_size, device=rel_pos.device)[:, None] * max(
        k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, device=rel_pos.device)[None, :] * max(
        q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return resized[rel.long()]


def add_decomposed_rel_pos(attn, q, rel_pos_h, rel_pos_w, q_size, k_size):
    q_h, q_w = q_size
    k_h, k_w = k_size
    Rh = get_rel_pos(q_h, k_h, rel_pos_h)
    Rw = get_rel_pos(q_w, k_w, rel_pos_w)
    B, _, dim = q.shape
    r_q = q.reshape(B, q_h, q_w, dim)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, Rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, Rw)
    attn = (attn.view(B, q_h, q_w, k_h, k_w) + rel_h[:, :, :, :, None]
            + rel_w[:, :, :, None, :])
    return attn.view(B, q_h * q_w, k_h * k_w)


def get_abs_pos(abs_pos: torch.Tensor, hw) -> torch.Tensor:
    """The pretraining grid's embedding without its class row, resized
    bicubically to hw: (1, h, w, C)."""
    h, w = hw
    abs_pos = abs_pos[:, 1:]
    size = int(math.sqrt(abs_pos.shape[1]))
    if size != h or size != w:
        new = F.interpolate(
            abs_pos.reshape(1, size, size, -1).permute(0, 3, 1, 2),
            size=(h, w), mode="bicubic", align_corners=False)
        return new.permute(0, 2, 3, 1)
    return abs_pos.reshape(1, h, w, -1)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, size: int):
        super().__init__()
        self.heads = heads
        self.scale = (dim // heads) ** -0.5
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * size - 1, dim // heads))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * size - 1, dim // heads))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, _ = x.shape
        qkv = self.qkv(x).reshape(B, H * W, 3, self.heads, -1) \
            .permute(2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, B * self.heads, H * W, -1).unbind(0)
        attn = (q * self.scale) @ k.transpose(-2, -1)
        attn = add_decomposed_rel_pos(attn, q, self.rel_pos_h,
                                      self.rel_pos_w, (H, W), (H, W))
        attn = attn.softmax(dim=-1)
        x = (attn @ v).view(B, self.heads, H, W, -1).permute(0, 2, 3, 1, 4) \
            .reshape(B, H, W, -1)
        return self.proj(x)


class Mlp(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = Linear(dim, MLP_RATIO * dim)
        self.fc2 = Linear(MLP_RATIO * dim, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, size: int):
        super().__init__()
        self.window = window
        self.norm1 = nn.LayerNorm(dim, eps=EPS)
        self.attn = Attention(dim, heads, window or size)
        self.norm2 = nn.LayerNorm(dim, eps=EPS)
        self.mlp = Mlp(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        x = self.norm1(x)
        if self.window > 0:
            H, W = x.shape[1], x.shape[2]
            x, pad_hw = window_partition(x, self.window)
        x = self.attn(x)
        if self.window > 0:
            x = window_unpartition(x, self.window, pad_hw, (H, W))
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.proj = Conv2d(cin, dim, PATCH, PATCH)

    def forward(self, x):
        return self.proj(x).permute(0, 2, 3, 1)


class ViT(nn.Module):
    def __init__(self, cin: int, dim: int, depth: int, heads: int,
                 window: int, global_blocks, img_size: int,
                 pretrain_img_size: int):
        super().__init__()
        self.patch_embed = PatchEmbed(cin, dim)
        self.pos_embed = nn.Parameter(torch.zeros(
            1, (pretrain_img_size // PATCH) ** 2 + 1, dim))
        self.blocks = nn.ModuleList(
            [Block(dim, heads, 0 if i in global_blocks else window,
                   img_size // PATCH) for i in range(depth)])

    def forward(self, x):
        x = self.patch_embed(x)
        x = x + get_abs_pos(self.pos_embed, (x.shape[1], x.shape[2]))
        for blk in self.blocks:
            if torch.is_grad_enabled():
                x = checkpoint(blk, x, use_reentrant=False)
            else:
                x = blk(x)
        return x


class LayerNorm2d(nn.Module):
    """detectron2's `LayerNorm`: over the channels of (B, C, H, W)."""

    def __init__(self, ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x):
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + EPS)
        return self.weight[:, None, None] * x + self.bias[:, None, None]


class ConvNorm(Conv2d):
    """detectron2's `Conv2d(..., bias=False, norm=LayerNorm)`."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__(cin, cout, k, padding=k // 2, bias=False)
        self.norm = LayerNorm2d(cout)

    def forward(self, x):
        return self.norm(super().forward(x))


class Deconv2x2(Linear):
    """`nn.ConvTranspose2d(cin, cout, 2, stride=2)` (its weight (cin, cout,
    2, 2) and bias) as the reference's linear layer: each input pixel's
    (2, 2, cout) outputs are one product, put in place by depth to
    space."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, 4 * cout)
        self.weight = nn.Parameter(torch.empty(cin, cout, 2, 2))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        B, cin, H, W = x.shape
        cout = self.weight.shape[1]
        w = self.weight.permute(2, 3, 1, 0).reshape(4 * cout, cin)
        y = F.linear(fake_quant(x.permute(0, 2, 3, 1), self.qdtype),
                     fake_quant(w, self.qdtype))
        y = y.view(B, H, W, 2, 2, cout).permute(0, 5, 1, 3, 2, 4)
        return y.reshape(B, cout, 2 * H, 2 * W) + self.bias[:, None, None]


class ViTDet(nn.Module):
    def __init__(self, c: Dict, dim: int, depth: int, heads: int,
                 window: int, global_blocks, img_size: int,
                 pretrain_img_size: int):
        super().__init__()
        out = OUT_CHANNELS
        self.net = ViT(c["input_channels"], dim, depth, heads, window,
                       global_blocks, img_size, pretrain_img_size)
        self.simfp_3 = nn.Sequential(Deconv2x2(dim, dim // 2),
                                     ConvNorm(dim // 2, out, 1),
                                     ConvNorm(out, out, 3))
        self.simfp_4 = nn.Sequential(ConvNorm(dim, out, 1),
                                     ConvNorm(out, out, 3))
        self.simfp_5 = nn.Sequential(nn.MaxPool2d(2, 2),
                                     ConvNorm(dim, out, 1),
                                     ConvNorm(out, out, 3))

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        y = self.net(x).permute(0, 3, 1, 2)
        return tuple(f(y) for f in (self.simfp_3, self.simfp_4,
                                    self.simfp_5))


# -- the benchmark's interface (`reference/backbones/__init__.py`) ---------
SPEC = dict(dim=EMBED, depth=DEPTH, heads=HEADS, window=WINDOW,
            global_blocks=GLOBAL_BLOCKS, img_size=IMG_SIZE,
            pretrain_img_size=PRETRAIN_IMG_SIZE)


def build(c: Dict) -> ViTDet:
    return ViTDet(c, **SPEC)


def channels(c: Dict) -> Tuple[int, int, int]:
    return (OUT_CHANNELS,) * 3


def _sites(c: Dict, spec: Dict) -> List[Tuple[int, int, int, int]]:
    """Each block's attention site at the configuration's image size, in
    block order: (rows, columns of a window, padded tokens, windows)."""
    g = -(-c["image_size"] // PATCH)
    out = []
    for i in range(spec["depth"]):
        ws = 0 if i in spec["global_blocks"] else spec["window"]
        sh = sw = ws or g
        gp = -(-g // sh) * sh
        out.append((sh, sw, gp * gp, (gp // sh) ** 2))
    return out


def vitdet_flops(c: Dict, spec: Dict) -> float:
    """One image: the patch convolution; every linear layer on the real
    tokens (a padded token's qkv is the bias: no product); attention's two
    products over the padded windows and each query's products with the
    (Sh + Sw) table rows of its bias; the pyramid's convolutions (the
    transposed one at 4 taps a pixel). Norms, softmax, GELU, the
    position embedding's resize and the max pool left out."""
    g = -(-c["image_size"] // PATCH)
    C, n = spec["dim"], g * g
    f = 2.0 * c["input_channels"] * PATCH * PATCH * C * n
    for sh, sw, npad, _ in _sites(c, spec):
        f += 2.0 * n * (3 * C * C + C * C + 2 * MLP_RATIO * C * C)
        f += 2 * 2.0 * npad * sh * sw * C + 2.0 * npad * (sh + sw) * C
    o = OUT_CHANNELS
    f += 2.0 * n * C * (C // 2) * 4                       # deconv
    f += 2.0 * 4 * n * (C // 2) * o + 2.0 * 4 * n * o * o * 9
    f += 2.0 * n * C * o + 2.0 * n * o * o * 9
    h = g // 2
    f += 2.0 * h * h * C * o + 2.0 * h * h * o * o * 9
    return f


def flops(c: Dict) -> float:
    return vitdet_flops(c, SPEC)


def rel_attn_sites(c: Dict, spec: Dict, images: int,
                   elt: int = 2) -> List[Tuple[float, float, float, float]]:
    """Each relative-attention site of a forward of `images` images, in
    block order: (forward bytes, forward FLOPs, backward bytes, backward
    FLOPs). Bytes count each input and output once, over the real tokens:
    forward q, k, v read and the output written, and each padded token's
    fp32 log-sum-exp a head; backward q, k, v, the output and its gradient
    read and the q, k, v gradient written, with the log-sum-exps; the
    tables are left out (under 33 KB). FLOPs: forward the two products
    over the padded windows and each query's (Sh + Sw) bias products;
    backward twice each."""
    g = -(-c["image_size"] // PATCH)
    C, heads = spec["dim"], spec["heads"]
    n = images * g * g
    out = []
    for sh, sw, npad, _ in _sites(c, spec):
        m = images * npad
        lse = m * heads * 4.0
        fwd_f = 2 * 2.0 * m * sh * sw * C + 2.0 * m * (sh + sw) * C
        out.append((n * 4 * C * elt + lse, fwd_f,
                    n * 8 * C * elt + lse, 2 * fwd_f))
    return out


def rel_attn(c: Dict, images: int):
    return rel_attn_sites(c, SPEC, images)


def init(name: str, z: torch.Tensor, init: Dict) -> Optional[torch.Tensor]:
    """The relative-position tables normal with std
    `init["vitdet_table_std"]` and the position embedding with std
    `init["vitdet_pos_std"]`; the rest by the generic rules. A name that is
    not the source's (a program that built another backbone) stops the
    run."""
    if not name.startswith(NAMES):
        raise SystemExit(f"the program's backbone has a parameter {name!r}: "
                         f"not a ViTDet parameter of detectron2's names")
    if name.endswith((".rel_pos_h", ".rel_pos_w")):
        return z * init["vitdet_table_std"]
    if name == "net.pos_embed":
        return z * init["vitdet_pos_std"]
    return None
