"""ViTDet's plain Vision Transformer backbone with its simple feature
pyramid (Li, Mao, Girshick, He, 2022, arXiv:2203.16527; detectron2,
`modeling/backbone/vit.py` `ViT` and `SimpleFeaturePyramid`,
`projects/ViTDet/configs/COCO/mask_rcnn_vitdet_l_100ep.py`).

A 16 x 16 patch embedding (a strided convolution with bias), the absolute
position embedding of the pretraining grid (its class row dropped, the
grid resized bicubically, align_corners False, to the token grid at every
forward), and blocks

    x = x + attn.proj(rel_attention(attn.qkv(norm1(x))))
    x = x + mlp.fc2(gelu(mlp.fc1(norm2(x))))

where `ops.rel_attention` attends in windows of 14 x 14 tokens (the grid
padded at the bottom and right, no shift, no mask) or, in the global
blocks, over the whole grid, with the decomposed relative-position bias
of the block's `rel_pos_h` and `rel_pos_w` (resampled where the grid is
not the one the tables were built for). LayerNorms with eps 1e-6, qkv
with bias, no final norm. The tokens stay in (B, H, W, C).

The pyramid reads the stride-16 map (NCHW): scale 2 a 2 x 2, stride-2
transposed convolution to C / 2 channels, scale 1 the map itself, scale
0.5 a 2 x 2 max pool; each then a 1 x 1 and a 3 x 3 convolution to 256
channels without bias, each followed by a LayerNorm over the channels
(eps 1e-6). Stride 8, 16 and 32 maps of 256 channels are returned.

Parameter names are the source's (`net.*`, `simfp_3/4/5.*`), so that its
checkpoints map one to one. Not built: the source's scale-4 branch and
`LastLevelMaxPool` (CAPE's encoder reads strides 8-32 and makes its
fourth level itself), stochastic depth (drop path 0), activation
checkpointing, residual blocks (ViTDet-L has none).

Init (a model trained from scratch, as the source's `_init_weights`):
linear kernels normal with std 0.02 and zero biases, the position
embedding normal with std 0.02 (the source's truncated normal,
untruncated), the relative-position tables zero (`rel_pos_zero_init`),
LayerNorms one and zero; the convolutions flax's lecun normal.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.rel_attn import rel_attention
from .layers import Conv2d, Dense, LayerNorm, lecun_normal_, normal_, zeros_

#: the backbones this module builds, by the configuration's `backbone`
VITDET: Dict[str, Dict] = {
    # ViTDet-L (`mask_rcnn_vitdet_l_100ep.py` over
    # `common/models/mask_rcnn_vitdet.py`)
    "vitdet_l": dict(embed_dim=1024, depth=24, num_heads=16, window=14,
                     global_blocks=(5, 11, 17, 23), img_size=1024,
                     pretrain_img_size=224),
    # the CPU tests' copy: heads of 64 channels, windows of 3 (4 x 4
    # tokens at 64 px: padded to 6 x 6), a 2 x 2 pretraining grid
    "vitdet_tiny": dict(embed_dim=128, depth=4, num_heads=2, window=3,
                        global_blocks=(1, 3), img_size=64,
                        pretrain_img_size=32),
}
PATCH = 16
MLP_RATIO = 4
EPS = 1e-6
#: the pyramid's channels
OUT_CHANNELS = 256


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, size: int):
        super().__init__()
        self.heads = heads
        self.qkv = Dense(dim, 3 * dim)
        self.proj = Dense(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * size - 1, dim // heads))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * size - 1, dim // heads))

    def forward(self, x: torch.Tensor, window: int) -> torch.Tensor:
        out = rel_attention(self.qkv(x), self.qkv.bias, self.rel_pos_h,
                            self.rel_pos_w, self.heads, window)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = Dense(dim, MLP_RATIO * dim)
        self.fc2 = Dense(MLP_RATIO * dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, size: int):
        super().__init__()
        self.window = window
        self.norm1 = LayerNorm(dim, EPS)
        self.attn = Attention(dim, heads, window or size)
        self.norm2 = LayerNorm(dim, EPS)
        self.mlp = Mlp(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), self.window)
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.proj = Conv2d(cin, dim, PATCH, stride=PATCH)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x).permute(0, 2, 3, 1)


def abs_pos(pos_embed: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The source's `get_abs_pos`: the class row dropped, the pretraining
    grid resized bicubically to (h, w) where it differs; (1, h, w, C),
    computed in fp32."""
    pos = pos_embed[:, 1:].float()
    side = int(round(pos.shape[1] ** 0.5))
    pos = pos.reshape(1, side, side, -1)
    if (side, side) != (h, w):
        pos = F.interpolate(pos.permute(0, 3, 1, 2), size=(h, w),
                            mode="bicubic", align_corners=False)
        pos = pos.permute(0, 2, 3, 1)
    return pos


class ViT(nn.Module):
    def __init__(self, spec: Dict, cin: int):
        super().__init__()
        dim, grid = spec["embed_dim"], spec["img_size"] // PATCH
        self.patch_embed = PatchEmbed(cin, dim)
        self.pos_embed = nn.Parameter(torch.zeros(
            1, (spec["pretrain_img_size"] // PATCH) ** 2 + 1, dim))
        self.blocks = nn.ModuleList(
            [Block(dim, spec["num_heads"],
                   0 if i in spec["global_blocks"] else spec["window"], grid)
             for i in range(spec["depth"])])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x)
        x = x + abs_pos(self.pos_embed, x.shape[1], x.shape[2]).to(x.dtype)
        for block in self.blocks:
            x = block(x)
        return x


class ChannelNorm(LayerNorm):
    """detectron2's `LayerNorm` of a (B, C, H, W) map: over the channels."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class ConvNorm(Conv2d):
    """detectron2's `Conv2d` with a norm: a convolution without bias, then
    the channels' LayerNorm (`norm`)."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__(cin, cout, k, padding=k // 2, bias=False)
        self.norm = ChannelNorm(cout, EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(super().forward(x))


class ConvTranspose2d(nn.ConvTranspose2d):
    """`nn.ConvTranspose2d` that casts its input to the weight dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(self.weight.dtype))


class ViTDet(nn.Module):
    """(B, C, H, W) -> the stride 8, 16, 32 maps of 256 channels, NCHW."""

    def __init__(self, name: str, input_channels: int = 3):
        super().__init__()
        if name not in VITDET:
            raise ValueError(f"no ViTDet backbone {name!r}: one of "
                             f"{sorted(VITDET)}")
        spec = VITDET[name]
        dim, out = spec["embed_dim"], OUT_CHANNELS
        self.net = ViT(spec, input_channels)
        self.simfp_3 = nn.Sequential(
            ConvTranspose2d(dim, dim // 2, 2, stride=2),
            ConvNorm(dim // 2, out, 1), ConvNorm(out, out, 3))
        self.simfp_4 = nn.Sequential(ConvNorm(dim, out, 1),
                                     ConvNorm(out, out, 3))
        self.simfp_5 = nn.Sequential(nn.MaxPool2d(2, 2),
                                     ConvNorm(dim, out, 1),
                                     ConvNorm(out, out, 3))
        #: the returned maps' channels
        self.channels: Tuple[int, ...] = (out, out, out)

    def init_weights(self, g: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, Dense):
                normal_(m.weight, 0.02, g)
                zeros_(m.bias)
            elif isinstance(m, Attention):
                zeros_(m.rel_pos_h)
                zeros_(m.rel_pos_w)
            elif isinstance(m, ConvTranspose2d):
                lecun_normal_(m.weight, g)
                zeros_(m.bias)
        normal_(self.net.pos_embed, 0.02, g)

    def forward(self, x: torch.Tensor) -> Sequence[torch.Tensor]:
        y = self.net(x).permute(0, 3, 1, 2)
        return tuple(branch(y).contiguous()
                     for branch in (self.simfp_3, self.simfp_4, self.simfp_5))
