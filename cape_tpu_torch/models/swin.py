"""Swin Transformer backbone (Liu et al., 2021, arXiv:2103.14030) in the
detection form DINO-4scale runs (Zhang et al., 2022, arXiv:2203.03605;
IDEA-Research/DINO, `models/dino/swin_transformer.py`).

A 4 x 4 patch embedding (a strided convolution and a LayerNorm), four
stages of Swin blocks with a patch merging between them, and a LayerNorm on
each returned stage. A block is

    x = x + attn.proj(window_attention(attn.qkv(norm1(x))))
    x = x + mlp.fc2(gelu(mlp.fc1(norm2(x))))

where `ops.window_attention` pads the grid to a multiple of the 12 x 12
window, shifts it cyclically by 6 in every odd block (at every stage, with
no clamp of the window to a smaller stage), attends within each window with
the head's relative-position bias and, when shifted, the -100 mask between
regions, and crops back to the real tokens. The tokens stay in (B, H, W, C)
from the embedding to the stage outputs, which are returned NCHW.

As in the source: qkv with bias, no absolute position embedding, patch
merging as LayerNorm(4C) then Linear(4C -> 2C) without bias (the 2 x 2
neighbours in the order (0, 0), (1, 0), (0, 1), (1, 1)), odd sizes padded
before the embedding and each merging. Parameter names are the source's,
so that its checkpoints map one to one; the relative-position indices and
shift masks are computed, not stored. Not built: stochastic depth (drop
path 0) and activation checkpointing.

Init (a model trained from scratch): linear kernels normal with std 0.02
and zero biases, the relative-position tables normal with std 0.02 (the
source's truncated normal, untruncated), LayerNorms one and zero, the
patch convolution flax's lecun normal.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.window_attn import BINS, WINDOW, window_attention
from .layers import Conv2d, Dense, LayerNorm, normal_, zeros_

#: the backbones this module builds, by the configuration's `backbone`:
#: embedding width, blocks and heads a stage (32 channels a head); both
#: with the source's 12 x 12 windows (`ops.window_attn.WINDOW`)
SWIN: Dict[str, Dict] = {
    # DINO's `swin_L_384_22k` (`config/DINO/DINO_4scale_swin.py`)
    "swin_L_384_22k": dict(embed_dim=192, depths=(2, 2, 18, 2),
                           num_heads=(6, 12, 24, 48)),
    # the CPU tests' copy: every stage, one head of 32 channels at first
    "swin_tiny": dict(embed_dim=32, depths=(2, 2, 2, 2),
                      num_heads=(1, 2, 4, 8)),
}
MLP_RATIO = 4
PATCH = 4
#: the stages returned, as DINO's `return_interm_indices`
OUT_INDICES = (1, 2, 3)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = Dense(dim, 3 * dim)
        self.proj = Dense(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(BINS, heads))

    def forward(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        out = window_attention(self.qkv(x), self.qkv.bias,
                               self.relative_position_bias_table,
                               self.heads, shift)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = Dense(dim, MLP_RATIO * dim)
        self.fc2 = Dense(MLP_RATIO * dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, shift: int):
        super().__init__()
        self.shift = shift
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, heads)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), self.shift)
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = Dense(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, H, W, _ = x.shape
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        return self.reduction(self.norm(x))


class BasicLayer(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, downsample: bool):
        super().__init__()
        self.blocks = nn.ModuleList(
            [SwinBlock(dim, heads, 0 if i % 2 == 0 else WINDOW // 2)
             for i in range(depth)])
        self.downsample = PatchMerging(dim) if downsample else None


class PatchEmbed(nn.Module):
    def __init__(self, in_chans: int, dim: int):
        super().__init__()
        self.proj = Conv2d(in_chans, dim, PATCH, stride=PATCH)
        self.norm = LayerNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, _, H, W = x.shape
        if H % PATCH or W % PATCH:
            x = F.pad(x, (0, -W % PATCH, 0, -H % PATCH))
        return self.norm(self.proj(x).permute(0, 2, 3, 1))


class SwinTransformer(nn.Module):
    """(B, C, H, W) -> the stage 2-4 maps (strides 8, 16, 32), NCHW."""

    def __init__(self, name: str, input_channels: int = 3):
        super().__init__()
        if name not in SWIN:
            raise ValueError(f"no Swin backbone {name!r}: one of "
                             f"{sorted(SWIN)}")
        spec = SWIN[name]
        dim, depths = spec["embed_dim"], spec["depths"]
        self.patch_embed = PatchEmbed(input_channels, dim)
        self.layers = nn.ModuleList(
            [BasicLayer(dim * 2 ** i, d, h, i < len(depths) - 1)
             for i, (d, h) in enumerate(zip(depths, spec["num_heads"]))])
        for i in OUT_INDICES:
            self.add_module(f"norm{i}", LayerNorm(dim * 2 ** i))
        #: the returned maps' channels
        self.channels: Tuple[int, ...] = tuple(dim * 2 ** i
                                               for i in OUT_INDICES)

    def init_weights(self, g: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, Dense):
                normal_(m.weight, 0.02, g)
                if m.bias is not None:
                    zeros_(m.bias)
            elif isinstance(m, WindowAttention):
                normal_(m.relative_position_bias_table, 0.02, g)

    def forward(self, x: torch.Tensor) -> Sequence[torch.Tensor]:
        x = self.patch_embed(x)
        outs = []
        for i, layer in enumerate(self.layers):
            for block in layer.blocks:
                x = block(x)
            if i in OUT_INDICES:
                y = getattr(self, f"norm{i}")(x)
                outs.append(y.permute(0, 3, 1, 2).contiguous())
            if layer.downsample is not None:
                x = layer.downsample(x)
        return tuple(outs)
