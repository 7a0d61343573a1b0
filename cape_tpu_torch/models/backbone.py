"""ResNet-50 backbone with frozen batch-norm: the port of
`cape_tpu.models.backbone`.

The JAX package runs NHWC; this module runs PyTorch's NCHW, and
`CAPE.encode_image` converts once at the input (and flattens the levels
back to the JAX package's row-major `(B, H*W, C)` order). Normalisation
layers are `FrozenAffine`, the inference form of a frozen BN. Returns the
layer2/3/4 feature maps (strides 8/16/32, channels 512/1024/2048).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import he_normal_, ones_, zeros_


class FrozenAffine(nn.Module):
    """Per-channel y = x * scale + bias over NCHW channels."""

    def __init__(self, features: int, zero_init_scale: bool = False):
        super().__init__()
        self.zero_init_scale = zero_init_scale
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def init_weights(self, g: torch.Generator) -> None:
        # zero-init the last affine scale of a bottleneck so a fresh
        # residual block is an identity map
        (zeros_ if self.zero_init_scale else ones_)(self.scale)
        zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale[:, None, None] + self.bias[:, None, None]


def _conv(cin: int, cout: int, kernel: int, stride: int = 1,
          dilation: int = 1) -> nn.Conv2d:
    pad = dilation * (kernel // 2)
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=pad,
                     dilation=dilation, bias=False)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck with frozen-affine norms."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 downsample: bool = False, dilation: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, features, 1)
        self.bn1 = FrozenAffine(features)
        self.conv2 = _conv(features, features, 3, stride, dilation)
        self.bn2 = FrozenAffine(features)
        self.conv3 = _conv(features, features * 4, 1)
        self.bn3 = FrozenAffine(features * 4, zero_init_scale=True)
        if downsample:
            self.downsample_conv = _conv(cin, features * 4, 1, stride)
            self.downsample_bn = FrozenAffine(features * 4)
        else:
            self.downsample_conv = self.downsample_bn = None

    def init_weights(self, g: torch.Generator) -> None:
        for c in (self.conv1, self.conv2, self.conv3, self.downsample_conv):
            if c is not None:
                he_normal_(c.weight, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample_conv is not None:
            identity = self.downsample_bn(self.downsample_conv(x))
        return F.relu(out + identity)


class ResNet50(nn.Module):
    """(B, C, H, W) -> (layer2, layer3, layer4) feature maps, NCHW."""

    def __init__(self, input_channels: int = 3,
                 block_counts: Sequence[int] = (3, 4, 6, 3),
                 dilation: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(input_channels, 64, 7, stride=2, padding=3,
                               bias=False)
        self.bn1 = FrozenAffine(64)
        widths = (64, 128, 256, 512)
        cin = 64
        layers = []
        for li, (count, width) in enumerate(zip(block_counts, widths)):
            # DC5: layer4 keeps stride 16 with dilated 3x3 convs; as in
            # torchvision's replace_stride_with_dilation, the layer's first
            # block keeps dilation 1 with stride 1, later blocks dilate by 2
            dilate_layer = dilation and li == 3
            stride = 1 if (li == 0 or dilate_layer) else 2
            blocks = []
            for bi in range(count):
                blocks.append(Bottleneck(
                    cin, width, stride=stride if bi == 0 else 1,
                    downsample=(bi == 0),
                    dilation=2 if (dilate_layer and bi > 0) else 1))
                cin = width * 4
            layers.append(nn.Sequential(*blocks))
        self.layer1, self.layer2, self.layer3, self.layer4 = layers

    def init_weights(self, g: torch.Generator) -> None:
        he_normal_(self.conv1.weight, g)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        x = self.layer1(x)
        c3 = self.layer2(x)
        c4 = self.layer3(c3)
        c5 = self.layer4(c4)
        return c3, c4, c5
