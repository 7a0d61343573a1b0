"""ResNet-50 (He et al., 2016, arXiv:1512.03385) with frozen affines in
place of batch norm, as the program's backbone: bottleneck blocks
(3, 4, 6, 3) of widths 64-512, C3-C5 at strides 8, 16 and 32."""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from reference.model import Conv2d

BLOCKS = (3, 4, 6, 3)
WIDTHS = (64, 128, 256, 512)


class Affine(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return x * self.scale[:, None, None] + self.bias[:, None, None]


class Bottleneck(nn.Module):
    def __init__(self, cin: int, width: int, stride: int, down: bool):
        super().__init__()
        self.conv1 = Conv2d(cin, width, 1, bias=False)
        self.bn1 = Affine(width)
        self.conv2 = Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = Affine(width)
        self.conv3 = Conv2d(width, width * 4, 1, bias=False)
        self.bn3 = Affine(width * 4)
        if down:
            self.downsample_conv = Conv2d(cin, width * 4, 1, stride,
                                          bias=False)
            self.downsample_bn = Affine(width * 4)
        else:
            self.downsample_conv = self.downsample_bn = None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        idt = x if self.downsample_conv is None else \
            self.downsample_bn(self.downsample_conv(x))
        return F.relu(out + idt)


class ResNet(nn.Module):
    def __init__(self, blocks: Sequence[int], cin: int = 3):
        super().__init__()
        self.conv1 = Conv2d(cin, 64, 7, 2, 3, bias=False)
        self.bn1 = Affine(64)
        c = 64
        for li, (n, w) in enumerate(zip(blocks, WIDTHS)):
            stride = 1 if li == 0 else 2
            layer = []
            for bi in range(n):
                layer.append(Bottleneck(c, w, stride if bi == 0 else 1,
                                        bi == 0))
                c = w * 4
            setattr(self, f"layer{li + 1}", nn.Sequential(*layer))

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        x = self.layer1(x)
        c3 = self.layer2(x)
        c4 = self.layer3(c3)
        return c3, c4, self.layer4(c4)


def _conv(cin, cout, k, hw_out) -> float:
    return 2.0 * cin * cout * k * k * hw_out


def resnet_flops(c: Dict, blocks: Sequence[int]) -> float:
    """One image through a ResNet of `blocks` bottlenecks a stage (the
    stem, every convolution; pooling and affines left out)."""
    S = c["image_size"]
    f = _conv(c["input_channels"], 64, 7, (S // 2) ** 2)
    size, cin = S // 4, 64
    for li, (n, w) in enumerate(zip(blocks, WIDTHS)):
        for bi in range(n):
            stride = 2 if (bi == 0 and li > 0) else 1
            out = size // stride
            f += _conv(cin, w, 1, size * size)
            f += _conv(w, w, 3, out * out)
            f += _conv(w, 4 * w, 1, out * out)
            if bi == 0:
                f += _conv(cin, 4 * w, 1, out * out)
            size, cin = out, 4 * w
    return f


def build(c: Dict) -> ResNet:
    return ResNet(BLOCKS, c["input_channels"])


def channels(c: Dict) -> Tuple[int, int, int]:
    return tuple(4 * w for w in WIDTHS[1:])


def flops(c: Dict) -> float:
    return resnet_flops(c, BLOCKS)


def init(name: str, z: torch.Tensor, init: Dict) -> Optional[torch.Tensor]:
    """Each bottleneck's last affine scale is the configuration's
    `init["bottleneck_last_scale"]`; the rest by the generic rules."""
    if name.endswith("bn3.scale"):
        return torch.full(z.shape, init["bottleneck_last_scale"],
                          device=z.device)
    return None
