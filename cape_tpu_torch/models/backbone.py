"""ResNet-50 backbone with frozen batch-norm: the port of
`cape_tpu.models.backbone`.

The JAX package runs NHWC; this module runs PyTorch's NCHW, and
`CAPE.encode_image` converts once at the input (and flattens the levels
back to the JAX package's row-major `(B, H*W, C)` order). Normalisation
layers are `FrozenAffine`, the inference form of a frozen BN. Returns the
layer2/3/4 feature maps (strides 8/16/32, channels 512/1024/2048).

`load_torch_resnet50_state` / `_npz` fold a torchvision resnet50
state_dict (ImageNet weights) into the backbone: BN folds into each
`FrozenAffine`, and the convs, already OIHW, are copied as they are.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
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
        #: the returned maps' channels
        self.channels = tuple(4 * w for w in widths[1:])

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


def resnet50_state_from_torchvision(backbone: ResNet50,
                                    sd: Mapping[str, np.ndarray]
                                    ) -> Dict[str, torch.Tensor]:
    """The fp32 values a torchvision resnet50 state_dict ({key: array})
    gives `backbone`'s parameters, by the backbone's own names.

    Keys like 'conv1.weight', 'layer1.0.conv1.weight',
    'layer1.0.bn1.{weight,bias,running_mean,running_var}',
    'layer1.0.downsample.{0,1}.*'. BN folds to scale = w/sqrt(var+eps),
    bias = b - mean*scale with eps 1e-5, in the arrays' own dtype as the
    JAX package folds (`cape_tpu.models.backbone.load_torch_resnet50_state`).
    `conv1` is taken only where its input channels match the backbone's
    (a 3-channel checkpoint leaves another `input_channels`' stem as it
    is); a block without `downsample.*` keys keeps its downsample.
    """
    eps = 1e-5
    out: Dict[str, torch.Tensor] = {}

    def conv(name, key):
        out[f"{name}.weight"] = torch.from_numpy(
            np.asarray(sd[key], dtype=np.float32).copy())

    def bn(name, prefix):
        w, b = sd[f"{prefix}.weight"], sd[f"{prefix}.bias"]
        rm, rv = sd[f"{prefix}.running_mean"], sd[f"{prefix}.running_var"]
        scale = w / np.sqrt(rv + eps)
        out[f"{name}.scale"] = torch.from_numpy(scale.astype(np.float32))
        out[f"{name}.bias"] = torch.from_numpy(
            (b - rm * scale).astype(np.float32))

    if sd["conv1.weight"].shape[1] == backbone.conv1.weight.shape[1]:
        conv("conv1", "conv1.weight")
    bn("bn1", "bn1")
    for li in range(4):
        for bi in range(len(getattr(backbone, f"layer{li + 1}"))):
            t = f"layer{li + 1}.{bi}"
            for c in ("conv1", "conv2", "conv3"):
                conv(f"{t}.{c}", f"{t}.{c}.weight")
            for n in ("bn1", "bn2", "bn3"):
                bn(f"{t}.{n}", f"{t}.{n}")
            if f"{t}.downsample.0.weight" in sd:
                conv(f"{t}.downsample_conv", f"{t}.downsample.0.weight")
                bn(f"{t}.downsample_bn", f"{t}.downsample.1")
    params = dict(backbone.named_parameters())
    for name, value in out.items():
        if tuple(value.shape) != tuple(params[name].shape):
            raise ValueError(f"torchvision weights for {name!r}: shape "
                             f"{tuple(value.shape)}, the backbone's "
                             f"{tuple(params[name].shape)}")
    return out


def load_torch_resnet50_state(backbone: ResNet50,
                              sd: Mapping[str, np.ndarray]
                              ) -> Dict[str, torch.Tensor]:
    """Fold a torchvision resnet50 state_dict into `backbone` in place (its
    parameters take the values cast to their dtype); returns the fp32
    values by the backbone's names, which training keeps as the masters
    (`train.create_train_state(..., masters=...)`)."""
    values = resnet50_state_from_torchvision(backbone, sd)
    params = dict(backbone.named_parameters())
    with torch.no_grad():
        for name, value in values.items():
            params[name].copy_(value)
    return values


def load_torch_resnet50_npz(backbone: ResNet50, npz_path: str
                            ) -> Dict[str, torch.Tensor]:
    """`load_torch_resnet50_state` from a state_dict saved as `.npz`."""
    with np.load(npz_path) as z:
        return load_torch_resnet50_state(backbone, dict(z))
