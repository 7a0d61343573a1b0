"""The program's test backbone: ResNet-50's stages with one bottleneck
each."""

from __future__ import annotations

from typing import Dict

from reference.backbones import resnet50

BLOCKS = (1, 1, 1, 1)
channels, init = resnet50.channels, resnet50.init


def build(c: Dict) -> resnet50.ResNet:
    return resnet50.ResNet(BLOCKS, c["input_channels"])


def flops(c: Dict) -> float:
    return resnet50.resnet_flops(c, BLOCKS)
