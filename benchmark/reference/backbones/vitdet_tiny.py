"""The program's test backbone: ViTDet-L's blocks and pyramid (heads of 64
channels, decomposed relative-position bias, window and global blocks) at
embed 128, 2 heads, 4 blocks of which 1 and 3 are global, windows of 3,
tables for a 64-px input and a 32-px pretraining grid."""

from __future__ import annotations

from typing import Dict, Tuple

from reference.backbones import vitdet_l as vitdet

SPEC = dict(dim=128, depth=4, heads=2, window=3, global_blocks=(1, 3),
            img_size=64, pretrain_img_size=32)
init = vitdet.init


def build(c: Dict) -> vitdet.ViTDet:
    return vitdet.ViTDet(c, **SPEC)


def channels(c: Dict) -> Tuple[int, int, int]:
    return vitdet.channels(c)


def flops(c: Dict) -> float:
    return vitdet.vitdet_flops(c, SPEC)


def rel_attn(c: Dict, images: int):
    return vitdet.rel_attn_sites(c, SPEC, images)
