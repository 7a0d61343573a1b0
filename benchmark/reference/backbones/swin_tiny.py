"""The program's test backbone: Swin-L's blocks (window 12, 32 channels a
head) at embed 32, two blocks a stage, heads 1/2/4/8."""

from __future__ import annotations

from typing import Dict, Tuple

from reference.backbones import swin_L_384_22k as swin

EMBED = 32
DEPTHS = (2, 2, 2, 2)
HEADS = (1, 2, 4, 8)
init = swin.init


def build(c: Dict) -> swin.SwinTransformer:
    return swin.swin(c, EMBED, DEPTHS, HEADS)


def channels(c: Dict) -> Tuple[int, int, int]:
    return tuple(EMBED * 2 ** i for i in swin.OUT_INDICES)


def flops(c: Dict) -> float:
    return swin.swin_flops(c, EMBED, DEPTHS)


def window_attn(c: Dict, images: int):
    return swin.window_attn_sites(c, EMBED, DEPTHS, HEADS, images)
