"""Tiny sizes of every cell, for the CPU tests: the cell's files, found by
name as a run finds them, with the configuration cut to the program's test
size and the traffic's pools cut to a few items (the mix's own `tiny`
parameters)."""

from __future__ import annotations

import copy
from typing import Dict

import common

#: the program's test configuration (every feature on, toy widths)
TINY = dict(image_size=64, hidden_dim=64, dim_feedforward=128, enc_layers=2,
            dec_layers=2, nheads=4, seq_len=24, vocab_size=100,
            max_support_keypoints=12, max_skeleton_edges=16,
            support_encoder_layers=1, num_gcn_layers=1, accumulation_steps=2,
            warmup_epochs=0, min_decode_len=2, bf16=False,
            backbone="resnet_tiny")


def files(cell_name: str, **config) -> Dict:
    f = copy.deepcopy(common.cell_files(cell_name))
    f["config"]["cape"].update(TINY, **config)
    f["traffic"].update(f["traffic"]["tiny"])
    return f
