"""The Swin-L configuration's files: the reference backbone's FLOP and site
counts, its weight init and its refusal of another program's backbone,
and the cells of each kind whole at the tiny size on the CPU with the
program's test Swin (`swin_tiny`)."""

import math
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import common
import harness
import tiny
from reference.backbones import swin_L_384_22k as swin
from reference.backbones import swin_tiny

CELL = "cape-swinl.train-update"


@pytest.mark.parametrize("size", [64, 72])
def test_flops_are_the_counted_products_less_the_padded_tokens(size):
    """`flops` counts every product on the real tokens and attention over
    the padded windows; the reference also projects the padded tokens (qkv
    and proj over every window token), which is all the flop counter sees
    more."""
    c = {"image_size": size, "input_channels": 3}
    ref = swin_tiny.build(c)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        ref(torch.zeros(1, 3, size, size))
    padded = sum(
        d * 2.0 * (swin._padded(h) * swin._padded(w) - h * w) * 4 * C * C
        for h, w, C, d in swin.stages(c, swin_tiny.EMBED, swin_tiny.DEPTHS))
    assert fc.get_total_flops() == swin_tiny.flops(c) + padded


def test_real_widths_counts():
    c = common.load_json(f"{common.HERE}/configs/cape-swinl.json")["cape"]
    sites = swin.window_attn(c, 4)
    assert len(sites) == sum(swin.DEPTHS) == 24
    fwd_s = sum(b for b, _, _, _ in sites) / 3.35e12
    bwd_s = sum(b for _, _, b, _ in sites) / 3.35e12
    assert 0.2e-3 < fwd_s < 0.3e-3 and 0.4e-3 < bwd_s < 0.6e-3
    assert all(b / 3.35e12 > f / 989e12 for b, f, _, _ in sites)
    assert math.isclose(swin.flops(c), 2 * 186.46401024e9)
    assert swin.channels(c) == (384, 768, 1536)


def test_init_takes_the_tables_and_refuses_other_backbones():
    z = torch.ones(529, 6)
    init = {"swin_table_std": 0.02}
    assert torch.equal(swin.init(
        "layers.0.blocks.1.attn.relative_position_bias_table", z, init),
        z * 0.02)
    assert swin.init("layers.0.blocks.1.attn.qkv.weight", z, init) is None
    with pytest.raises(SystemExit, match="not a Swin parameter"):
        swin.init("layer1.0.conv1.weight", z, init)


def test_readers_read_nothing_without_a_trace():
    f = tiny.files(CELL, backbone="swin_tiny")
    run = harness.Run(f, 1, 0.01, True, "cpu")
    for name in ("window_attn_fwd_roofline.train",
                 "window_attn_bwd_roofline.train",
                 "window_attn.kernel_share.train"):
        assert common.metric_reader(name)(run) is None


@pytest.mark.bench_dry
@pytest.mark.parametrize("cell", [CELL, "cape-geo.serve-b8",
                                  "cape-geo.eval-kpt"])
def test_every_kind_runs_whole_with_the_test_swin(cell):
    """The Swin cell, and serving (`CAPEPredictor.predict`) and the
    protocol evaluation (`evaluate_cape`) on the program's test Swin,
    whole at the tiny size against the reference."""
    f = tiny.files(cell, backbone="swin_tiny")
    f["config"]["assumed"]["init"].setdefault("swin_table_std", 0.02)
    r = harness.execute(cell, 2 ** 31 + 5, 0.01, False, "cpu",
                        time.perf_counter(), files=f)
    assert r["correct"], r["checks"]
    assert "setup_s" in r["metrics"] and len(r["metrics"]) >= 2
