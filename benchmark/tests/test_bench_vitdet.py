"""The ViTDet-L configuration's files: the reference backbone's FLOP and
site counts, its weight init and its refusal of another program's
backbone, the readers without a trace, and the cells of each kind whole
at the tiny size on the CPU with the program's test ViTDet
(`vitdet_tiny`)."""

import math
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import common
import harness
import tiny
from reference.backbones import vitdet_l as vit
from reference.backbones import vitdet_tiny

CELL = "cape-vitdetl.train-update"


@pytest.mark.parametrize("size", [64, 96])
def test_flops_are_the_counted_products_less_the_padded_tokens(size):
    """`flops` counts every product on the real tokens, attention and the
    bias products over the padded windows and the pyramid; the reference
    also projects the padded tokens (qkv and proj over every window
    token), which is all the flop counter sees more."""
    c = {"image_size": size, "input_channels": 3}
    ref = vitdet_tiny.build(c)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        ref(torch.zeros(1, 3, size, size))
    g = size // vit.PATCH
    C = vitdet_tiny.SPEC["dim"]
    padded = sum(2.0 * (npad - g * g) * 4 * C * C
                 for _, _, npad, _ in vit._sites(c, vitdet_tiny.SPEC))
    assert fc.get_total_flops() == pytest.approx(vitdet_tiny.flops(c)
                                                 + padded, rel=1e-12)


def test_real_widths_counts():
    c = common.load_json(f"{common.HERE}/configs/cape-vitdetl.json")["cape"]
    sites = vit.rel_attn(c, 4)
    assert len(sites) == vit.DEPTH == 24
    glob = [s for i, s in enumerate(sites) if i in vit.GLOBAL_BLOCKS]
    assert len(glob) == 4 and all(s == glob[0] for s in glob)
    # a global site is bound by the products, a windowed one by bytes
    assert glob[0][1] / 989e12 > glob[0][0] / 3.35e12
    assert sites[0][0] / 3.35e12 > sites[0][1] / 989e12
    assert math.isclose(vit.flops(c) / 1e12, 2.8933, rel_tol=1e-4)
    assert vit.channels(c) == (256, 256, 256)


def test_init_takes_the_tables_and_refuses_other_backbones():
    z = torch.ones(127, 64)
    init = {"vitdet_table_std": 0.02, "vitdet_pos_std": 0.05}
    assert torch.equal(vit.init("net.blocks.5.attn.rel_pos_h", z, init),
                       z * 0.02)
    assert torch.equal(vit.init("net.pos_embed", z, init), z * 0.05)
    assert vit.init("net.blocks.5.attn.qkv.weight", z, init) is None
    assert vit.init("simfp_3.0.weight", z, init) is None
    with pytest.raises(SystemExit, match="not a ViTDet parameter"):
        vit.init("layers.0.blocks.1.attn.qkv.weight", z, init)


def test_readers_read_nothing_without_a_trace():
    f = tiny.files(CELL, backbone="vitdet_tiny")
    run = harness.Run(f, 1, 0.01, True, "cpu")
    for name in ("rel_attn_fwd_roofline.train",
                 "rel_attn_bwd_roofline.train",
                 "rel_attn.kernel_share.train"):
        assert common.metric_reader(name)(run) is None


@pytest.mark.bench_dry
@pytest.mark.parametrize("cell", [CELL, "cape-geo.serve-b8",
                                  "cape-geo.eval-kpt"])
def test_every_kind_runs_whole_with_the_test_vitdet(cell):
    """The ViTDet cell, and serving (`CAPEPredictor.predict`) and the
    protocol evaluation (`evaluate_cape`) on the program's test ViTDet,
    whole at the tiny size against the reference."""
    f = tiny.files(cell, backbone="vitdet_tiny")
    f["config"]["assumed"]["init"].setdefault("vitdet_table_std", 0.02)
    f["config"]["assumed"]["init"].setdefault("vitdet_pos_std", 0.02)
    r = harness.execute(cell, 2 ** 31 + 5, 0.01, False, "cpu",
                        time.perf_counter(), files=f)
    assert r["correct"], r["checks"]
    assert "setup_s" in r["metrics"] and len(r["metrics"]) >= 2
