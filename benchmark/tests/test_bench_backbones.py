"""Backbones chosen by the configuration's `backbone` key
(`reference/backbones/<backbone>.py`): a new one enters as a new file and
a configuration that names it, with no other file changed; an unknown one
stops the run naming the file looked for; the shipped ones keep the
parameter layout, FLOPs, weights and reference outputs that the harness
gave before backbones were files (the values below)."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

import check as checks
import common
import counts
import tiny
import traffic
from conftest import BENCH, ROOT

#: before backbones were files: the real widths' (name:shape) layout
#: (sha256 of the lines), its leaf and element counts, and the FLOPs
PARENT = {
    "cape-geo": dict(
        leaves=616, params=46633966,
        sha="3b858ad16dabeb844706718ae35c2f450ffdf0fd38b164a918f30b8cc4135bbd",
        image_flops=94388617216.0, train_update_flops=4959525470208.0,
        decode_flops_8_7=796329447424.0, decode_flops_8_17=797800935424.0),
    "cape-legacy": dict(
        leaves=617, params=46503150,
        sha="d4df6b3b631c46e0a7234a0ad0bc0dc515a0c6c390214e2d7810998c71258c62",
        image_flops=94388617216.0, train_update_flops=4957284139008.0,
        decode_flops_8_7=795955892224.0, decode_flops_8_17=797427380224.0),
}
#: before backbones were files, at the tiny size: the weights of seed
#: 2**33 + 5 (sha256 of names and bytes) and sums of the reference's
#: teacher-forced classes and coordinates on the batch of `_tiny_batch`
PARENT_TINY = {
    "cape-geo.train-update": dict(
        weights="4089b163c0d28a254296bdabb4c2fa6e79ee93a02e1eca157b7ddb43"
                "ca13279a",
        cls_sum=-30.384544904343784, cls_abs=193.99038771353662,
        refs_sum=89.31792947649956),
    "cape-legacy.eval-kpt": dict(
        weights="c17b3b1c44a5f3a83c1a8bb22da8e827982684144a0ee0a677e32f61"
                "6bf450e9",
        cls_sum=-811.4306917190552, cls_abs=2536.9193258285522,
        refs_sum=84.63223838806152),
}
SEQ = ("seq11", "seq12", "seq21", "seq22", "delta_x1", "delta_x2",
       "delta_y1", "delta_y2")


def _config(name):
    return common.load_json(os.path.join(BENCH, "configs",
                                         name + ".json"))["cape"]


@pytest.mark.parametrize("name", sorted(PARENT))
def test_real_widths_keep_layout_and_flops(name):
    c, want = _config(name), PARENT[name]
    shapes = checks.param_shapes(c)
    lines = "\n".join(f"{k}:{tuple(v)}" for k, v in shapes.items())
    assert len(shapes) == want["leaves"]
    assert sum(v.numel() for v in shapes.values()) == want["params"]
    assert hashlib.sha256(lines.encode()).hexdigest() == want["sha"]
    assert counts.image_flops(c) == want["image_flops"]
    assert counts.train_update_flops(c, 4) == want["train_update_flops"]
    assert counts.decode_flops(c, 8, 7) == want["decode_flops_8_7"]
    assert counts.decode_flops(c, 8, 17) == want["decode_flops_8_17"]


def _tiny_batch(f, c):
    t = dict(f["traffic"], kind="train", episodes=1, queries=2, pool=1,
             keypoints=[[3, 1], [5, 1]], jitter=0.03, unlabeled=0.1, block=8)
    b = traffic.train(t, c, 7)[0]
    x = {k: torch.as_tensor(v) for k, v in b.items() if k != "targets"}
    seq = {k: torch.as_tensor(b["targets"][k]) for k in SEQ}
    seq = {k: v.long() if k.startswith("seq") else v for k, v in seq.items()}
    return (x["query_images"], x["support_coords"], x["support_mask"],
            x["skeleton_edges"], seq)


@pytest.mark.parametrize("cell", sorted(PARENT_TINY))
def test_tiny_weights_and_outputs_unchanged(cell):
    f, want = tiny.files(cell), PARENT_TINY[cell]
    c = f["config"]["cape"]
    init = dict(f["config"]["assumed"]["init"], **f["traffic"]["init"])
    w = common.make_weights(checks.param_shapes(c), c, init, 2 ** 33 + 5,
                            "cpu")
    h = hashlib.sha256()
    for k, v in w.items():
        h.update(k.encode())
        h.update(v.numpy().tobytes())
    assert h.hexdigest() == want["weights"]
    ref = checks.reference(c, w, "cpu")
    with torch.no_grad():
        cls, refs = ref(*_tiny_batch(f, c))
    # the same weights and the same arithmetic: equal but for the order
    # of a sum the CPU's kernels may choose
    assert float(cls.double().sum()) == pytest.approx(want["cls_sum"],
                                                      rel=1e-6)
    assert float(cls.double().abs().sum()) == pytest.approx(want["cls_abs"],
                                                            rel=1e-6)
    assert float(refs.double().sum()) == pytest.approx(want["refs_sum"],
                                                       rel=1e-6)


@pytest.mark.parametrize("entry", ["param_shapes", "make_weights",
                                   "image_flops"])
def test_unknown_backbone_names_the_file(entry):
    c = dict(tiny.files("cape-geo.serve-b8")["config"]["cape"],
             backbone="no_such_net")
    call = {"param_shapes": lambda: checks.param_shapes(c),
            "make_weights": lambda: common.make_weights(
                {"backbone.conv1.weight": (2, 3, 1, 1)}, c, {}, 1, "cpu"),
            "image_flops": lambda: counts.image_flops(c)}[entry]
    path = os.path.join(BENCH, "reference", "backbones", "no_such_net.py")
    with pytest.raises(SystemExit, match=path.replace(".", r"\.")):
        call()


TOY = '''"""A toy backbone: three strided convolutions and a gain."""

import torch
import torch.nn as nn
import torch.nn.functional as F

from reference.model import Conv2d


class Toy(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.stem = Conv2d(cin, 16, 8, 8)
        self.down1 = Conv2d(16, 24, 2, 2)
        self.down2 = Conv2d(24, 40, 2, 2)
        self.gain = nn.Parameter(torch.ones(40))

    def forward(self, x):
        c3 = F.relu(self.stem(x))
        c4 = F.relu(self.down1(c3))
        return c3, c4, self.down2(c4) * self.gain[:, None, None]


def build(c):
    return Toy(c["input_channels"])


def channels(c):
    return (16, 24, 40)


def flops(c):
    S = c["image_size"]
    return 2.0 * (c["input_channels"] * 16 * 64 * (S // 8) ** 2
                  + 16 * 24 * 4 * (S // 16) ** 2
                  + 24 * 40 * 4 * (S // 32) ** 2)


def init(name, z, init):
    return torch.full(z.shape, init["toy_gain"]) if name == "gain" else None
'''

PROBE = '''
import json, os, sys
sys.path[:0] = [{bench!r}, {root!r}]
import torch
from torch.utils.flop_counter import FlopCounterMode
import check, common, counts, tiny
conf = common.load_json(os.path.join({bench!r}, "configs", "toy.json"))
c = dict(conf["cape"], **dict(tiny.TINY, backbone=conf["cape"]["backbone"]))
init = dict(conf["assumed"]["init"], class_bias=[0.0, 0.0, 0.0])
shapes = check.param_shapes(c)
w = common.make_weights(shapes, c, init, 11, "cpu")
ref = check.reference(c, w, "cpu")
q = check.reference(c, w, "cpu", torch.float8_e4m3fn)
imgs = torch.zeros(1, c["image_size"], c["image_size"], 3, dtype=torch.uint8)
with torch.no_grad(), FlopCounterMode(display=False) as m:
    memory = ref.encode_image(imgs)
print(json.dumps({{
    "files": [m_.__file__ for m_ in (check, common, counts)],
    "backbone": sorted(k for k in shapes if k.startswith("backbone.")),
    "gain": sorted(set(w["backbone.gain"].tolist())),
    "stem_std": float(w["backbone.stem.weight"].std()),
    "memory": list(memory.shape),
    "counted": float(m.get_total_flops()),
    "image_flops": counts.image_flops(c),
    "control": str(q.backbone.stem.qdtype)}}))
'''


def test_a_backbone_enters_as_new_files(tmp_path):
    """In a copy of the benchmark, a toy backbone's file and a
    configuration that names it are the only files added: the reference,
    the parameter shapes, the weights (its `init` and the generic rules),
    the FLOP count and the control all take it."""
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    (bench / "reference" / "backbones" / "toy.py").write_text(TOY)
    conf = common.load_json(os.path.join(BENCH, "configs", "cape-geo.json"))
    conf["cape"]["backbone"] = "toy"
    conf["assumed"]["init"]["toy_gain"] = 0.5
    (bench / "configs" / "toy.json").write_text(json.dumps(conf))
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(bench=str(bench),
                                            root=str(tmp_path))],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.splitlines()[-1])
    assert all(p.startswith(str(bench)) for p in got["files"])
    assert got["backbone"] == [
        "backbone.down1.bias", "backbone.down1.weight", "backbone.down2.bias",
        "backbone.down2.weight", "backbone.gain", "backbone.stem.bias",
        "backbone.stem.weight"]
    assert got["gain"] == [0.5]
    # He-normal by the generic rule: fan_in 3 x 8 x 8
    assert got["stem_std"] == pytest.approx((2 / 192) ** 0.5, rel=0.1)
    d = tiny.TINY["hidden_dim"]
    assert got["memory"] == [1, 8 * 8 + 4 * 4 + 2 * 2 + 1, d]
    assert got["image_flops"] == pytest.approx(got["counted"], rel=1e-9)
    assert got["control"] == "torch.float8_e4m3fn"
