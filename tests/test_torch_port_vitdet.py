"""The port's ViTDet backbone (`cape_tpu_torch/models/vitdet.py`) and its
attention with decomposed relative-position bias
(`cape_tpu_torch/ops/rel_attn.py`) against the benchmark's plain float32
reference (`benchmark/reference/backbones/vitdet_l.py`), which follows
detectron2's `modeling/backbone/vit.py` and `utils.py` (window_partition
with zero padding, get_rel_pos, add_decomposed_rel_pos, get_abs_pos,
SimpleFeaturePyramid): fp32 on the CPU, seeded weights, no JAX.

The attention kernels run on the card only; here `rel_attention` takes its
plain version, whose index maps (`_window_maps`) and bias products (each
query against every table row, the entry at qy - ky + S - 1 gathered) are
the arithmetic the kernels do.

Tolerances: fp32 against fp32, the same function computed in another
order (gathers and an index scatter against pad and partition; the bias
as q against every table row, then gathered, against the table's rows
gathered first and an einsum; the transposed convolution as a product
and depth to space against the library's): outputs and gradients within
2e-5 of the largest magnitude of the compared tensor; the training step's
loss terms, through the whole tiny model and its optimizer, within 1e-4
relative.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import sys

import pytest
import torch
import torch.nn.functional as F

from cape_tpu_torch import trace
from cape_tpu_torch.config import tiny_test_config
from cape_tpu_torch.models.cape import BACKBONES, CAPE
from cape_tpu_torch.models.vitdet import VITDET, ViTDet
from cape_tpu_torch.ops import rel_attn as ra

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
# appended, never prepended: benchmark/trace.py would shadow the standard
# library's `trace`
if BENCH not in sys.path:
    sys.path.append(BENCH)

from reference.backbones import vitdet_l as ref_vit  # noqa: E402
from reference.backbones import vitdet_tiny as ref_tiny  # noqa: E402
from reference.model import RefCAPE  # noqa: E402

RTOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def close(got, want, what, rtol=RTOL):
    scale = want.abs().max().clamp(min=1e-12)
    gap = (got - want).abs().max()
    assert gap <= rtol * scale, f"{what}: gap {gap:.3g} of {scale:.3g}"


def seeded_(module: torch.nn.Module, seed: int) -> None:
    """Every parameter drawn from a seeded normal: kernels at 1/sqrt(fan
    in), biases, norms, tables and the position embedding at 0.3 (so that
    the padded tokens' qkv bias, the tables and the norms all matter)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in sorted(module.named_parameters()):
            z = torch.randn(p.shape, generator=g)
            if p.dim() >= 2 and "rel_pos" not in name \
                    and "pos_embed" not in name:
                fan = p[0].numel() if "simfp_3.0" not in name \
                    else p.shape[0]
                p.copy_(z / fan ** 0.5)
            elif name.endswith("weight"):
                p.copy_(1.0 + 0.3 * z)
            else:
                p.copy_(0.3 * z)


def test_reference_imports_nothing_of_the_port():
    for mod in (ref_vit, ref_tiny):
        tree = ast.parse(open(mod.__file__).read())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names]
        names += [n.module or "" for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom)]
        assert not [n for n in names if n.startswith(("cape_tpu", "jax"))]


def test_real_widths_names_and_shapes_agree():
    """vitdet_l at its published widths, built on the meta device: the
    port's parameter names and shapes are the reference's (detectron2's)."""
    c = {"input_channels": 3, "image_size": 1024}
    with torch.device("meta"):
        port = ViTDet("vitdet_l")
        ref = ref_vit.build(c)
    mine = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    theirs = {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    assert mine == theirs
    assert sum(v.numel() for v in port.parameters()) == 307_958_272
    assert port.channels == ref_vit.channels(c) == (256, 256, 256)
    spec = VITDET["vitdet_l"]
    assert (spec["embed_dim"], spec["depth"], spec["num_heads"],
            spec["window"], spec["global_blocks"]) == (
                1024, 24, 16, 14, (5, 11, 17, 23))
    assert mine["net.pos_embed"] == (1, 197, 1024)
    assert mine["net.blocks.5.attn.rel_pos_h"] == (127, 64)
    assert mine["net.blocks.4.attn.rel_pos_w"] == (27, 64)
    assert mine["simfp_3.0.weight"] == (1024, 512, 2, 2)
    for name in ("net.patch_embed.proj.bias", "net.blocks.23.mlp.fc2.weight",
                 "simfp_4.0.norm.weight", "simfp_5.2.norm.bias",
                 "simfp_3.0.bias"):
        assert name in mine, name
    assert "simfp_4.0.bias" not in mine and "simfp_2.0.weight" not in mine


def _reference_attention(attn, x, window):
    """The reference block's attention part on normed tokens x (B, H, W, C):
    zero-pad and partition, attend, unpartition and crop."""
    B, H, W, C = x.shape
    if not window:
        return attn(x)
    win, pad_hw = ref_vit.window_partition(x, window)
    return ref_vit.window_unpartition(attn(win), window, pad_hw, (H, W))


@pytest.mark.parametrize("case", [
    # (H, W, window, table rows or None for 2 * side - 1)
    (5, 7, 3, None),        # windows, the grid padded to 6 x 9
    (4, 4, 0, None),        # global
    (3, 5, 0, None),        # global, not square
    (6, 6, 0, (7, 9)),      # global, both tables resampled (11 rows)
    (5, 7, 3, (3, 7)),      # windows, both tables resampled (5 rows)
])
def test_plain_rel_attention_against_the_reference(case):
    """`rel_attention` (the plain version on the CPU) with the block's qkv
    and proj around it, against the reference's partition /
    add_decomposed_rel_pos formulation, non-zero tables: outputs and the
    gradients of the tokens, qkv's weight and bias, both tables and
    proj."""
    H, W, window, rows = case
    heads, C = 2, 128
    ref = ref_vit.Attention(C, heads, window or max(H, W))
    if rows is not None:
        ref.rel_pos_h = torch.nn.Parameter(torch.zeros(rows[0], C // heads))
        ref.rel_pos_w = torch.nn.Parameter(torch.zeros(rows[1], C // heads))
    seeded_(ref, H * 10 + W)
    g = torch.Generator().manual_seed(H * 100 + W + window)
    x = torch.randn(2, H, W, C, generator=g)
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    params = {k: v.detach().clone().requires_grad_()
              for k, v in ref.named_parameters()}
    qkv = F.linear(xa, params["qkv.weight"], params["qkv.bias"])
    out = F.linear(ra.rel_attention(
        qkv, params["qkv.bias"], params["rel_pos_h"], params["rel_pos_w"],
        heads, window), params["proj.weight"], params["proj.bias"])
    want = _reference_attention(ref, xb, window)
    close(out, want, "output")
    cot = torch.randn(out.shape, generator=g)
    (out * cot).sum().backward()
    (want * cot).sum().backward()
    close(xa.grad, xb.grad, "tokens")
    for name, p in ref.named_parameters():
        close(params[name].grad, p.grad, name)


@pytest.mark.parametrize("case", [(5, 7, 3), (4, 4, 0), (16, 16, 14),
                                  (64, 64, 0), (20, 40, 0)])
def test_kernel_geometry(case):
    """The kernels' slots: whole slot rows of 16, 32 or 64, tiles of 128
    slots holding whole slot rows, every window row inside and less than
    a tile past the last."""
    H, W, window = case
    nW, slots = ra.geometry(H, W, window)
    Sh, Sw = ra.sides(H, W, window)
    swp = max(16, 1 << (Sw - 1).bit_length())
    assert nW == -(-H // Sh) * -(-W // Sw)
    assert slots % ra.TILE == 0 and ra.TILE % swp == 0
    assert Sh <= slots // swp < Sh + ra.TILE // swp
    if case == (64, 64, 0):
        assert (nW, slots) == (1, 4096)
    if case == (16, 16, 14):
        assert (nW, slots) == (4, 256)


@pytest.mark.parametrize("case", [(5, 7, 3), (16, 16, 14), (64, 64, 14),
                                  (4, 4, 0), (20, 40, 0)])
def test_window_maps_are_the_reference_partition(case):
    """The index maps the kernels and the plain version read by: each
    window's tokens in the order of the reference's zero-padded
    `window_partition` (a padded token -1), the whole grid in row order
    for a global block, and each token's row and column in its window."""
    H, W, window = case
    src, rows, cols = ra._window_maps(H, W, window)
    Sh, Sw = ra.sides(H, W, window)
    pos = torch.arange(1, H * W + 1).reshape(1, H, W, 1)
    if window:
        win, _ = ref_vit.window_partition(pos, window)
        want = win.reshape(-1, Sh * Sw) - 1
    else:
        want = pos.reshape(1, H * W) - 1
    assert torch.equal(src, want)
    assert src.shape[0] == ra.geometry(H, W, window)[0]
    ys, xs = torch.meshgrid(torch.arange(Sh), torch.arange(Sw),
                            indexing="ij")
    assert torch.equal(rows, ys.reshape(-1))
    assert torch.equal(cols, xs.reshape(-1))


@pytest.mark.parametrize("size", [64, 96])
def test_backbone_maps_and_every_gradient(size):
    """vitdet_tiny at 64 px (4 x 4 tokens: windows of 3 padded to 6 x 6,
    the 2 x 2 pretraining grid resized) and 96 px (6 x 6 tokens: the
    global blocks' 7-row tables resampled to 11): the three maps and every
    parameter's gradient."""
    c = {"input_channels": 3, "image_size": size}
    port = ViTDet("vitdet_tiny")
    ref = ref_tiny.build(c)
    seeded_(port, 3)
    ref.load_state_dict(port.state_dict(), strict=True)
    g = torch.Generator().manual_seed(size)
    x = torch.randn(2, 3, size, size, generator=g)
    mine, theirs = port(x), ref(x)
    assert [tuple(t.shape) for t in mine] == [
        (2, 256, size // 8, size // 8), (2, 256, size // 16, size // 16),
        (2, 256, size // 32, size // 32)]
    assert [tuple(t.shape) for t in mine] == [tuple(t.shape) for t in theirs]
    for i, (a, b) in enumerate(zip(mine, theirs)):
        close(a, b, f"stride {8 << i}")
    cots = [torch.randn(t.shape, generator=g) for t in theirs]
    sum((a * w).sum() for a, w in zip(mine, cots)).backward()
    sum((b * w).sum() for b, w in zip(theirs, cots)).backward()
    ref_params = dict(ref.named_parameters())
    for name, p in port.named_parameters():
        close(p.grad, ref_params[name].grad, name)


def test_training_step_loss_against_the_reference():
    """A whole tiny CAPE training step with `vitdet_tiny`:
    `train.make_train_step` on the benchmark's seeded weights and one
    training batch, against the reference's forward and criterion on the
    same weights and batch (dropout off): every loss term."""
    import common
    import traffic
    from reference.train import criterion
    from cape_tpu_torch.data.prefetch import to_device
    from cape_tpu_torch.train import create_train_state, make_train_step
    cfg = tiny_test_config(backbone="vitdet_tiny", dropout=0.0)
    c = dataclasses.asdict(cfg)
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in RefCAPE(c).state_dict().items()}
    init = {"bottleneck_last_scale": 0.2, "coords_head_last_scale": 0.5,
            "class_bias": [0.0, 0.0, 0.0], "vitdet_table_std": 0.02,
            "vitdet_pos_std": 0.02}
    w = common.make_weights(shapes, c, init, 2 ** 33 + 5, "cpu")
    model = CAPE(cfg, device="cpu")
    model.load_state_dict(w, strict=True)
    ref = RefCAPE(c)
    ref.load_state_dict(w, strict=True)
    t = dict(kind="train", episodes=1, queries=2, pool=1, block=8,
             keypoints=[[3, 1], [5, 1]], jitter=0.03, unlabeled=0.1)
    batch = traffic.train(t, c, 7)[0]
    state = create_train_state(cfg, model, 10, masters=w)
    step = make_train_step(model, cfg, 10)
    _, m = step(state, to_device(batch, torch.device("cpu")), None)
    tg = {k: torch.as_tensor(v) for k, v in batch["targets"].items()}
    seq = {k: tg[k].long() if k.startswith("seq") else tg[k]
           for k in ("seq11", "seq12", "seq21", "seq22", "delta_x1",
                     "delta_x2", "delta_y1", "delta_y2")}
    classes, refs = ref(torch.as_tensor(batch["query_images"]),
                        torch.as_tensor(batch["support_coords"]),
                        torch.as_tensor(batch["support_mask"]),
                        torch.as_tensor(batch["skeleton_edges"]), seq)
    terms = criterion(classes, refs, tg, c)
    names = [k for k in terms if k != "total"]
    assert len(names) == 2 * cfg.dec_layers
    for k in names:
        got, want = float(m[k]), float(terms[k].detach())
        assert abs(got - want) <= 1e-4 * abs(want), (k, got, want)


def test_cpu_calls_take_the_plain_route():
    """On CPU tensors no kernel launches and the kernel route's counter
    stays; a CUDA-only check refuses what the kernels do not take."""
    before = trace.counters().get("vitdet.rel_attn", 0)
    launches = (ra.rel_attn_forward.launches, ra.rel_attn_backward.launches)
    qkv = torch.randn(1, 5, 7, 3 * 128, requires_grad=True)
    bias = torch.randn(3 * 128, requires_grad=True)
    th = torch.randn(5, 64, requires_grad=True)
    tw = torch.randn(5, 64, requires_grad=True)
    out = ra.rel_attention(qkv, bias, th, tw, 2, 3)
    out.sum().backward()
    assert out.shape == (1, 5, 7, 128) and th.grad is not None
    assert trace.counters().get("vitdet.rel_attn", 0) == before
    assert (ra.rel_attn_forward.launches,
            ra.rel_attn_backward.launches) == launches
    b16 = [t.detach().bfloat16() for t in (qkv, bias, th, tw)]
    with pytest.raises(ValueError, match="heads of 32"):
        ra._check_kernel(*b16, 4, 3)
    with pytest.raises(ValueError, match="at most 64"):
        ra._check_kernel(torch.zeros(1, 65, 7, 384, dtype=torch.bfloat16),
                         *b16[1:], 2, 0)
    with pytest.raises(TypeError, match="bfloat16 only"):
        ra._check_kernel(qkv.detach(), *b16[1:], 2, 3)
    with pytest.raises(ValueError, match="window -1"):
        ra.rel_attention(qkv, bias, th, tw, 2, -1)


def test_cape_refuses_dilation():
    """DC5 dilation is ResNet-50's only: a ViTDet backbone refuses it."""
    with pytest.raises(ValueError, match="backbone='vitdet_tiny'"):
        CAPE(tiny_test_config(backbone="vitdet_tiny", dilation=True),
             device="cpu")


def test_backbones_list_vitdet():
    assert BACKBONES[-2:] == ("vitdet_l", "vitdet_tiny")
