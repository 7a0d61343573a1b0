"""The port's Swin backbone (`cape_tpu_torch/models/swin.py`) and its
shifted-window attention (`cape_tpu_torch/ops/window_attn.py`) against the
benchmark's plain float32 reference (`benchmark/reference/backbones/`),
which follows DINO's `models/dino/swin_transformer.py` (roll, pad, window
partition, mask): fp32 on the CPU, seeded weights, no JAX.

The window-attention kernels run on the card only; here `window_attention`
takes its plain version, whose index maps (`_window_maps`: each window
token's real position, relative-position bin and region) are the
arithmetic the kernels do, and are held against the reference's
`relative_index` and `shift_mask` too.

Tolerances: fp32 against fp32, the same function computed in another
order (gathers and an index scatter against roll, pad and partition; the
scores scaled after the product against q scaled before it): outputs and
gradients within 2e-5 of the largest magnitude of the compared tensor.
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
from cape_tpu_torch.config import CAPEConfig, tiny_test_config
from cape_tpu_torch.models.cape import BACKBONES, CAPE
from cape_tpu_torch.models.swin import SWIN, SwinTransformer
from cape_tpu_torch.ops import window_attn as wa

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
# appended, never prepended: benchmark/trace.py would shadow the standard
# library's `trace`
if BENCH not in sys.path:
    sys.path.append(BENCH)

from reference.backbones import swin_L_384_22k as ref_swin  # noqa: E402
from reference.backbones import swin_tiny as ref_tiny  # noqa: E402
from reference.model import RefCAPE  # noqa: E402

RTOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def close(got, want, what):
    scale = want.abs().max().clamp(min=1e-12)
    gap = (got - want).abs().max()
    assert gap <= RTOL * scale, f"{what}: gap {gap:.3g} of {scale:.3g}"


def seeded_(module: torch.nn.Module, seed: int) -> None:
    """Every parameter drawn from a seeded normal: kernels at 1/sqrt(fan
    in), biases, norms and tables at 0.3 (so that the padded tokens' qkv
    bias, the tables and the norms all matter)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in sorted(module.named_parameters()):
            z = torch.randn(p.shape, generator=g)
            if p.dim() >= 2 and "table" not in name:
                p.copy_(z / p[0].numel() ** 0.5)
            elif name.endswith("weight"):
                p.copy_(1.0 + 0.3 * z)
            else:
                p.copy_(0.3 * z)


def test_reference_imports_nothing_of_the_port():
    for mod in (ref_swin, ref_tiny):
        tree = ast.parse(open(mod.__file__).read())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names]
        names += [n.module or "" for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom)]
        assert not [n for n in names if n.startswith("cape_tpu")], names


def test_real_widths_names_and_shapes_agree():
    """swin_L_384_22k at its published widths, built on the meta device:
    the port's parameter names and shapes are the reference's (DINO's)."""
    c = {"input_channels": 3, "image_size": 512}
    with torch.device("meta"):
        port = SwinTransformer("swin_L_384_22k")
        ref = ref_swin.build(c)
    mine = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    theirs = {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    assert mine == theirs
    assert sum(v.numel() for v in port.parameters()) == 195_200_820
    assert port.channels == ref_swin.channels(c) == (384, 768, 1536)
    spec = SWIN["swin_L_384_22k"]
    assert (spec["embed_dim"], spec["depths"], spec["num_heads"],
            wa.WINDOW) == (192, (2, 2, 18, 2), (6, 12, 24, 48), 12)
    for name in ("patch_embed.proj.weight", "patch_embed.norm.bias",
                 "layers.2.blocks.17.attn.relative_position_bias_table",
                 "layers.2.blocks.17.attn.qkv.bias",
                 "layers.3.blocks.1.mlp.fc2.weight",
                 "layers.2.downsample.reduction.weight", "norm3.weight"):
        assert name in mine, name
    assert "layers.2.downsample.reduction.bias" not in mine
    assert "layers.3.downsample.norm.weight" not in mine


@pytest.mark.parametrize("size", [64, 72])
def test_backbone_maps_and_every_gradient(size):
    """swin_tiny at 64 px (stage 1 16 x 16 padded to 24, stage 4 2 x 2
    within one window) and 72 px (odd stages padded before merging)."""
    c = {"input_channels": 3, "image_size": size}
    port = SwinTransformer("swin_tiny")
    ref = ref_tiny.build(c)
    seeded_(port, 3)
    ref.load_state_dict(port.state_dict(), strict=True)
    g = torch.Generator().manual_seed(size)
    x = torch.randn(2, 3, size, size, generator=g)
    mine, theirs = port(x), ref(x)
    assert [tuple(t.shape) for t in mine] == [tuple(t.shape) for t in theirs]
    cots = [torch.randn(t.shape, generator=g) for t in theirs]
    for i, (a, b) in enumerate(zip(mine, theirs)):
        close(a, b, f"stage {i + 1}")
    sum((a * w).sum() for a, w in zip(mine, cots)).backward()
    sum((b * w).sum() for b, w in zip(theirs, cots)).backward()
    ref_params = dict(ref.named_parameters())
    for name, p in port.named_parameters():
        close(p.grad, ref_params[name].grad, name)


def _reference_attention(attn, x, shift):
    """The reference block's attention part on normed tokens x (B, H, W, C):
    pad, roll, partition, attend, reverse, roll back, crop."""
    B, H, W, C = x.shape
    ws = ref_swin.WINDOW
    y = F.pad(x, (0, 0, 0, -W % ws, 0, -H % ws))
    _, Hp, Wp, _ = y.shape
    if shift:
        y = torch.roll(y, (-shift, -shift), (1, 2))
    win = ref_swin.window_partition(y, ws).view(-1, ws * ws, C)
    mask = ref_swin.shift_mask(Hp, Wp, ws, ws // 2) if shift else None
    y = ref_swin.window_reverse(attn(win, mask).view(-1, ws, ws, C), ws,
                                Hp, Wp)
    if shift:
        y = torch.roll(y, (shift, shift), (1, 2))
    return y[:, :H, :W]


@pytest.mark.parametrize("shift", [0, 6])
@pytest.mark.parametrize("hw", [(16, 16), (2, 2), (13, 25)])
def test_plain_window_attention_against_the_reference(shift, hw):
    """`window_attention` (the plain version on the CPU) with the block's
    qkv and proj around it, against the reference's roll / pad / partition /
    mask formulation: outputs and the gradients of qkv's weight and bias,
    the table, proj and the tokens."""
    H, W = hw
    heads, C = 2, 64
    ref = ref_swin.WindowAttention(C, heads, ref_swin.WINDOW)
    seeded_(ref, 11)
    g = torch.Generator().manual_seed(H * 100 + W + shift)
    x = torch.randn(2, H, W, C, generator=g)
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    params = {k: v.detach().clone().requires_grad_()
              for k, v in ref.named_parameters()}
    qkv = F.linear(xa, params["qkv.weight"], params["qkv.bias"])
    out = F.linear(wa.window_attention(
        qkv, params["qkv.bias"], params["relative_position_bias_table"],
        heads, shift), params["proj.weight"], params["proj.bias"])
    want = _reference_attention(ref, xb, shift)
    close(out, want, "output")
    cot = torch.randn(out.shape, generator=g)
    (out * cot).sum().backward()
    (want * cot).sum().backward()
    close(xa.grad, xb.grad, "tokens")
    for name, p in ref.named_parameters():
        close(params[name].grad, p.grad, name)


@pytest.mark.parametrize("shift", [0, 6])
@pytest.mark.parametrize("hw", [(16, 16), (2, 2), (36, 36), (13, 25)])
def test_index_maps_are_the_references(shift, hw):
    """The plain version's (and the kernels') index arithmetic: each window
    token's real position (the reference's padded, rolled grid cut into
    windows), bins equal to `relative_index`, and regions whose equality
    is the reference's zero entries of `shift_mask`."""
    H, W = hw
    ws = wa.WINDOW
    src, bins, region = wa._window_maps(H, W, shift)
    Hp, Wp = wa.padded(H), wa.padded(W)
    pos = torch.full((1, Hp, Wp, 1), -1.0)
    pos[0, :H, :W, 0] = torch.arange(H * W, dtype=torch.float32).view(H, W)
    pos = torch.roll(pos, (-shift, -shift), (1, 2))
    assert torch.equal(src, ref_swin.window_partition(pos, ws).view(
        -1, ws * ws).long())
    assert torch.equal(bins, ref_swin.relative_index(ws))
    same = region[:, :, None] == region[:, None, :]
    if shift:
        assert torch.equal(same, ref_swin.shift_mask(Hp, Wp, ws, shift) == 0)


def test_encode_image_against_the_reference():
    """`CAPE.encode_image` with `swin_tiny` (the input projections on its
    32/64/128... channels, the deformable encoder) against
    `RefCAPE.encode_image` with the same weights (names and shapes of the
    whole model held equal by `load_state_dict(strict=True)`)."""
    cfg = tiny_test_config(backbone="swin_tiny")
    port = CAPE(cfg, device="cpu")
    seeded_(port.backbone, 5)
    ref = RefCAPE(dataclasses.asdict(cfg))
    ref.load_state_dict(port.state_dict(), strict=True)
    g = torch.Generator().manual_seed(9)
    images = torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8,
                           generator=g)
    with torch.no_grad():
        close(port.encode_image(images), ref.encode_image(images),
              "memory")


def test_cpu_calls_take_the_plain_route():
    """On CPU tensors no kernel launches and the kernel route's counter
    stays; a CUDA-only check refuses what the kernels do not take."""
    before = trace.counters().get("swin.window_attn", 0)
    launches = (wa.window_attn_forward.launches,
                wa.window_attn_backward.launches)
    qkv = torch.randn(1, 5, 7, 3 * 64, requires_grad=True)
    bias = torch.randn(3 * 64, requires_grad=True)
    table = torch.randn(wa.BINS, 2, requires_grad=True)
    out = wa.window_attention(qkv, bias, table, 2, 6)
    out.sum().backward()
    assert out.shape == (1, 5, 7, 64) and bias.grad is not None
    assert trace.counters().get("swin.window_attn", 0) == before
    assert (wa.window_attn_forward.launches,
            wa.window_attn_backward.launches) == launches
    with pytest.raises(ValueError, match="heads of 16"):
        wa._check_kernel(qkv.detach().bfloat16(), bias.detach().bfloat16(),
                         torch.zeros(wa.BINS, 4, dtype=torch.bfloat16), 4)
    with pytest.raises(TypeError, match="bfloat16 only"):
        wa._check_kernel(qkv.detach(), bias.detach(), table.detach(), 2)
    with pytest.raises(ValueError, match="shift 12"):
        wa.window_attention(qkv, bias, table, 2, 12)


@pytest.mark.parametrize("case", ["unknown backbone", "dilated swin"])
def test_cape_refuses(case):
    """Another name than `BACKBONES` raises (it used to build ResNet-50),
    as does DC5 dilation on a Swin backbone."""
    cfg = (tiny_test_config(backbone="resnet_small") if case ==
           "unknown backbone" else tiny_test_config(backbone="swin_tiny",
                                                    dilation=True))
    with pytest.raises(ValueError, match="backbone='"):
        CAPE(cfg, device="cpu")


def test_train_loop_refuses_resnet_weights_on_swin():
    from cape_tpu_torch.train.loop import train_loop
    cfg = tiny_test_config(backbone="swin_tiny", resnet_weights="r50.npz")
    model = CAPE(cfg, device="cpu")
    with pytest.raises(ValueError, match="torchvision ResNet-50"):
        train_loop(model, cfg, None, None, None)


def test_cli_backbone_help_lists_the_names():
    from cape_tpu_torch.cli.train import get_args_parser
    action = {a.dest: a for a in get_args_parser()._actions}["backbone"]
    assert all(n in action.help for n in BACKBONES)
    assert BACKBONES == ("resnet50", "resnet_tiny", "swin_L_384_22k",
                         "swin_tiny", "vitdet_l", "vitdet_tiny")
    assert CAPEConfig().backbone == "resnet50"
