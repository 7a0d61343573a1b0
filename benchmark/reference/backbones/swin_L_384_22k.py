"""Swin-L as DINO-4scale configures it (`swin_L_384_22k`): Swin
Transformer (Liu et al., 2021, arXiv:2103.14030) in the detection form of
IDEA-Research/DINO (`models/dino/swin_transformer.py`,
`config/DINO/DINO_4scale_swin.py`), written from that description in plain
float32 torch: embed 192, depths 2/2/18/2, heads 6/12/24/48 (32 channels
a head), window 12, MLP ratio 4, qkv with bias, no absolute position
embedding, a LayerNorm after the patch embedding, patch merging as
LayerNorm(4C) then Linear(4C -> 2C) without bias, and a LayerNorm on each
returned stage (1, 2, 3: strides 8, 16, 32, channels 384, 768, 1536).

A block is the source's: `norm1`, the grid padded with zeros at the bottom
and right to a multiple of the window (so a padded token's q, k and v are
the qkv bias), in odd blocks rolled by -6 (at every stage, the window never
clamped to a smaller stage), cut into windows of 144 tokens, attention
with the relative-position bias of a (23 * 23, heads) table and, when
rolled, the mask of -100 between the nine regions of the padded grid (its
last 12 and last 6 rows and columns cut off), the windows put back, rolled
back and cropped, the residual; then `norm2`, fc1, GELU, fc2 and the
residual. Departures from the source: no stochastic depth (its drop path
is 0 here), no activation checkpointing; the relative-position index and
the shift mask are computed at each call, not stored as buffers.

Linear layers and the patch convolution are the reference's own, so that
the control's rounding reaches them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from reference.model import Conv2d, Linear

EMBED = 192
DEPTHS = (2, 2, 18, 2)
HEADS = (6, 12, 24, 48)
WINDOW = 12
MLP_RATIO = 4
PATCH = 4
OUT_INDICES = (1, 2, 3)
MASK_FILL = -100.0
#: the first names of the backbone's parameters (`init` refuses others)
NAMES = ("patch_embed.", "layers.") + tuple(f"norm{i}." for i in OUT_INDICES)


def relative_index(ws: int, device=None) -> torch.Tensor:
    """(ws*ws, ws*ws): the table row of each (query, key) pair."""
    c = torch.stack(torch.meshgrid(torch.arange(ws, device=device),
                                   torch.arange(ws, device=device),
                                   indexing="ij")).flatten(1)
    rel = (c[:, :, None] - c[:, None, :]).permute(1, 2, 0) + (ws - 1)
    return rel[..., 0] * (2 * ws - 1) + rel[..., 1]


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    B, H, W, C = x.shape
    x = x.view(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, C)


def window_reverse(windows: torch.Tensor, ws: int, H: int,
                   W: int) -> torch.Tensor:
    B = windows.shape[0] // (H * W // ws // ws)
    x = windows.view(B, H // ws, W // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, -1)


def shift_mask(Hp: int, Wp: int, ws: int, shift: int,
               device=None) -> torch.Tensor:
    """(nW, ws*ws, ws*ws): 0 within a region of the padded grid, -100
    between regions (the source's `attn_mask`)."""
    img = torch.zeros((1, Hp, Wp, 1), device=device)
    cuts = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    cnt = 0
    for h in cuts:
        for w in cuts:
            img[:, h, w, :] = cnt
            cnt += 1
    mw = window_partition(img, ws).view(-1, ws * ws)
    m = mw[:, None, :] - mw[:, :, None]
    return m.masked_fill(m != 0, MASK_FILL).masked_fill(m == 0, 0.0)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, ws: int):
        super().__init__()
        self.heads, self.ws = heads, ws
        self.scale = (dim // heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * ws - 1) ** 2, heads))
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        B_, N, C = x.shape
        qkv = self.qkv(x).reshape(B_, N, 3, self.heads, C // self.heads) \
            .permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * self.scale, qkv[1], qkv[2]
        attn = q @ k.transpose(-2, -1)
        idx = relative_index(self.ws, x.device).reshape(-1)
        bias = self.relative_position_bias_table[idx].view(N, N, -1)
        attn = attn + bias.permute(2, 0, 1)[None]
        if mask is not None:
            nW = mask.shape[0]
            attn = (attn.view(B_ // nW, nW, self.heads, N, N)
                    + mask[None, :, None]).view(-1, self.heads, N, N)
        attn = torch.softmax(attn, -1)
        return self.proj((attn @ v).transpose(1, 2).reshape(B_, N, C))


class Mlp(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = Linear(dim, MLP_RATIO * dim)
        self.fc2 = Linear(MLP_RATIO * dim, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, ws: int, shift: int):
        super().__init__()
        self.ws, self.shift = ws, shift
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, heads, ws)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim)

    def forward(self, x: torch.Tensor, H: int, W: int,
                mask: torch.Tensor) -> torch.Tensor:
        B, L, C = x.shape
        ws, s = self.ws, self.shift
        shortcut = x
        x = self.norm1(x).view(B, H, W, C)
        pad_r, pad_b = (ws - W % ws) % ws, (ws - H % ws) % ws
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        _, Hp, Wp, _ = x.shape
        if s > 0:
            x = torch.roll(x, shifts=(-s, -s), dims=(1, 2))
        win = window_partition(x, ws).view(-1, ws * ws, C)
        win = self.attn(win, mask if s > 0 else None)
        x = window_reverse(win.view(-1, ws, ws, C), ws, Hp, Wp)
        if s > 0:
            x = torch.roll(x, shifts=(s, s), dims=(1, 2))
        x = x[:, :H, :W, :].reshape(B, H * W, C)
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x, H, W):
        B, L, C = x.shape
        x = x.view(B, H, W, C)
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        return self.reduction(self.norm(x.view(B, -1, 4 * C)))


class BasicLayer(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, ws: int,
                 downsample: bool):
        super().__init__()
        self.ws = ws
        self.blocks = nn.ModuleList(
            [SwinBlock(dim, heads, ws, 0 if i % 2 == 0 else ws // 2)
             for i in range(depth)])
        self.downsample = PatchMerging(dim) if downsample else None

    def forward(self, x, H, W):
        ws = self.ws
        Hp, Wp = -(-H // ws) * ws, -(-W // ws) * ws
        mask = shift_mask(Hp, Wp, ws, ws // 2, x.device)
        for blk in self.blocks:
            x = blk(x, H, W, mask)
        if self.downsample is None:
            return x, H, W, x, H, W
        return x, H, W, self.downsample(x, H, W), (H + 1) // 2, (W + 1) // 2


class PatchEmbed(nn.Module):
    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.proj = Conv2d(cin, dim, PATCH, PATCH)
        self.norm = nn.LayerNorm(dim)

    def forward(self, x):
        _, _, H, W = x.shape
        if W % PATCH:
            x = F.pad(x, (0, PATCH - W % PATCH))
        if H % PATCH:
            x = F.pad(x, (0, 0, 0, PATCH - H % PATCH))
        x = self.proj(x)
        Wh, Ww = x.shape[2:]
        x = self.norm(x.flatten(2).transpose(1, 2))
        return x.transpose(1, 2).view(-1, x.shape[-1], Wh, Ww)


class SwinTransformer(nn.Module):
    def __init__(self, cin: int, embed: int, depths: Sequence[int],
                 heads: Sequence[int], ws: int):
        super().__init__()
        self.patch_embed = PatchEmbed(cin, embed)
        self.layers = nn.ModuleList(
            [BasicLayer(embed * 2 ** i, d, h, ws, i < len(depths) - 1)
             for i, (d, h) in enumerate(zip(depths, heads))])
        self.features = [embed * 2 ** i for i in range(len(depths))]
        for i in OUT_INDICES:
            self.add_module(f"norm{i}", nn.LayerNorm(self.features[i]))

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        x = self.patch_embed(x)
        Wh, Ww = x.shape[2:]
        x = x.flatten(2).transpose(1, 2)
        outs: List[torch.Tensor] = []
        for i, layer in enumerate(self.layers):
            x_out, H, W, x, Wh, Ww = layer(x, Wh, Ww)
            if i in OUT_INDICES:
                y = getattr(self, f"norm{i}")(x_out)
                outs.append(y.view(-1, H, W, self.features[i])
                            .permute(0, 3, 1, 2).contiguous())
        return tuple(outs)


# -- the benchmark's interface (`reference/backbones/__init__.py`) ---------
def swin(c: Dict, embed: int, depths, heads) -> SwinTransformer:
    return SwinTransformer(c["input_channels"], embed, depths, heads, WINDOW)


def build(c: Dict) -> SwinTransformer:
    return swin(c, EMBED, DEPTHS, HEADS)


def channels(c: Dict) -> Tuple[int, int, int]:
    return tuple(EMBED * 2 ** i for i in OUT_INDICES)


def _padded(n: int) -> int:
    return -(-n // WINDOW) * WINDOW


def stages(c: Dict, embed: int, depths) -> List[Tuple[int, int, int, int]]:
    """Each stage's (height, width, channels, blocks) at the configuration's
    image size."""
    h = w = -(-c["image_size"] // PATCH)
    out = []
    for i, d in enumerate(depths):
        out.append((h, w, embed * 2 ** i, d))
        h, w = (h + 1) // 2, (w + 1) // 2
    return out


def swin_flops(c: Dict, embed: int, depths) -> float:
    """One image: the patch convolution, every linear layer on the real
    tokens (a padded token's qkv is the bias: no product), the mergings,
    and attention's two products over the padded windows (144 keys a
    token, C channels); norms, softmax and GELU left out."""
    S = -(-c["image_size"] // PATCH)
    f = 2.0 * c["input_channels"] * PATCH * PATCH * embed * S * S
    st = stages(c, embed, depths)
    for i, (h, w, C, d) in enumerate(st):
        n, npad = h * w, _padded(h) * _padded(w)
        block = 2.0 * n * (3 * C * C + C * C + 2 * MLP_RATIO * C * C) \
            + 2 * 2.0 * npad * WINDOW * WINDOW * C
        f += d * block
        if i + 1 < len(st):
            h2, w2 = st[i + 1][:2]
            f += 2.0 * h2 * w2 * 4 * C * 2 * C
    return f


def flops(c: Dict) -> float:
    return swin_flops(c, EMBED, DEPTHS)


def window_attn_sites(c: Dict, embed: int, depths, heads, images: int,
                      elt: int = 2) -> List[Tuple[float, float, float,
                                                 float]]:
    """Each window-attention site of a forward of `images` images, in block
    order: (forward bytes, forward FLOPs, backward bytes, backward FLOPs).
    Bytes count each input and output once, over the real tokens: forward
    q, k, v read and the output written, and each window row's fp32
    log-sum-exp; backward q, k, v, the output and its gradient read and
    the q, k, v gradient written, with the log-sum-exps. FLOPs: the two
    products over the padded windows forward, four backward."""
    out = []
    for (h, w, C, d), nh in zip(stages(c, embed, depths), heads):
        n, npad = images * h * w, images * _padded(h) * _padded(w)
        lse = npad * nh * 4.0
        fwd_b = n * 4 * C * elt + lse
        bwd_b = n * 8 * C * elt + lse
        fwd_f = 2 * 2.0 * npad * WINDOW * WINDOW * C
        out += [(fwd_b, fwd_f, bwd_b, 2 * fwd_f)] * d
    return out


def window_attn(c: Dict, images: int):
    return window_attn_sites(c, EMBED, DEPTHS, HEADS, images)


def init(name: str, z: torch.Tensor, init: Dict) -> Optional[torch.Tensor]:
    """The relative-position tables normal with std
    `init["swin_table_std"]` (Swin's init); the rest by the generic rules.
    A name that is not the source's (a program that built another
    backbone) stops the run."""
    if not name.startswith(NAMES):
        raise SystemExit(f"the program's backbone has a parameter {name!r}: "
                         f"not a Swin parameter of DINO's names")
    if name.endswith("relative_position_bias_table"):
        return z * init["swin_table_std"]
    return None
