"""Shifted-window self-attention of a Swin block (Liu et al., 2021,
arXiv:2103.14030), in the detection form that DINO's Swin-L runs
(IDEA-Research/DINO, `models/dino/swin_transformer.py`), from the qkv
projection's output to the input of `attn.proj`.

`window_attention(qkv, qkv_bias, table, heads, shift)` takes the
(B, H, W, 3C) output of the block's `attn.qkv` on its real tokens and
returns the (B, H, W, C) attention output on the same tokens. Its function
is the source's:

- the grid is padded at the bottom and right to a multiple of the window
  (`WINDOW` = 12); a padded token's q, k and v are `qkv_bias`, since the
  source pads after `norm1` and projects the zeros;
- with `shift` > 0 the padded grid is rolled by -shift on both axes
  before the windows are cut, and the output rolled back;
- each window of 144 tokens attends over itself, head by head:
  softmax(q k^T / sqrt(Dh) + bias + mask) v, with `bias` the head's entry
  of the (23 * 23, heads) relative-position table and, in a shifted block,
  `mask` -100 between tokens of different regions of the padded grid (its
  last `WINDOW` rows and columns cut at -shift), 0 within one; padded
  tokens are not masked;
- the output is cropped to the real tokens.

- CUDA tensors: the hand-written kernels `csrc/window_attn.cu`, one
  forward and one backward launch a call (the backward's deterministic
  reduction of the table's and the bias's gradient is a second, small
  launch), wrapped in one `torch.autograd.Function`. The forward reads q,
  k and v straight from the projection's output, does the shift, the
  padding and the partition by indexing, and writes the output cropped
  and un-shifted; it saves each row's log-sum-exp, from which the
  backward recomputes the probabilities. bf16 only; anything else raises.
  They replace no Pallas kernel: the JAX package has no Swin backbone.
  They were added because plain PyTorch runs each of the 24 sites of a
  Swin-L forward as a roll, a pad, a partition, (144 x 144) scores and
  probabilities for every window and head in device memory, a bias
  gather, a mask add and a softmax, then the reverse partition, roll and
  crop, and its backward again.
- CPU tensors: `window_attention_plain`, the same function in plain
  PyTorch (fp32), differentiated by autograd.

`window_attn_forward.launches` and `window_attn_backward.launches` count
kernel launches (never plain calls); the trace counter `swin.window_attn`
counts calls that took the kernel route (a captured step counts its sites
once, at the capture).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from .. import trace
from . import _build

#: the window's side: the kernels are built for 12 x 12 windows
WINDOW = 12
#: a head's width the kernels take
HEAD_DIM = 32
#: relative offsets a head's bias table holds: (2 * WINDOW - 1) ** 2
BINS = (2 * WINDOW - 1) ** 2
#: the value the source adds between tokens of different regions
MASK_FILL = -100.0


def padded(n: int) -> int:
    """`n` rounded up to a multiple of the window."""
    return -(-n // WINDOW) * WINDOW


@functools.lru_cache(maxsize=32)
def _window_maps(H: int, W: int, shift: int) -> Tuple[torch.Tensor, ...]:
    """The windows' tokens as indices (CPU tensors), (nW, 144) each: the
    flat real position `y * W + x` each token reads (-1 for a padded
    token), its relative-position bin against every other token of its
    window (144, 144), and its region of the padded grid (nW, 144)."""
    Hp, Wp = padded(H), padded(W)
    ys = torch.arange(Hp)
    xs = torch.arange(Wp)
    yo, xo = (ys + shift) % Hp, (xs + shift) % Wp       # rolled by -shift
    src = torch.where((yo[:, None] < H) & (xo[None, :] < W),
                      yo[:, None] * W + xo[None, :], torch.full((), -1))
    cut = (Hp - WINDOW, Hp - shift), (Wp - WINDOW, Wp - shift)
    ry = (ys >= cut[0][0]).long() + (ys >= cut[0][1]).long()
    rx = (xs >= cut[1][0]).long() + (xs >= cut[1][1]).long()
    region = ry[:, None] * 3 + rx[None, :]

    def windows(t):
        return t.reshape(Hp // WINDOW, WINDOW, Wp // WINDOW, WINDOW) \
            .permute(0, 2, 1, 3).reshape(-1, WINDOW * WINDOW)

    r = torch.arange(WINDOW * WINDOW)
    ri, ci = r // WINDOW, r % WINDOW
    bins = (ri[:, None] - ri[None, :] + WINDOW - 1) * (2 * WINDOW - 1) \
        + (ci[:, None] - ci[None, :] + WINDOW - 1)
    return windows(src), bins, windows(region)


def window_attention_plain(qkv: torch.Tensor, qkv_bias: torch.Tensor,
                           table: torch.Tensor, heads: int,
                           shift: int) -> torch.Tensor:
    """Plain PyTorch version of `window_attention`, in fp32 by indexing:
    each window's tokens gathered from the real positions (the bias where
    padded), the scores with the table's bins and the region mask, the
    softmax, and the output scattered back to the real positions; returned
    in qkv's dtype."""
    B, H, W, C3 = qkv.shape
    C = C3 // 3
    Dh = C // heads
    src, bins, region = (t.to(qkv.device) for t in _window_maps(H, W,
                                                                shift))
    nW, N = src.shape
    rows = qkv.float().reshape(B, H * W, C3)
    tok = rows[:, src.clamp(min=0).reshape(-1)].reshape(B, nW, N, C3)
    tok = torch.where((src >= 0)[None, :, :, None], tok,
                      qkv_bias.float().expand(B, nW, N, C3))
    q, k, v = tok.reshape(B * nW, N, 3, heads, Dh).permute(2, 0, 3, 1, 4)
    logits = (q @ k.transpose(-1, -2)) * Dh ** -0.5
    logits = logits + table.float()[bins].permute(2, 0, 1)[None]
    if shift:
        mask = (region[:, :, None] != region[:, None, :]).float() * MASK_FILL
        logits = (logits.reshape(B, nW, heads, N, N)
                  + mask[None, :, None]).reshape(B * nW, heads, N, N)
    out = (torch.softmax(logits, -1) @ v).transpose(1, 2).reshape(
        B, nW * N, C)
    real = (src >= 0).reshape(-1)
    flat = out.new_zeros(B, H * W, C)
    flat[:, src.reshape(-1)[real]] = out[:, real]
    return flat.reshape(B, H, W, C).to(qkv.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("window_attn")
    fwd, bwd = lib.window_attn_forward_launch, lib.window_attn_backward_launch
    if fwd.argtypes is None:
        fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fwd.restype = ctypes.c_int
        bwd.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        bwd.restype = ctypes.c_int
    return lib


def _check(qkv, qkv_bias, table, heads: int, shift: int) -> None:
    if qkv.dim() != 4 or qkv.shape[-1] % 3:
        raise ValueError(f"window_attention: qkv (B, H, W, 3C) expected, "
                         f"got {tuple(qkv.shape)}")
    C = qkv.shape[-1] // 3
    if heads < 1 or C % heads:
        raise ValueError(f"window_attention: {C} channels in {heads} heads")
    if qkv_bias.shape != (3 * C,) or table.shape != (BINS, heads):
        raise ValueError(f"window_attention: bias {tuple(qkv_bias.shape)} "
                         f"and table {tuple(table.shape)} for {C} channels "
                         f"in {heads} heads: ({3 * C},) and ({BINS}, "
                         f"{heads}) expected")
    if not 0 <= shift < WINDOW:
        raise ValueError(f"window_attention: shift {shift} outside [0, "
                         f"{WINDOW})")
    if qkv_bias.device != qkv.device or table.device != qkv.device:
        raise ValueError("window_attention: qkv, bias and table on "
                         "different devices")


def _check_kernel(qkv, qkv_bias, table, heads: int) -> None:
    C = qkv.shape[-1] // 3
    if C // heads != HEAD_DIM:
        raise ValueError(f"window_attention kernel: heads of {C // heads} "
                         f"channels ({HEAD_DIM} only)")
    for name, t in (("qkv", qkv), ("bias", qkv_bias), ("table", table)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"window_attention kernel: {name} is {t.dtype} "
                            "(bfloat16 only)")
    if qkv.device.index != torch.cuda.current_device():
        raise ValueError("kernel inputs must be on the current CUDA device")
    B, H, W, _ = qkv.shape
    if B * H * W * 3 * C >= 2 ** 31:
        raise ValueError(f"window_attention kernel: qkv {tuple(qkv.shape)}: "
                         "offsets past 32 bits")


def _aligned(*tensors) -> None:
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("window_attention kernel: operands must lie on "
                         "16-byte boundaries")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def window_attn_forward(qkv: torch.Tensor, qkv_bias: torch.Tensor,
                        table: torch.Tensor, heads: int, shift: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel: (out (B, H, W, C) bf16, lse (B, nW, heads, 144)
    fp32, each row's log2-sum-exp2 of its scores times log2(e))."""
    _check(qkv, qkv_bias, table, heads, shift)
    _check_kernel(qkv, qkv_bias, table, heads)
    qkv, qkv_bias, table = (t.contiguous() for t in (qkv, qkv_bias, table))
    B, H, W, C3 = qkv.shape
    nW = (padded(H) // WINDOW) * (padded(W) // WINDOW)
    out = torch.empty((B, H, W, C3 // 3), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((B, nW, heads, WINDOW * WINDOW), dtype=torch.float32,
                      device=qkv.device)
    _aligned(qkv, qkv_bias, out)
    err = _lib().window_attn_forward_launch(
        qkv.data_ptr(), qkv_bias.data_ptr(), table.data_ptr(),
        out.data_ptr(), lse.data_ptr(), B, H, W, C3 // 3, heads, shift,
        _stream())
    if err:
        raise RuntimeError(f"window_attn_forward kernel launch failed: "
                           f"CUDA error {err}")
    window_attn_forward.launches += 1
    return out, lse


window_attn_forward.launches = 0


def window_attn_backward(qkv: torch.Tensor, qkv_bias: torch.Tensor,
                         table: torch.Tensor, heads: int, shift: int,
                         out: torch.Tensor, lse: torch.Tensor,
                         grad_out: torch.Tensor
                         ) -> Tuple[torch.Tensor, ...]:
    """The backward kernels: (grad_qkv, grad_bias, grad_table) in the
    inputs' dtype. grad_qkv is the gradient at the real tokens; grad_bias
    sums the padded tokens' gradients (their q, k and v are the bias), and
    grad_table the scores' gradients by bin, both reduced over the
    windows in a fixed order (the same bits every run)."""
    qkv, qkv_bias, table, out, lse, grad_out = (t.contiguous() for t in (
        qkv, qkv_bias, table, out, lse, grad_out))
    B, H, W, C3 = qkv.shape
    C = C3 // 3
    if grad_out.shape != out.shape or grad_out.dtype != out.dtype:
        raise ValueError(f"window_attn_backward: grad_out "
                         f"{tuple(grad_out.shape)} {grad_out.dtype} does not "
                         f"match the output {tuple(out.shape)} {out.dtype}")
    nW = lse.shape[1]
    dev = qkv.device
    grad_qkv = torch.empty_like(qkv)
    part_table = torch.empty((B * nW, heads, BINS), dtype=torch.float32,
                             device=dev)
    part_bias = torch.empty((B * nW, heads, 2 * HEAD_DIM),
                            dtype=torch.float32, device=dev)
    grad_table = torch.empty((BINS, heads), dtype=torch.float32, device=dev)
    grad_bias = torch.empty((C3,), dtype=torch.float32, device=dev)
    _aligned(qkv, qkv_bias, out, grad_out, grad_qkv)
    err = _lib().window_attn_backward_launch(
        qkv.data_ptr(), qkv_bias.data_ptr(), table.data_ptr(),
        out.data_ptr(), grad_out.data_ptr(), lse.data_ptr(),
        grad_qkv.data_ptr(), part_table.data_ptr(), part_bias.data_ptr(),
        grad_table.data_ptr(), grad_bias.data_ptr(), B, H, W, C, heads,
        shift, _stream())
    if err:
        raise RuntimeError(f"window_attn_backward kernel launch failed: "
                           f"CUDA error {err}")
    window_attn_backward.launches += 1
    return (grad_qkv, grad_bias.to(qkv_bias.dtype),
            grad_table.to(table.dtype))


window_attn_backward.launches = 0


class _WindowAttention(torch.autograd.Function):
    """The kernels' forward and backward as one autograd function. Saves
    qkv, the bias, the table, the output and the log-sum-exps: no score or
    probability reaches device memory."""

    @staticmethod
    def forward(ctx, qkv, qkv_bias, table, heads, shift):
        out, lse = window_attn_forward(qkv, qkv_bias, table, heads, shift)
        ctx.save_for_backward(qkv, qkv_bias, table, out, lse)
        ctx.heads, ctx.shift = heads, shift
        return out

    @staticmethod
    def backward(ctx, grad_out):
        qkv, qkv_bias, table, out, lse = ctx.saved_tensors
        grads = window_attn_backward(qkv, qkv_bias, table, ctx.heads,
                                     ctx.shift, out, lse,
                                     grad_out.to(out.dtype))
        need = ctx.needs_input_grad[:3]
        return tuple(g if n else None for g, n in zip(grads, need)) + (
            None, None)


def window_attention(qkv: torch.Tensor, qkv_bias: torch.Tensor,
                     table: torch.Tensor, heads: int,
                     shift: int) -> torch.Tensor:
    """Shifted-window attention of one Swin block: kernel on CUDA, plain
    on CPU.

    Args:
        qkv: (B, H, W, 3C), `attn.qkv`'s output on the real tokens.
        qkv_bias: (3C,), `attn.qkv`'s bias: the padded tokens' q, k, v.
        table: (23 * 23, heads), `attn.relative_position_bias_table`.
        heads: the block's heads (C / heads = 32 on the card).
        shift: 0, or the cyclic shift of an odd block (6).

    Returns:
        (B, H, W, C) in qkv's dtype: the input of `attn.proj`.
    """
    _check(qkv, qkv_bias, table, heads, shift)
    if qkv.device.type == "cpu":
        return window_attention_plain(qkv, qkv_bias, table, heads, shift)
    if qkv.device.type != "cuda":
        raise ValueError(f"window_attention: unsupported device "
                         f"{qkv.device}")
    _check_kernel(qkv, qkv_bias, table, heads)
    trace.count("swin.window_attn")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (qkv, qkv_bias, table)):
        return _WindowAttention.apply(qkv, qkv_bias, table, heads, shift)
    return window_attn_forward(qkv, qkv_bias, table, heads, shift)[0]
