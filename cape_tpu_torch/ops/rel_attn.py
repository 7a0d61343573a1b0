"""Self-attention with decomposed relative-position bias, as a ViTDet block
runs it (Li et al., 2022, arXiv:2203.16527; detectron2,
`modeling/backbone/vit.py` `Attention` and `utils.py` `window_partition`,
`get_rel_pos`, `add_decomposed_rel_pos`), from the qkv projection's output
to the input of `attn.proj`.

`rel_attention(qkv, qkv_bias, rel_pos_h, rel_pos_w, heads, window)` takes
the (B, H, W, 3C) output of the block's `attn.qkv` on its real tokens and
returns the (B, H, W, C) attention output on the same tokens. Its function
is the source's:

- with `window` > 0 the grid is padded at the bottom and right to a
  multiple of the window and cut into windows of window x window tokens;
  a padded token's q, k and v are `qkv_bias`, since the source pads after
  `norm1` and projects the zeros; no token is masked. With `window` 0 the
  whole grid is one window (a global block);
- each window attends over itself, head by head:
  softmax(q k^T / sqrt(Dh) + rel_h + rel_w) v, where for a query at row
  qy, column qx of its window and a key at (ky, kx)
  rel_h = q . Rh[qy - ky + Sh - 1], rel_w = q . Rw[qx - kx + Sw - 1],
  q unscaled; Rh and Rw are the tables `rel_pos_h` (2 Sh - 1, Dh) and
  `rel_pos_w` (2 Sw - 1, Dh), shared by the heads, resampled linearly to
  that length where they have another (`resize_rel_pos`, the source's
  `get_rel_pos`);
- the output is cropped to the real tokens.

- CUDA tensors: the hand-written kernels `csrc/rel_attn.cu`, one forward
  and one backward launch a call (the backward's deterministic reduction
  of the tables' and the bias's gradients is a second, small launch),
  wrapped in one `torch.autograd.Function`. The forward reads q, k and v
  straight from the projection's output, does the padding and the
  partition by indexing, builds the bias in the kernel from q and the
  tables, and writes the output cropped; it saves each row's
  log-sum-exp, from which the backward recomputes the probabilities (and
  the bias from q and the tables); no score reaches device memory. bf16
  only, heads of 64 channels, windows of at most 64 x 64; anything else
  raises. They replace no Pallas kernel: the JAX package has no ViTDet
  backbone. They were added because plain PyTorch runs each of the 24
  sites of a ViTDet-L forward as a pad, a partition, two bias products,
  the whole score and probability matrices in device memory (16 heads of
  4,096 x 4,096 an image at a global site of 1,024 px), a softmax and the
  reverse partition, and its backward again.
- CPU tensors: `rel_attention_plain`, the same function in plain PyTorch
  (fp32), differentiated by autograd.

`rel_attn_forward.launches` and `rel_attn_backward.launches` count kernel
launches (never plain calls); the trace counter `vitdet.rel_attn` counts
calls that took the kernel route (a captured step counts its sites once,
at the capture).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from .. import trace
from . import _build

#: a head's width the kernels take
HEAD_DIM = 64
#: the largest window side (rows or columns) the kernels take
MAX_SIDE = 64
#: slots a block of the kernels holds (4 warps of 32 rows forward, 8 of 16
#: backward)
TILE = 128
#: slots a round of the kernels takes
CHUNK = 64


def sides(H: int, W: int, window: int) -> Tuple[int, int]:
    """A window's rows and columns: the window, or the grid for a global
    block (`window` 0)."""
    return (window, window) if window else (H, W)


def resize_rel_pos(table: torch.Tensor, size: int) -> torch.Tensor:
    """The source's `get_rel_pos` table for queries and keys of `size`
    positions each: `table` itself where it has 2 * size - 1 rows, else
    resampled to that length linearly (`F.interpolate`, align_corners
    False), in the table's dtype."""
    n = 2 * size - 1
    if table.shape[0] == n:
        return table
    out = F.interpolate(table.float().t()[None], size=n, mode="linear")
    return out[0].t().to(table.dtype)


@functools.lru_cache(maxsize=32)
def _window_maps(H: int, W: int, window: int) -> Tuple[torch.Tensor, ...]:
    """The windows' tokens as indices (CPU tensors): the flat real position
    `y * W + x` each token of each window reads (nW, Sh * Sw; -1 for a
    padded token), and each token's row and column in its window."""
    Sh, Sw = sides(H, W, window)
    Hp, Wp = -(-H // Sh) * Sh, -(-W // Sw) * Sw
    ys, xs = torch.arange(Hp), torch.arange(Wp)
    src = torch.where((ys[:, None] < H) & (xs[None, :] < W),
                      ys[:, None] * W + xs[None, :], torch.full((), -1))
    src = src.reshape(Hp // Sh, Sh, Wp // Sw, Sw).permute(0, 2, 1, 3) \
        .reshape(-1, Sh * Sw)
    r = torch.arange(Sh * Sw)
    return src, r // Sw, r % Sw


def rel_attention_plain(qkv: torch.Tensor, qkv_bias: torch.Tensor,
                        rel_pos_h: torch.Tensor, rel_pos_w: torch.Tensor,
                        heads: int, window: int) -> torch.Tensor:
    """Plain PyTorch version of `rel_attention`, in fp32 by indexing, as the
    kernels compute it: each window's tokens gathered from the real
    positions (the bias where padded); each query's products with every
    table row, q Rh^T and q Rw^T, of which the entry at qy - ky + Sh - 1
    (qx - kx + Sw - 1) is its bias at key row ky (column kx); the softmax;
    the output scattered back to the real positions. Returned in qkv's
    dtype."""
    B, H, W, C3 = qkv.shape
    C = C3 // 3
    Dh = C // heads
    Sh, Sw = sides(H, W, window)
    rh_t = resize_rel_pos(rel_pos_h, Sh).float()
    rw_t = resize_rel_pos(rel_pos_w, Sw).float()
    src, qy, qx = (t.to(qkv.device) for t in _window_maps(H, W, window))
    nW, N = src.shape
    rows = qkv.float().reshape(B, H * W, C3)
    tok = rows[:, src.clamp(min=0).reshape(-1)].reshape(B, nW, N, C3)
    tok = torch.where((src >= 0)[None, :, :, None], tok,
                      qkv_bias.float().expand(B, nW, N, C3))
    q, k, v = tok.reshape(B * nW, N, 3, heads, Dh).permute(2, 0, 3, 1, 4)
    logits = (q @ k.transpose(-1, -2)) * Dh ** -0.5
    ph, pw = q @ rh_t.t(), q @ rw_t.t()           # (.., N, 2S - 1)
    # rel_h[i, ky] = ph[i, qy_i - ky + Sh - 1]: the gathered columns
    kh = qy[:, None] - torch.arange(Sh, device=qy.device)[None] + Sh - 1
    kw = qx[:, None] - torch.arange(Sw, device=qx.device)[None] + Sw - 1
    rel_h = ph.gather(-1, kh.expand(*ph.shape[:-1], Sh))
    rel_w = pw.gather(-1, kw.expand(*pw.shape[:-1], Sw))
    logits = logits + rel_h[..., qy] + rel_w[..., qx]
    out = (torch.softmax(logits, -1) @ v).transpose(1, 2).reshape(
        B, nW * N, C)
    real = (src >= 0).reshape(-1)
    flat = out.new_zeros(B, H * W, C)
    flat[:, src.reshape(-1)[real]] = out[:, real]
    return flat.reshape(B, H, W, C).to(qkv.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("rel_attn")
    fwd, bwd = lib.rel_attn_forward_launch, lib.rel_attn_backward_launch
    if fwd.argtypes is None:
        fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fwd.restype = ctypes.c_int
        bwd.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        bwd.restype = ctypes.c_int
    return lib


def _check(qkv, qkv_bias, rel_pos_h, rel_pos_w, heads: int,
           window: int) -> None:
    if qkv.dim() != 4 or qkv.shape[-1] % 3:
        raise ValueError(f"rel_attention: qkv (B, H, W, 3C) expected, got "
                         f"{tuple(qkv.shape)}")
    C = qkv.shape[-1] // 3
    if heads < 1 or C % heads:
        raise ValueError(f"rel_attention: {C} channels in {heads} heads")
    Dh = C // heads
    if qkv_bias.shape != (3 * C,) or any(
            t.dim() != 2 or t.shape[1] != Dh or t.shape[0] < 1
            for t in (rel_pos_h, rel_pos_w)):
        raise ValueError(f"rel_attention: bias {tuple(qkv_bias.shape)} and "
                         f"tables {tuple(rel_pos_h.shape)}, "
                         f"{tuple(rel_pos_w.shape)} for {C} channels in "
                         f"{heads} heads: ({3 * C},) and (L, {Dh}) expected")
    if window < 0:
        raise ValueError(f"rel_attention: window {window} (0 for global)")
    if any(t.device != qkv.device for t in (qkv_bias, rel_pos_h,
                                            rel_pos_w)):
        raise ValueError("rel_attention: qkv, bias and tables on different "
                         "devices")


def _check_kernel(qkv, qkv_bias, rel_h, rel_w, heads: int,
                  window: int) -> None:
    """What the kernels take, the tables already at 2 * side - 1 rows."""
    B, H, W, C3 = qkv.shape
    C = C3 // 3
    if C // heads != HEAD_DIM:
        raise ValueError(f"rel_attention kernel: heads of {C // heads} "
                         f"channels ({HEAD_DIM} only)")
    Sh, Sw = sides(H, W, window)
    if Sh > MAX_SIDE or Sw > MAX_SIDE:
        raise ValueError(f"rel_attention kernel: windows of {Sh} x {Sw} "
                         f"tokens (at most {MAX_SIDE} a side)")
    for name, t in (("qkv", qkv), ("bias", qkv_bias), ("rel_pos_h", rel_h),
                    ("rel_pos_w", rel_w)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"rel_attention kernel: {name} is {t.dtype} "
                            "(bfloat16 only)")
    if qkv.device.index != torch.cuda.current_device():
        raise ValueError("kernel inputs must be on the current CUDA device")
    if B * H * W * C3 >= 2 ** 31:
        raise ValueError(f"rel_attention kernel: qkv {tuple(qkv.shape)}: "
                         "offsets past 32 bits")


def geometry(H: int, W: int, window: int) -> Tuple[int, int]:
    """The kernels' slots of one window: (windows an image, slots a
    window). A window's rows are laid out in slot rows of 16, 32 or 64
    (the columns rounded up to a power of two), tiles of 128 slots holding
    whole slot rows."""
    Sh, Sw = sides(H, W, window)
    nW = -(-H // Sh) * -(-W // Sw)
    swp = 16
    while swp < Sw:
        swp *= 2
    rows = CHUNK // swp
    return nW, 2 * -(-Sh // (2 * rows)) * CHUNK


def _aligned(*tensors) -> None:
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("rel_attention kernel: operands must lie on "
                         "16-byte boundaries")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def rel_attn_forward(qkv: torch.Tensor, qkv_bias: torch.Tensor,
                     rel_h: torch.Tensor, rel_w: torch.Tensor, heads: int,
                     window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel on tables of 2 * side - 1 rows: (out (B, H, W, C)
    bf16, lse (B * nW, heads, slots) fp32, each slot's log2-sum-exp2 of
    its scores times log2(e), +inf where the slot holds no token)."""
    qkv, qkv_bias, rel_h, rel_w = (t.contiguous() for t in (
        qkv, qkv_bias, rel_h, rel_w))
    B, H, W, C3 = qkv.shape
    nW, slots = geometry(H, W, window)
    dev = qkv.device
    out = torch.empty((B, H, W, C3 // 3), dtype=qkv.dtype, device=dev)
    lse = torch.empty((B * nW, heads, slots), dtype=torch.float32,
                      device=dev)
    _aligned(qkv, qkv_bias, rel_h, rel_w, out, lse)
    err = _lib().rel_attn_forward_launch(
        qkv.data_ptr(), qkv_bias.data_ptr(), rel_h.data_ptr(),
        rel_w.data_ptr(), out.data_ptr(), lse.data_ptr(), B, H, W,
        C3 // 3, heads, window, _stream())
    if err:
        raise RuntimeError(f"rel_attn_forward kernel launch failed: CUDA "
                           f"error {err}")
    rel_attn_forward.launches += 1
    return out, lse


rel_attn_forward.launches = 0


def rel_attn_backward(qkv: torch.Tensor, qkv_bias: torch.Tensor,
                      rel_h: torch.Tensor, rel_w: torch.Tensor, heads: int,
                      window: int, out: torch.Tensor, lse: torch.Tensor,
                      grad_out: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The backward kernels: (grad_qkv, grad_bias, grad_rel_h, grad_rel_w)
    in the inputs' dtypes. grad_qkv is the gradient at the real tokens;
    grad_bias sums the padded tokens' gradients (their q, k and v are the
    bias), the tables' gradients the products of each query with its bias
    terms' gradients; both reduced over the blocks in a fixed order (the
    same bits every run)."""
    qkv, qkv_bias, rel_h, rel_w, out, lse, grad_out = (
        t.contiguous() for t in (qkv, qkv_bias, rel_h, rel_w, out, lse,
                                 grad_out))
    B, H, W, C3 = qkv.shape
    C = C3 // 3
    if grad_out.shape != out.shape or grad_out.dtype != out.dtype:
        raise ValueError(f"rel_attn_backward: grad_out "
                         f"{tuple(grad_out.shape)} {grad_out.dtype} does not "
                         f"match the output {tuple(out.shape)} {out.dtype}")
    nW, slots = geometry(H, W, window)
    blocks = B * nW * heads * (slots // TILE)
    L = rel_h.shape[0] + rel_w.shape[0]
    dev = qkv.device
    grad_qkv = torch.empty_like(qkv)
    part_kv = torch.empty((blocks, 2 * HEAD_DIM), dtype=torch.float32,
                          device=dev)
    part_tab = torch.empty((blocks, L, HEAD_DIM), dtype=torch.float32,
                           device=dev)
    grad_h = torch.empty(rel_h.shape, dtype=torch.float32, device=dev)
    grad_w = torch.empty(rel_w.shape, dtype=torch.float32, device=dev)
    grad_bias = torch.empty((C3,), dtype=torch.float32, device=dev)
    _aligned(qkv, qkv_bias, rel_h, rel_w, out, grad_out, lse, grad_qkv)
    err = _lib().rel_attn_backward_launch(
        qkv.data_ptr(), qkv_bias.data_ptr(), rel_h.data_ptr(),
        rel_w.data_ptr(), out.data_ptr(), grad_out.data_ptr(),
        lse.data_ptr(), grad_qkv.data_ptr(),
        part_kv.data_ptr(), part_tab.data_ptr(), grad_h.data_ptr(),
        grad_w.data_ptr(), grad_bias.data_ptr(), B, H, W, C, heads, window,
        _stream())
    if err:
        raise RuntimeError(f"rel_attn_backward kernel launch failed: CUDA "
                           f"error {err}")
    rel_attn_backward.launches += 1
    return (grad_qkv, grad_bias.to(qkv_bias.dtype), grad_h.to(rel_h.dtype),
            grad_w.to(rel_w.dtype))


rel_attn_backward.launches = 0


class _RelAttention(torch.autograd.Function):
    """The kernels' forward and backward as one autograd function. Saves
    qkv, the bias, the tables, the output and the log-sum-exps: no score
    or probability reaches device memory."""

    @staticmethod
    def forward(ctx, qkv, qkv_bias, rel_h, rel_w, heads, window):
        out, lse = rel_attn_forward(qkv, qkv_bias, rel_h, rel_w, heads,
                                    window)
        ctx.save_for_backward(qkv, qkv_bias, rel_h, rel_w, out, lse)
        ctx.heads, ctx.window = heads, window
        return out

    @staticmethod
    def backward(ctx, grad_out):
        qkv, qkv_bias, rel_h, rel_w, out, lse = ctx.saved_tensors
        grads = rel_attn_backward(qkv, qkv_bias, rel_h, rel_w, ctx.heads,
                                  ctx.window, out, lse,
                                  grad_out.to(out.dtype))
        need = ctx.needs_input_grad[:4]
        return tuple(g if n else None for g, n in zip(grads, need)) + (
            None, None)


def rel_attention(qkv: torch.Tensor, qkv_bias: torch.Tensor,
                  rel_pos_h: torch.Tensor, rel_pos_w: torch.Tensor,
                  heads: int, window: int) -> torch.Tensor:
    """Attention with decomposed relative-position bias of one ViTDet
    block: kernel on CUDA, plain on CPU.

    Args:
        qkv: (B, H, W, 3C), `attn.qkv`'s output on the real tokens.
        qkv_bias: (3C,), `attn.qkv`'s bias: the padded tokens' q, k, v.
        rel_pos_h, rel_pos_w: (L, C / heads), `attn.rel_pos_h` and
            `attn.rel_pos_w`, resampled to 2 * side - 1 rows where longer
            or shorter.
        heads: the block's heads (C / heads = 64 on the card).
        window: the window's side, or 0 for attention over the whole grid.

    Returns:
        (B, H, W, C) in qkv's dtype: the input of `attn.proj`.
    """
    _check(qkv, qkv_bias, rel_pos_h, rel_pos_w, heads, window)
    if qkv.device.type == "cpu":
        return rel_attention_plain(qkv, qkv_bias, rel_pos_h, rel_pos_w,
                                   heads, window)
    if qkv.device.type != "cuda":
        raise ValueError(f"rel_attention: unsupported device {qkv.device}")
    Sh, Sw = sides(qkv.shape[1], qkv.shape[2], window)
    rel_h, rel_w = resize_rel_pos(rel_pos_h, Sh), resize_rel_pos(rel_pos_w,
                                                                 Sw)
    _check_kernel(qkv, qkv_bias, rel_h, rel_w, heads, window)
    trace.count("vitdet.rel_attn")
    return _RelAttention.apply(qkv, qkv_bias, rel_h, rel_w, heads, window)
