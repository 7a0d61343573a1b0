"""One v1 decoder layer's KV-cached decode step: the query position, the
layer (`DecoderLayer.forward_step`) and its refinement of the reference
point (`Decoder._refine`), for all B episodes of a token.

- `layer_step_plain(decoder, lid, ...)`: the chain of PyTorch modules the
  decode has always run; CPU tensors, and every decode the kernel does not
  take, run it.
- `layer_step(decoder, lid, ...)`: on CUDA tensors the hand-written kernel
  `csrc/decode_layer.cu`, one launch a layer and token (a cluster of 8
  blocks for every 8 episodes), which writes the new K/V row into the
  layer's cache at the device position and returns the new `x` (bf16) and
  reference point (fp32); on CPU tensors `layer_step_plain`. It replaces
  no Pallas kernel: the JAX package leaves this glue to XLA's fusion
  inside its `jit`; on the card the chain was ~420 ATen kernels a layer.
  The decode sites' quad gather is folded into it.
- `refusal(decoder, x, mem_value, cache, support_k)`: why a step does not
  take the kernel, or None (its row of `ops.msda`'s route table). The
  kernel takes what it can observe to be the flagship's layer: a v1 layer
  against its quad slab, the 'auto' MSDA selection, d 256 in 8 heads, 4
  levels of 4 points, an FFN of 1024, bf16 parameters, cache and slab, a
  cache no longer than `seq_len`, at most 128 support keys, and CUDA
  tensors. The pre-projections (`qkv_proj`), the query position
  (`query_pos_type`) and the refinement (`poly_refine`, or the last
  layer) are the kernel's arguments.

The kernel reads every parameter where it lies (a struct of pointers, no
packed copy), so a model loaded or trained after its first decode decodes
with its current weights, and a captured graph sees updates in place.
`layer_step.launches` counts kernel launches (never plain calls); the trace
counter `decode.layer_step` counts steps that took the kernel (a captured
decode counts its layers at the capture).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import trace
from . import _build
from .msda import quad_level_offsets, resolve_impl

#: the shapes the kernel is built for
D_MODEL, HEADS, LEVELS, POINTS, D_FFN = 256, 8, 4, 4, 1024
#: support keys (`max_support_keypoints`) the kernel takes, at most
MAX_SUPPORT = 128

_PARAMS = (
    "pos_w", "pos_b", "pos_nw", "pos_nb", "aq_w", "ak_w", "av_w",
    "sa_qw", "sa_qb", "sa_kw", "sa_kb", "sa_vw", "sa_vb", "sa_ow", "sa_ob",
    "n2_w", "n2_b", "su_qw", "su_qb", "su_ow", "su_ob", "ns_w", "ns_b",
    "off_w", "off_b", "aw_w", "aw_b", "op_w", "op_b", "n1_w", "n1_b",
    "f1_w", "f1_b", "f2_w", "f2_b", "n3_w", "n3_b",
    "h0_w", "h0_b", "h1_w", "h1_b", "h2_w", "h2_b")
_IO = ("x", "ref", "pos", "cache_k", "cache_v", "sup_k", "sup_v",
       "sup_mask", "slab", "x_out", "ref_out")


class _Args(ctypes.Structure):
    """`DecodeLayerArgs` of `csrc/decode_layer.cu`, field for field."""

    _fields_ = ([(n, ctypes.c_void_p) for n in _PARAMS + _IO]
                + [(n, ctypes.c_longlong) for n in ("sup_sb", "sup_sh",
                                                     "sup_sn")]
                + [(n, ctypes.c_int) for n in ("x_fp32", "ref_sb", "batch",
                                               "cache_len", "n_sup",
                                               "slab_rows")]
                + [(n, ctypes.c_int * LEVELS) for n in ("lvl_h", "lvl_w",
                                                        "lvl_off")])


def _linear(m):
    return (m.weight, m.bias)


def layer_params(decoder, lid: int) -> Tuple[Optional[torch.Tensor], ...]:
    """The tensors of `_PARAMS` for layer `lid`, None where it has none."""
    layer = decoder.layers[lid]
    sine = decoder.query_pos_type == "sine"
    pos = (_linear(decoder.pos_trans) + _linear(decoder.pos_trans_norm)
           if sine else (None,) * 4)
    pre = ((layer.attn_q.weight, layer.attn_k.weight, layer.attn_v.weight)
           if isinstance(layer.attn_q, torch.nn.Linear) else (None,) * 3)
    sa, su, ca = layer.self_attn, layer.support_attn, layer.cross_attn
    head = decoder.coords_heads[str(lid)] if refines(decoder, lid) else None
    coords = (sum((_linear(m) for m in head.layers), ()) if head is not None
              else (None,) * 6)
    return (pos + pre + _linear(sa.q_proj) + _linear(sa.k_proj)
            + _linear(sa.v_proj) + _linear(sa.out_proj) + _linear(layer.norm2)
            + _linear(su.q_proj) + _linear(su.out_proj)
            + _linear(layer.norm_support) + _linear(ca.sampling_offsets)
            + _linear(ca.attention_weights) + _linear(ca.output_proj)
            + _linear(layer.norm1) + _linear(layer.linear1)
            + _linear(layer.linear2) + _linear(layer.norm3) + coords)


def refines(decoder, lid: int) -> bool:
    """Whether layer `lid` moves the reference point (`Decoder._refine`)."""
    return decoder.poly_refine or lid == decoder.num_layers - 1


def refusal(decoder, x: torch.Tensor, mem_value: torch.Tensor, cache,
            support_k: torch.Tensor) -> Optional[str]:
    """Why this step does not take the kernel, or None where it does. The
    device is asked last, so that a CPU tensor of a shape the kernel takes
    is refused for its device alone."""
    if decoder.layer_type != "v1" or decoder.attn_concat_src:
        return "not a v1 layer without a prefix"
    if mem_value.ndim != 3:
        return "no quad slab (CAPE_DECODE_PREQUAD=0)"
    layer = decoder.layers[0]
    ca = layer.cross_attn
    impl = resolve_impl(ca.n_levels * ca.n_points)
    if impl != "auto":
        return f"the MSDA selection is {impl!r}"
    dims = (decoder.d_model, decoder.n_heads, ca.n_levels, ca.n_points,
            layer.linear1.out_features)
    if dims != (D_MODEL, HEADS, LEVELS, POINTS, D_FFN):
        return (f"(d, heads, levels, points, ffn) {dims}: the kernel takes "
                f"{(D_MODEL, HEADS, LEVELS, POINTS, D_FFN)}")
    if decoder.dtype != torch.bfloat16 or cache.k.dtype != torch.bfloat16 \
            or mem_value.dtype != torch.bfloat16 \
            or x.dtype not in (torch.float32, torch.bfloat16):
        return (f"parameters {decoder.dtype}, cache {cache.k.dtype}, slab "
                f"{mem_value.dtype}, x {x.dtype}: the kernel takes bf16")
    if cache.k.shape[2] > decoder.query_embed.shape[0]:
        return f"a cache of {cache.k.shape[2]} slots, past seq_len"
    if support_k.shape[2] > MAX_SUPPORT:
        return (f"{support_k.shape[2]} support keys: the kernel takes "
                f"{MAX_SUPPORT}")
    if x.device.type != "cuda":
        return f"x on {x.device.type}"
    return None


def layer_step_plain(decoder, lid: int, x, ref, mem_value, spatial_shapes,
                     cache, pos, support_k, support_v, support_mask):
    """The chain: query position, `DecoderLayer.forward_step`, refinement.
    Returns (x, ref); the cache is written in place at `pos`."""
    B = x.shape[0]
    query_pos = decoder._query_pos(ref)
    ref_input = ref[:, :, None, :].expand(B, 1, decoder.n_levels, 2)
    x, _ = decoder.layers[lid].forward_step(
        x, query_pos, ref_input, mem_value, spatial_shapes, cache, pos,
        support_k, support_v, support_mask)
    return x, decoder._refine(lid, x, ref)


def _lib():
    fn = _build.load("decode_layer").decode_layer_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _ptr(t: Optional[torch.Tensor], what: str,
         dtype=torch.bfloat16) -> Optional[int]:
    if t is None:
        return None
    if t.dtype != dtype or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"decode_layer kernel: {what} must be contiguous "
                         f"{dtype} on a 16-byte boundary ({t.dtype})")
    return t.data_ptr()


def layer_step(decoder, lid: int, x, ref, mem_value, spatial_shapes, cache,
               pos, support_k, support_v, support_mask):
    """`layer_step_plain`'s function: the kernel on CUDA tensors (it raises
    on what it does not take), the chain on CPU tensors.

    Args:
        x: (B, 1, D) fp32 (layer 0, from the token embedding) or bf16.
        ref: (B, 1, 2) fp32, any batch stride.
        mem_value: (B*H, S', 4*Dh) the layer's quad slab.
        cache: the layer's `LayerCache`, (B, H, L, Dh) each.
        pos: 0-d int64 on the device, the slot written.
        support_k, support_v: (B, H, N, Dh); support_mask (B, N) bool.
    Returns:
        x (B, 1, D) bf16 and ref (B, 1, 2) fp32.
    """
    args = (x, ref, mem_value, spatial_shapes, cache, pos, support_k,
            support_v, support_mask)
    if x.device.type == "cpu":
        return layer_step_plain(decoder, lid, *args)
    why = refusal(decoder, x, mem_value, cache, support_k)
    if why:
        raise ValueError(f"decode_layer kernel: {why}")
    B = x.shape[0]
    if x.device.index != torch.cuda.current_device():
        raise ValueError("kernel inputs must be on the current CUDA device")
    if x.shape != (B, 1, D_MODEL) or ref.shape != (B, 1, 2) \
            or ref.dtype != torch.float32 or ref.stride(2) != 1:
        raise ValueError(f"decode_layer kernel: x {tuple(x.shape)} and ref "
                         f"{tuple(ref.shape)} {ref.dtype}")
    L = cache.k.shape[2]
    if cache.k.shape != (B, HEADS, L, D_MODEL // HEADS) \
            or cache.v.shape != cache.k.shape \
            or mem_value.shape[::2] != (B * HEADS, 4 * D_MODEL // HEADS):
        raise ValueError(f"decode_layer kernel: cache {tuple(cache.k.shape)}"
                         f" and slab {tuple(mem_value.shape)} for batch {B}")
    if pos.dtype != torch.int64 or pos.numel() != 1:
        raise ValueError("decode_layer kernel: pos must be one int64")
    if support_k.shape != support_v.shape or \
            support_k.stride() != support_v.stride() or \
            support_k.shape[:2] != (B, HEADS) or support_k.stride(3) != 1 \
            or any(s % 8 for s in support_k.stride()[:3]) \
            or support_k.dtype != torch.bfloat16 \
            or support_v.dtype != torch.bfloat16:
        raise ValueError("decode_layer kernel: support K/V (B, H, N, Dh) "
                         "bf16 with rows of Dh contiguous values expected")
    if support_mask.dtype != torch.bool or \
            support_mask.shape != (B, support_k.shape[2]):
        raise ValueError("decode_layer kernel: support_mask (B, N) bool")
    if any(t.data_ptr() % 16 for t in (support_k, support_v)):
        raise ValueError("decode_layer kernel: support K/V must lie on "
                         "16-byte boundaries")
    mask = support_mask.contiguous()
    x_out = torch.empty((B, 1, D_MODEL), dtype=torch.bfloat16,
                        device=x.device)
    refine = refines(decoder, lid)
    ref_out = torch.empty((B, 1, 2), dtype=torch.float32, device=x.device) \
        if refine else ref
    params = layer_params(decoder, lid)
    a = _Args(*([_ptr(p, n, torch.float32 if n.startswith("off")
                      else torch.bfloat16)
                 for p, n in zip(params, _PARAMS)] + [
        _ptr(x, "x", x.dtype), ref.data_ptr(), pos.data_ptr(),
        _ptr(cache.k, "cache"), _ptr(cache.v, "cache"),
        support_k.data_ptr(), support_v.data_ptr(), mask.data_ptr(),
        _ptr(mem_value, "quad slab"), x_out.data_ptr(),
        ref_out.data_ptr() if refine else None]))
    a.sup_sb, a.sup_sh, a.sup_sn = support_k.stride()[:3]
    a.x_fp32 = int(x.dtype == torch.float32)
    a.ref_sb = ref.stride(0)
    a.batch, a.cache_len = B, L
    a.n_sup, a.slab_rows = support_k.shape[2], mem_value.shape[1]
    a.lvl_h[:] = [h for h, _ in spatial_shapes]
    a.lvl_w[:] = [w for _, w in spatial_shapes]
    a.lvl_off[:] = list(quad_level_offsets(spatial_shapes))
    err = _lib()(ctypes.addressof(a), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"decode_layer kernel launch failed: CUDA error "
                           f"{err}")
    layer_step.launches += 1
    trace.count("decode.layer_step")
    return x_out, ref_out


layer_step.launches = 0
