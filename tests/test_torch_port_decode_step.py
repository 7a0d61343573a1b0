"""The decode's layer step (`cape_tpu_torch/ops/decode_step.py`): which
steps take the hand-written kernel (`csrc/decode_layer.cu`, card only) and
what the wrapper does on the CPU, where it runs the chain of modules the
decode ran before the kernel. No JAX.

- `refusal` answers for the flagship's bf16 layer (only the device is
  against it on the CPU), the tiny config, fp32, `CAPE_DECODE_PREQUAD=0`,
  forced `CAPE_MSDA_GATHER` / `CAPE_MSDA_TINY` names, a cache past
  `seq_len` and more support keys than the kernel takes;
- `qkv_proj=False`, `query_pos_type="none"` and `poly_refine=False` pass
  it, and reach the kernel as its arguments (`layer_params`);
- the module imports without CUDA or nvcc, and `ops.launch_counters` lists
  the kernel's counter;
- the argument struct the wrapper fills in ctypes has the C struct's
  fields, in its order;
- `layer_step` on CPU tensors is the chain, bit for bit: x, ref and the
  cache row written at the device position.
"""

from __future__ import annotations

import copy
import os
import re
import subprocess
import sys

import pytest
import torch

from cape_tpu_torch.config import tiny_test_config
from cape_tpu_torch.models.cape import CAPE
from cape_tpu_torch.models.decoder import Decoder, LayerCache
from cape_tpu_torch.ops import _build
from cape_tpu_torch.ops import decode_step as ds
from cape_tpu_torch.ops import launch_counters
from cape_tpu_torch.ops.msda import precompute_quad_slab

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the flagship's level shapes at 512 px, cut to 32 px here: the predicate
#: reads no level size, the chain's test below runs the tiny config's
SHAPES = ((4, 4), (2, 2), (1, 1), (1, 1))


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _decoder(d=256, ffn=1024, heads=8, dtype=torch.bfloat16, **kw):
    """A 2-layer decoder of the flagship's widths (or others), cast as
    `CAPE._cast` casts: the sampling offsets' projection stays fp32."""
    g = torch.Generator().manual_seed(0)
    dec = Decoder(num_layers=2, d_model=d, d_ffn=ffn, n_heads=heads,
                  n_levels=4, n_points=4, seq_len=200, **kw)
    with torch.no_grad():
        for p in dec.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    dec.to(dtype)
    for layer in dec.layers:
        layer.cross_attn.sampling_offsets.float()
    dec.query_embed.data = dec.query_embed.data.float()
    return dec


def _step_inputs(dec, B=2, L=18, N=100, x_dtype=torch.float32):
    """(x, slab, cache, support K) of a step at these sizes: only their
    shapes and dtypes reach `refusal`."""
    d, H = dec.d_model, dec.n_heads
    x = torch.zeros((B, 1, d), dtype=x_dtype)
    value = torch.zeros((B, sum(h * w for h, w in SHAPES), H, d // H),
                        dtype=dec.dtype)
    slab = precompute_quad_slab(value, SHAPES)
    cache = LayerCache(torch.zeros((B, H, L, d // H), dtype=dec.dtype),
                       torch.zeros((B, H, L, d // H), dtype=dec.dtype))
    sk = torch.zeros((B, H, N, d // H), dtype=dec.dtype)
    return x, slab, cache, sk


@pytest.mark.parametrize("case, env, want", [
    ("flagship_bf16", {}, "x on cpu"),
    ("flagship_bf16_input", {}, "x on cpu"),
    ("tiny", {}, "(d, heads, levels, points, ffn)"),
    ("fp32", {}, "the kernel takes bf16"),
    ("prequad_off", {"CAPE_DECODE_PREQUAD": "0"}, "no quad slab"),
    ("forced_gather", {"CAPE_MSDA_GATHER": "fused"},
     "the MSDA selection is 'fused'"),
    ("forced_tiny", {"CAPE_MSDA_TINY": "xla"}, "the MSDA selection is 'xla'"),
    ("long_cache", {}, "past seq_len"),
    ("many_support", {}, "support keys"),
])
def test_refusal_answers(monkeypatch, case, env, want):
    """The flagship's bf16 step is refused for its CPU device alone (the
    device is asked last); every other case keeps the chain for its own
    reason."""
    for k in ("CAPE_MSDA_GATHER", "CAPE_MSDA_TINY", "CAPE_DECODE_PREQUAD"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if case == "tiny":
        dec = _decoder(d=64, ffn=128, heads=4, dtype=torch.float32)
    else:
        dec = _decoder(dtype=torch.float32 if case == "fp32" else
                       torch.bfloat16)
    x, slab, cache, sk = _step_inputs(
        dec, L=201 if case == "long_cache" else 18,
        N=129 if case == "many_support" else 100,
        x_dtype=torch.bfloat16 if case == "flagship_bf16_input"
        else torch.float32)
    if case == "prequad_off":
        # what `precompute_static` keeps under CAPE_DECODE_PREQUAD=0
        slab = torch.zeros((2, 22, dec.n_heads, dec.d_model // dec.n_heads),
                           dtype=dec.dtype)
    why = ds.refusal(dec, x, slab, cache, sk)
    assert why is not None and want in why, why


@pytest.mark.parametrize("kw", [
    {"qkv_proj": False}, {"query_pos_type": "none"}, {"poly_refine": False},
    {"qkv_proj": False, "query_pos_type": "none", "poly_refine": False},
], ids=["no_qkv_proj", "no_query_pos", "no_poly_refine", "all_three"])
def test_options_reach_the_kernel_as_arguments(kw):
    """The three options pass the predicate (only the CPU is against them)
    and become null parameters of the kernel's struct: no pre-projections,
    no query position, no coordinate head where the layer does not
    refine."""
    dec = _decoder(**kw)
    x, slab, cache, sk = _step_inputs(dec)
    assert ds.refusal(dec, x, slab, cache, sk) == "x on cpu"
    names = dict(zip(ds._PARAMS, ds.layer_params(dec, 0)))
    last = dict(zip(ds._PARAMS, ds.layer_params(dec, 1)))
    pre = ("aq_w", "ak_w", "av_w")
    pos = ("pos_w", "pos_b", "pos_nw", "pos_nb")
    head = ("h0_w", "h0_b", "h1_w", "h1_b", "h2_w", "h2_b")
    assert all((names[n] is None) == (not kw.get("qkv_proj", True))
               for n in pre)
    assert all((names[n] is None) == (kw.get("query_pos_type") == "none")
               for n in pos)
    assert all((names[n] is None) == (not kw.get("poly_refine", True))
               for n in head)
    # the last layer always refines (`Decoder._refine`)
    assert all(last[n] is not None for n in head)
    assert ds.refines(dec, 1) and ds.refines(dec, 0) == kw.get(
        "poly_refine", True)
    # every tensor the kernel reads is the module's own parameter
    params = {id(p) for p in dec.parameters()}
    assert all(id(t) in params for t in names.values() if t is not None)


def test_imports_without_cuda_or_nvcc():
    """Importing the wrapper builds nothing and needs neither a card nor
    nvcc: the kernel is built at its first launch."""
    env = dict(os.environ, CUDA_HOME="/nonexistent", PATH="/usr/bin:/bin",
               CUDA_VISIBLE_DEVICES="")
    env.pop("CUDA_PATH", None)
    code = ("import cape_tpu_torch.ops.decode_step as d, torch; "
            "print(d.layer_step.launches, torch.cuda.is_available())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["0", "False"]


def test_launch_counters_list_the_kernel():
    counters = launch_counters()
    assert counters["decode_layer"] == (ds.layer_step, "launches")
    assert "decode_layer" in _build.SOURCES


def test_ctypes_struct_matches_the_c_struct():
    """`_Args` lists `DecodeLayerArgs`' fields in the C source's order, with
    pointers as pointers, the strides as 64-bit and the rest as ints."""
    import ctypes

    src = open(os.path.join(ROOT, "cape_tpu_torch", "ops", "csrc",
                            "decode_layer.cu")).read()
    body = src[src.index("struct DecodeLayerArgs {"):]
    body = re.sub(r"//[^\n]*", "", body[:body.index("};")].split("{", 1)[1])
    c_fields = []
    for decl in body.split(";"):
        decl = " ".join(decl.split())
        if not decl:
            continue
        kind = "ptr" if "*" in decl else (
            "long" if decl.startswith("long long") else "int")
        names = re.sub(r"^(const )?(bf16|float|void|long long|int|"
                       r"unsigned char) ?", "", decl)
        for name in names.split(","):
            name = name.strip().lstrip("*").strip()
            c_fields.append((name.split("[")[0],
                             "arr" if "[" in name else kind))
    kinds = {ctypes.c_void_p: "ptr", ctypes.c_longlong: "long",
             ctypes.c_int: "int"}
    py = [(n, kinds.get(t, "arr")) for n, t in ds._Args._fields_]
    assert py == c_fields


def _chain(dec, lid, x, ref, mem_value, shapes, cache, pos, sk, sv, mask):
    """The decode's layer step as `Decoder.forward_step` ran it before the
    kernel: query position, the layer, refinement."""
    B = x.shape[0]
    query_pos = dec._query_pos(ref)
    ref_input = ref[:, :, None, :].expand(B, 1, dec.n_levels, 2)
    x, _ = dec.layers[lid].forward_step(
        x, query_pos, ref_input, mem_value, shapes, cache, pos, sk, sv, mask)
    return x, dec._refine(lid, x, ref)


@pytest.mark.parametrize("lid", [0, 1])
@pytest.mark.parametrize("kw", [{}, {"dec_qkv_proj": False},
                                {"query_pos_type": "none",
                                 "with_poly_refine": False}],
                         ids=["default", "no_qkv_proj", "plain_options"])
def test_layer_step_on_cpu_is_the_chain(lid, kw):
    """On CPU tensors the wrapper returns the chain's x and ref and writes
    the chain's cache row, bit for bit, at the tiny config's shapes (a
    real model's weights, a position mid-cache, a support set with padding
    and an expanded reference point as the decode passes it)."""
    cfg = tiny_test_config(**kw)
    model = CAPE(cfg, device="cpu",
                 generator=torch.Generator().manual_seed(3))
    dec, shapes = model.decoder, model.spatial_shapes
    g = torch.Generator().manual_seed(4)
    B, L = 2, 9
    S = sum(h * w for h, w in shapes)
    memory = torch.randn((B, S, cfg.hidden_dim), generator=g)
    feats = torch.randn((B, cfg.max_support_keypoints, cfg.hidden_dim),
                        generator=g)
    mask = torch.zeros((B, cfg.max_support_keypoints), dtype=torch.bool)
    mask[0, 5:] = True
    mems, kvs = dec.precompute_static(memory, feats, shapes)
    H, dh = cfg.nheads, cfg.hidden_dim // cfg.nheads
    k0 = torch.randn((B, H, L, dh), generator=g)
    v0 = torch.randn((B, H, L, dh), generator=g)
    x = torch.randn((B, 1, cfg.hidden_dim), generator=g)
    ref = torch.sigmoid(torch.randn((1, 1, 2), generator=g)).expand(B, 1, 2)
    pos = torch.tensor(4)
    got_cache = LayerCache(k0.clone(), v0.clone())
    want_cache = LayerCache(k0.clone(), v0.clone())
    launches = ds.layer_step.launches
    got = ds.layer_step(dec, lid, x, ref, mems[lid], shapes, got_cache, pos,
                        *kvs[lid], mask)
    want = _chain(copy.deepcopy(dec), lid, x, ref, mems[lid], shapes,
                  want_cache, pos, *kvs[lid], mask)
    assert ds.layer_step.launches == launches     # CPU calls never count
    for a, b in zip(got + tuple(got_cache), want + tuple(want_cache)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert not torch.equal(got_cache.k[:, :, 4], k0[:, :, 4])
    assert torch.equal(got_cache.k[:, :, :4], k0[:, :, :4])
