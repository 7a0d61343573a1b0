#!/usr/bin/env python3
"""Time the whole-op MSDA forward (`msda_forward`) and the fused level
sample's forward (`fused_fwd`) on the card at the paths' shapes.

Run from the root of a checkout on a machine with one CUDA card:
`python3 <path to>/torch_sample_fwd_sweep.py [--variants]`. The port is
imported from the working directory, so the same script times another
checkout of it (an older one included) when run from that checkout's
root; the inputs come from the `chip_smoke.py` beside this script, from
a seed, so every checkout is timed on the same ones. Times are
`chip_smoke.device_ms` (the call captured 20 times into a CUDA graph and
replayed) and, as `ms`, eager calls between two events.

- `msda_forward`, bf16, at the serving encoder (8 images), the training
  encoder (4) and the teacher-forced decoder (4 images, 200 queries), with
  uniform and with model-like locations: the op as the checkout runs it
  (`ms_deform_attn_pallas`: one kernel, or the corner preparation, the
  value's transpose, a kernel over the prepared corners and the output's
  transpose), and where the checkout has them apart, `prepare_corners`
  alone and that kernel alone. Each output is checked against the direct
  4-corner core (`ms_deform_attn_core_naive`) in fp32.
- `fused_fwd` (`fused_level_sample`), bf16, at the encoder's four levels
  (64 slabs), the teacher-forced decoder's level 0 (32 slabs) and the
  decode step (64 slabs of 4 rows), with uniform and model-like indices,
  each checked against `fused_level_sample_plain`.
- `--variants`: two throwaway builds of the fused forward, compiled here
  with nvcc from `VARIANTS` below, that test what limits a design of one
  row a thread: (a) its mapping (a thread per 4 bf16 values of a row)
  loading gi and w4 and storing the sum of the row's w4, with no gather:
  what the output write alone costs; (b) the same design, one row and
  one dependent chain a thread, in 16-byte lanes; (c) the output written
  alone (`zero_`); and (d) a design of k = 4 rows a thread, a tile's
  stride apart, whose gi and w4 are loaded before any corner, all 16
  corner loads issued at once and the next tile's gi and w4 loaded before
  the stores, on a grid of at most 8 blocks an SM that walks the tiles
  (k = 1 or 2 where the tiles would not fill the card). At the encoder's
  four levels and the decoder's level 0, uniform indices.

One JSON line per case. Nothing on the port's paths calls this script.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import inspect
import json
import os
import subprocess
import sys

#: the throwaway variants of `--variants` (bf16 only), C interface
VARIANTS = r"""
#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ float lo(unsigned x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float hi(unsigned x) { return __uint_as_float(x & 0xffff0000u); }
__device__ __forceinline__ unsigned pk(float a, float b) {
  __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<unsigned*>(&p);
}

// (a) a thread per 4 values of a row: gi and w4, then one 8-byte store
__global__ void sum_w4_kernel(const int* __restrict__ gi,
                              const uint2* __restrict__ w4,
                              uint2* __restrict__ out, int N, int lg) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= (N << lg)) return;
  const long long r = (long long)blockIdx.y * N + (i >> lg);
  const int g = __ldg(gi + r);
  const uint2 w = __ldg(w4 + r);
  const float s = lo(w.x) + hi(w.x) + lo(w.y) + hi(w.y) + (g == -2147483647 - 1);
  uint2 o;
  o.x = pk(s, s);
  o.y = o.x;
  out[(r << lg) + (i & ((1 << lg) - 1))] = o;
}

// (b) one row and one chain a thread, in 16-byte lanes (8 bf16 values)
__global__ void one_row16_kernel(const uint4* __restrict__ slab,
                                 const int* __restrict__ gi,
                                 const uint2* __restrict__ w4,
                                 uint4* __restrict__ out, int HW, int N,
                                 int Wl, int lg, long long slab_bs) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= (N << lg)) return;
  const long long b = blockIdx.y;
  const long long r = b * N + (i >> lg);
  const int q = i & ((1 << lg) - 1);
  const long long base = __ldg(gi + r);
  const uint2 wr = __ldg(w4 + r);
  const float wc[4] = {lo(wr.x), hi(wr.x), lo(wr.y), hi(wr.y)};
  const int shift[4] = {0, 1, Wl, Wl + 1};
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const long long idx = base + shift[c];
    if (idx < 0 || idx >= HW) continue;
    const uint4 v = __ldg(slab + ((b * slab_bs + idx) << lg) + q);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc[2 * k] += wc[c] * lo(w[k]);
      acc[2 * k + 1] += wc[c] * hi(w[k]);
    }
  }
  uint4 o;
  o.x = pk(acc[0], acc[1]);
  o.y = pk(acc[2], acc[3]);
  o.z = pk(acc[4], acc[5]);
  o.w = pk(acc[6], acc[7]);
  out[(r << lg) + q] = o;
}

// (d) k rows a thread, loads ahead, a grid that walks the tiles
template <int K>
__global__ void __launch_bounds__(256) rows_k_kernel(
    const uint4* __restrict__ slab, const int* __restrict__ gi,
    const uint2* __restrict__ w4, uint4* __restrict__ out, int HW, int N,
    int Wl, int lg, int R, int tiles, long long slab_bs) {
  const int u = threadIdx.x & ((1 << lg) - 1), ro = threadIdx.x >> lg;
  const int tile_rows = blockDim.x >> lg;
  const int shift[4] = {0, 1, Wl, Wl + 1};
  int r[K], g[K];
  long long base[K];
  uint2 w[K];
  auto meta = [&](int t) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int row = (t * K + j) * tile_rows + ro;
      r[j] = row < R ? row : -1;
      g[j] = row < R ? __ldg(gi + row) : 0;
      w[j] = row < R ? __ldg(w4 + row) : make_uint2(0, 0);
      base[j] = row < R ? (long long)(row / N) * slab_bs : 0;
    }
  };
  int t = blockIdx.x;
  meta(t);
  while (t < tiles) {
    uint4 v[K][4];
#pragma unroll
    for (int j = 0; j < K; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int idx = g[j] + shift[c];
        v[j][c] = r[j] >= 0 && idx >= 0 && idx < HW
                      ? __ldg(slab + ((base[j] + idx) << lg) + u)
                      : make_uint4(0, 0, 0, 0);
      }
    int rc[K];
    uint2 wc[K];
#pragma unroll
    for (int j = 0; j < K; ++j) { rc[j] = r[j]; wc[j] = w[j]; }
    t += gridDim.x;
    if (t < tiles) meta(t);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float ws[4] = {lo(wc[j].x), hi(wc[j].x), lo(wc[j].y), hi(wc[j].y)};
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const unsigned x[4] = {v[j][c].x, v[j][c].y, v[j][c].z, v[j][c].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[2 * q] += ws[c] * lo(x[q]);
          acc[2 * q + 1] += ws[c] * hi(x[q]);
        }
      }
      if (rc[j] >= 0)
        __stcs(out + ((long long)rc[j] << lg) + u,
               make_uint4(pk(acc[0], acc[1]), pk(acc[2], acc[3]),
                          pk(acc[4], acc[5]), pk(acc[6], acc[7])));
    }
  }
}

// which 0: (a), Dh / 4 lanes a row; which 1: (b), Dh / 8 lanes a row;
// which 2: (d), Dh / 8 lanes a row
extern "C" int variant_launch(int which, const void* slab, const void* gi,
                              const void* w4, void* out, int BH, int HW,
                              int N, int Wl, int Dh, long long slab_bs,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int lanes = which == 0 ? Dh / 4 : Dh / 8;
  int lg = 0;
  while ((1 << lg) < lanes) ++lg;
  if (which == 2) {
    const int R = BH * N, tile_rows = 256 >> lg;
    int k = 4, tiles = 0;
    for (; k > 1; k /= 2)
      if ((R + k * tile_rows - 1) / (k * tile_rows) >= 2 * 132) break;
    tiles = (R + k * tile_rows - 1) / (k * tile_rows);
    const int blocks = tiles < 8 * 132 ? tiles : 8 * 132;
    const uint4* sl = (const uint4*)slab;
    const int* g = (const int*)gi;
    const uint2* w = (const uint2*)w4;
    if (k == 4)
      rows_k_kernel<4><<<blocks, 256, 0, s>>>(sl, g, w, (uint4*)out, HW, N,
                                              Wl, lg, R, tiles, slab_bs);
    else if (k == 2)
      rows_k_kernel<2><<<blocks, 256, 0, s>>>(sl, g, w, (uint4*)out, HW, N,
                                              Wl, lg, R, tiles, slab_bs);
    else
      rows_k_kernel<1><<<blocks, 256, 0, s>>>(sl, g, w, (uint4*)out, HW, N,
                                              Wl, lg, R, tiles, slab_bs);
    return (int)cudaGetLastError();
  }
  const dim3 grid((unsigned)(((long long)N * lanes + 255) / 256), BH, 1);
  if (which == 0)
    sum_w4_kernel<<<grid, 256, 0, s>>>((const int*)gi, (const uint2*)w4,
                                       (uint2*)out, N, lg);
  else
    one_row16_kernel<<<grid, 256, 0, s>>>((const uint4*)slab,
                                          (const int*)gi, (const uint2*)w4,
                                          (uint4*)out, HW, N, Wl, lg,
                                          slab_bs);
  return (int)cudaGetLastError();
}
"""


def _load_chip_smoke():
    """This checkout's `chip_smoke.py` (inputs, timers), whichever checkout
    the port is imported from."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("sweep_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _variants_lib(build_dir):
    """Compile `VARIANTS` with the port's nvcc flags into `build_dir`."""
    from cape_tpu_torch.ops import _build

    os.makedirs(build_dir, exist_ok=True)
    src = os.path.join(build_dir, "fwd_variants.cu")
    lib = os.path.join(build_dir, "libfwd_variants.so")
    with open(src, "w") as f:
        f.write(VARIANTS)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
                   check=True)
    fn = ctypes.CDLL(lib).variant_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 5 + [ctypes.c_longlong,
                                           ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def sweep_msda(torch, cs, card):
    from cape_tpu_torch.models.cape import level_shapes
    from cape_tpu_torch.ops import msda_kernel as mk
    from cape_tpu_torch.ops.msda import ms_deform_attn_core_naive

    g = torch.Generator(device="cuda").manual_seed(0)
    shapes = level_shapes(512, 4)
    # an older checkout's kernel takes the prepared corners
    split = "value_bh" in inspect.signature(mk.msda_forward).parameters
    for site, (B, Lq) in cs.MSDA_CASES.items():
        for kind in ("uniform", "model"):
            value, loc, attn = cs._msda_inputs(torch, g, shapes, B, Lq, kind,
                                               torch.bfloat16)
            args = (value, shapes, loc, attn)
            got = mk.ms_deform_attn_pallas(*args)
            want = ms_deform_attn_core_naive(value.float(), shapes, loc,
                                             attn.float())
            torch.cuda.synchronize()
            cs.check(torch.allclose(got.float(), want, atol=1e-3,
                                    rtol=2 ** -7),
                     f"msda differs from the 4-corner core ({site}, {kind})")
            t = {"op": dict(zip(("ms", "device_ms"), cs.both_ms(
                torch, lambda: mk.ms_deform_attn_pallas(*args))))}
            if split:
                t["prepare_corners"] = dict(zip(("ms", "device_ms"),
                                                cs.both_ms(
                    torch, lambda: mk.prepare_corners(shapes, loc, attn))))
                S, H, Dh = value.shape[1:]
                corners = mk.prepare_corners(shapes, loc, attn)
                value_bh = value.transpose(1, 2).reshape(
                    B * H, S, Dh).contiguous()
                t["kernel"] = dict(zip(("ms", "device_ms"), cs.both_ms(
                    torch, lambda: mk.msda_forward(value_bh, *corners))))
                del corners, value_bh
            b_ms, o_ms = cs._msda_bound_ms(torch, *args)
            t["bound_ms"] = max(b_ms, o_ms)
            print(f"msda_forward [{site}, {kind} locations] {json.dumps(t)} "
                  f"({card})", flush=True)
            del value, loc, attn, args, got, want


def sweep_fused(torch, cs, card, variant):
    from cape_tpu_torch.models.cape import level_shapes
    from cape_tpu_torch.ops import msda_fused as mf

    g = torch.Generator(device="cuda").manual_seed(0)
    shapes = level_shapes(512, 4)
    for label, BH, (Hl, Wl, N) in cs.FWD_TIMED:
        lvl = int(label[-1])
        refs = cs._encoder_refs(torch, shapes, BH // 8, "cuda") \
            if label.startswith("encoder") \
            else torch.rand(BH // 8, N // 4, 2, generator=g, device="cuda")
        local = cs._model_indices(torch, g, shapes, BH // 8, 8, 4, refs)[lvl]
        for kind in ("uniform", "model"):
            slab, gi, w4, _ = cs._sample_inputs(
                torch, g, BH, Hl, Wl, N, 32, torch.bfloat16, False,
                awkward=False)
            if kind == "model":
                gi = (local - (Wl + 1)).contiguous()
            args = (slab, gi, w4, Wl)
            got = mf.fused_level_sample(*args)
            want = mf.fused_level_sample_plain(*args)
            torch.cuda.synchronize()
            cs.check(torch.allclose(got.float(), want.float(), atol=1e-5,
                                    rtol=2 ** -7),
                     f"fused_fwd differs from plain ({label}, {kind})")
            t = {"fused_fwd": dict(zip(("ms", "device_ms"), cs.both_ms(
                torch, lambda: mf.fused_level_sample(*args))))}
            t["bound_ms"] = max(cs._sample_bound_ms(torch, slab, gi, w4, Wl,
                                                    False))
            if variant is not None and not label.startswith("decode step") \
                    and kind == "uniform":
                out = torch.empty_like(got)
                stride = slab.stride(0) // 32
                for which, name in ((0, "(a) sum of w4, no gather"),
                                    (1, "(b) one row a thread, 16-byte "
                                        "lanes"),
                                    (2, "(d) k rows a thread, loads ahead, "
                                        "a grid that walks the tiles")):
                    def run(which=which):
                        err = variant(
                            which, slab.data_ptr(), gi.data_ptr(),
                            w4.data_ptr(), out.data_ptr(), BH, Hl * Wl, N,
                            Wl, 32, stride,
                            torch.cuda.current_stream().cuda_stream)
                        cs.check(err == 0, f"variant launch: error {err}")
                    run()
                    torch.cuda.synchronize()
                    if which > 0:
                        cs.check(torch.allclose(out.float(), want.float(),
                                                atol=1e-5, rtol=2 ** -7),
                                 f"variant {name} differs ({label})")
                    t[name] = {"device_ms": cs.device_ms(torch, run)}
                t["(c) the output written alone (zero_)"] = {
                    "device_ms": cs.device_ms(torch, out.zero_)}
                del out
            print(f"fused_fwd [{label}, {kind} indices] {json.dumps(t)} "
                  f"({card})", flush=True)
            del slab, gi, w4, args, got, want
        del local, refs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", action="store_true",
                    help="also time the throwaway fused forwards")
    ap.add_argument("--only", choices=("msda", "fused"),
                    help="time one of the two kernels")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_sample_fwd_sweep: CUDA is not available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    cs = _load_chip_smoke()
    card = cs.card_identity()
    print(f"{card}; port from {os.getcwd()}", flush=True)
    from cape_tpu_torch.ops import _build

    _build.build_all()
    variant = _variants_lib(str(_build.BUILD_DIR / "fwd_variants")) \
        if args.variants else None
    with torch.no_grad():
        if args.only != "fused":
            sweep_msda(torch, cs, card)
        if args.only != "msda":
            sweep_fused(torch, cs, card, variant)
    return 0


if __name__ == "__main__":
    sys.exit(main())
