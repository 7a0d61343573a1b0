// Fused MSDA level sample over the QUAD slab, forward and backward:
//   out[b, r, d]             = sum_c w4[b, r, c] * slab[b, gi[b, r], c*Dh + d]
//   dslab[b, s, c*Dh + d]    = sum over r with gi[b, r] == s of
//                              w4[b, r, c] * dout[b, r, d]
//   dw4[b, r, c]             = sum_d dout[b, r, d] * slab[b, gi[b, r], c*Dh + d]
// A quad row holds the 2x2 bilinear neighbourhood of one grid cell as four
// Dh-wide bands, so one row index serves all four corners. A row index
// outside [0, n) gives a zero output row and dw4 = 0, adds nothing to
// dslab, and is never read.
//
// Replaces the Pallas kernels `_quadfused_fwd_kernel`
// (cape_tpu/ops/msda_fused.py:231, pallas_call at :294) and
// `_quadfused_bwd_kernel` (:249, pallas_call at :313). On the TPU the row
// gather is a one-hot matmul, the blend a lane-repeated weight and the
// corner sum a second matmul; dslab is carried across sequential grid
// steps. Here a thread loads the four bands of its row directly, and the
// backward's sum across rows that share an index is made with atomics.
//
// Bound: bytes. Forward: the quad rows selected (4 * Dh values each), gi,
// w4 and the (BH, N, Dh) output, each once. Backward: the same reads plus
// dout, and dslab (4 * Dh wide) and dw4 written once. The gathered
// (BH, N, 4 * Dh) rows stay in registers.
//
// Design: as fused.cu, one thread per group of 4 consecutive channels of
// an output row (rows4.cuh); it reads the same group of each of the four
// bands, so the Dh / 4 lanes of a row read 4 runs of Dh * elt contiguous
// bytes of one quad row. Sums are fp32 with one rounding at the store (the
// TPU kernel also rounds each w * g term to the slab dtype before the
// corner sum). Backward: one float4 vector atomic per band into a zeroed
// fp32 buffer, cast by the wrapper; about 5 rows share a quad row at the
// encoder's level 0 and about 300 at its smallest level. dw4 is a shuffle
// reduction over the row's lanes.

#include "rows4.cuh"

using namespace rows4;

namespace {

template <bool kBf16>
__global__ void quadfused_fwd_kernel(const void* __restrict__ slab,
                                     const int* __restrict__ gi,
                                     const void* __restrict__ w4,
                                     void* __restrict__ out, int n, int N,
                                     int lg, long long slab_bs) {
  const int i = blockIdx.x * kThreads + threadIdx.x;  // group in the slab
  if (i >= (N << lg)) return;
  const long long b = blockIdx.y;
  const long long r = b * N + (i >> lg);
  const int q = i & ((1 << lg) - 1);
  const int idx = __ldg(gi + r);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (idx >= 0 && idx < n) {
    const float4 w = load4<kBf16>(w4, r);
    const float wc[4] = {w.x, w.y, w.z, w.w};
    const long long row = (b * slab_bs + idx) << (lg + 2);  // 4 bands
#pragma unroll
    for (int c = 0; c < 4; ++c)
      fma4(acc, wc[c], load4<kBf16>(slab, row + (c << lg) + q));
  }
  store4<kBf16>(out, (r << lg) + q, acc);
}

template <bool kBf16>
__global__ void quadfused_bwd_kernel(const void* __restrict__ slab,
                                     const int* __restrict__ gi,
                                     const void* __restrict__ w4,
                                     const void* __restrict__ dout,
                                     float4* __restrict__ dslab,
                                     void* __restrict__ dw4, int n, int N,
                                     int lg, long long slab_bs) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool active = i < (N << lg);  // whole rows: N << lg groups
  const long long b = blockIdx.y;
  const long long r = b * N + (i >> lg);
  const int q = i & ((1 << lg) - 1);
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  if (active) {
    const int idx = __ldg(gi + r);
    if (idx >= 0 && idx < n) {
      const float4 w = load4<kBf16>(w4, r);
      const float4 d = load4<kBf16>(dout, (r << lg) + q);
      const float wc[4] = {w.x, w.y, w.z, w.w};
      const long long row = (b * slab_bs + idx) << (lg + 2);
      const long long drow = (b * n + idx) << (lg + 2);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        p[c] = dot4(d, load4<kBf16>(slab, row + (c << lg) + q));
        atomicAdd(dslab + (drow + (c << lg) + q),
                  make_float4(wc[c] * d.x, wc[c] * d.y, wc[c] * d.z,
                              wc[c] * d.w));
      }
    }
  }
  row_sum4(p, 1 << lg);
  if (active && q == 0)
    store4<kBf16>(dw4, r, make_float4(p[0], p[1], p[2], p[3]));
}

}  // namespace

// slab: BH quad slabs of (n, 4 * Dh) rows of fp32 (dtype 0) or bf16
// (dtype 1), slab b starting `slab_bs` ROWS after slab b - 1 (n for a
// contiguous array); gi (BH, N) int32; w4 (BH, N, 4) and out (BH, N, Dh)
// contiguous, in the slab's dtype. Everything 16-byte aligned; Dh / 4 a
// power of two up to 32; BH at most 65535. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int quadfused_fwd_launch(const void* slab, const void* gi,
                                    const void* w4, void* out, int BH, int n,
                                    int N, int Dh, long long slab_bs,
                                    int dtype, void* stream) {
  int lg, err;
  const dim3 grid = launch_grid(BH, N, Dh, dtype, &lg, &err);
  if (err) return err;
  if (grid.x > 0 && grid.y > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 1) {
      quadfused_fwd_kernel<true><<<grid, kThreads, 0, s>>>(
          slab, (const int*)gi, w4, out, n, N, lg, slab_bs);
    } else {
      quadfused_fwd_kernel<false><<<grid, kThreads, 0, s>>>(
          slab, (const int*)gi, w4, out, n, N, lg, slab_bs);
    }
  }
  return (int)cudaGetLastError();
}

// As above plus dout (BH, N, Dh) in the slab's dtype; dslab (BH, n, 4 * Dh)
// fp32, contiguous and zeroed by the caller; dw4 (BH, N, 4) in the slab's
// dtype.
extern "C" int quadfused_bwd_launch(const void* slab, const void* gi,
                                    const void* w4, const void* dout,
                                    void* dslab, void* dw4, int BH, int n,
                                    int N, int Dh, long long slab_bs,
                                    int dtype, void* stream) {
  int lg, err;
  const dim3 grid = launch_grid(BH, N, Dh, dtype, &lg, &err);
  if (err) return err;
  if (grid.x > 0 && grid.y > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 1) {
      quadfused_bwd_kernel<true><<<grid, kThreads, 0, s>>>(
          slab, (const int*)gi, w4, dout, (float4*)dslab, dw4, n, N, lg,
          slab_bs);
    } else {
      quadfused_bwd_kernel<false><<<grid, kThreads, 0, s>>>(
          slab, (const int*)gi, w4, dout, (float4*)dslab, dw4, n, N, lg,
          slab_bs);
    }
  }
  return (int)cudaGetLastError();
}
