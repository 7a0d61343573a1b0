// Fused MSDA level sample over the RAW level slab, forward and backward:
//   out[b, r, :]   = sum_c w4[b, r, c] * slab[b, gi[b, r] + shift_c, :]
//   dslab[b, s, :] = sum over (r, c) with gi[b, r] + shift_c == s of
//                    w4[b, r, c] * dout[b, r, :]
//   dw4[b, r, c]   = <dout[b, r, :], slab[b, gi[b, r] + shift_c, :]>
// with shifts (0, 1, Wl, Wl + 1), the four bilinear corners of flat cell
// gi. A corner whose index lies outside [0, HW) adds nothing to out and to
// dslab and gets dw4 = 0; it is never read.
//
// Replaces the Pallas kernels `_fused_fwd_kernel`
// (cape_tpu/ops/msda_fused.py:88, pallas_call at :165) and
// `_fused_bwd_kernel` (:99, pallas_call at :183). On the TPU the gather is
// a weighted one-hot matrix (four compares over an (R, HW) tile) times
// the slab on the MXU, because Mosaic cannot gather, and the backward
// carries dslab across sequential grid steps. Here a thread computes
// gi + shift_c, tests the range and loads the row; blocks run in no
// order, so the backward's sum across rows is made with atomics.
//
// Bound: bytes. Forward: the slab rows the corners select, gi, w4 and
// the (BH, N, Dh) output, each once; the 8 flops a loaded value costs are
// far below the card's fp32 rate. Backward: the same reads plus dout, and
// dslab and dw4 written once. Neither writes the (BH, N, 4 * Dh) gathered
// rows that the quad-row path puts through device memory.
//
// Design: one thread per group of 4 consecutive channels of an output row
// (rows4.cuh), so Dh / 4 neighbouring lanes share a row: they read its gi
// and w4 from the same address (one broadcast access), each corner as
// Dh * elt contiguous bytes, and a warp writes 32 / (Dh / 4) whole
// consecutive output rows. Sums are fp32 with one rounding at the store.
// Backward: each thread adds w_c * dout to dslab with one float4 vector
// atomic (as scatter.cu: whole 32-byte sectors) into a zeroed fp32 buffer
// that the wrapper casts to the slab dtype; the order of that sum varies
// from run to run. About 21 corners land on each slab row at the
// encoder's level 0 and about 1,360 at its smallest level, where the
// atomics serialise in the L2; a per-block partial sum in shared memory
// would take that off. dw4 needs no atomics: the row's lanes reduce their
// partial dot products with shuffles and lane 0 of the row stores all 4.

#include "rows4.cuh"

using namespace rows4;

namespace {

template <bool kBf16>
__global__ void fused_fwd_kernel(const void* __restrict__ slab,
                                 const int* __restrict__ gi,
                                 const void* __restrict__ w4,
                                 void* __restrict__ out, int HW, int N,
                                 int Wl, int lg, long long slab_bs) {
  const int i = blockIdx.x * kThreads + threadIdx.x;  // group in the slab
  if (i >= (N << lg)) return;
  const long long b = blockIdx.y;
  const long long r = b * N + (i >> lg);
  const int q = i & ((1 << lg) - 1);
  const long long base = __ldg(gi + r);
  const float4 w = load4<kBf16>(w4, r);
  const float wc[4] = {w.x, w.y, w.z, w.w};
  const int shift[4] = {0, 1, Wl, Wl + 1};
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const long long idx = base + shift[c];
    if (idx < 0 || idx >= HW) continue;
    fma4(acc, wc[c], load4<kBf16>(slab, ((b * slab_bs + idx) << lg) + q));
  }
  store4<kBf16>(out, (r << lg) + q, acc);
}

template <bool kBf16>
__global__ void fused_bwd_kernel(const void* __restrict__ slab,
                                 const int* __restrict__ gi,
                                 const void* __restrict__ w4,
                                 const void* __restrict__ dout,
                                 float4* __restrict__ dslab,
                                 void* __restrict__ dw4, int HW, int N,
                                 int Wl, int lg, long long slab_bs) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool active = i < (N << lg);  // whole rows: N << lg groups
  const long long b = blockIdx.y;
  const long long r = b * N + (i >> lg);
  const int q = i & ((1 << lg) - 1);
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  if (active) {
    const long long base = __ldg(gi + r);
    const float4 w = load4<kBf16>(w4, r);
    const float4 d = load4<kBf16>(dout, (r << lg) + q);
    const float wc[4] = {w.x, w.y, w.z, w.w};
    const int shift[4] = {0, 1, Wl, Wl + 1};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const long long idx = base + shift[c];
      if (idx < 0 || idx >= HW) continue;
      p[c] = dot4(d, load4<kBf16>(slab, ((b * slab_bs + idx) << lg) + q));
      atomicAdd(dslab + (((b * HW + idx) << lg) + q),
                make_float4(wc[c] * d.x, wc[c] * d.y, wc[c] * d.z,
                            wc[c] * d.w));
    }
  }
  row_sum4(p, 1 << lg);
  if (active && q == 0)
    store4<kBf16>(dw4, r, make_float4(p[0], p[1], p[2], p[3]));
}

}  // namespace

// slab: BH level slabs of (HW, Dh) rows of fp32 (dtype 0) or bf16
// (dtype 1), slab b starting `slab_bs` ROWS after slab b - 1 (HW for a
// contiguous array); gi (BH, N) int32; w4 (BH, N, 4) and out (BH, N, Dh)
// contiguous, in the slab's dtype. Everything 16-byte aligned; Dh / 4 a
// power of two up to 32; BH at most 65535. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int fused_fwd_launch(const void* slab, const void* gi,
                                const void* w4, void* out, int BH, int HW,
                                int N, int Wl, int Dh, long long slab_bs,
                                int dtype, void* stream) {
  int lg, err;
  const dim3 grid = launch_grid(BH, N, Dh, dtype, &lg, &err);
  if (err) return err;
  if (grid.x > 0 && grid.y > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 1) {
      fused_fwd_kernel<true><<<grid, kThreads, 0, s>>>(
          slab, (const int*)gi, w4, out, HW, N, Wl, lg, slab_bs);
    } else {
      fused_fwd_kernel<false><<<grid, kThreads, 0, s>>>(
          slab, (const int*)gi, w4, out, HW, N, Wl, lg, slab_bs);
    }
  }
  return (int)cudaGetLastError();
}

// As above plus dout (BH, N, Dh) in the slab's dtype; dslab (BH, HW, Dh)
// fp32, contiguous and zeroed by the caller; dw4 (BH, N, 4) in the slab's
// dtype.
extern "C" int fused_bwd_launch(const void* slab, const void* gi,
                                const void* w4, const void* dout,
                                void* dslab, void* dw4, int BH, int HW,
                                int N, int Wl, int Dh, long long slab_bs,
                                int dtype, void* stream) {
  int lg, err;
  const dim3 grid = launch_grid(BH, N, Dh, dtype, &lg, &err);
  if (err) return err;
  if (grid.x > 0 && grid.y > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 1) {
      fused_bwd_kernel<true><<<grid, kThreads, 0, s>>>(
          slab, (const int*)gi, w4, dout, (float4*)dslab, dw4, HW, N, Wl, lg,
          slab_bs);
    } else {
      fused_bwd_kernel<false><<<grid, kThreads, 0, s>>>(
          slab, (const int*)gi, w4, dout, (float4*)dslab, dw4, HW, N, Wl, lg,
          slab_bs);
    }
  }
  return (int)cudaGetLastError();
}
