// Whole multi-scale deformable attention forward over prepared corners:
// out[bh, q, :] = sum_k w[bh, q, k] * valid[bh, q, k] * value[bh, idx[bh, q, k], :]
// over the K4 = L * P * 4 clipped flat bilinear corners of every query.
//
// Replaces the Pallas kernel `_msda_kernel` (cape_tpu/ops/msda_pallas.py:48,
// pallas_call at :133), which holds one (b, h) value slab in VMEM and
// gathers with an in-kernel take_along_axis. Here the value rows come
// straight from device memory (and L2: one (b, h) slab is 5440 x 32 bf16,
// 348 KB, reused by all its queries).
//
// Bound: bytes. The prepared idx (int32), w (fp32) and valid (fp32) are
// 12 bytes per corner, B*H*Lq*K4*12 = 267 MB per encoder layer at batch 8,
// against 22 MB of value and 22 MB of output: about 0.09 ms a layer at
// 3.35 TB/s. Design: one warp per (bh, query); lane j loads corner k0 + j
// of idx/w/valid (coalesced 128-byte loads) and the warp broadcasts each
// corner with __shfl_sync, while the lanes cover Dh = 32 value columns
// (a coalesced 64-byte bf16 row). Accumulation is fp32, the result is
// written in the value dtype. An index outside [0, S) is skipped, so the
// kernel never reads outside the slab.
//
// Computing the corners in-kernel from the sampling locations and the
// attention weights (12 + 4 bytes per point instead of 48 per 4 corners)
// would cut the dominant bytes about 4x; that is for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void msda_forward_kernel(const T* __restrict__ value,
                                    const int* __restrict__ idx,
                                    const float* __restrict__ w,
                                    const float* __restrict__ valid,
                                    T* __restrict__ out, int S, int Lq,
                                    int K4, int Dh, long long n_rows) {
  const long long row =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;  // (bh, q)
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;  // uniform across the warp
  const long long bh = row / Lq;
  const T* vbase = value + bh * (long long)S * Dh;
  const int* ip = idx + row * K4;
  const float* wp = w + row * K4;
  const float* vp = valid + row * K4;
  for (int d0 = 0; d0 < Dh; d0 += 32) {
    const int d = d0 + lane;
    float acc = 0.f;
    for (int k0 = 0; k0 < K4; k0 += 32) {
      const int k = k0 + lane;
      int my_i = -1;
      float my_w = 0.f;
      if (k < K4) {
        my_i = __ldg(ip + k);
        my_w = __ldg(wp + k) * __ldg(vp + k);
      }
      const int kn = min(32, K4 - k0);
      for (int j = 0; j < kn; ++j) {
        const int r = __shfl_sync(0xffffffffu, my_i, j);
        const float wj = __shfl_sync(0xffffffffu, my_w, j);
        if (d < Dh && r >= 0 && r < S)
          acc += wj * to_f32(vbase[(long long)r * Dh + d]);
      }
    }
    if (d < Dh) out[row * Dh + d] = from_f32<T>(acc);
  }
}

template <typename T>
void launch(const void* value, const void* idx, const void* w,
            const void* valid, void* out, int BH, int S, int Lq, int K4,
            int Dh, cudaStream_t stream) {
  const long long n_rows = (long long)BH * Lq;
  if (n_rows == 0) return;
  const int threads = 256;  // 8 warps, one (bh, query) each
  const long long blocks = (n_rows * 32 + threads - 1) / threads;
  msda_forward_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      (const T*)value, (const int*)idx, (const float*)w,
      (const float*)valid, (T*)out, S, Lq, K4, Dh, n_rows);
}

}  // namespace

// value (BH, S, Dh) and out (BH, Lq, Dh) in one dtype (0 = fp32,
// 1 = bf16); idx int32, w and valid fp32, each (BH, Lq, K4); all
// contiguous. Returns cudaGetLastError().
extern "C" int msda_forward_launch(const void* value, const void* idx,
                                   const void* w, const void* valid,
                                   void* out, int BH, int S, int Lq, int K4,
                                   int Dh, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    launch<float>(value, idx, w, valid, out, BH, S, Lq, K4, Dh, s);
  else if (dtype == 1)
    launch<__nv_bfloat16>(value, idx, w, valid, out, BH, S, Lq, K4, Dh, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
