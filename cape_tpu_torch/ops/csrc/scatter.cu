// Row scatter-add, the backward of the quad-row gather:
//   dslab[b, s, :] = sum over i with gi[b, i] == s of dg[b, i, :]
// into a zeroed fp32 (B, n, C) buffer; an index outside [0, n) adds nothing
// (the forward's zero fill: such a row was never read).
//
// Replaces the Pallas kernel `_scatter_bwd_kernel`
// (cape_tpu/ops/gather_mxu.py:68, pallas_call at :124). On the TPU the
// scatter is the transposed one-hot matmul (onehot^T @ dg, accumulated in
// fp32 across sequential grid steps) because Mosaic cannot lower a
// scatter. Hopper blocks run in no order, so the sum across rows that hit
// the same slab row is made with atomics instead.
//
// Bound: bytes. Each cotangent row is read once and each slab row is
// written once in fp32: B*N*C*elt + 4*B*N + 4*B*n*C bytes at the card's
// memory rate. At the encoder's level 0 about 5 indices land on each slab
// row (21,760 into 4,161); the atomics resolve in the L2, where one slab's
// fp32 rows (2.1 MB at C = 128) fit, though all 32 slabs of a call
// (68 MB) do not.
//
// Design: one thread per 4 consecutive values of a cotangent row, which it
// loads in one 8-byte (bf16) or 16-byte (fp32) access and adds with one
// Hopper vector atomic (`atomicAdd` on a float4, issued as a reduction
// since the result is unused). Consecutive threads take consecutive groups
// of a row, so a warp reads 256 (bf16) or 512 (fp32) contiguous bytes and
// its atomic instruction covers 512 contiguous bytes of one slab row: every
// 32-byte L2 sector it touches is updated whole, where scalar atomics from
// threads that each own a 16-byte vector would touch 32 sectors for one
// float each. Duplicate indices are safe; the order of the fp32 sum varies
// from run to run. The wrapper zeroes the buffer before and casts to the
// slab dtype after.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <bool kBf16>
__global__ void quad_scatter_kernel(const void* __restrict__ dg,
                                    const int* __restrict__ gi,
                                    float4* __restrict__ dslab, int n, int N,
                                    int gpr, long long total) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const long long r = t / gpr;          // cotangent row, b * N + i
    const int idx = __ldg(gi + r);
    if (idx < 0 || idx >= n) continue;
    const int q = (int)(t - r * gpr);     // group of 4 values in the row
    const long long b = r / N;
    float4 v;
    if constexpr (kBf16) {
      // a bf16 is the top half of an fp32: value 2k is the low half of
      // word k, value 2k+1 the high half
      const uint2 x = __ldg(reinterpret_cast<const uint2*>(dg) + t);
      v = make_float4(__uint_as_float(x.x << 16),
                      __uint_as_float(x.x & 0xffff0000u),
                      __uint_as_float(x.y << 16),
                      __uint_as_float(x.y & 0xffff0000u));
    } else {
      v = __ldg(reinterpret_cast<const float4*>(dg) + t);
    }
    atomicAdd(dslab + (b * n + idx) * gpr + q, v);
  }
}

}  // namespace

// dg (B, N, C) of fp32 (dtype 0) or bf16 (dtype 1), 16-byte aligned, with
// C a multiple of 4 (the wrapper asks for 16-byte rows); gi (B, N) int32;
// dslab (B, n, C) fp32, zeroed by the caller. `row_bytes` is C times the
// element size of dg. Returns cudaGetLastError(), or cudaErrorInvalidValue
// for an unknown dtype.
extern "C" int quad_scatter_launch(const void* dg, const void* gi,
                                   void* dslab, int B, int n, int N,
                                   int row_bytes, int dtype, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const int gpr = row_bytes / (dtype == 1 ? 8 : 16);  // 4-value groups
  const long long total = (long long)B * N * gpr;
  if (total > 0) {
    const int threads = 256;
    long long blocks = (total + threads - 1) / threads;
    if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 1) {
      quad_scatter_kernel<true><<<(unsigned)blocks, threads, 0, s>>>(
          dg, (const int*)gi, (float4*)dslab, n, N, gpr, total);
    } else {
      quad_scatter_kernel<false><<<(unsigned)blocks, threads, 0, s>>>(
          dg, (const int*)gi, (float4*)dslab, n, N, gpr, total);
    }
  }
  return (int)cudaGetLastError();
}
