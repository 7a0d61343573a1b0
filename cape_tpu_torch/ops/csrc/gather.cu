// Row gather with zero fill: out[b, i, :] = quad[b, gi[b, i], :], and 0
// where gi[b, i] lies outside [0, n).
//
// Replaces the Pallas kernel `_gather_fwd_kernel`
// (cape_tpu/ops/gather_mxu.py:57, pallas_call at :102). On the TPU the
// gather is a one-hot matmul because Mosaic cannot lower a row gather; a
// GPU gathers rows directly, so none of that design carries over.
//
// Bound: bytes. The kernel does no arithmetic; it must read every gathered
// row and write every output row once, 2 * B * N * C * elt + 4 * B * N
// bytes, at the card's memory rate. Design: rows are moved as 16-byte
// vectors, consecutive threads on consecutive vectors of one row (a
// 256-byte bf16 row is a half-warp, a 512-byte fp32 row a warp), so every
// load and store is a full coalesced 16-byte access. An index outside the
// slab writes zeros and never reads. The decode-step call (B*H = 64
// slabs, N = 16 rows) moves about 0.5 MB and is bound by its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void quad_gather_kernel(const uint4* __restrict__ quad,
                                   const int* __restrict__ gi,
                                   uint4* __restrict__ out, int n, int N,
                                   int vpr, long long total) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const long long r = t / vpr;           // output row, b * N + i
    const int v = (int)(t - r * vpr);      // 16-byte vector within the row
    const long long b = r / N;
    const int idx = __ldg(gi + r);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (idx >= 0 && idx < n) val = __ldg(quad + (b * n + idx) * vpr + v);
    out[t] = val;
  }
}

}  // namespace

// quad (B, n, row_bytes) and out (B, N, row_bytes) 16-byte aligned,
// row_bytes a multiple of 16; gi (B, N) int32. Returns cudaGetLastError().
extern "C" int quad_gather_launch(const void* quad, const void* gi,
                                  void* out, int B, int n, int N,
                                  int row_bytes, void* stream) {
  const int vpr = row_bytes / 16;
  const long long total = (long long)B * N * vpr;
  if (total > 0) {
    const int threads = 256;
    long long blocks = (total + threads - 1) / threads;
    if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
    quad_gather_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(
        (const uint4*)quad, (const int*)gi, (uint4*)out, n, N, vpr, total);
  }
  return (int)cudaGetLastError();
}
