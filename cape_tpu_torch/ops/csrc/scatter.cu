// Row scatter-add, the backward of the quad-row gather:
//   dslab[b, s, :] = sum over i with gi[b, i] == s of dg[b, i, :]
// summed in fp32 and written once in the dtype of dg; a slab row that no
// index hits is written as zeros, and an index outside [0, n) adds nothing
// (the forward's zero fill: such a row was never read).
//
// Replaces the Pallas kernel `_scatter_bwd_kernel`
// (cape_tpu/ops/gather_mxu.py:68, pallas_call at :124). On the TPU the
// scatter is the transposed one-hot matmul (onehot^T @ dg, accumulated in
// fp32 across sequential grid steps) because Mosaic cannot lower a
// scatter. Hopper blocks run in no order and carry nothing over, so here
// the owner of a slab row computes it.
//
// Bound: bytes. Each cotangent row and each index is read once and each
// slab row is written once in the slab's dtype:
// B*N*C*elt + 4*B*N + B*n*C*elt bytes at the card's memory rate.
//
// Design: one launch, one pass over the output, no fp32 buffer in device
// memory, no zero fill and no cast pass, and no floating-point atomics.
//  - A block owns a tile of consecutive slab rows of one slab (the tiling
//    is decided by `scatter_plan` in `ops/gather.py`; this file computes
//    no policy). It scans gi[b, :], 8 coalesced loads in flight per
//    thread, and threads whose index falls into the tile push its position
//    onto that row's chain in shared memory: `next[i] = exchange(head[row],
//    i)`, one integer atomic per match. Exactly one tile owns an index, so
//    every cotangent row is read from device memory once over the grid.
//  - Then a group of lanes (16 for a 256-byte bf16 row, a warp for a
//    512-byte fp32 row) takes the next row of the tile from a counter (the
//    chains differ in length: rows at an image border collect twice the
//    average), walks its chain and sums
//    the cotangent rows in registers: a lane loads one 16-byte vector of
//    each, neighbouring lanes neighbouring vectors, 4 rows in flight. A
//    row that has one owner needs no atomics and no shared-memory traffic
//    for its sums. The alternative, adding into an fp32 tile in shared
//    memory, pays a compare-and-swap loop per value (there is no fp32
//    `atomicAdd` in shared memory on this card), and the model's indices
//    are local (a query samples around its own reference point, so
//    neighbouring entries hit the same rows): measured, such adds run 2
//    to 5 times slower than this design.
//  - Where the tiles alone fill the card (levels 0 and 1, the decoder) the
//    group converts its sums and stores the row, 16 bytes a lane: shared
//    memory holds only the chains. Where they do not (n = 273, 73 with
//    N = 21,760) the N indices are split over a thread block cluster, run
//    of 32 by run of 32 in turns (contiguous shares would hand one block
//    all of a tile's matches: the encoder's queries come in image order):
//    every block sums its share into its own fp32 copy of the tile in
//    shared memory, and after a cluster barrier each block adds a share of
//    the rows over the copies through distributed shared memory, converts
//    and stores them. The same fp32 tile carries the sums from pass to
//    pass where a block's share of N is longer than its chain storage.
// Duplicate indices are safe. A chain's order depends on which thread's
// exchange came first, so the order of the fp32 sum varies from run to
// run; the sum over the blocks of a cluster is taken in rank order.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxSharedBytes = 232448;  // what a block may use on sm_90
constexpr int kThreads = 512;            // the most the kernel is built for

// The 8 (bf16) or 4 (fp32) values of a 16-byte vector, added to acc.
template <bool kBf16>
__device__ __forceinline__ void accumulate(float* acc, uint4 x) {
  const unsigned w[4] = {x.x, x.y, x.z, x.w};
  if constexpr (kBf16) {
    // a bf16 is the top half of an fp32: value 2k is the low half of word
    // k, value 2k+1 the high half
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc[2 * k] += __uint_as_float(w[k] << 16);
      acc[2 * k + 1] += __uint_as_float(w[k] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] += __uint_as_float(w[k]);
  }
}

// 8 fp32 -> 8 bf16 (round to nearest even), or 4 fp32 as they are.
template <bool kBf16>
__device__ __forceinline__ uint4 pack(const float* acc) {
  if constexpr (kBf16) {
    unsigned w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const __nv_bfloat162 p =
          __floats2bfloat162_rn(acc[2 * q], acc[2 * q + 1]);
      w[q] = *reinterpret_cast<const unsigned*>(&p);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    return make_uint4(__float_as_uint(acc[0]), __float_as_uint(acc[1]),
                      __float_as_uint(acc[2]), __float_as_uint(acc[3]));
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
quad_scatter_kernel(const uint4* __restrict__ dg, const int* __restrict__ gi,
                    uint4* __restrict__ out, int n, int N, int C, int vpr,
                    int rows_per_tile, int tiles, int cap, int use_tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int W = kBf16 ? 8 : 4;            // values per 16-byte vector
  const int tid = threadIdx.x, nthr = blockDim.x;

  // a cluster of K blocks per tile; one block where there is no fp32 tile
  int K = 1, rank = 0;
  if (use_tile) {
    cg::cluster_group cluster = cg::this_cluster();
    K = (int)cluster.num_blocks();
    rank = (int)cluster.block_rank();
  }
  const long long cid = blockIdx.x / K;      // b * tiles + tile
  const long long b = cid / tiles;
  const int row0 = (int)(cid - b * tiles) * rows_per_tile;
  const int rows = max(0, min(rows_per_tile, n - row0));

  // shared memory: the rows' chain heads, the chain links, then the tile
  int* head = reinterpret_cast<int*>(smem);
  int* ticket = head + ((rows_per_tile + 3) & ~3);   // the next row to sum
  int* next = ticket + 4;
  float* tile = reinterpret_cast<float*>(next + cap);

  // a group of G lanes per row: the vectors of a row, up to a warp
  int G = 1;
  while (G < vpr && G < 32) G <<= 1;
  const int gl = tid & (G - 1), lead = tid & 31 & ~(G - 1);
  const unsigned peers = (G == 32 ? 0xffffffffu : (1u << G) - 1u) << lead;

  for (int r = tid; r < rows; r += nthr) head[r] = -1;
  if (tid == 0) *ticket = 0;
  if (use_tile)
    for (int t = tid; t < rows * (C / 4); t += nthr)
      reinterpret_cast<float4*>(tile)[t] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  // This block's share of the slab's indices: of the runs of 32 (a warp's
  // coalesced load), every K-th, so that each block of a cluster sees all
  // parts of gi[b, :] whatever the order of the indices. Slot o of the
  // share is index `at(o)`; `cap` slots a pass.
  const int share = (((N + 31) >> 5) + K - 1) / K << 5;
  auto at = [&](int o) { return (((o >> 5) * K + rank) << 5) | (o & 31); };
  const int* gib = gi + b * N;
  const uint4* dgb = dg + b * N * vpr;
  uint4* outb = out + ((long long)b * n + row0) * vpr;

  int s0 = 0;
  do {
    const int len = min(share - s0, cap);
    // chain every index of the pass that falls into the tile to its row
    for (int o = tid; o < len; o += 8 * nthr) {
      int idx[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int oq = o + q * nthr, i = at(s0 + oq);
        idx[q] = (oq < len && i < N) ? __ldg(gib + i) : -1;
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        // an empty slot holds -1, and -1 - row0 wraps far above `rows`
        const unsigned r = (unsigned)idx[q] - (unsigned)row0;
        if (r < (unsigned)rows)
          next[o + q * nthr] = atomicExch(head + r, o + q * nthr);
      }
    }
    __syncthreads();

    // a group per row, taken in turn as groups come free (chains differ
    // in length): its chain's cotangent rows summed in registers
    for (;;) {
      int r = 0;
      if (gl == 0) r = atomicAdd(ticket, 1);
      r = __shfl_sync(peers, r, lead);
      if (r >= rows) break;
      for (int vb = 0; vb < vpr; vb += G) {
        const int v = vb + gl;
        const bool on = v < vpr;
        float acc[W];
#pragma unroll
        for (int q = 0; q < W; ++q) acc[q] = 0.f;
        int e = head[r];
        while (e >= 0) {
          int slot[4];
          slot[0] = e;
#pragma unroll
          for (int u = 1; u < 4; ++u)
            slot[u] = slot[u - 1] >= 0 ? next[slot[u - 1]] : -1;
          e = slot[3] >= 0 ? next[slot[3]] : -1;
          uint4 x[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            x[u] = (on && slot[u] >= 0)
                       ? __ldg(dgb + (long long)at(s0 + slot[u]) * vpr + v)
                       : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
          for (int u = 0; u < 4; ++u) accumulate<kBf16>(acc, x[u]);
        }
        if (!on) continue;
        if (use_tile) {
          float4* cell = reinterpret_cast<float4*>(tile + r * C + v * W);
#pragma unroll
          for (int q = 0; q < W / 4; ++q) {
            float4 t = cell[q];
            t.x += acc[4 * q];
            t.y += acc[4 * q + 1];
            t.z += acc[4 * q + 2];
            t.w += acc[4 * q + 3];
            cell[q] = t;
          }
        } else {
          outb[(long long)r * vpr + v] = pack<kBf16>(acc);
        }
      }
    }
    s0 += cap;
    if (s0 < share) {              // another pass: empty chains again
      __syncthreads();
      for (int r = tid; r < rows; r += nthr) head[r] = -1;
      if (tid == 0) *ticket = 0;
      __syncthreads();
    }
  } while (s0 < share);

  if (!use_tile) return;

  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();   // every block's copy of the tile is complete

  // this block's share of the tile's rows: summed over the copies, stored
  const bool pow2 = (vpr & (vpr - 1)) == 0;
  const int shift = __ffs(vpr) - 1;
  const int rshare = (rows + K - 1) / K;
  const int ra = min(rows, rank * rshare), rb = min(rows, ra + rshare);
  for (int j = tid; j < (rb - ra) * vpr; j += nthr) {
    const int m = pow2 ? j >> shift : j / vpr, v = j - m * vpr;
    const int r = ra + m;
    float acc[W];
#pragma unroll
    for (int q = 0; q < W; ++q) acc[q] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float4* src = reinterpret_cast<const float4*>(
          cluster.map_shared_rank(tile, k) + r * C + v * W);
#pragma unroll
      for (int q = 0; q < W / 4; ++q) {
        const float4 t = src[q];
        acc[4 * q] += t.x;
        acc[4 * q + 1] += t.y;
        acc[4 * q + 2] += t.z;
        acc[4 * q + 3] += t.w;
      }
    }
    outb[(long long)r * vpr + v] = pack<kBf16>(acc);
  }

  cluster.sync();   // no block leaves while its copy may still be read
}

// Raise the kernel's dynamic shared memory limit once per device.
template <bool kBf16>
cudaError_t allow_shared_memory() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(quad_scatter_kernel<kBf16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSharedBytes);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

template <bool kBf16>
cudaError_t launch(const void* dg, const void* gi, void* out, int n, int N,
                   int C, int vpr, int rows_per_tile, int tiles, int cap,
                   int use_tile, unsigned blocks, int cluster, int threads,
                   int smem_bytes, cudaStream_t stream) {
  cudaError_t err = allow_shared_memory<kBf16>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, quad_scatter_kernel<kBf16>,
                           (const uint4*)dg, (const int*)gi, (uint4*)out, n,
                           N, C, vpr, rows_per_tile, tiles, cap, use_tile);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// dg (B, N, C) of fp32 (dtype 0) or bf16 (dtype 1) and dslab (B, n, C) of the
// same dtype, both 16-byte aligned with rows of `row_bytes` = C * elt bytes,
// a multiple of 16; gi (B, N) int32. The tiling comes from the caller's
// plan: `tiles` tiles of `rows_per_tile` slab rows cover [0, n); a cluster
// of `cluster` blocks (1..8) of `threads` threads works on each, every
// block chaining `cap` indices a pass (a multiple of 4); `use_tile` (0 or
// 1; 1 where the cluster has more than one block or a block more than one
// pass) keeps the sums in an fp32 tile in shared memory; `smem_bytes` of
// dynamic shared memory hold the chain heads, a counter, the links and
// that tile.
// Returns the CUDA error of the set-up or the launch (0 = none),
// cudaErrorInvalidValue for a plan the kernel cannot run.
extern "C" int quad_scatter_launch(const void* dg, const void* gi,
                                   void* dslab, int B, int n, int N,
                                   int row_bytes, int dtype,
                                   int rows_per_tile, int tiles, int cluster,
                                   int cap, int use_tile, int threads,
                                   int smem_bytes, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (B <= 0 || n <= 0) return (int)cudaSuccess;       // nothing to write
  const int elt = dtype == 1 ? 2 : 4;
  const int C = row_bytes / elt, vpr = row_bytes / 16;
  if (row_bytes <= 0 || row_bytes % 16 || N < 0 || rows_per_tile < 1 ||
      tiles < 1 || (long long)tiles * rows_per_tile < n || cluster < 1 ||
      cluster > 8 || threads < 32 || threads > kThreads || threads % 32 ||
      cap < 4 || cap % 4 || (use_tile != 0 && use_tile != 1))
    return (int)cudaErrorInvalidValue;
  const long long share =
      (((long long)N + 31) / 32 + cluster - 1) / cluster * 32;
  const long long passes = (share + cap - 1) / cap;
  const long long need =
      4LL * ((rows_per_tile + 3) & ~3) + 16 + 4LL * cap +
                         (use_tile ? 4LL * rows_per_tile * C : 0LL);
  const long long blocks = (long long)B * tiles * cluster;
  if ((!use_tile && (cluster > 1 || passes > 1)) || smem_bytes < need ||
      smem_bytes > kMaxSharedBytes || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(dtype == 1
                   ? launch<true>(dg, gi, dslab, n, N, C, vpr, rows_per_tile,
                                  tiles, cap, use_tile,
                                  (unsigned)blocks, cluster, threads,
                                  smem_bytes, s)
                   : launch<false>(dg, gi, dslab, n, N, C, vpr, rows_per_tile,
                                   tiles, cap, use_tile,
                                   (unsigned)blocks, cluster, threads,
                                   smem_bytes, s));
}
