// Row lists: the machinery of the backwards of the two fused level
// samples (fused.cu, quadfused.cu). Each computes output rows that are
// sums over the entries of an index array that land on them:
//   out[b, s, :] = sum over entries i of slab b that target row s of
//                  (what entry i contributes)
// Hopper blocks run in no order and carry nothing over, so the owner of an
// output row computes it, once, with no floating-point atomics, no fp32
// buffer in device memory, no zero fill and no cast pass:
//  - A block owns a tile of consecutive output rows of one slab (the
//    tiling is decided by `sample_bwd_plan` in `ops/msda_fused.py`; no
//    kernel computes policy). It scans the slab's indices (8 coalesced
//    loads in flight a thread) and lists, in shared memory, the entries
//    whose KEY falls into the tile's key range, grouped by key
//    (`Block::sort`, a counting sort). A key is an output row, or
//    (fused.cu) a cell whose four corners are rows: the key range then
//    reaches `halo` keys below the tile.
//  - A team of lanes works on a row, taken from a counter (lists differ
//    in length). Its lanes hold the row's 16-byte (or 8-byte) units in
//    groups of G lanes; each group takes other entries of the row's
//    list(s), 4 in flight a lane, sums their contributions in registers,
//    and the groups' sums are added up at the end of the row (`Team`).
//    In quadfused.cu a row whose list is long for its team is left to the
//    whole block (`Block::defer`).
//  - Where the tiles alone fill the card the group converts its sums and
//    stores the row. Where they do not (few output rows, many entries) the
//    entries are split over a thread block cluster, run of 32 by run of 32
//    in turns; every block sums its share into its own fp32 copy of the
//    tile in shared memory, and after a cluster barrier each block adds a
//    share of the rows over the copies through distributed shared memory,
//    converts and stores them. The same fp32 tile carries the sums from
//    pass to pass where a block's share is longer than its list storage.
// A row no entry reaches is stored as zeros. The lists come out in the
// same order every run and the cluster's copies are added in rank order,
// so a result is the same, bit for bit, every run. Not taken: adding into
// an fp32 tile with shared-memory atomics (a compare-and-swap loop per
// value on this card; 2 to 5 times slower in `quad_scatter` with the
// model's local indices), and chaining entries to their keys with an
// atomic exchange per match as `scatter.cu` does (cheaper to build, but
// the chains' order, and so the fp32 sums' bits, change from run to run).

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rowlist {

namespace cg = cooperative_groups;

constexpr int kMaxSharedBytes = 232448;  // what a block may use on sm_90
constexpr int kThreads = 512;            // the most the kernels are built for
// steps (of one entry a list a lane) a team takes in a row before the row
// is left to the whole block (`Block::defer`)
constexpr int kLong = 16;

template <int kBytes>
struct RawOf;
template <>
struct RawOf<16> {
  using T = uint4;
};
template <>
struct RawOf<8> {
  using T = uint2;
};

// A lane's unit of a row: kBytes (16, or 8 where a row is narrower) of
// fp32 or bf16 values, moved in one access and summed as fp32.
template <bool kBf16, int kBytes>
struct Unit {
  static constexpr int kVals = kBytes / (kBf16 ? 2 : 4);
  static constexpr int kWords = kBytes / 4;
  using Raw = typename RawOf<kBytes>::T;

  static __device__ __forceinline__ void store(void* p, long long u, Raw x) {
    reinterpret_cast<Raw*>(p)[u] = x;
  }
  static __device__ __forceinline__ Raw zero() { return Raw{}; }

  // The values as fp32. A bf16 is the top half of an fp32: value 2k is
  // the low half of word k, value 2k+1 the high half.
  static __device__ __forceinline__ void unpack(Raw x, float* v) {
    const unsigned* w = reinterpret_cast<const unsigned*>(&x);
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      if constexpr (kBf16) {
        v[2 * k] = __uint_as_float(w[k] << 16);
        v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
      } else {
        v[k] = __uint_as_float(w[k]);
      }
    }
  }

  // One rounding to nearest even for bf16; fp32 as it is.
  static __device__ __forceinline__ Raw pack(const float* v) {
    Raw x;
    unsigned* w = reinterpret_cast<unsigned*>(&x);
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      if constexpr (kBf16) {
        const __nv_bfloat162 p = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
        w[k] = *reinterpret_cast<const unsigned*>(&p);
      } else {
        w[k] = __float_as_uint(v[k]);
      }
    }
    return x;
  }
};

// One value of fp32 or bf16 (w4, dw4).
template <bool kBf16>
__device__ __forceinline__ float load1(const void* p, long long i) {
  if constexpr (kBf16)
    return __uint_as_float(
        (unsigned)__ldg(reinterpret_cast<const unsigned short*>(p) + i) << 16);
  else
    return __ldg(reinterpret_cast<const float*>(p) + i);
}

template <bool kBf16>
__device__ __forceinline__ void store1(void* p, long long i, float v) {
  if constexpr (kBf16)
    reinterpret_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    reinterpret_cast<float*>(p)[i] = v;
}

// The lanes that work on one output row: a TEAM of S groups of G lanes
// (G: the row's units, a power of two up to a warp; S from the caller, so
// that T = G * S is at most a warp). Each lane of a group holds one unit
// of the row; the groups of a team take other entries of the row's
// list(s), and their sums are added up with shuffles at the end of the
// row. The R = 32 / T teams of a warp take R rows at a time and go in
// step, so that every shuffle is a whole warp's (a shuffle among some
// lanes of a warp compiles to a convergence check that costs more than
// the shuffle): one group a team where rows get few entries, a whole
// warp where they get many, so that the rows a warp waits for are few.
struct Team {
  int G, gl, S, sub, T, R, team;  // group lanes, lane in it, groups a
                                  // team, group, team lanes, teams a
                                  // warp, team in the warp
  __device__ Team(int units, int split) {
    G = 1;
    while (G < units && G < 32) G <<= 1;
    S = 1;
    while (S < split && G * S < 32) S <<= 1;
    T = G * S;
    R = 32 / T;
    const int lane = threadIdx.x & 31;
    gl = lane & (G - 1);
    sub = (lane & (T - 1)) / G;
    team = lane / T;
  }
  // x summed over the aligned runs of `span` lanes (a power of two up to
  // 32; the same in the whole warp)
  static __device__ __forceinline__ float sum(float x, int span) {
#pragma unroll
    for (int off = 1; off < 32; off <<= 1)
      if (off < span) x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
  }
  // Each of p[0..3] summed over the group; `put(c, sum)` is called once
  // for each c: by the lane of rank c * G / 4 where G >= 4 (halves, then
  // quarters, exchange the sums they do not keep: log2(G) + 1 shuffles
  // for the four), else by lane 0.
  template <class Put>
  __device__ __forceinline__ void sum4(float p[4], Put put) const {
    if (G >= 4) {
      const int h1 = G >> 1, h2 = G >> 2;
      const bool up = gl & h1, up2 = gl & h2;
      float a0 = up ? p[2] : p[0], a1 = up ? p[3] : p[1];
      a0 += __shfl_xor_sync(0xffffffffu, up ? p[0] : p[2], h1);
      a1 += __shfl_xor_sync(0xffffffffu, up ? p[1] : p[3], h1);
      float a = up2 ? a1 : a0;
      a += __shfl_xor_sync(0xffffffffu, up2 ? a0 : a1, h2);
      a = sum(a, h2);
      if ((gl & (h2 - 1)) == 0) put((up ? 2 : 0) + (up2 ? 1 : 0), a);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) p[c] = sum(p[c], G);
      if (gl == 0) {
#pragma unroll
        for (int c = 0; c < 4; ++c) put(c, p[c]);
      }
    }
  }
  // a[0 .. n) summed over the team's groups, in every lane
  template <int n>
  __device__ __forceinline__ void across(float* a) const {
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      if (off < G || off >= T) continue;
#pragma unroll
      for (int k = 0; k < n; ++k)
        a[k] += __shfl_xor_sync(0xffffffffu, a[k], off);
    }
  }
};

// A block's part of a row-list kernel: its cluster rank, slab and tile of
// output rows, and its shared memory: the row counter; per (key, warp)
// counts that become offsets; each warp's matching slots in its scan
// order; the slots in key order; the fp32 tile.
struct Block {
  int K, rank;          // blocks of the cluster, this one's rank
  long long b;          // slab
  int tile, row0, rows; // tile of the slab, its first row, its rows
  int key0, nkeys;      // the index value of key 0; rows + the halo
  int warps;            // warps of the block
  int N, share, cap;    // entries a slab, this block's share, a pass
  int* ticket;
  int* wsum;            // a warp's total in the block-wide prefix sum
  unsigned short *cnt, *stage, *list;
  float *acc, *part;

  __device__ Block(unsigned char* smem, int use_tile, int n, int N_, int C,
                   int rows_per_tile, int tiles, int cap_, int halo) {
    K = 1;
    rank = 0;
    if (use_tile) {
      cg::cluster_group cluster = cg::this_cluster();
      K = (int)cluster.num_blocks();
      rank = (int)cluster.block_rank();
    }
    const long long cid = blockIdx.x / K;  // b * tiles + tile
    b = cid / tiles;
    tile = (int)(cid - b * tiles);
    row0 = tile * rows_per_tile;
    rows = max(0, min(rows_per_tile, n - row0));
    key0 = row0 - halo;
    nkeys = rows + halo;
    warps = blockDim.x >> 5;
    N = N_;
    cap = cap_;
    // of the runs of 32 entries (a warp's coalesced load), every K-th, so
    // that each block of a cluster sees all parts of the slab's entries
    // whatever their order
    share = (((N + 31) >> 5) + K - 1) / K << 5;
    ticket = reinterpret_cast<int*>(smem);
    wsum = ticket + 4;
    cnt = reinterpret_cast<unsigned short*>(wsum + 32);
    stage = cnt + ((warps * (rows_per_tile + halo) + 7) & ~7);
    list = stage + (cap + blockDim.x - 1) / blockDim.x * blockDim.x;
    acc = reinterpret_cast<float*>(list + cap);
    part = acc + (use_tile ? rows_per_tile * C : 0);
    if (use_tile)
      for (int t = threadIdx.x; t < rows * (C / 4); t += blockDim.x)
        reinterpret_cast<float4*>(acc)[t] = make_float4(0.f, 0.f, 0.f, 0.f);
    clear();
  }

  // Empty lists and the row counter (for the first pass and every other).
  __device__ __forceinline__ void clear() {
    for (int j = threadIdx.x; j < (nkeys * warps + 7) / 8; j += blockDim.x)
      reinterpret_cast<uint4*>(cnt)[j] = make_uint4(0u, 0u, 0u, 0u);
    if (threadIdx.x < 3) ticket[threadIdx.x] = 0;
    __syncthreads();
  }

  // the entry in slot o of this block's share
  __device__ __forceinline__ int at(int o) const {
    return (((o >> 5) * K + rank) << 5) | (o & 31);
  }

  // The key of index value g: 0 .. nkeys - 1, or 0xffff outside the
  // tile's range (below key0 wraps far above nkeys).
  __device__ __forceinline__ unsigned key_of(int g) const {
    const unsigned d = (unsigned)g - (unsigned)key0;
    return d < (unsigned)nkeys ? d : 0xffffu;
  }

  // List the entries of the pass from slot s0 on by key, in the same
  // order every run (a counting sort in shared memory); `seen(i, g)` is
  // called for every entry i of the pass with its index value g.
  //  1. Each warp scans its slots (8 coalesced loads in flight a lane),
  //     keeps those whose key is in the tile's range, in its scan order
  //     (a ballot gives each its place), and counts them per (key, warp)
  //     with integer atomics (no counter is shared between warps).
  //  2. A block-wide prefix sum over (key, warp) turns counts into offsets.
  //  3. Each warp takes its kept slots again, in the same order: lanes
  //     with the same key find each other (`__match_any_sync`), and a lane
  //     goes to its warp's offset for the key plus its rank among them.
  // Afterwards the slots of key k are list[begin(k) .. end(k)).
  template <class Seen>
  __device__ __forceinline__ void sort(const int* __restrict__ gib, int s0,
                                       Seen seen) {
    const int len = min(share - s0, cap);
    const int nthr = blockDim.x, lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const unsigned below = (1u << lane) - 1u;
    unsigned short* kept = stage + warp * ((cap + nthr - 1) / nthr * 32);
    unsigned* cnt2 = reinterpret_cast<unsigned*>(cnt);
    int nkept = 0;  // the same in the whole warp
    for (int o0 = warp * 32; o0 < len; o0 += 8 * nthr) {
      int idx[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int oq = o0 + q * nthr + lane, i = at(s0 + oq);
        idx[q] = (oq < len && i < N) ? __ldg(gib + i) : 0;
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int oq = o0 + q * nthr + lane, i = at(s0 + oq);
        unsigned k = 0xffffu;
        if (oq < len && i < N) {
          seen(i, idx[q]);
          k = key_of(idx[q]);
        }
        const unsigned m = __ballot_sync(0xffffffffu, k != 0xffffu);
        if (k != 0xffffu) {
          kept[nkept + __popc(m & below)] = (unsigned short)oq;
          const unsigned j = k * warps + warp;  // 16-bit count j
          atomicAdd(cnt2 + (j >> 1), 1u << (16 * (j & 1)));
        }
        nkept += __popc(m);
      }
    }
    __syncthreads();

    // exclusive prefix sum of cnt[0 .. nkeys * warps), a run of 16-byte
    // words (8 counts) per thread
    uint4* c8 = reinterpret_cast<uint4*>(cnt);
    const int M = (nkeys * warps + 7) / 8, per = (M + nthr - 1) / nthr;
    const int ja = min(M, threadIdx.x * per), jb = min(M, ja + per);
    int run = 0;
    for (int j = ja; j < jb; ++j) {
      const uint4 x = c8[j];
      const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) run += (w[q] & 0xffffu) + (w[q] >> 16);
    }
    int incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += x;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = lane < warps ? wsum[lane] : 0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int x = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += x;
      }
      if (lane < warps) wsum[lane] = w;  // inclusive over warps
    }
    __syncthreads();
    run = incl - run + (warp > 0 ? wsum[warp - 1] : 0);
    for (int j = ja; j < jb; ++j) {
      const uint4 x = c8[j];
      unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const unsigned lo = (unsigned)run;
        run += w[q] & 0xffffu;
        const unsigned hi = (unsigned)run;
        run += w[q] >> 16;
        w[q] = lo | hi << 16;
      }
      c8[j] = make_uint4(w[0], w[1], w[2], w[3]);
    }
    __syncthreads();

    // the kept slots to their places, 4 rounds of 32 in flight
    for (int j0 = 0; j0 < nkept; j0 += 128) {
      int slot[4];
      unsigned k[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + 32 * u + lane;
        slot[u] = j < nkept ? kept[j] : -1;
        k[u] = slot[u] >= 0 ? key_of(__ldg(gib + at(s0 + slot[u])))
                            : 0xffffu;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const unsigned peers = __match_any_sync(0xffffffffu, k[u]);
        unsigned short* off = cnt + k[u] * warps + warp;
        if (slot[u] >= 0)
          list[*off + __popc(peers & below)] = (unsigned short)slot[u];
        __syncwarp();
        if (slot[u] >= 0 && (peers & below) == 0)
          *off += (unsigned short)__popc(peers);
        __syncwarp();
      }
    }
    __syncthreads();
  }

  // The list of key k: its first position and its end.
  __device__ __forceinline__ int end(int k) const {
    return cnt[k * warps + warps - 1];
  }
  __device__ __forceinline__ int begin(int k) const {
    return k > 0 ? end(k - 1) : 0;
  }

  // The first of the next n rows of the tile for the warp (rows or more
  // when none is left).
  __device__ __forceinline__ int take(int n) const {
    int r = 0;
    if ((threadIdx.x & 31) == 0) r = atomicAdd(ticket, n);
    return __shfl_sync(0xffffffffu, r, 0);
  }

  // Rows whose lists are long for their team are put aside (`defer`, by
  // one lane of the team) and taken afterwards, one at a time, by all the
  // warps of the block, each a share of the row's entries, their sums
  // added up through `part` (one row of C fp32 values a warp): where many
  // entries meet on a row (the model's samples clamped to a border, a
  // small level's rows in a cluster) one team would keep its warp, and
  // the block, waiting. Their numbers go where the sort kept its slots.
  __device__ __forceinline__ void defer(int r) {
    stage[atomicAdd(ticket + 1, 1)] = (unsigned short)r;
  }
  __device__ __forceinline__ int deferred() const { return ticket[1]; }
  __device__ __forceinline__ int deferred_row(int h) const {
    return stage[h];
  }

  // The fp32 tile: row r, values from v on.
  template <int kVals>
  __device__ __forceinline__ void add(int r, int C, int v, const float* a) {
    float4* cell = reinterpret_cast<float4*>(acc + r * C + v);
#pragma unroll
    for (int q = 0; q < kVals / 4; ++q) {
      float4 t = cell[q];
      t.x += a[4 * q];
      t.y += a[4 * q + 1];
      t.z += a[4 * q + 2];
      t.w += a[4 * q + 3];
      cell[q] = t;
    }
  }

  // Another pass: empty lists again.
  __device__ __forceinline__ void reset() {
    __syncthreads();
    clear();
  }

  // After the last pass: this block's share of the tile's rows summed
  // over the cluster's copies and stored, `units` units of C values a row,
  // at out (the tile's first row).
  template <class U>
  __device__ void finish(void* __restrict__ out, int C, int units) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every block's copy of the tile is complete
    constexpr int W = U::kVals;
    const bool pow2 = (units & (units - 1)) == 0;
    const int shift = __ffs(units) - 1;
    const int rshare = (rows + K - 1) / K;
    const int ra = min(rows, rank * rshare), rb = min(rows, ra + rshare);
    for (int j = threadIdx.x; j < (rb - ra) * units; j += blockDim.x) {
      const int m = pow2 ? j >> shift : j / units, v = j - m * units;
      const int r = ra + m;
      float a[W];
#pragma unroll
      for (int q = 0; q < W; ++q) a[q] = 0.f;
      for (int k = 0; k < K; ++k) {
        const float4* src = reinterpret_cast<const float4*>(
            cluster.map_shared_rank(acc, k) + r * C + v * W);
#pragma unroll
        for (int q = 0; q < W / 4; ++q) {
          const float4 t = src[q];
          a[4 * q] += t.x;
          a[4 * q + 1] += t.y;
          a[4 * q + 2] += t.z;
          a[4 * q + 3] += t.w;
        }
      }
      U::store(out, (long long)r * units + v, U::pack(a));
    }
    cluster.sync();  // no block leaves while its copy may still be read
  }
};

// Bytes of dynamic shared memory a plan needs (as `ops/msda_fused.py`'s
// `_list_bytes`): the counters and the warps' totals (144 bytes), a 2-byte
// count per (key, warp) padded to 16 bytes, 2 bytes a slot for the kept
// slots (each warp's part rounded up to whole rounds of the block) and 2
// for the list, the fp32 tile, and a row of C fp32 values a warp.
inline long long shared_need(int rows_per_tile, int halo, int cap, int C,
                             int use_tile, int threads) {
  return 144 + 2LL * ((threads / 32 * (rows_per_tile + halo) + 7) & ~7) +
         2LL * ((cap + threads - 1) / threads * threads) + 2LL * cap +
         (use_tile ? 4LL * rows_per_tile * C : 0LL) + 4LL * threads / 32 * C;
}

// The caller's plan (`ops.msda_fused.sample_bwd_plan`): `tiles` tiles of
// `rows_per_tile` output rows cover [0, n); a cluster of `cluster` blocks
// (1..8) of `threads` threads works on each, every block listing `cap`
// entries a pass (a multiple of 8); `use_tile` (0 or 1; 1 where the
// cluster has more than one block or a block more than one pass) keeps
// the sums in an fp32 tile in shared memory; `smem_bytes` of dynamic
// shared memory (`shared_need`); `split` groups a team.
struct Plan {
  int rows_per_tile, tiles, cluster, cap, use_tile, threads, smem_bytes,
      split;
};

// cudaErrorInvalidValue for a plan the kernels cannot run, else 0.
inline int check_plan(const Plan& p, int n, int N, int C, int halo,
                      long long B) {
  if (N < 0 || p.rows_per_tile < 1 || p.tiles < 1 ||
      (long long)p.tiles * p.rows_per_tile < n || p.cluster < 1 ||
      p.cluster > 8 || p.threads < 32 || p.threads > kThreads ||
      p.threads % 32 || p.cap < 8 || p.cap % 8 || p.cap > 65535 ||
      (p.use_tile != 0 && p.use_tile != 1) || halo < 0 || C % 4 ||
      p.rows_per_tile + halo >= 65535 || p.split < 1 || p.split > 32)
    return (int)cudaErrorInvalidValue;
  const long long share =
      (((long long)N + 31) / 32 + p.cluster - 1) / p.cluster * 32;
  const long long passes = (share + p.cap - 1) / p.cap;
  if ((!p.use_tile && (p.cluster > 1 || passes > 1)) ||
      p.smem_bytes < shared_need(p.rows_per_tile, halo, p.cap, C, p.use_tile,
                                 p.threads) ||
      p.smem_bytes > kMaxSharedBytes ||
      B * p.tiles * p.cluster > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// Launch `kernel` over B * tiles clusters of the plan, after raising its
// dynamic shared memory limit once per device (`done`: one flag a device,
// kept by the caller for this kernel).
template <class Kernel, class... Args>
cudaError_t launch(Kernel kernel, bool* done, const Plan& p, long long B,
                   cudaStream_t stream, Args... args) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSharedBytes);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * p.tiles * p.cluster), 1, 1);
  cfg.blockDim = dim3((unsigned)p.threads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)p.smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace rowlist
