// Self-attention with decomposed relative-position bias of a ViTDet block,
// forward and backward, from the qkv projection's output to the input of
// the output projection (the function of `ops/rel_attn.py`'s
// `rel_attention_plain`):
//   for every image b, window w of the grid padded to a multiple of the
//   window (the whole grid in a global block) and head h:
//     out[i] = sum_j softmax_j(q_i . k_j / 8 + q_i . Rh[qy_i - ky_j + Sh - 1]
//                                         + q_i . Rw[qx_i - kx_j + Sw - 1]) v_j
//   over the window's Sh x Sw tokens i, j at rows y and columns x, where a
//   token reads q, k, v from the projection's output at its real position,
//   or the projection's bias where it is padding; Rh (2 Sh - 1, 64) and Rw
//   (2 Sw - 1, 64) are the block's tables, shared by the heads. The output
//   is written at the real positions only.
//
// Replaces no Pallas kernel: the JAX package has no ViTDet backbone. Added
// for ViTDet-L, whose 24 blocks (20 in 14 x 14 windows, 4 over the whole
// 64 x 64 grid at 1,024 px) run this at every forward and backward.
//
// Bound: a global site is bound by the tensor cores (4,096 keys a query:
// 2 x 4,096 x 64 multiply-adds a token and head, ~1,000 FLOPs a byte
// against the H100's ~295) and, as much, by the exponentials (one a score
// against 256 FLOPs of products: the SFU's rate); a window site (196 keys)
// by bytes. So nothing of the scores reaches device memory, and the bias
// is built in the kernel: rel_h[i, ky] = q_i . Rh[qy_i - ky + Sh - 1] is
// one product of a query with a table row, Sh + Sw of them a query
// against Sh x Sw keys.
//
// Layout. A window's tokens are laid out in slots: its rows one after the
// other, each in a slot row of 16, 32 or 64 slots (its columns rounded up
// to a power of two); slots past the window's rows or columns hold no
// token and are masked. A block holds a tile of whole slot rows and walks
// over the window's other side in chunks of 64 slots (whole slot rows
// too), so that within a chunk a key's column depends only on its place
// in the chunk and its row only on the chunk. Every chunk is brought into
// shared memory by asynchronous copies (`cp.async`, zero-filled where a
// slot holds no token) one chunk ahead of its use, and every operand of
// `mma.sync.m16n8k16` (bf16 in, fp32 sums) that is not held in registers
// is read from token-major tiles by `ldmatrix`, transposed where the
// product needs its other layout.
//
// Forward: a block is (128 queries, window, head), 4 warps of 32 rows (two
// m-tiles sharing each k and v fragment), two blocks an SM. It computes
// each query's products with every table row by the same mma as the
// scores, kept where they land on a key row or column: rh[i][ky] and
// rw[i][kx] (-inf past the window: the mask). Each lane then holds its
// four rows' rw at the columns it meets in every chunk (64 registers) and
// reads rh once a key row. Over each half chunk: scores in registers, the
// bias added, an online softmax (running max and sum, the output
// rescaled), the probabilities going from the scores' accumulator
// registers into the A fragments of the product with v. It writes the
// output at the real tokens and each slot's log-sum-exp (+inf where the
// slot holds no token).
//
// Backward (flash-attention's, two kinds of block in one launch, 8 warps
// each, so that every sum is taken in a fixed order without atomics):
// - a key block (128 keys, window, head), a warp per 16 keys, walks over
//   the query chunks: it recomputes the chunk's bias terms at its keys
//   (rw by mma, rh by dot products), the scores and the probabilities from
//   the saved log-sum-exps, dP = dO v^T and dS = P (dP - D) with
//   D_i = dO_i . O_i, and accumulates dV = P^T dO and dK = dS^T q in
//   registers; the padded keys' dk and dv (their k and v are the bias) are
//   summed in a fixed order as the block's partial sums;
// - a query block (128 queries) walks over the key chunks: it recomputes
//   dS and takes dQ = dS k, and the bias terms' gradients: drw[i][kx]
//   summed in registers over the chunks, drh[i][ky] over a key row by a
//   fixed shuffle. Then the bias's share of dq (sum_ky drh Rh[..] +
//   sum_kx drw Rw[..]) and the block's partial sums of the tables'
//   gradients (sum_i drh[i][..] q_i at each table row).
// A second, small kernel sums the blocks' partials in a fixed order: the
// same bits every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kDh = 64;                // a head's channels
constexpr int kChunk = 64;             // slots a round takes
constexpr int kFwdWarps = 4;           // the forward: 32 queries a warp
constexpr int kFwdThreads = kFwdWarps * 32;
constexpr int kWarps = 8;              // the backward: two chunks
constexpr int kThreads = kWarps * 32;
constexpr int kTile = kWarps * 16;
constexpr int kRow = kDh + 8;          // a token-major tile's row, bf16
constexpr int kMaxSide = 64;           // a window's rows or columns
constexpr int kTabRows = 2 * kMaxSide; // a table's rows, padded
constexpr int kRhStride = kMaxSide + 1;
constexpr int kRelhStride = 9;         // a key tile's slot rows (8) + 1
constexpr int kRwcStride = kMaxSide + 4;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kScale = 0.125f;       // 64 ** -0.5
constexpr int kReduceThreads = 256;
constexpr int kTileBytes = kChunk * kRow * 2;          // a chunk's tile
constexpr int kTabBytes = 2 * kTabRows * kRow * 2;     // both tables

typedef __nv_bfloat16 bf16;

struct Geo {
  int B, H, W, C, heads;
  int Sh, Sw;        // a window's rows and columns
  int nWw, nW;       // windows a row of windows, windows an image
  int lg, swp;       // a slot row's length and its log2
  int rows;          // slot rows a chunk
  int chunks;        // chunks a window (a multiple of 2)
  int shr;           // slot rows a window: chunks * rows
  int Lh, Lw;        // the tables' rows: 2 Sh - 1, 2 Sw - 1
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// 2^x by the SFU alone (relative error under 2^-22; 2^-inf is +0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// d += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 in, fp32
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices, lane l giving the address of row l % 8 of
// matrix l / 8: lane (g, t) gets row g, columns 2t, 2t + 1 of each.
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// As `ldsm`, transposed: lane (g, t) gets rows 2t, 2t + 1 of column g.
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// 16 bytes from global to shared memory, asynchronously; zeros if `zero`.
__device__ __forceinline__ void cp16(void* dst, const void* src, bool zero) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(zero ? 0 : 16));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until this thread's copies have landed.
__device__ __forceinline__ void cp_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// The A fragment of rows r0.. r0 + 15, columns k0.. k0 + 15 of a tile
// whose rows are `stride` elements apart.
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* tile,
                                       int stride, int r0, int k0, int g,
                                       int t) {
  const bf16* p = tile + (r0 + g) * stride + k0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * stride);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * stride + 8);
}

// B fragments of rows n0.. n0 + 7 of a token-major tile, as the column
// side of a product over the 64 channels (the keys of q k^T): b[kk] for
// channels kk * 16.. kk * 16 + 15.
__device__ __forceinline__ void frags_b(uint32_t (&b)[4][2], const bf16* tile,
                                        int n0, int lane) {
#pragma unroll
  for (int k2 = 0; k2 < 2; ++k2) {
    uint32_t r[4];
    ldsm(r, tile + (n0 + (lane & 7)) * kRow + k2 * 32 + (lane >> 3) * 8);
    b[2 * k2][0] = r[0];
    b[2 * k2][1] = r[1];
    b[2 * k2 + 1][0] = r[2];
    b[2 * k2 + 1][1] = r[3];
  }
}

// B fragments of the channels n0.. n0 + 15 (two n-tiles) over the rows
// k0.. k0 + 15 of a token-major tile, as the row side of a product (the
// keys of P v): b[0], b[1] for channels n0.., b[2], b[3] for n0 + 8...
__device__ __forceinline__ void frags_bt(uint32_t (&b)[4], const bf16* tile,
                                         int k0, int n0, int lane) {
  ldsm_t(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kRow + n0 +
                (lane >> 4) * 8);
}

__device__ __forceinline__ bool slot_valid(const Geo& g, int s) {
  return (s >> g.lg) < g.Sh && (s & (g.swp - 1)) < g.Sw;
}

// Where q, k or v (seg 0, 1, 2) of head h at a slot's token lies: 8
// channels from `chunk` * 8 (the bias where the slot holds no token; it
// is then read as zeros).
__device__ __forceinline__ const bf16* qkv_at(const bf16* qkv,
                                              const bf16* bias, const Geo& g,
                                              int src, int seg, int h,
                                              int chunk) {
  const int col = seg * g.C + h * kDh + chunk * 8;
  return src >= 0 ? qkv + (long long)src * 3 * g.C + col : bias + col;
}

// Where a block's window starts: its image's first row, and the window's
// first grid row and column.
struct Origin {
  int bH, Y0, X0;
};

__device__ __forceinline__ Origin origin(const Geo& g, int b, int wy,
                                         int wx) {
  return Origin{b * g.H, wy * g.Sh, wx * g.Sw};
}

// The token slot s of the block's window holds: its row of the (B * H *
// W) grid, -1 where it is padding of the grid (its q, k, v are the bias),
// -2 where the slot holds no token.
__device__ __forceinline__ int src_at(const Geo& g, const Origin& o, int s) {
  const int y = s >> g.lg, x = s & (g.swp - 1);
  const int Y = o.Y0 + y, X = o.X0 + x;
  return (y >= g.Sh || x >= g.Sw) ? -2
         : (Y >= g.H || X >= g.W) ? -1
                                  : (o.bH + Y) * g.W + X;
}

// Segments `seg0`.. `seg0 + NSEG - 1` of q, k, v at the 64 slots from s0
// into token-major tiles `tile0` + seg * kChunk * kRow, asynchronously.
template <int NSEG>
__device__ __forceinline__ void fetch_qkv(const bf16* qkv, const bf16* bias,
                                          const Geo& g, const Origin& o,
                                          int h, int s0, int seg0,
                                          bf16* tile0) {
  for (int idx = threadIdx.x; idx < kChunk * 8 * NSEG; idx += blockDim.x) {
    const int j = idx / (8 * NSEG), part = idx % (8 * NSEG);
    const int seg = part >> 3, cc = part & 7;
    const int src = src_at(g, o, s0 + j);
    cp16(tile0 + seg * kChunk * kRow + j * kRow + cc * 8,
         qkv_at(qkv, bias, g, src, seg0 + seg, h, cc), src == -2);
  }
}

// Rows s0.. s0 + n - 1 of q into a token-major tile (plain loads).
__device__ void load_q(const bf16* qkv, const bf16* bias, const Geo& g,
                       const Origin& o, int h, int s0, int n, bf16* tile) {
  for (int idx = threadIdx.x; idx < n * 8; idx += blockDim.x) {
    const int i = idx >> 3, cc = idx & 7;
    const int src = src_at(g, o, s0 + i);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (src != -2)
      v = *reinterpret_cast<const uint4*>(qkv_at(qkv, bias, g, src, 0, h,
                                                 cc));
    *reinterpret_cast<uint4*>(tile + i * kRow + cc * 8) = v;
  }
}

// Both tables' rows, token-major, zero rows up to a multiple of 16.
__device__ void stage_tables(bf16* dst, const bf16* rel_h, const bf16* rel_w,
                             const Geo& g) {
  for (int idx = threadIdx.x; idx < 2 * kTabRows * 8; idx += blockDim.x) {
    const int w = idx / (kTabRows * 8), r = (idx >> 3) % kTabRows;
    const int c = idx & 7, L = w ? g.Lw : g.Lh;
    if (r >= ((L + 15) & ~15)) continue;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < L)
      v = *reinterpret_cast<const uint4*>((w ? rel_w : rel_h) + r * kDh +
                                          c * 8);
    *reinterpret_cast<uint4*>(dst + (w * kTabRows + r) * kRow + c * 8) = v;
  }
}

// The rows i0, i1 (at positions p0, p1 along the table's axis) against
// the table's rows in n-tiles nt0, nt0 + step, ...: the product with row r
// lands at key position k = p + S - 1 - r, kept where it lies in [0, S).
__device__ void rel_products(const uint32_t (&qa)[4][4], const bf16* tab,
                             int L, int S, int p0, int p1, int i0, int i1,
                             float* rel, int stride, int lane, int nt0,
                             int step) {
  const int t = lane & 3;
  const int tiles = (L + 7) >> 3;
  for (int nt = nt0; nt < tiles; nt += step) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    uint32_t b[4][2];
    frags_b(b, tab, nt * 8, lane);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma(acc, qa[kk], b[kk][0], b[kk][1]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = nt * 8 + 2 * t + (e & 1);
      const int k = (e < 2 ? p0 : p1) + S - 1 - r;
      if (r < L && k >= 0 && k < S)
        rel[(e < 2 ? i0 : i1) * stride + k] = acc[e];
    }
  }
}

struct FwdSmem {
  bf16 q[kTile * kRow];
  // the tables, then the k, v stages
  __align__(16) unsigned char a[kTabBytes];
  float rh[kTile * kRhStride];        // first rw, until it is in registers
  int qsrc[kTile];
};
static_assert(4 * kTileBytes == kTabBytes, "tables and k, v stages alias");
static_assert(kTile * kMaxSide <= kTile * kRhStride, "rw fits in rh");

__global__ void __launch_bounds__(kFwdThreads, 2)
rel_attn_fwd_kernel(const bf16* __restrict__ qkv,
                    const bf16* __restrict__ bias,
                    const bf16* __restrict__ rel_h,
                    const bf16* __restrict__ rel_w, bf16* __restrict__ out,
                    float* __restrict__ lse, const Geo g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(smem_raw);
  bf16* tabs = reinterpret_cast<bf16*>(sm.a);
  float* rw = sm.rh;
  const int tile = blockIdx.x, bw = blockIdx.y, h = blockIdx.z;
  const int b = bw / g.nW, w = bw - b * g.nW;
  const Origin org = origin(g, b, w / g.nWw, w % g.nWw);
  const long long head0 = ((long long)bw * g.heads + h) * g.chunks * kChunk;
  const int t0 = tile * kTile;
  const int tid = threadIdx.x;
  for (int i = tid; i < kTile; i += kFwdThreads)
    sm.qsrc[i] = src_at(g, org, t0 + i);
  for (int idx = tid; idx < kTile * g.swp; idx += kFwdThreads)
    rw[idx] = (idx & (g.swp - 1)) < g.Sw ? 0.f : -INFINITY;
  stage_tables(tabs, rel_h, rel_w, g);
  __syncthreads();
  for (int idx = tid; idx < kTile * 8; idx += kFwdThreads) {
    const int i = idx >> 3, cc = idx & 7, src = sm.qsrc[i];
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (src != -2)
      v = *reinterpret_cast<const uint4*>(qkv_at(qkv, bias, g, src, 0, h,
                                                 cc));
    *reinterpret_cast<uint4*>(sm.q + i * kRow + cc * 8) = v;
  }
  __syncthreads();

  // a warp takes 32 rows: m-tiles r0 and r0 + 16, rows r0 + 16 m + gr
  // and r0 + 16 m + gr + 8
  const int warp = tid >> 5, lane = tid & 31, gr = lane >> 2, t = lane & 3;
  const int r0 = warp * 32;
  int row[2][2], sl[2][2];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      row[m][u] = r0 + 16 * m + gr + 8 * u;
      sl[m][u] = t0 + row[m][u];
    }
  uint32_t qa[2][4][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      frag_a(qa[m][kk], sm.q, kRow, r0 + 16 * m, kk * 16, gr, t);
#pragma unroll
  for (int m = 0; m < 2; ++m)
    rel_products(qa[m], tabs + kTabRows * kRow, g.Lw, g.Sw,
                 sl[m][0] & (g.swp - 1), sl[m][1] & (g.swp - 1), row[m][0],
                 row[m][1], rw, g.swp, lane, 0, 1);
  __syncthreads();
  float rwr[2][2][8][2];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          rwr[m][u][n][e] =
              rw[row[m][u] * g.swp + ((8 * n + 2 * t + e) & (g.swp - 1))] *
              kLog2e;
  __syncthreads();                // rw is in registers: rh takes its space
  for (int idx = tid; idx < kTile * g.shr; idx += kFwdThreads) {
    const int i = idx / g.shr, ky = idx - i * g.shr;
    sm.rh[i * kRhStride + ky] = ky < g.Sh ? 0.f : -INFINITY;
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < 2; ++m)
    rel_products(qa[m], tabs, g.Lh, g.Sh, sl[m][0] >> g.lg,
                 sl[m][1] >> g.lg, row[m][0], row[m][1], sm.rh, kRhStride,
                 lane, 0, 1);
  __syncthreads();                // the tables' space takes k and v
  fetch_qkv<2>(qkv, bias, g, org, h, 0, 1, tabs);
  cp_commit();

  float o[2][8][4], mx[2][2], l[2][2];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[m][n][e] = 0.f;
    mx[m][0] = mx[m][1] = -INFINITY;
    l[m][0] = l[m][1] = 0.f;
  }
  const float sc = kScale * kLog2e;
  for (int c = 0; c < g.chunks; ++c) {
    cp_wait0();
    __syncthreads();              // chunk c landed; chunk c - 1 is read
    if (c + 1 < g.chunks)
      fetch_qkv<2>(qkv, bias, g, org, h, (c + 1) * kChunk, 1,
                   tabs + ((c + 1) & 1) * 2 * kChunk * kRow);
    cp_commit();
    const bf16* ks = tabs + (c & 1) * 2 * kChunk * kRow;
    const bf16* vs = ks + kChunk * kRow;
    // two rounds of 32 keys, an online softmax over each
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float s[2][4][4];
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        uint32_t kb[4][2];
        frags_b(kb, ks, (4 * half + nn) * 8, lane);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[m][nn][e] = 0.f;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            mma(s[m][nn], qa[m][kk], kb[kk][0], kb[kk][1]);
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        float hn[4][2], cm[2] = {-INFINITY, -INFINITY};
        float h0 = 0.f, h1 = 0.f;
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) {
          const int n = 4 * half + nn;
          if (nn == 0 || ((8 * n) & (g.swp - 1)) == 0) {   // a key row
            const int ky = c * g.rows + ((8 * n) >> g.lg);
            h0 = sm.rh[row[m][0] * kRhStride + ky] * kLog2e;
            h1 = sm.rh[row[m][1] * kRhStride + ky] * kLog2e;
          }
          hn[nn][0] = h0;
          hn[nn][1] = h1;
          s[m][nn][0] = fmaf(s[m][nn][0], sc, rwr[m][0][n][0]);
          s[m][nn][1] = fmaf(s[m][nn][1], sc, rwr[m][0][n][1]);
          s[m][nn][2] = fmaf(s[m][nn][2], sc, rwr[m][1][n][0]);
          s[m][nn][3] = fmaf(s[m][nn][3], sc, rwr[m][1][n][1]);
          cm[0] = fmaxf(cm[0], fmaxf(s[m][nn][0], s[m][nn][1]) + h0);
          cm[1] = fmaxf(cm[1], fmaxf(s[m][nn][2], s[m][nn][3]) + h1);
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
#pragma unroll
          for (int x = 1; x < 4; x *= 2)
            cm[u] = fmaxf(cm[u], __shfl_xor_sync(0xffffffffu, cm[u], x));
          // the first round holds a key of every row: finite from it on
          const float nm = fmaxf(mx[m][u], cm[u]);
          const float al = ex2(mx[m][u] - nm);
          mx[m][u] = nm;
          l[m][u] *= al;
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            o[m][n][2 * u] *= al;
            o[m][n][2 * u + 1] *= al;
          }
        }
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) {
          const float e0 = mx[m][0] - hn[nn][0], e1 = mx[m][1] - hn[nn][1];
          s[m][nn][0] = ex2(s[m][nn][0] - e0);
          s[m][nn][1] = ex2(s[m][nn][1] - e0);
          s[m][nn][2] = ex2(s[m][nn][2] - e1);
          s[m][nn][3] = ex2(s[m][nn][3] - e1);
          l[m][0] += s[m][nn][0] + s[m][nn][1];
          l[m][1] += s[m][nn][2] + s[m][nn][3];
        }
      }
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2) {
        uint32_t pa[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          pa[m][0] = pack(s[m][2 * k2][0], s[m][2 * k2][1]);
          pa[m][1] = pack(s[m][2 * k2][2], s[m][2 * k2][3]);
          pa[m][2] = pack(s[m][2 * k2 + 1][0], s[m][2 * k2 + 1][1]);
          pa[m][3] = pack(s[m][2 * k2 + 1][2], s[m][2 * k2 + 1][3]);
        }
#pragma unroll
        for (int n2 = 0; n2 < 4; ++n2) {
          uint32_t vb[4];
          frags_bt(vb, vs, half * 32 + k2 * 16, n2 * 16, lane);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            mma(o[m][2 * n2], pa[m], vb[0], vb[1]);
            mma(o[m][2 * n2 + 1], pa[m], vb[2], vb[3]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int x = 1; x < 4; x *= 2)
        l[m][u] += __shfl_xor_sync(0xffffffffu, l[m][u], x);
      if (t == 0)
        lse[head0 + sl[m][u]] = slot_valid(g, sl[m][u])
                                    ? mx[m][u] + log2f(l[m][u])
                                    : INFINITY;
      const float rl = 1.f / l[m][u];
      // the warp's own q rows take its output
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<uint32_t*>(sm.q + row[m][u] * kRow + n * 8 +
                                     2 * t) =
            pack(o[m][n][2 * u] * rl, o[m][n][2 * u + 1] * rl);
    }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int id = lane + 32 * k, i = r0 + (id >> 3), chunk = id & 7;
    const int src = sm.qsrc[i];
    if (src >= 0)
      *reinterpret_cast<uint4*>(out + (long long)src * g.C + h * kDh +
                                chunk * 8) =
          *reinterpret_cast<const uint4*>(sm.q + i * kRow + chunk * 8);
  }
}

// D_i = dO_i . O_i of n token-major rows, 4 lanes a row.
__device__ void row_dots(const bf16* dout, const bf16* o, int n, float* d) {
  for (int idx = threadIdx.x; idx < n * 4; idx += blockDim.x) {
    const int i = idx >> 2, part = idx & 3;
    float acc = 0.f;
#pragma unroll
    for (int e = 0; e < 16; e += 2) {
      const float2 a = unpack(dout + i * kRow + part * 16 + e);
      const float2 c = unpack(o + i * kRow + part * 16 + e);
      acc = fmaf(a.x, c.x, fmaf(a.y, c.y, acc));
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) d[i] = acc;
  }
}

// dO and O of the slots s0.. s0 + n - 1 (zero where the slot holds no
// real token: its output is cropped) and, where `ls` is given, their
// log-sum-exps, asynchronously.
__device__ void fetch_dout(const bf16* out, const bf16* dout,
                           const float* lse, const Geo& g, const Origin& org,
                           int h, long long head0, int s0, int n, bf16* dt,
                           bf16* ot, float* ls) {
  for (int idx = threadIdx.x; idx < n * 16; idx += blockDim.x) {
    const int i = idx >> 4, which = (idx >> 3) & 1, cc = idx & 7;
    const int src = src_at(g, org, s0 + i);
    const long long at = (long long)(src >= 0 ? src : 0) * g.C + h * kDh +
                         cc * 8;
    cp16((which ? ot : dt) + i * kRow + cc * 8, (which ? out : dout) + at,
         src < 0);
  }
  if (ls != nullptr)
    for (int idx = threadIdx.x; idx < n / 4; idx += blockDim.x)
      cp16(ls + 4 * idx, lse + head0 + s0 + 4 * idx, false);
}

struct KvStage {
  bf16 q[kChunk * kRow], dout[kChunk * kRow], o[kChunk * kRow];
  float lse[kChunk];
};

struct KvSmem {
  bf16 k[kTile * kRow], v[kTile * kRow];
  KvStage stage[2];
  bf16 tabs[2 * kTabRows * kRow];
  float rw[kChunk * kRwcStride];      // each query at every key column
  float rh[kChunk * kRelhStride];     // each query at the tile's key rows
  float dsum[kChunk];
  float pad[kWarps][2 * kDh];         // each warp's padded keys' dk, dv
  int ksrc[kTile];
};

// A key block: dK, dV of 128 keys, over every query chunk.
__device__ __forceinline__ void kv_block(
    unsigned char* smem_raw, const bf16* qkv, const bf16* bias,
    const bf16* rel_h, const bf16* rel_w, const bf16* out, const bf16* dout,
    const float* lse, bf16* dqkv, float* part_kv, const Geo& g, int kt,
    int bw, int h) {
  KvSmem& sm = *reinterpret_cast<KvSmem*>(smem_raw);
  const int b = bw / g.nW, w = bw - b * g.nW;
  const Origin org = origin(g, b, w / g.nWw, w % g.nWw);
  const long long head0 = ((long long)bw * g.heads + h) * g.chunks * kChunk;
  const int tiles = g.chunks / 2;
  const int t0 = kt * kTile, y0 = t0 >> g.lg;   // first slot, slot row
  const int trows = 2 * g.rows;                 // the tile's slot rows
  const int tid = threadIdx.x;
  for (int i = tid; i < kTile; i += kThreads)
    sm.ksrc[i] = src_at(g, org, t0 + i);
  for (int idx = tid; idx < kChunk * g.swp; idx += kThreads) {
    const int i = idx >> g.lg, x = idx & (g.swp - 1);
    sm.rw[i * kRwcStride + x] = x < g.Sw ? 0.f : -INFINITY;
  }
  stage_tables(sm.tabs, rel_h, rel_w, g);
  // the tile's k and v rows (k then v, 128 rows each)
  for (int idx = tid; idx < kTile * 16; idx += kThreads) {
    const int j = idx >> 4, seg = (idx >> 3) & 1, cc = idx & 7;
    const int src = src_at(g, org, t0 + j);
    cp16((seg ? sm.v : sm.k) + j * kRow + cc * 8,
         qkv_at(qkv, bias, g, src, 1 + seg, h, cc), src == -2);
  }
  fetch_dout(out, dout, lse, g, org, h, head0, 0, kChunk, sm.stage[0].dout,
             sm.stage[0].o, sm.stage[0].lse);
  fetch_qkv<1>(qkv, bias, g, org, h, 0, 0, sm.stage[0].q);
  cp_commit();

  const int warp = tid >> 5, lane = tid & 31, gr = lane >> 2, t = lane & 3;
  const int k0 = warp * 16, j0 = k0 + gr, j1 = j0 + 8;
  const int ly0 = ((t0 + j0) >> g.lg) - y0, lx0 = (t0 + j0) & (g.swp - 1);
  const int ly1 = ((t0 + j1) >> g.lg) - y0, lx1 = (t0 + j1) & (g.swp - 1);
  const float sc = kScale * kLog2e;
  uint32_t ka[4][4], va[4][4];
  float dv[8][4], dk[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[n][e] = dk[n][e] = 0.f;

  for (int c = 0; c < g.chunks; ++c) {
    const int c0 = c * kChunk;
    cp_wait0();
    __syncthreads();              // chunk c landed; chunk c - 1 is read
    if (c + 1 < g.chunks) {
      KvStage& nx = sm.stage[(c + 1) & 1];
      fetch_dout(out, dout, lse, g, org, h, head0, c0 + kChunk, kChunk,
                 nx.dout, nx.o, nx.lse);
      fetch_qkv<1>(qkv, bias, g, org, h, c0 + kChunk, 0, nx.q);
    }
    cp_commit();
    KvStage& cs = sm.stage[c & 1];
    if (c == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        frag_a(ka[kk], sm.k, kRow, k0, kk * 16, gr, t);
        frag_a(va[kk], sm.v, kRow, k0, kk * 16, gr, t);
      }
    }
    row_dots(cs.dout, cs.o, kChunk, sm.dsum);
    {
      // the chunk's rw by mma: warp w takes queries 16 (w % 4).. and every
      // other n-tile of the table from w / 4
      const int m0 = (warp & 3) * 16;
      uint32_t qa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        frag_a(qa[kk], cs.q, kRow, m0, kk * 16, gr, t);
      const int a0 = c0 + m0 + gr, a1 = a0 + 8;
      rel_products(qa, sm.tabs + kTabRows * kRow, g.Lw, g.Sw,
                   a0 & (g.swp - 1), a1 & (g.swp - 1), m0 + gr, m0 + gr + 8,
                   sm.rw, kRwcStride, lane, warp >> 2, 2);
    }
    // the chunk's rh at the tile's key rows: one dot product a pair
    for (int p = tid; p < kChunk * trows; p += kThreads) {
      const int i = p / trows, u = p - i * trows;
      const int ky = y0 + u, qy = (c0 + i) >> g.lg;
      const int r = qy - ky + g.Sh - 1;
      float acc = 0.f;
      if (r >= 0 && r < g.Lh) {
#pragma unroll 8
        for (int d = 0; d < kDh; d += 2) {
          const float2 a = unpack(cs.q + i * kRow + d);
          const float2 e = unpack(sm.tabs + r * kRow + d);
          acc = fmaf(a.x, e.x, fmaf(a.y, e.y, acc));
        }
      }
      sm.rh[i * kRelhStride + u] = ky < g.Sh ? acc : -INFINITY;
    }
    __syncthreads();
    for (int q0 = 0; q0 < kChunk; q0 += 16) {
      uint32_t qb[2][4][2], ob[2][4][2];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        frags_b(qb[n], cs.q, q0 + n * 8, lane);
        frags_b(ob[n], cs.dout, q0 + n * 8, lane);
      }
      float p[2][4], ds[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float st[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          mma(st, ka[kk], qb[n][kk][0], qb[n][kk][1]);
          mma(dp, va[kk], ob[n][kk][0], ob[n][kk][1]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = q0 + n * 8 + 2 * t + (e & 1);
          const float b2 = (sm.rh[i * kRelhStride + (e < 2 ? ly0 : ly1)] +
                            sm.rw[i * kRwcStride + (e < 2 ? lx0 : lx1)]) *
                           kLog2e;
          p[n][e] = ex2(fmaf(st[e], sc, b2) - cs.lse[i]);
          ds[n][e] = p[n][e] * (dp[e] - sm.dsum[i]);
        }
      }
      const uint32_t pa[4] = {pack(p[0][0], p[0][1]), pack(p[0][2], p[0][3]),
                              pack(p[1][0], p[1][1]), pack(p[1][2], p[1][3])};
      const uint32_t sa[4] = {pack(ds[0][0], ds[0][1]),
                              pack(ds[0][2], ds[0][3]),
                              pack(ds[1][0], ds[1][1]),
                              pack(ds[1][2], ds[1][3])};
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2) {
        uint32_t bo[4], bq[4];
        frags_bt(bo, cs.dout, q0, n2 * 16, lane);
        frags_bt(bq, cs.q, q0, n2 * 16, lane);
        mma(dv[2 * n2], pa, bo[0], bo[1]);
        mma(dv[2 * n2 + 1], pa, bo[2], bo[3]);
        mma(dk[2 * n2], sa, bq[0], bq[1]);
        mma(dk[2 * n2 + 1], sa, bq[2], bq[3]);
      }
    }
  }
  // the padded keys' dk and dv, summed over the warp's rows in a fixed
  // order (lanes of one column: xor over the row groups)
  const bool pad0 = sm.ksrc[j0] == -1, pad1 = sm.ksrc[j1] == -1;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float sk = (pad0 ? dk[n][e] : 0.f) + (pad1 ? dk[n][e + 2] : 0.f);
      float sv = (pad0 ? dv[n][e] : 0.f) + (pad1 ? dv[n][e + 2] : 0.f);
#pragma unroll
      for (int x = 4; x < 32; x *= 2) {
        sk += __shfl_xor_sync(0xffffffffu, sk, x);
        sv += __shfl_xor_sync(0xffffffffu, sv, x);
      }
      if (gr == 0) {
        sm.pad[warp][n * 8 + 2 * t + e] = sk * kScale;
        sm.pad[warp][kDh + n * 8 + 2 * t + e] = sv;
      }
    }
  }
  // the warp's own k and v rows take dK and dV, then 16-byte stores
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = n * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(sm.k + j0 * kRow + col) =
        pack(dk[n][0] * kScale, dk[n][1] * kScale);
    *reinterpret_cast<uint32_t*>(sm.k + j1 * kRow + col) =
        pack(dk[n][2] * kScale, dk[n][3] * kScale);
    *reinterpret_cast<uint32_t*>(sm.v + j0 * kRow + col) =
        pack(dv[n][0], dv[n][1]);
    *reinterpret_cast<uint32_t*>(sm.v + j1 * kRow + col) =
        pack(dv[n][2], dv[n][3]);
  }
  __syncwarp();
  for (int id = lane; id < 16 * 16; id += 32) {
    const int j = k0 + (id >> 4), part = (id >> 3) & 1, chunk = id & 7;
    const int src = sm.ksrc[j];
    if (src >= 0)
      *reinterpret_cast<uint4*>(dqkv + (long long)src * 3 * g.C +
                                (1 + part) * g.C + h * kDh + chunk * 8) =
          *reinterpret_cast<const uint4*>((part ? sm.v : sm.k) + j * kRow +
                                          chunk * 8);
  }
  __syncthreads();
  const long long blk = ((long long)bw * g.heads + h) * tiles + kt;
  for (int c = tid; c < 2 * kDh; c += kThreads) {
    float acc = 0.f;
#pragma unroll
    for (int w_ = 0; w_ < kWarps; ++w_) acc += sm.pad[w_][c];
    part_kv[blk * 2 * kDh + c] = acc;
  }
}

struct QSmem {
  bf16 q[kTile * kRow], dout[kTile * kRow];
  // the tables, then the double-buffered k and v chunks
  __align__(16) unsigned char a[kTabBytes];
  float lse[kTile], dsum[kTile];
  float rh[kTile * kRhStride], drh[kTile * kRhStride];
  float rw[kTile * kMaxSide];         // then drw
  int qsrc[kTile];
};

// A query block: dQ of 128 queries, the bias terms' gradients, the bias's
// share of dQ and the tables' partial gradients, over every key chunk.
__device__ __forceinline__ void q_block(
    unsigned char* smem_raw, const bf16* qkv, const bf16* bias,
    const bf16* rel_h, const bf16* rel_w, const bf16* out, const bf16* dout,
    const float* lse, bf16* dqkv, float* part_tab, const Geo& g, int qt,
    int bw, int h) {
  QSmem& sm = *reinterpret_cast<QSmem*>(smem_raw);
  bf16* tabs = reinterpret_cast<bf16*>(sm.a);
  float* drw_s = sm.rw;
  const int b = bw / g.nW, w = bw - b * g.nW;
  const Origin org = origin(g, b, w / g.nWw, w % g.nWw);
  const long long head0 = ((long long)bw * g.heads + h) * g.chunks * kChunk;
  const int tiles = g.chunks / 2;
  const int t0 = qt * kTile;
  const int tid = threadIdx.x;
  for (int i = tid; i < kTile; i += kThreads) {
    sm.qsrc[i] = src_at(g, org, t0 + i);
    sm.lse[i] = lse[head0 + t0 + i];
  }
  for (int idx = tid; idx < kTile * g.shr; idx += kThreads) {
    const int i = idx / g.shr, ky = idx - i * g.shr;
    sm.rh[i * kRhStride + ky] = ky < g.Sh ? 0.f : -INFINITY;
  }
  for (int idx = tid; idx < kTile * g.swp; idx += kThreads)
    sm.rw[idx] = (idx & (g.swp - 1)) < g.Sw ? 0.f : -INFINITY;
  load_q(qkv, bias, g, org, h, t0, kTile, sm.q);
  // dO, and O in the tables' space until D is taken
  bf16* ot = tabs;
  for (int half = 0; half < 2; ++half)
    fetch_dout(out, dout, nullptr, g, org, h, head0, t0 + half * kChunk,
               kChunk, sm.dout + half * kChunk * kRow,
               ot + half * kChunk * kRow, nullptr);
  cp_commit();
  cp_wait0();
  __syncthreads();
  row_dots(sm.dout, ot, kTile, sm.dsum);
  __syncthreads();
  stage_tables(tabs, rel_h, rel_w, g);
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31, gr = lane >> 2, t = lane & 3;
  const int r0 = warp * 16, i0 = r0 + gr, i1 = i0 + 8;
  const int s0 = t0 + i0, s1 = t0 + i1;
  uint32_t qa[4][4], oa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    frag_a(qa[kk], sm.q, kRow, r0, kk * 16, gr, t);
    frag_a(oa[kk], sm.dout, kRow, r0, kk * 16, gr, t);
  }
  rel_products(qa, tabs, g.Lh, g.Sh, s0 >> g.lg, s1 >> g.lg, i0, i1, sm.rh,
               kRhStride, lane, 0, 1);
  rel_products(qa, tabs + kTabRows * kRow, g.Lw, g.Sw, s0 & (g.swp - 1),
               s1 & (g.swp - 1), i0, i1, sm.rw, g.swp, lane, 0, 1);
  __syncthreads();
  float rwr[2][8][2], drw[2][8][2];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int kx = (8 * n + 2 * t + e) & (g.swp - 1);
      rwr[0][n][e] = sm.rw[i0 * g.swp + kx] * kLog2e;
      rwr[1][n][e] = sm.rw[i1 * g.swp + kx] * kLog2e;
      drw[0][n][e] = drw[1][n][e] = 0.f;
    }
  const float lse0 = sm.lse[i0], lse1 = sm.lse[i1];
  const float dsum0 = sm.dsum[i0], dsum1 = sm.dsum[i1];
  __syncthreads();                // the tables' space takes k and v
  fetch_qkv<2>(qkv, bias, g, org, h, 0, 1, tabs);
  cp_commit();
  const int nper = g.swp >> 3;   // key n-tiles a slot row
  const float sc = kScale * kLog2e;
  float dq[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int c = 0; c < g.chunks; ++c) {
    cp_wait0();
    __syncthreads();              // chunk c landed; chunk c - 1 is read
    if (c + 1 < g.chunks)
      fetch_qkv<2>(qkv, bias, g, org, h, (c + 1) * kChunk, 1,
                   tabs + ((c + 1) & 1) * 2 * kChunk * kRow);
    cp_commit();
    const bf16* ks = tabs + (c & 1) * 2 * kChunk * kRow;
    const bf16* vs = ks + kChunk * kRow;
    float a0 = 0.f, a1 = 0.f;      // a key row's dS, the lane's two rows
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float s[4][4], dp[4][4];
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        const int n = 4 * half + nn;
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nn][e] = dp[nn][e] = 0.f;
        uint32_t kb[4][2], vb[4][2];
        frags_b(kb, ks, n * 8, lane);
        frags_b(vb, vs, n * 8, lane);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          mma(s[nn], qa[kk], kb[kk][0], kb[kk][1]);
          mma(dp[nn], oa[kk], vb[kk][0], vb[kk][1]);
        }
      }
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        const int n = 4 * half + nn;
        const int ky = c * g.rows + ((8 * n) >> g.lg);
        const float e0 = lse0 - sm.rh[i0 * kRhStride + ky] * kLog2e;
        const float e1 = lse1 - sm.rh[i1 * kRhStride + ky] * kLog2e;
        s[nn][0] = ex2(fmaf(s[nn][0], sc, rwr[0][n][0]) - e0) *
                   (dp[nn][0] - dsum0);
        s[nn][1] = ex2(fmaf(s[nn][1], sc, rwr[0][n][1]) - e0) *
                   (dp[nn][1] - dsum0);
        s[nn][2] = ex2(fmaf(s[nn][2], sc, rwr[1][n][0]) - e1) *
                   (dp[nn][2] - dsum1);
        s[nn][3] = ex2(fmaf(s[nn][3], sc, rwr[1][n][1]) - e1) *
                   (dp[nn][3] - dsum1);
        drw[0][n][0] += s[nn][0];
        drw[0][n][1] += s[nn][1];
        drw[1][n][0] += s[nn][2];
        drw[1][n][1] += s[nn][3];
        a0 += s[nn][0] + s[nn][1];
        a1 += s[nn][2] + s[nn][3];
        if (((n + 1) & (nper - 1)) == 0) {   // the end of a key row
          a0 += __shfl_xor_sync(0xffffffffu, a0, 1);
          a0 += __shfl_xor_sync(0xffffffffu, a0, 2);
          a1 += __shfl_xor_sync(0xffffffffu, a1, 1);
          a1 += __shfl_xor_sync(0xffffffffu, a1, 2);
          if (t == 0) {
            sm.drh[i0 * kRhStride + ky] = a0;
            sm.drh[i1 * kRhStride + ky] = a1;
          }
          a0 = a1 = 0.f;
        }
      }
      // dQ += dS k over the half's 32 keys
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2) {
        const uint32_t sa[4] = {pack(s[2 * k2][0], s[2 * k2][1]),
                                pack(s[2 * k2][2], s[2 * k2][3]),
                                pack(s[2 * k2 + 1][0], s[2 * k2 + 1][1]),
                                pack(s[2 * k2 + 1][2], s[2 * k2 + 1][3])};
        const int key = half * 32 + k2 * 16;
#pragma unroll
        for (int n2 = 0; n2 < 4; ++n2) {
          uint32_t kb[4];
          frags_bt(kb, ks, key, n2 * 16, lane);
          mma(dq[2 * n2], sa, kb[0], kb[1]);
          mma(dq[2 * n2 + 1], sa, kb[2], kb[3]);
        }
      }
    }
  }
  // drw by key column: the n-tiles that meet one column, in order
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    if (n < nper) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x0 = 0.f, x1 = 0.f;
#pragma unroll
        for (int m = 0; m < 8; ++m)
          if ((m & (nper - 1)) == n) {
            x0 += drw[0][m][e];
            x1 += drw[1][m][e];
          }
        drw_s[i0 * g.swp + 8 * n + 2 * t + e] = x0;
        drw_s[i1 * g.swp + 8 * n + 2 * t + e] = x1;
      }
    }
  }
  __syncthreads();                // drh, drw whole; the k, v stages free
  stage_tables(tabs, rel_h, rel_w, g);
  __syncthreads();
  // G[i][r]: the bias term's gradient of query i at table row r (drh at
  // key row qy_i + Sh - 1 - r, drw likewise by columns; 0 elsewhere)
  auto G = [&](int w2, int i, int r) -> float {
    const int sl = t0 + i, L = w2 ? g.Lw : g.Lh, S = w2 ? g.Sw : g.Sh;
    const int k = (w2 ? (sl & (g.swp - 1)) : (sl >> g.lg)) + S - 1 - r;
    if (r >= L || k < 0 || k >= S || !slot_valid(g, sl)) return 0.f;
    return w2 ? drw_s[i * g.swp + k] : sm.drh[i * kRhStride + k];
  };
  // the bias's share of dq: G T over the table rows, by mma at the warp's
  // rows (G rounded to bf16, as dS is for dS k)
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int w2 = 0; w2 < 2; ++w2) {
    const int L = w2 ? g.Lw : g.Lh;
    const bf16* tab = tabs + w2 * kTabRows * kRow;
    for (int k0 = 0; k0 < L; k0 += 16) {
      const int r = k0 + 2 * t;
      const uint32_t a[4] = {pack(G(w2, i0, r), G(w2, i0, r + 1)),
                             pack(G(w2, i1, r), G(w2, i1, r + 1)),
                             pack(G(w2, i0, r + 8), G(w2, i0, r + 9)),
                             pack(G(w2, i1, r + 8), G(w2, i1, r + 9))};
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2) {
        uint32_t tb[4];
        frags_bt(tb, tab, k0, n2 * 16, lane);
        mma(acc[2 * n2], a, tb[0], tb[1]);
        mma(acc[2 * n2 + 1], a, tb[2], tb[3]);
      }
    }
  }
  // the warp's own dO rows take dQ, then 16-byte stores
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = n * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(sm.dout + i0 * kRow + col) =
        pack(fmaf(dq[n][0], kScale, acc[n][0]),
             fmaf(dq[n][1], kScale, acc[n][1]));
    *reinterpret_cast<uint32_t*>(sm.dout + i1 * kRow + col) =
        pack(fmaf(dq[n][2], kScale, acc[n][2]),
             fmaf(dq[n][3], kScale, acc[n][3]));
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int id = lane + 32 * k, i = r0 + (id >> 3), chunk = id & 7;
    const int src = sm.qsrc[i];
    if (src >= 0)
      *reinterpret_cast<uint4*>(dqkv + (long long)src * 3 * g.C + h * kDh +
                                chunk * 8) =
          *reinterpret_cast<const uint4*>(sm.dout + i * kRow + chunk * 8);
  }
  // the tables' partial gradients, G^T q over the tile's queries by mma: a
  // warp per 16 table rows
  const long long blk = ((long long)bw * g.heads + h) * tiles + qt;
  float* pt = part_tab + blk * (g.Lh + g.Lw) * kDh;
  const int mh = (g.Lh + 15) >> 4, mw = (g.Lw + 15) >> 4;
  for (int u = warp; u < mh + mw; u += kWarps) {
    const int w2 = u >= mh, rt = (w2 ? u - mh : u) * 16;
    const int L = w2 ? g.Lw : g.Lh;
    float part[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
    for (int k0 = 0; k0 < kTile; k0 += 16) {
      const int i = k0 + 2 * t, r = rt + gr;
      const uint32_t a[4] = {pack(G(w2, i, r), G(w2, i + 1, r)),
                             pack(G(w2, i, r + 8), G(w2, i + 1, r + 8)),
                             pack(G(w2, i + 8, r), G(w2, i + 9, r)),
                             pack(G(w2, i + 8, r + 8), G(w2, i + 9, r + 8))};
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2) {
        uint32_t qb[4];
        frags_bt(qb, sm.q, k0, n2 * 16, lane);
        mma(part[2 * n2], a, qb[0], qb[1]);
        mma(part[2 * n2 + 1], a, qb[2], qb[3]);
      }
    }
    float* row = pt + ((w2 ? g.Lh : 0) + rt) * kDh;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = n * 8 + 2 * t;
      if (rt + gr < L) {
        row[gr * kDh + col] = part[n][0];
        row[gr * kDh + col + 1] = part[n][1];
      }
      if (rt + gr + 8 < L) {
        row[(gr + 8) * kDh + col] = part[n][2];
        row[(gr + 8) * kDh + col + 1] = part[n][3];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
rel_attn_bwd_kernel(const bf16* __restrict__ qkv,
                    const bf16* __restrict__ bias,
                    const bf16* __restrict__ rel_h,
                    const bf16* __restrict__ rel_w,
                    const bf16* __restrict__ out,
                    const bf16* __restrict__ dout,
                    const float* __restrict__ lse, bf16* __restrict__ dqkv,
                    float* __restrict__ part_kv,
                    float* __restrict__ part_tab, const Geo g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tiles = g.chunks / 2;
  if ((int)blockIdx.x < tiles)
    kv_block(smem_raw, qkv, bias, rel_h, rel_w, out, dout, lse, dqkv,
             part_kv, g, blockIdx.x, blockIdx.y, blockIdx.z);
  else
    q_block(smem_raw, qkv, bias, rel_h, rel_w, out, dout, lse, dqkv,
            part_tab, g, blockIdx.x - tiles, blockIdx.y, blockIdx.z);
}

// The tables' and the bias's gradients from the blocks' partial sums: a
// block of 256 threads takes 32 entries, its 8 warps each a fixed eighth
// of the partials (in order), then sums the eighths in order: the same
// bits every run. The q part of the bias gets 0 (a padded query's dq is
// 0: its output is cropped).
constexpr int kReduceCols = 32;
constexpr int kReduceParts = kReduceThreads / kReduceCols;

__global__ void __launch_bounds__(kReduceThreads)
rel_attn_table_grad_kernel(const float* __restrict__ part_kv,
                           const float* __restrict__ part_tab,
                           float* __restrict__ dth, float* __restrict__ dtw,
                           float* __restrict__ dbias, int windows, int tiles,
                           int heads, int Lh, int Lw, int C) {
  __shared__ float sums[kReduceParts][kReduceCols];
  const int col = threadIdx.x % kReduceCols, part = threadIdx.x / kReduceCols;
  const int id = blockIdx.x * kReduceCols + col;
  const int nt = (Lh + Lw) * kDh;
  const long long blocks = (long long)windows * heads * tiles;
  float acc = 0.f;
  if (id < nt) {
    for (long long k = part; k < blocks; k += kReduceParts)
      acc += part_tab[k * nt + id];
  } else if (id < nt + 3 * C && (id - nt) >= C) {
    const int c = id - nt, seg = c / C, ch = c - seg * C;
    const int h = ch / kDh, d = ch - h * kDh;
    const long long per = (long long)windows * tiles;
    for (long long k = part; k < per; k += kReduceParts) {
      const long long w = k / tiles, kt = k - w * tiles;
      acc += part_kv[((w * heads + h) * tiles + kt) * 2 * kDh +
                     (seg - 1) * kDh + d];
    }
  }
  sums[part][col] = acc;
  __syncthreads();
  if (part != 0 || id >= nt + 3 * C) return;
  float total = 0.f;
#pragma unroll
  for (int p = 0; p < kReduceParts; ++p) total += sums[p][col];
  if (id < Lh * kDh) dth[id] = total;
  else if (id < nt) dtw[id - Lh * kDh] = total;
  else dbias[id - nt] = total;
}

bool geometry(Geo& g, int B, int H, int W, int C, int heads, int window) {
  if (B < 1 || H < 1 || W < 1 || heads < 1 || C != heads * kDh ||
      window < 0 || (long long)B * H * W * 3 * C >= 0x7fffffffLL)
    return false;
  g.B = B;
  g.H = H;
  g.W = W;
  g.C = C;
  g.heads = heads;
  g.Sh = window ? window : H;
  g.Sw = window ? window : W;
  if (g.Sh > kMaxSide || g.Sw > kMaxSide) return false;
  g.swp = 16;
  g.lg = 4;
  while (g.swp < g.Sw) {
    g.swp *= 2;
    ++g.lg;
  }
  g.rows = kChunk >> g.lg;
  g.chunks = 2 * ((g.Sh + 2 * g.rows - 1) / (2 * g.rows));
  g.shr = g.chunks * g.rows;
  g.nWw = (W + g.Sw - 1) / g.Sw;
  g.nW = (H + g.Sh - 1) / g.Sh * g.nWw;
  g.Lh = 2 * g.Sh - 1;
  g.Lw = 2 * g.Sw - 1;
  return (long long)B * g.nW <= 65535 && heads <= 65535 &&
         (long long)B * g.nW * heads * g.chunks * kChunk < 0x7fffffffLL;
}

template <typename T>
cudaError_t allow_smem(T* kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

constexpr int kBwdSmem =
    sizeof(KvSmem) > sizeof(QSmem) ? (int)sizeof(KvSmem) : (int)sizeof(QSmem);

}  // namespace

// qkv (B, H, W, 3C), bias (3C), rel_h (2 Sh - 1, 64), rel_w (2 Sw - 1, 64),
// out (B, H, W, C): bf16, contiguous, 16-byte aligned; lse (B * nW, heads,
// slots) fp32. C = heads * 64; window 0 for global. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments the kernel
// does not take.
extern "C" int rel_attn_forward_launch(const void* qkv, const void* bias,
                                       const void* rel_h, const void* rel_w,
                                       void* out, void* lse, int B, int H,
                                       int W, int C, int heads, int window,
                                       void* stream) {
  Geo g;
  if (!geometry(g, B, H, W, C, heads, window))
    return (int)cudaErrorInvalidValue;
  static const cudaError_t ready =
      allow_smem(rel_attn_fwd_kernel, (int)sizeof(FwdSmem));
  if (ready != cudaSuccess) return (int)ready;
  dim3 grid(g.chunks / 2, B * g.nW, heads);
  rel_attn_fwd_kernel<<<grid, kFwdThreads, sizeof(FwdSmem),
                        (cudaStream_t)stream>>>(
      (const bf16*)qkv, (const bf16*)bias, (const bf16*)rel_h,
      (const bf16*)rel_w, (bf16*)out, (float*)lse, g);
  return (int)cudaGetLastError();
}

// The forward's operands, its output and lse, and the output's gradient
// dout (B, H, W, C) bf16; writes dqkv (B, H, W, 3C) bf16 at every real
// token and, through the blocks' partial sums part_kv (blocks, 128) and
// part_tab (blocks, Lh + Lw, 64) fp32 (blocks = B * nW * heads * slots /
// 128), the tables' gradients dth (Lh, 64), dtw (Lw, 64) and the padded
// tokens' gradient dbias (3C), fp32.
extern "C" int rel_attn_backward_launch(
    const void* qkv, const void* bias, const void* rel_h, const void* rel_w,
    const void* out, const void* dout, const void* lse, void* dqkv,
    void* part_kv, void* part_tab, void* dth, void* dtw, void* dbias, int B,
    int H, int W, int C, int heads, int window, void* stream) {
  Geo g;
  if (!geometry(g, B, H, W, C, heads, window))
    return (int)cudaErrorInvalidValue;
  static const cudaError_t ready = allow_smem(rel_attn_bwd_kernel, kBwdSmem);
  if (ready != cudaSuccess) return (int)ready;
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles = g.chunks / 2;
  dim3 grid(2 * tiles, B * g.nW, heads);
  rel_attn_bwd_kernel<<<grid, kThreads, kBwdSmem, s>>>(
      (const bf16*)qkv, (const bf16*)bias, (const bf16*)rel_h,
      (const bf16*)rel_w, (const bf16*)out, (const bf16*)dout,
      (const float*)lse, (bf16*)dqkv, (float*)part_kv, (float*)part_tab, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = (g.Lh + g.Lw) * kDh + 3 * C;
  rel_attn_table_grad_kernel<<<(n + kReduceCols - 1) / kReduceCols,
                               kReduceThreads, 0, s>>>(
      (const float*)part_kv, (const float*)part_tab, (float*)dth,
      (float*)dtw, (float*)dbias, B * g.nW, tiles, heads, g.Lh, g.Lw, C);
  return (int)cudaGetLastError();
}
