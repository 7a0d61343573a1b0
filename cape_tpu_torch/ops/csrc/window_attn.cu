// Shifted-window self-attention of a Swin block, forward and backward,
// from the qkv projection's output to the input of the output projection
// (the function of `ops/window_attn.py`'s `window_attention_plain`):
//   for every image b, window w of the grid padded to a multiple of 12 and
//   rolled by -shift, and head h:
//     out[i] = sum_j softmax_j(q_i . k_j / sqrt(32) + table[bin(i, j), h]
//                              + mask(i, j)) v_j
//   over the window's 144 tokens i, j, where a token of the padded grid
//   reads q, k, v from the projection's output at its real position, or
//   the projection's bias where it is padding; bin(i, j) is the relative
//   offset (ri - rj + 11) * 23 + (ci - cj + 11); mask is -100 between
//   tokens of different regions of the padded grid in a shifted block.
//   The output is written at the real positions only.
//
// Replaces no Pallas kernel: the JAX package has no Swin backbone. Added
// for the DINO-4scale Swin-L backbone, whose 24 blocks run this at every
// forward and backward.
//
// Bound: bytes. A site reads q, k, v of its real tokens (3C bf16 a token)
// and writes the output (C); the products are 2 x 144 x 32 multiply-adds a
// token and head, ~72 FLOPs a byte against the H100's ~295. So nothing of
// the (144 x 144) scores reaches device memory: the shift, the padding and
// the window partition are indexing, the bias and the mask are added in
// registers, the softmax runs in fp32 and only each row's log-sum-exp is
// stored for the backward.
//
// Design. A block is one (window, head) of one image: 9 warps, a warp per
// 16 rows of the window's 144. The block stages its tokens' q and k
// (token-major) and v (channel-major) in shared memory, rows padded so
// that the fragment loads of `mma.sync.m16n8k16` (bf16 in, fp32 sums) meet
// no bank twice. Forward: a warp runs the scores of its 16 queries in
// chunks of 48 keys with an online softmax (running max and sum, output
// rescaled), the probabilities going from the scores' accumulator
// registers straight into the A fragments of the product with v.
// Backward (flash-attention's, one window at a time): the block stages q,
// k, v and the output's gradient dO in both layouts and D_i = dO_i . O_i;
// a warp per 16 keys recomputes its scores against every query chunk of
// 16, the probabilities from the saved log-sum-exp, dP = dO v^T and
// dS = P (dP - D), accumulates dV = P^T dO and dK = dS^T q in registers
// and writes dS (bf16) to shared memory; then a warp per 16 queries takes
// dQ = dS k. The padded tokens' dk and dv (their k and v are the bias) are
// summed by each warp in a fixed order, and the block's dS by bin (each
// bin a thread, its pairs in a fixed order): both as the block's partial
// sums, which a second kernel reduces over the windows in a fixed order.
// No float atomics: reruns give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWin = 12;
constexpr int kN = kWin * kWin;                   // tokens a window
constexpr int kDh = 32;                           // a head's channels
constexpr int kWarps = kN / 16;                   // a warp per 16 rows
constexpr int kThreads = kWarps * 32;
constexpr int kSide = 2 * kWin - 1;
constexpr int kBins = kSide * kSide;              // relative offsets
constexpr int kPart = 2 * kDh;                    // a head's padded dk, dv
constexpr int kRow = kDh + 8;    // a token-major tile's row, bf16
constexpr int kCol = kN + 8;     // a channel-major tile's row, bf16
constexpr int kChunk = 48;       // keys a forward round takes
constexpr float kMaskFill = -100.f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kScale = 0.17677669529663687f;   // 32 ** -0.5
constexpr int kReduceThreads = 256;

typedef __nv_bfloat16 bf16;

struct Geo {
  int B, H, W, C, heads, shift, Hp, Wp, nWw, nW;
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

// The window's token i of image b: its flat real position (b, y, x) as a
// row of the (B * H * W) grid, or -1 where it is padding; and its region
// of the padded, rolled grid.
struct Token {
  int src, region;
};

__device__ __forceinline__ Token token(const Geo& g, int b, int wy, int wx,
                                       int i) {
  const int ys = wy * kWin + i / kWin, xs = wx * kWin + i % kWin;
  int yo = ys + g.shift, xo = xs + g.shift;
  if (yo >= g.Hp) yo -= g.Hp;
  if (xo >= g.Wp) xo -= g.Wp;
  Token tk;
  tk.src = (yo < g.H && xo < g.W) ? (b * g.H + yo) * g.W + xo : -1;
  const int ry = (ys >= g.Hp - kWin) + (ys >= g.Hp - g.shift);
  const int rx = (xs >= g.Wp - kWin) + (xs >= g.Wp - g.shift);
  tk.region = ry * 3 + rx;
  return tk;
}

__device__ __forceinline__ int bin_of(int i, int j) {
  return (i / kWin - j / kWin + kWin - 1) * kSide + (i % kWin - j % kWin) +
         kWin - 1;
}

// What both kernels stage besides the tiles: the head's table (fp32), each
// token's real row and region.
struct Common {
  float tab[kBins];
  int src[kN];
  int region[kN];
};

__device__ void stage_common(Common& cm, const Geo& g, const bf16* table,
                             int b, int wy, int wx, int h) {
  for (int k = threadIdx.x; k < kBins; k += kThreads)
    cm.tab[k] = __bfloat162float(table[k * g.heads + h]);
  for (int i = threadIdx.x; i < kN; i += kThreads) {
    const Token tk = token(g, b, wy, wx, i);
    cm.src[i] = tk.src;
    cm.region[i] = tk.region;
  }
}

// q, k or v (seg 0, 1, 2) of head h at token i: 8 channels from `chunk` * 8,
// from the projection's output, or its bias where the token is padding.
__device__ __forceinline__ uint4 load_qkv(const bf16* qkv, const bf16* bias,
                                          const Geo& g, int src, int seg,
                                          int h, int chunk) {
  const int col = seg * g.C + h * kDh + chunk * 8;
  const bf16* p = src >= 0 ? qkv + (long long)src * 3 * g.C + col
                           : bias + col;
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void put_rows(bf16* tile, int token, int chunk,
                                         uint4 v) {
  *reinterpret_cast<uint4*>(tile + token * kRow + chunk * 8) = v;
}

__device__ __forceinline__ void put_cols(bf16* tile, int token, int chunk,
                                         uint4 v) {
  const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
  for (int k = 0; k < 8; ++k) tile[(chunk * 8 + k) * kCol + token] = e[k];
}

// The score of query i against key j in log2 units.
__device__ __forceinline__ float logit2(const Common& cm, float s, int i,
                                        int j, bool shifted, float scale) {
  float v = s * scale + cm.tab[bin_of(i, j)];
  if (shifted && cm.region[i] != cm.region[j]) v += kMaskFill;
  return v * kLog2e;
}

struct FwdSmem {
  bf16 q[kN * kRow];
  bf16 k[kN * kRow];
  bf16 vt[kDh * kCol];
  Common cm;
};

__global__ void __launch_bounds__(kThreads)
window_attn_fwd_kernel(const bf16* __restrict__ qkv,
                       const bf16* __restrict__ bias,
                       const bf16* __restrict__ table, bf16* __restrict__ out,
                       float* __restrict__ lse, const Geo g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(smem_raw);
  const int bw = blockIdx.x, h = blockIdx.y;
  const int b = bw / g.nW, w = bw - b * g.nW;
  const int wy = w / g.nWw, wx = w - wy * g.nWw;
  stage_common(sm.cm, g, table, b, wy, wx, h);
  __syncthreads();
  for (int idx = threadIdx.x; idx < kN * 12; idx += kThreads) {
    const int i = idx / 12, seg = idx % 12 / 4, chunk = idx % 4;
    const uint4 v = load_qkv(qkv, bias, g, sm.cm.src[i], seg, h, chunk);
    if (seg == 0) put_rows(sm.q, i, chunk, v);
    else if (seg == 1) put_rows(sm.k, i, chunk, v);
    else put_cols(sm.vt, i, chunk, v);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, t = lane % 4;
  const int r0 = warp * 16;
  const int i0 = r0 + gr, i1 = i0 + 8;          // the lane's two rows
  const bool shifted = g.shift > 0;
  const float scale = kScale;
  uint32_t qa[2][4];
  frag_a(qa[0], sm.q, kRow, r0, 0, gr, t);
  frag_a(qa[1], sm.q, kRow, r0, 16, gr, t);
  float o[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int c0 = 0; c0 < kN; c0 += kChunk) {
    float s[kChunk / 8][4];
#pragma unroll
    for (int n = 0; n < kChunk / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      const bf16* kp = sm.k + (c0 + n * 8 + gr) * kRow + 2 * t;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        mma(s[n], qa[kk], ld32(kp + kk * 16), ld32(kp + kk * 16 + 8));
    }
    float cm0 = -INFINITY, cm1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < kChunk / 8; ++n) {
      const int j = c0 + n * 8 + 2 * t;
      s[n][0] = logit2(sm.cm, s[n][0], i0, j, shifted, scale);
      s[n][1] = logit2(sm.cm, s[n][1], i0, j + 1, shifted, scale);
      s[n][2] = logit2(sm.cm, s[n][2], i1, j, shifted, scale);
      s[n][3] = logit2(sm.cm, s[n][3], i1, j + 1, shifted, scale);
      cm0 = fmaxf(cm0, fmaxf(s[n][0], s[n][1]));
      cm1 = fmaxf(cm1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int x = 1; x < 4; x *= 2) {
      cm0 = fmaxf(cm0, __shfl_xor_sync(0xffffffffu, cm0, x));
      cm1 = fmaxf(cm1, __shfl_xor_sync(0xffffffffu, cm1, x));
    }
    const float n0 = fmaxf(m0, cm0), n1 = fmaxf(m1, cm1);
    const float a0 = exp2f(m0 - n0), a1 = exp2f(m1 - n1);
    m0 = n0;
    m1 = n1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      o[n][0] *= a0;
      o[n][1] *= a0;
      o[n][2] *= a1;
      o[n][3] *= a1;
    }
#pragma unroll
    for (int n = 0; n < kChunk / 8; ++n) {
      s[n][0] = exp2f(s[n][0] - m0);
      s[n][1] = exp2f(s[n][1] - m0);
      s[n][2] = exp2f(s[n][2] - m1);
      s[n][3] = exp2f(s[n][3] - m1);
      l0 += s[n][0] + s[n][1];
      l1 += s[n][2] + s[n][3];
    }
#pragma unroll
    for (int kt = 0; kt < kChunk / 16; ++kt) {
      const uint32_t pa[4] = {pack(s[2 * kt][0], s[2 * kt][1]),
                              pack(s[2 * kt][2], s[2 * kt][3]),
                              pack(s[2 * kt + 1][0], s[2 * kt + 1][1]),
                              pack(s[2 * kt + 1][2], s[2 * kt + 1][3])};
      const int key = c0 + kt * 16 + 2 * t;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const bf16* vp = sm.vt + (n * 8 + gr) * kCol + key;
        mma(o[n], pa, ld32(vp), ld32(vp + 8));
      }
    }
  }
#pragma unroll
  for (int x = 1; x < 4; x *= 2) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const float r0l = 1.f / l0, r1l = 1.f / l1;
  if (t == 0) {
    float* lp = lse + ((long long)bw * g.heads + h) * kN;
    lp[i0] = m0 + log2f(l0);
    lp[i1] = m1 + log2f(l1);
  }
  // the warp's own q rows take its output, then 16-byte stores
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    *reinterpret_cast<uint32_t*>(sm.q + i0 * kRow + n * 8 + 2 * t) =
        pack(o[n][0] * r0l, o[n][1] * r0l);
    *reinterpret_cast<uint32_t*>(sm.q + i1 * kRow + n * 8 + 2 * t) =
        pack(o[n][2] * r1l, o[n][3] * r1l);
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int id = lane + 32 * k, i = r0 + id / 4, chunk = id % 4;
    const int src = sm.cm.src[i];
    if (src >= 0)
      *reinterpret_cast<uint4*>(out + (long long)src * g.C + h * kDh +
                                chunk * 8) =
          *reinterpret_cast<const uint4*>(sm.q + i * kRow + chunk * 8);
  }
}

struct BwdSmem {
  bf16 q[kN * kRow], k[kN * kRow], v[kN * kRow], dout[kN * kRow];
  bf16 qt[kDh * kCol], kt[kDh * kCol], doutt[kDh * kCol];
  bf16 ds[kN * kCol];             // dS, query-major
  float lse[kN], dsum[kN];
  float pad[kWarps][kPart];       // each warp's padded keys' dk, dv
  Common cm;
};

__global__ void __launch_bounds__(kThreads)
window_attn_bwd_kernel(const bf16* __restrict__ qkv,
                       const bf16* __restrict__ bias,
                       const bf16* __restrict__ table,
                       const bf16* __restrict__ out,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       bf16* __restrict__ dqkv,
                       float* __restrict__ part_table,
                       float* __restrict__ part_bias, const Geo g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem& sm = *reinterpret_cast<BwdSmem*>(smem_raw);
  const int bw = blockIdx.x, h = blockIdx.y;
  const int b = bw / g.nW, w = bw - b * g.nW;
  const int wy = w / g.nWw, wx = w - wy * g.nWw;
  const long long slot = (long long)bw * g.heads + h;
  stage_common(sm.cm, g, table, b, wy, wx, h);
  for (int i = threadIdx.x; i < kN; i += kThreads)
    sm.lse[i] = lse[slot * kN + i];
  __syncthreads();
  for (int idx = threadIdx.x; idx < kN * 12; idx += kThreads) {
    const int i = idx / 12, seg = idx % 12 / 4, chunk = idx % 4;
    const uint4 v = load_qkv(qkv, bias, g, sm.cm.src[i], seg, h, chunk);
    if (seg == 0) {
      put_rows(sm.q, i, chunk, v);
      put_cols(sm.qt, i, chunk, v);
    } else if (seg == 1) {
      put_rows(sm.k, i, chunk, v);
      put_cols(sm.kt, i, chunk, v);
    } else {
      put_rows(sm.v, i, chunk, v);
    }
  }
  // dO and D_i = dO_i . O_i; a padded token's dO is 0 (it is cropped)
  for (int idx = threadIdx.x; idx < kN * 4; idx += kThreads) {
    const int i = idx / 4, chunk = idx % 4;
    const int src = sm.cm.src[i];
    uint4 dv = make_uint4(0u, 0u, 0u, 0u), ov = dv;
    if (src >= 0) {
      const long long at = (long long)src * g.C + h * kDh + chunk * 8;
      dv = *reinterpret_cast<const uint4*>(dout + at);
      ov = *reinterpret_cast<const uint4*>(out + at);
    }
    put_rows(sm.dout, i, chunk, dv);
    put_cols(sm.doutt, i, chunk, dv);
    const bf16* de = reinterpret_cast<const bf16*>(&dv);
    const bf16* oe = reinterpret_cast<const bf16*>(&ov);
    float d = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      d += __bfloat162float(de[e]) * __bfloat162float(oe[e]);
    d += __shfl_xor_sync(0xffffffffu, d, 1);   // the token's 4 lanes
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    if (chunk == 0) sm.dsum[i] = d;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, t = lane % 4;
  const bool shifted = g.shift > 0;
  const float scale = kScale;
  {
    // a warp per 16 keys: dV, dK and its part of dS
    const int k0 = warp * 16;
    const int j0 = k0 + gr, j1 = j0 + 8;        // the lane's two keys
    uint32_t ka[2][4], va[2][4];
    frag_a(ka[0], sm.k, kRow, k0, 0, gr, t);
    frag_a(ka[1], sm.k, kRow, k0, 16, gr, t);
    frag_a(va[0], sm.v, kRow, k0, 0, gr, t);
    frag_a(va[1], sm.v, kRow, k0, 16, gr, t);
    float dv[4][4], dk[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dv[n][e] = dk[n][e] = 0.f;
    for (int q0 = 0; q0 < kN; q0 += 16) {
      float p[2][4], ds[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float st[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
        const int qn = q0 + n * 8 + gr;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const bf16* qp = sm.q + qn * kRow + kk * 16 + 2 * t;
          mma(st, ka[kk], ld32(qp), ld32(qp + 8));
          const bf16* dp_ = sm.dout + qn * kRow + kk * 16 + 2 * t;
          mma(dp, va[kk], ld32(dp_), ld32(dp_ + 8));
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = e < 2 ? j0 : j1;
          const int i = q0 + n * 8 + 2 * t + (e & 1);
          p[n][e] = exp2f(logit2(sm.cm, st[e], i, j, shifted, scale) -
                          sm.lse[i]);
          ds[n][e] = p[n][e] * (dp[e] - sm.dsum[i]);
          sm.ds[i * kCol + j] = __float2bfloat16_rn(ds[n][e]);
        }
      }
      const uint32_t pa[4] = {pack(p[0][0], p[0][1]), pack(p[0][2], p[0][3]),
                              pack(p[1][0], p[1][1]), pack(p[1][2], p[1][3])};
      const uint32_t sa[4] = {pack(ds[0][0], ds[0][1]),
                              pack(ds[0][2], ds[0][3]),
                              pack(ds[1][0], ds[1][1]),
                              pack(ds[1][2], ds[1][3])};
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const bf16* op = sm.doutt + (n * 8 + gr) * kCol + q0 + 2 * t;
        mma(dv[n], pa, ld32(op), ld32(op + 8));
        const bf16* qp = sm.qt + (n * 8 + gr) * kCol + q0 + 2 * t;
        mma(dk[n], sa, ld32(qp), ld32(qp + 8));
      }
    }
    // the padded keys' dk and dv, summed over the warp's rows in a fixed
    // order (lanes of one column: xor over the row groups)
    const bool pad0 = sm.cm.src[j0] < 0, pad1 = sm.cm.src[j1] < 0;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
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
          sm.pad[warp][n * 8 + 2 * t + e] = sk * scale;
          sm.pad[warp][kDh + n * 8 + 2 * t + e] = sv;
        }
      }
    }
    // the warp's own k and v rows take dK and dV, then 16-byte stores
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int c = n * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(sm.k + j0 * kRow + c) =
          pack(dk[n][0] * scale, dk[n][1] * scale);
      *reinterpret_cast<uint32_t*>(sm.k + j1 * kRow + c) =
          pack(dk[n][2] * scale, dk[n][3] * scale);
      *reinterpret_cast<uint32_t*>(sm.v + j0 * kRow + c) =
          pack(dv[n][0], dv[n][1]);
      *reinterpret_cast<uint32_t*>(sm.v + j1 * kRow + c) =
          pack(dv[n][2], dv[n][3]);
    }
    __syncwarp();
    for (int id = lane; id < 16 * 8; id += 32) {
      const int j = k0 + id / 8, part = id % 8 / 4, chunk = id % 4;
      const int src = sm.cm.src[j];
      if (src >= 0)
        *reinterpret_cast<uint4*>(dqkv + (long long)src * 3 * g.C +
                                  (1 + part) * g.C + h * kDh + chunk * 8) =
            *reinterpret_cast<const uint4*>((part ? sm.v : sm.k) + j * kRow +
                                            chunk * 8);
    }
  }
  __syncthreads();
  {
    // a warp per 16 queries: dQ = dS k
    const int r0 = warp * 16;
    const int i0 = r0 + gr, i1 = i0 + 8;
    float dq[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
#pragma unroll 3
    for (int k0 = 0; k0 < kN; k0 += 16) {
      uint32_t a[4];
      frag_a(a, sm.ds, kCol, r0, k0, gr, t);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const bf16* kp = sm.kt + (n * 8 + gr) * kCol + k0 + 2 * t;
        mma(dq[n], a, ld32(kp), ld32(kp + 8));
      }
    }
    // the warp's own q rows take dQ (no warp reads q any more)
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int c = n * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(sm.q + i0 * kRow + c) =
          pack(dq[n][0] * scale, dq[n][1] * scale);
      *reinterpret_cast<uint32_t*>(sm.q + i1 * kRow + c) =
          pack(dq[n][2] * scale, dq[n][3] * scale);
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int id = lane + 32 * k, i = r0 + id / 4, chunk = id % 4;
      const int src = sm.cm.src[i];
      if (src >= 0)
        *reinterpret_cast<uint4*>(dqkv + (long long)src * 3 * g.C +
                                  h * kDh + chunk * 8) =
            *reinterpret_cast<const uint4*>(sm.q + i * kRow + chunk * 8);
    }
  }
  // the block's dS by bin, each bin's pairs in a fixed order
  for (int k = threadIdx.x; k < kBins; k += kThreads) {
    const int dy = k / kSide - (kWin - 1), dx = k % kSide - (kWin - 1);
    float acc = 0.f;
    for (int ri = max(0, dy); ri < min(kWin, kWin + dy); ++ri)
      for (int ci = max(0, dx); ci < min(kWin, kWin + dx); ++ci) {
        const int i = ri * kWin + ci, j = (ri - dy) * kWin + ci - dx;
        acc += __bfloat162float(sm.ds[i * kCol + j]);
      }
    part_table[slot * kBins + k] = acc;
  }
  for (int c = threadIdx.x; c < kPart; c += kThreads) {
    float acc = 0.f;
#pragma unroll
    for (int w_ = 0; w_ < kWarps; ++w_) acc += sm.pad[w_][c];
    part_bias[slot * kPart + c] = acc;
  }
}

// The table's and the bias's gradients: each a thread, the blocks'
// partial sums over the windows in order. The q part of the bias gets 0
// (a padded query's dq is 0: its output is cropped).
__global__ void __launch_bounds__(kReduceThreads)
window_attn_bias_grad_kernel(const float* __restrict__ part_table,
                             const float* __restrict__ part_bias,
                             float* __restrict__ dtable,
                             float* __restrict__ dbias, int windows,
                             int heads, int C) {
  const int per = kBins + 3 * kDh;
  const int id = blockIdx.x * blockDim.x + threadIdx.x;
  if (id >= heads * per) return;
  const int h = id / per, j = id - h * per;
  if (j < kBins) {
    float acc = 0.f;
    for (int w = 0; w < windows; ++w)
      acc += part_table[((long long)w * heads + h) * kBins + j];
    dtable[j * heads + h] = acc;
    return;
  }
  const int c = j - kBins;            // 0..95: q, k, v channels of head h
  const int seg = c / kDh, ch = c % kDh;
  float acc = 0.f;
  if (seg > 0)
    for (int w = 0; w < windows; ++w)
      acc += part_bias[((long long)w * heads + h) * kPart + c - kDh];
  dbias[seg * C + h * kDh + ch] = acc;
}

bool geometry(Geo& g, int B, int H, int W, int C, int heads, int shift) {
  if (B < 1 || H < 1 || W < 1 || heads < 1 || C != heads * kDh ||
      shift < 0 || shift >= kWin ||
      (long long)B * H * W * 3 * C >= 0x7fffffffLL)
    return false;
  g.B = B;
  g.H = H;
  g.W = W;
  g.C = C;
  g.heads = heads;
  g.shift = shift;
  g.Hp = (H + kWin - 1) / kWin * kWin;
  g.Wp = (W + kWin - 1) / kWin * kWin;
  g.nWw = g.Wp / kWin;
  g.nW = g.Hp / kWin * g.nWw;
  return (long long)B * g.nW < 0x7fffffffLL && heads <= 65535;
}

template <typename T>
cudaError_t allow_smem(T* kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace

// qkv (B, H, W, 3C), bias (3C), table (23 * 23, heads), out (B, H, W, C):
// bf16, contiguous, 16-byte aligned; lse (B, nW, heads, 144) fp32. C =
// heads * 32. Returns cudaGetLastError(), or cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int window_attn_forward_launch(const void* qkv, const void* bias,
                                          const void* table, void* out,
                                          void* lse, int B, int H, int W,
                                          int C, int heads, int shift,
                                          void* stream) {
  Geo g;
  if (!geometry(g, B, H, W, C, heads, shift))
    return (int)cudaErrorInvalidValue;
  static const cudaError_t ready =
      allow_smem(window_attn_fwd_kernel, (int)sizeof(FwdSmem));
  if (ready != cudaSuccess) return (int)ready;
  dim3 grid(B * g.nW, heads);
  window_attn_fwd_kernel<<<grid, kThreads, sizeof(FwdSmem),
                           (cudaStream_t)stream>>>(
      (const bf16*)qkv, (const bf16*)bias, (const bf16*)table, (bf16*)out,
      (float*)lse, g);
  return (int)cudaGetLastError();
}

// The forward's operands, its output and lse, and the output's gradient
// dout (B, H, W, C) bf16; writes dqkv (B, H, W, 3C) bf16 at every real
// token, through the partial sums part_table (B * nW, heads, 529) and
// part_bias (B * nW, heads, 64) fp32 the table's gradient dtable
// (529, heads) and the padded tokens' gradient dbias (3C) fp32.
extern "C" int window_attn_backward_launch(
    const void* qkv, const void* bias, const void* table, const void* out,
    const void* dout, const void* lse, void* dqkv, void* part_table,
    void* part_bias, void* dtable, void* dbias, int B, int H, int W, int C,
    int heads, int shift, void* stream) {
  Geo g;
  if (!geometry(g, B, H, W, C, heads, shift))
    return (int)cudaErrorInvalidValue;
  static const cudaError_t ready =
      allow_smem(window_attn_bwd_kernel, (int)sizeof(BwdSmem));
  if (ready != cudaSuccess) return (int)ready;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid(B * g.nW, heads);
  window_attn_bwd_kernel<<<grid, kThreads, sizeof(BwdSmem), s>>>(
      (const bf16*)qkv, (const bf16*)bias, (const bf16*)table,
      (const bf16*)out, (const bf16*)dout, (const float*)lse, (bf16*)dqkv,
      (float*)part_table, (float*)part_bias, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = heads * (kBins + 3 * kDh);
  window_attn_bias_grad_kernel<<<(n + kReduceThreads - 1) / kReduceThreads,
                                 kReduceThreads, 0, s>>>(
      (const float*)part_table, (const float*)part_bias, (float*)dtable,
      (float*)dbias, B * g.nW, heads, C);
  return (int)cudaGetLastError();
}
