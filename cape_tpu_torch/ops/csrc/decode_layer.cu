// One v1 decoder layer's KV-cached decode step, for all B episodes of a
// token, in one launch (the function of `ops/decode_step.py`'s
// `layer_step_plain`, itself `Decoder._query_pos`, `DecoderLayer.
// forward_step` and `Decoder._refine`):
//   qp  = LN(pos_trans(sine(ref)))                 (0 without a query pos)
//   q   = q_proj(attn_q(x) + qp) / sqrt(32); k, v = k_proj(attn_k(x)),
//         v_proj(attn_v(x)), written into the layer's cache at `pos`
//   t   = norm2(x + out_proj(softmax(q k^T over slots <= pos) v))
//   t   = norm_support(t + out_proj(softmax(q' k_s^T, mask) v_s)),
//         q' = q_proj(t) / sqrt(32) against the precomputed support K/V
//   t   = norm1(t + output_proj(MSDA(t + qp, ref, quad slab)))
//   x'  = norm3(t + linear2(relu(linear1(t))))
//   ref' = sigmoid(head(x') + inverse_sigmoid(ref)) where the layer refines
// with the attention softmaxes over all keys, masked ones at the finite
// -1e9 (so a support set with every key masked attends uniformly), and the
// deformable attention's sampling as `ms_deform_attn_core_prequad`: per
// (head, level, point) one quad row of the packed slab and four bilinear
// corner weights, zero out of bounds.
//
// Replaces no Pallas kernel: the JAX package's decode step is plain JAX
// inside a `jit`, where XLA fuses this glue. On the card the same step ran
// as ~420 ATen kernels a layer, each a few microseconds of launch and
// latency for a handful of bytes. The decode sites' quad gather
// (`csrc/gather.cu`) is folded in: `gather.cu` serves forced selections,
// refused or tiny sites and the decode chain; under `auto` the encoder
// runs `msda_forward_kernel`.
//
// Bound: bytes. At batch 8 a launch reads the layer's ~1.48 M parameters
// (2.96 MB in bf16; the sampling offsets' projection is fp32), 1,024 quad
// rows of 256 bytes, the cached keys and values up to `pos` and the
// support's; its FLOPs (~24 M) are nothing against them. So the design
// reads each weight once a launch for every 8 episodes. At that size the
// time goes to latency, not bytes (~1 us of device memory traffic against
// ~35 us), and the design's other answers are to that:
//
// Design. A cluster of 8 blocks (one a head) takes up to 8 episodes; the
// grid is one cluster a tile of 8. Every projection is split by output
// columns over the cluster's blocks (block r owns head r's 32 columns of a
// d-wide output, 128 of the FFN's hidden), and a block computes its
// columns for all the tile's episodes on the tensor cores: one
// `mma.sync.m16n8k16` (bf16 in, fp32 sums) takes 8 weight rows against the
// 8 episodes (rows 8-15 of its A operand are zero), the products' inputs
// in bf16 as the chain's `Dense` layers cast theirs; the sampling offsets'
// fp32 projection runs on fp32 FMAs. A block's weight rows are contiguous,
// so they stream into shared memory as 16 KB bulk copies (the Tensor
// Memory Accelerator, one mbarrier a stage, 7 stages) issued ahead of
// their use. Between dependent phases the blocks exchange their columns
// through distributed shared memory: 16-byte `st.async` stores into every
// block, counted on the receiver's mbarrier of that exchange, so no
// cluster-wide barrier (and its memory fence, ~900 cycles) stands between
// phases; LayerNorms and residuals then run in every block on the full
// rows, in fp32. Attention phases need no exchange: block r holds head
// r's q, k and v, so it writes the new cache row, attends over the cache
// and over the support's unmasked keys (a warp an episode, a lane a key,
// online softmax in fp32, the next key's rows in flight; a masked key's
// weight is exactly 0 beside an unmasked one) and samples the slab (a
// half-warp a sample: 16 lanes x 16 bytes is one quad row) for its head.
// The launch is a programmatic dependent launch: the next layer's blocks
// start while this one runs and stream their weights in before they wait
// for its output. Weights, cache, support and slab are read in bf16; the
// cache row and the output are written in bf16. Every sum has a fixed
// order and no atomics: reruns give the same bits.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 256;          // model width
constexpr int H = 8;            // heads
constexpr int DH = D / H;       // a head's width
constexpr int LV = 4;           // feature levels
constexpr int PT = 4;           // points a level
constexpr int LP = LV * PT;     // samples a head
constexpr int FF = 1024;        // FFN hidden
constexpr int BT = 8;           // episodes a cluster
constexpr int CL = H;           // blocks a cluster: one a head
constexpr int NT = 256;         // threads a block
constexpr int NW = NT / 32;     // warps a block: one an episode
constexpr int QROW = 4 * DH;    // a quad row's elements
constexpr float NEG_INF = -1e9f;
constexpr float LN_EPS = 1e-5f;
static_assert(NW == BT, "a warp an episode");
static_assert(BT * DH == NT, "a thread a (episode, column) of a head");

}  // namespace

// The layer's parameters where they lie (nn.Linear weights (out, in),
// row-major), a null pointer where the layer has none, and the step's
// inputs and outputs. `ops/decode_step.py` mirrors this layout in ctypes.
struct DecodeLayerArgs {
  const bf16 *pos_w, *pos_b, *pos_nw, *pos_nb;     // query position
  const bf16 *aq_w, *ak_w, *av_w;                  // pre-projections
  const bf16 *sa_qw, *sa_qb, *sa_kw, *sa_kb, *sa_vw, *sa_vb, *sa_ow, *sa_ob;
  const bf16 *n2_w, *n2_b;
  const bf16 *su_qw, *su_qb, *su_ow, *su_ob;       // support attention
  const bf16 *ns_w, *ns_b;
  const float *off_w, *off_b;                      // sampling offsets, fp32
  const bf16 *aw_w, *aw_b, *op_w, *op_b;
  const bf16 *n1_w, *n1_b;
  const bf16 *f1_w, *f1_b, *f2_w, *f2_b;
  const bf16 *n3_w, *n3_b;
  const bf16 *h0_w, *h0_b, *h1_w, *h1_b, *h2_w, *h2_b;   // coords head
  const void* x;                 // (B, D), fp32 or bf16
  const float* ref;              // (B, 2) at batch stride ref_sb
  const long long* pos;          // 0-d, the cache slot
  bf16 *cache_k, *cache_v;       // (B, H, cache_len, DH)
  const bf16 *sup_k, *sup_v;     // (B, H, n_sup, DH) at the strides below
  const unsigned char* sup_mask; // (B, n_sup), 1 = ignore
  const bf16* slab;              // (B * H, slab_rows, 4 * DH)
  bf16* x_out;                   // (B, D)
  float* ref_out;                // (B, 2)
  long long sup_sb, sup_sh, sup_sn;
  int x_fp32, ref_sb, batch, cache_len, n_sup, slab_rows;
  int lvl_h[LV], lvl_w[LV], lvl_off[LV];
};

namespace {

constexpr int SLOT = 16384;     // bytes a weight stage
constexpr int NSLOT = 7;        // weight stages in flight
constexpr int MAXCH = 32;       // weight chunks a launch, at most
constexpr int NLN = 5;          // LayerNorms: pos, norm2, support, 1, 3
constexpr int MAXSUP = 128;     // support keys the kernel takes
constexpr int NX = 11;          // exchanges between the cluster's blocks
constexpr int XS = D + 32;      // bf16 row stride of a d-wide activation
constexpr int HS = FF + 32;     // of the FFN's hidden (the pad spreads the
                                // 8 rows of a fragment load over the banks)

// a block's weight slice: `rows` rows of `row_bytes`, in chunks of whole
// rows of at most SLOT bytes, the first at sequence number `first`
struct Slice {
  int first, rows, row_bytes;
};

// shared memory of a block: the tile's activations, fp32 where they feed a
// residual or a LayerNorm, bf16 where they feed a product (the chain's
// `Dense` casts its input to bf16 the same way)
struct Smem {
  float xin[BT][D];                 // the layer's input
  float t[BT][D];                   // the running target
  float qp[BT][D];                  // query position
  float tmp[BT][D];                 // MSDA's query t + qp
  alignas(16) bf16 xb[BT][XS];      // the input
  alignas(16) bf16 ab[BT][XS];      // the reference point's sine embedding,
                                    // then self-attention's query input,
                                    // then MSDA's query
  alignas(16) bf16 tb[BT][XS];      // t
  // the exchanges, every block's columns of an output (`send`): exchange n
  // in ex[n % 2]; exchange 1 holds four d-wide outputs
  alignas(16) bf16 ex[2][4 * BT * XS];
  alignas(128) unsigned char ring[NSLOT][SLOT];   // weight stages
  alignas(16) bf16 ln[NLN][2][D];                  // LayerNorm scale, offset
  // this block's bias slices (16-byte aligned: asynchronous copies)
  alignas(16) bf16 b_pos[DH];
  alignas(16) bf16 b_sq[DH];
  alignas(16) bf16 b_sk[DH];
  alignas(16) bf16 b_sv[DH];
  alignas(16) bf16 b_so[DH];
  alignas(16) bf16 b_uq[DH];
  alignas(16) bf16 b_uo[DH];
  alignas(16) bf16 b_aw[LP];
  alignas(16) bf16 b_op[DH];
  alignas(16) bf16 b_f1[FF / CL];
  alignas(16) bf16 b_f2[DH];
  alignas(16) bf16 b_h0[DH];
  alignas(16) bf16 b_h1[DH];
  alignas(16) bf16 b_h2[8];
  alignas(16) float b_off[2 * LP];
  float part[NW][32][2];            // split products' partial sums
  // this block's head
  float qh[BT][DH];
  float off[BT][2 * LP];
  float aw[BT][LP];
  float sw[BT][LP][4];
  int sbase[BT][LP];
  short kidx[BT][MAXSUP];           // the support keys attended, in order
  int kcnt[BT];
  int kall[BT];                     // every key masked: all attended
  float ref[BT][2];
  float hoff[BT][2];
  // the weight stream: chunk sources and sizes, stage barriers
  const unsigned char* ch_src[MAXCH];
  int ch_bytes[MAXCH];
  unsigned long long bar[NSLOT];
  unsigned long long xbar[NX];      // exchange n's arrivals: xbar[n - 1]
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ unsigned pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ void cvt8(const uint4& u, float (&w)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    w[2 * i] = f.x;
    w[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void lds8(const bf16* p, float (&w)[8]) {
  cvt8(*reinterpret_cast<const uint4*>(p), w);
}

__device__ __forceinline__ void lds8(const float* p, float (&w)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

// `bytes` (a multiple of 16, or 4) from global to shared memory, 16 bytes
// a thread, asynchronously (completed by `cp.async.wait_all`)
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           int bytes) {
  if (bytes < 16) {
    if (threadIdx.x == 0)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                       smem_u32(dst)), "l"(src) : "memory");
    return;
  }
  for (int i = threadIdx.x; i < bytes / 16; i += NT)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     smem_u32(static_cast<unsigned char*>(dst) + 16 * i)),
                 "l"(static_cast<const unsigned char*>(src) + 16 * i)
                 : "memory");
}

// this block's shared address `addr` in cluster block `rank`
__device__ __forceinline__ unsigned mapa(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// 16 bytes into another block's shared memory, counted on its mbarrier
__device__ __forceinline__ void st_async(unsigned addr, const uint4& v,
                                         unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];" ::"r"(addr), "r"(v.x), "r"(v.y), "r"(v.z),
      "r"(v.w), "r"(bar) : "memory");
}

// wait for an exchange's bytes from every block of the cluster (a stall
// past any step's time traps instead of hanging the card)
__device__ __forceinline__ void xwait(unsigned long long* b) {
  unsigned done = 0, spins = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cluster."
        "shared::cta.b64 p, [%1], 0;\n selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_u32(b)) : "memory");
    if (++spins == (1u << 26)) __trap();
  } while (!done);
}

__device__ __forceinline__ void mbar_wait(unsigned long long* b,
                                          unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, "
        "[%1], %2;\n selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_u32(b)), "r"(parity) : "memory");
  } while (!done);
}

// The block's weight slices, streamed through NSLOT stages by bulk copies
// (the Tensor Memory Accelerator) ahead of their use: chunk q goes to stage
// q % NSLOT once chunk q - NSLOT is released. Every thread keeps the same
// counts; thread 0 issues.
struct Stream {
  Smem* sm;
  int n, issued, released;

  __device__ Slice add(const void* src, int rows, int row_bytes) {
    const int per = SLOT / row_bytes;
    Slice s{n, rows, row_bytes};
    for (int r = 0; r < rows; r += per) {
      if (threadIdx.x == 0) {
        sm->ch_src[n] = static_cast<const unsigned char*>(src) +
                        (size_t)r * row_bytes;
        sm->ch_bytes[n] = min(per, rows - r) * row_bytes;
      }
      ++n;
    }
    return s;
  }

  __device__ void issue() {
    bool fenced = false;
    while (issued < n && issued < released + NSLOT) {
      if (threadIdx.x == 0) {
        if (!fenced)
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        const int q = issued % NSLOT;
        const unsigned bytes = (unsigned)sm->ch_bytes[issued];
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                smem_u32(&sm->bar[q])), "r"(bytes) : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
            "bytes [%0], [%1], %2, [%3];" ::"r"(smem_u32(sm->ring[q])),
            "l"(sm->ch_src[issued]), "r"(bytes), "r"(smem_u32(&sm->bar[q]))
            : "memory");
      }
      fenced = true;
      ++issued;
    }
  }

  __device__ int chunks(const Slice& s) const {
    const int per = SLOT / s.row_bytes;
    return (s.rows + per - 1) / per;
  }

  // wait for a slice's chunks
  __device__ void wait(const Slice& s) {
    for (int q = s.first; q < s.first + chunks(s); ++q)
      mbar_wait(&sm->bar[q % NSLOT], (unsigned)(q / NSLOT) & 1u);
  }

  // row `j` of a slice that has arrived
  template <typename WT>
  __device__ const WT* row(const Slice& s, int j) const {
    const int per = SLOT / s.row_bytes;
    return reinterpret_cast<const WT*>(
        sm->ring[(s.first + j / per) % NSLOT] + (j % per) * s.row_bytes);
  }

  // after a barrier that ends the reads of every slice up to `s`
  __device__ void release(const Slice& s) {
    released = s.first + chunks(s);
    issue();
  }
};

// one step of the transposing butterfly: lanes with bit OFF set keep the
// upper half of their values, the others the lower, each adding its
// partner's copy of the half it keeps
template <int OFF>
__device__ __forceinline__ void bfly(float (&v)[32], bool up) {
#pragma unroll
  for (int i = 0; i < OFF; ++i) {
    const float send = up ? v[i] : v[i + OFF];
    const float keep = up ? v[i + OFF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
}

// v[i] on every lane -> lane l holds, in v[0], the sum over lanes of v[l]
__device__ __forceinline__ void reduce32(float (&v)[32], int lane) {
  bfly<16>(v, lane & 16);
  bfly<8>(v, lane & 8);
  bfly<4>(v, lane & 4);
  bfly<2>(v, lane & 2);
  bfly<1>(v, lane & 1);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// d += a b on the tensor cores: a (16 x 16) of which rows 8-15 are zero,
// b (16 x 8), bf16 in, fp32 sums
__device__ __forceinline__ void mma16816(float (&d)[4], unsigned a0,
                                         unsigned a2, unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// One 8-row tile of a slice against the tile's episodes over k in
// [k0, k0 + klen): lane (g, q) returns episode g's sums of the tile's rows
// 2q and 2q + 1. A sum's k order is a fixed relabelling: each lane takes 8
// consecutive k of every 32 (one 16-byte load of x and one of w) as the
// fragment positions 2q, 2q + 1, 2q + 8, 2q + 9 of two mma steps, for the
// episode and the weight row alike.
template <int KS>
__device__ __forceinline__ float2 tile_sum(const Stream& st, const Slice& s,
                                           int tile, const bf16* X, int k0,
                                           int klen, int lane) {
  const int g = lane >> 2, q = lane & 3;
  const bool live = tile * 8 + g < s.rows;
  const bf16* w = live ? st.row<bf16>(s, tile * 8 + g) : nullptr;
  const bf16* x = X + g * KS;
  float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int kb = k0; kb < k0 + klen; kb += 32) {
    const uint4 xa = *reinterpret_cast<const uint4*>(x + kb + q * 8);
    uint4 wa = make_uint4(0u, 0u, 0u, 0u);
    if (live) wa = *reinterpret_cast<const uint4*>(w + kb + q * 8);
    mma16816(d0, xa.x, xa.y, wa.x, wa.y);
    mma16816(d1, xa.z, xa.w, wa.z, wa.w);
  }
  return make_float2(d0[0] + d1[0], d0[1] + d1[1]);
}

// The slice's rows as output columns of x W^T + b for the tile's
// episodes, x the bf16 rows X[BT][KS] (k < K) in shared memory, on the
// tensor cores. Tiles of 8 rows go to the warps, and where there are fewer
// tiles than warps each tile's k range is split over NW / tiles warps,
// whose partial sums the first adds in order. out(e, c, v_c, v_c+1) for
// every even column c, by every lane of the warps that emit. Waits for the
// slice's weights first.
template <int K, int KS, typename Out>
__device__ __forceinline__ void gemv(Smem& sm, Stream& st, const Slice& s,
                                     const bf16* bias, const bf16* X,
                                     Out out) {
  st.wait(s);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = 2 * (lane & 3);
  const int tiles = (s.rows + 7) / 8;
  auto emit = [&](int tile, float2 v) {
    const int n = tile * 8 + c;
    const float b0 = bias && n < s.rows ? to_f(bias[n]) : 0.f;
    const float b1 = bias && n + 1 < s.rows ? to_f(bias[n + 1]) : 0.f;
    out(g, n, v.x + b0, v.y + b1);
  };
  if (tiles >= NW) {
    for (int tile = warp; tile < tiles; tile += NW)
      emit(tile, tile_sum<KS>(st, s, tile, X, 0, K, lane));
    return;
  }
  const int splits = NW / tiles, tile = warp % tiles, part = warp / tiles;
  const float2 v = tile_sum<KS>(st, s, tile, X, part * (K / splits),
                                K / splits, lane);
  sm.part[warp][lane][0] = v.x;
  sm.part[warp][lane][1] = v.y;
  __syncthreads();
  if (part == 0) {
    float2 sum = make_float2(0.f, 0.f);
    for (int p = 0; p < splits; ++p) {
      sum.x += sm.part[tile + p * tiles][lane][0];
      sum.y += sm.part[tile + p * tiles][lane][1];
    }
    emit(tile, sum);
  }
  __syncthreads();
}

// fp32 columns of x W^T + b, fp32 weights and inputs (the sampling
// offsets' projection, kept in fp32): warp w takes the column groups
// w, w + NW, ... of 4 columns, a lane 8 k of each 256, one transposing
// butterfly reduces the warp's 32 sums; out(e, column, value).
template <typename Out>
__device__ __forceinline__ void gemv_fp32(Stream& st, const Slice& s,
                                          const float* bias, const float* xs,
                                          Out out) {
  st.wait(s);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ncols = s.rows;
  for (int g = warp * 4; g < ncols; g += NW * 4) {
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    const int k0 = lane * 8;
    float w[4][8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (g + j < ncols) {
        lds8(st.row<float>(s, g + j) + k0, w[j]);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) w[j][i] = 0.f;
      }
    }
#pragma unroll
    for (int e = 0; e < BT; ++e) {
      float x[8];
      lds8(xs + e * D + k0, x);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float a = acc[j * 8 + e];
#pragma unroll
        for (int i = 0; i < 8; ++i) a = fmaf(w[j][i], x[i], a);
        acc[j * 8 + e] = a;
      }
    }
    reduce32(acc, lane);
    const int j = lane >> 3, e = lane & 7;
    if (g + j < ncols) out(e, g + j, acc[0] + bias[g + j]);
  }
}

// dst[e] = LN(a[e] + b[e]) * w + bias over D, warp e, in fp32 and (dstb)
// bf16; `a` an fp32 row, `b` a bf16 exchange row (either may be null),
// `p` the scale and offset
__device__ __forceinline__ void layer_norm(float* dst, bf16* dstb,
                                           const float* a, const bf16* b,
                                           const bf16 (&p)[2][D], int e,
                                           int lane) {
  const int k0 = lane * 8;
  float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (a) lds8(a + e * D + k0, v);
  if (b) {
    float u[8];
    lds8(b + e * XS + k0, u);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] += u[i];
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) s += v[i];
  const float mean = warp_sum(s) * (1.f / D);
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) q += (v[i] - mean) * (v[i] - mean);
  const float r = rsqrtf(warp_sum(q) * (1.f / D) + LN_EPS);
  float wv[8], bv[8], y[8];
  lds8(&p[0][k0], wv);
  lds8(&p[1][k0], bv);
#pragma unroll
  for (int i = 0; i < 8; ++i) y[i] = (v[i] - mean) * r * wv[i] + bv[i];
  float4* d4 = reinterpret_cast<float4*>(dst + e * D + k0);
  d4[0] = make_float4(y[0], y[1], y[2], y[3]);
  d4[1] = make_float4(y[4], y[5], y[6], y[7]);
  if (dstb)
    *reinterpret_cast<uint4*>(dstb + e * XS + k0) = make_uint4(
        pack2(y[0], y[1]), pack2(y[2], y[3]), pack2(y[4], y[5]),
        pack2(y[6], y[7]));
}

// Attention of one episode's head query (fp32, pre-scaled) over the keys
// key(0), ..., key(n - 1), each DH bf16 at kb + key * stride (vb for the
// values): lane j takes keys j, j + 32, ... with an online softmax, the
// next key's rows in flight while one is summed; returns lane l's output
// channel l. `masked` puts every logit at NEG_INF (a support set with
// every key masked). Plain loads: the cache's new row was written in this
// launch.
template <typename Key>
__device__ __forceinline__ float attend(const float* q_s, int n,
                                        const bf16* kb, const bf16* vb,
                                        long long stride, Key key,
                                        bool masked, int lane) {
  float q[DH];
#pragma unroll
  for (int i = 0; i < DH; ++i) q[i] = q_s[i];
  float m = -INFINITY, s = 0.f, acc[32];
#pragma unroll
  for (int i = 0; i < DH; ++i) acc[i] = 0.f;
  uint4 kr[DH / 8], vr[DH / 8];
  int k = lane;
  if (k < n) {
    const long long at = key(k) * stride;
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) {
      kr[c] = reinterpret_cast<const uint4*>(kb + at)[c];
      vr[c] = reinterpret_cast<const uint4*>(vb + at)[c];
    }
  }
  while (k < n) {
    const int kn = k + 32;
    uint4 kq[DH / 8], vq[DH / 8];
    if (kn < n) {
      const long long at = key(kn) * stride;
#pragma unroll
      for (int c = 0; c < DH / 8; ++c) {
        kq[c] = reinterpret_cast<const uint4*>(kb + at)[c];
        vq[c] = reinterpret_cast<const uint4*>(vb + at)[c];
      }
    }
    float logit = 0.f;
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) {
      float w[8];
      cvt8(kr[c], w);
#pragma unroll
      for (int i = 0; i < 8; ++i) logit = fmaf(q[c * 8 + i], w[i], logit);
    }
    if (masked) logit = NEG_INF;
    if (logit > m) {
      const float sc = expf(m - logit);
      s *= sc;
#pragma unroll
      for (int i = 0; i < DH; ++i) acc[i] *= sc;
      m = logit;
    }
    const float p = expf(logit - m);
    s += p;
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) {
      float w[8];
      cvt8(vr[c], w);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[c * 8 + i] = fmaf(p, w[i], acc[c * 8 + i]);
    }
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) {
      kr[c] = kq[c];
      vr[c] = vq[c];
    }
    k = kn;
  }
  const float M = warp_max(m);
  const float f = s > 0.f ? expf(m - M) : 0.f;
  const float S = warp_sum(s * f);
#pragma unroll
  for (int i = 0; i < DH; ++i) acc[i] *= f;
  reduce32(acc, lane);
  return acc[0] / S;
}

__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(NT, 1)
decode_layer_kernel(const DecodeLayerArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();             // this block's head
  const int e0 = (blockIdx.x / CL) * BT;               // the tile's first
  const int nb = min(BT, a.batch - e0);                // episodes in it
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float scale = rsqrtf((float)DH);
  const int RB = D * 2;                                // bf16 row bytes

  // the weight stream, in the order of use: this block's rows of each
  // projection (head r's 32 columns, 128 of the FFN's hidden)
  Stream st{&sm, 0, 0, 0};
  Slice w_pos{}, w_aq{}, w_ak{}, w_av{}, w_h0{}, w_h1{}, w_h2{};
  if (a.pos_w) w_pos = st.add(a.pos_w + r * DH * D, DH, RB);
  if (a.aq_w) {
    w_aq = st.add(a.aq_w + r * DH * D, DH, RB);
    w_ak = st.add(a.ak_w + r * DH * D, DH, RB);
    w_av = st.add(a.av_w + r * DH * D, DH, RB);
  }
  const Slice w_sq = st.add(a.sa_qw + r * DH * D, DH, RB);
  const Slice w_sk = st.add(a.sa_kw + r * DH * D, DH, RB);
  const Slice w_sv = st.add(a.sa_vw + r * DH * D, DH, RB);
  const Slice w_so = st.add(a.sa_ow + r * DH * D, DH, RB);
  const Slice w_uq = st.add(a.su_qw + r * DH * D, DH, RB);
  const Slice w_uo = st.add(a.su_ow + r * DH * D, DH, RB);
  const Slice w_off = st.add(a.off_w + r * 2 * LP * D, 2 * LP, D * 4);
  const Slice w_aw = st.add(a.aw_w + r * LP * D, LP, RB);
  const Slice w_op = st.add(a.op_w + r * DH * D, DH, RB);
  constexpr int FS = FF / CL;
  const Slice w_f1 = st.add(a.f1_w + r * FS * D, FS, RB);
  const Slice w_f2 = st.add(a.f2_w + r * DH * FF, DH, FF * 2);
  if (a.h0_w) {
    w_h0 = st.add(a.h0_w + r * DH * D, DH, RB);
    w_h1 = st.add(a.h1_w + r * DH * D, DH, RB);
    if (r == 0) w_h2 = st.add(a.h2_w, 2, RB);
  }
  if (tid == 0) {
    for (int q = 0; q < NSLOT; ++q)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       smem_u32(&sm.bar[q])) : "memory");
    // each exchange: 8 blocks' 512-byte slices (16 KB for the FFN's
    // hidden; 512 bytes an output for the first), 0 where it is skipped
    const unsigned slice = BT * DH * 2;
    const unsigned bytes[NX] = {
        CL * slice * ((a.pos_w ? 1u : 0u) + (a.aq_w ? 3u : 0u)),
        CL * slice, CL * slice, CL * slice, CL * slice, CL * slice,
        CL * slice, CL * BT * (FF / CL) * 2, CL * slice,
        a.h0_w ? CL * slice : 0u, a.h0_w ? CL * slice : 0u};
    for (int x = 0; x < NX; ++x) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       smem_u32(&sm.xbar[x])) : "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(smem_u32(&sm.xbar[x])), "r"(bytes[x]) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the next layer's launch may start now: until its `griddepcontrol.wait`
  // it reads parameters only, which no decode writes
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  __syncthreads();
  st.issue();

  // the LayerNorms' parameters and this block's biases, asynchronously
  const bf16* lnp[NLN][2] = {{a.pos_nw, a.pos_nb}, {a.n2_w, a.n2_b},
                             {a.ns_w, a.ns_b}, {a.n1_w, a.n1_b},
                             {a.n3_w, a.n3_b}};
#pragma unroll
  for (int i = 0; i < NLN; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (lnp[i][j]) copy_async(sm.ln[i][j], lnp[i][j], D * 2);
  if (a.pos_b) copy_async(sm.b_pos, a.pos_b + r * DH, DH * 2);
  copy_async(sm.b_sq, a.sa_qb + r * DH, DH * 2);
  copy_async(sm.b_sk, a.sa_kb + r * DH, DH * 2);
  copy_async(sm.b_sv, a.sa_vb + r * DH, DH * 2);
  copy_async(sm.b_so, a.sa_ob + r * DH, DH * 2);
  copy_async(sm.b_uq, a.su_qb + r * DH, DH * 2);
  copy_async(sm.b_uo, a.su_ob + r * DH, DH * 2);
  copy_async(sm.b_off, a.off_b + r * 2 * LP, 2 * LP * 4);
  copy_async(sm.b_aw, a.aw_b + r * LP, LP * 2);
  copy_async(sm.b_op, a.op_b + r * DH, DH * 2);
  copy_async(sm.b_f1, a.f1_b + r * FS, FS * 2);
  copy_async(sm.b_f2, a.f2_b + r * DH, DH * 2);
  if (a.h0_w) {
    copy_async(sm.b_h0, a.h0_b + r * DH, DH * 2);
    copy_async(sm.b_h1, a.h1_b + r * DH, DH * 2);
    copy_async(sm.b_h2, a.h2_b, 4);
  }

  // the step's inputs, once the kernels before this one have finished
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int pos = (int)min(max(*a.pos, 0LL), (long long)(a.cache_len - 1));
  static_assert(BT * D == 8 * NT, "8 input values a thread");
  {
    const int e = tid * 8 / D, k = tid * 8 % D;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (e < nb) {
      const size_t at = (size_t)(e0 + e) * D + k;
      if (a.x_fp32) {
        lds8(static_cast<const float*>(a.x) + at, v);
      } else {
        cvt8(*reinterpret_cast<const uint4*>(static_cast<const bf16*>(a.x) + at), v);
      }
    }
    float4* d4 = reinterpret_cast<float4*>(&sm.xin[e][k]);
    d4[0] = make_float4(v[0], v[1], v[2], v[3]);
    d4[1] = make_float4(v[4], v[5], v[6], v[7]);
    *reinterpret_cast<uint4*>(&sm.xb[e][k]) = make_uint4(
        pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
        pack2(v[6], v[7]));
  }
  if (tid < BT * 2) {
    const int e = tid >> 1, c = tid & 1;
    sm.ref[e][c] = e < nb ? a.ref[(size_t)(e0 + e) * a.ref_sb + c] : 0.5f;
  }
  {     // episode `warp`'s unmasked support keys, in order
    const int e = warp;
    int cnt = 0;
    if (e < nb) {
      const unsigned char* mk = a.sup_mask + (size_t)(e0 + e) * a.n_sup;
      bool live[MAXSUP / 32];
#pragma unroll
      for (int i = 0; i < MAXSUP / 32; ++i) {
        const int k = 32 * i + lane;
        live[i] = k < a.n_sup && mk[k] == 0;
      }
#pragma unroll
      for (int i = 0; i < MAXSUP / 32; ++i) {
        const unsigned bal = __ballot_sync(0xffffffffu, live[i]);
        if (live[i])
          sm.kidx[e][cnt + __popc(bal & ((1u << lane) - 1u))] = (short)(32 * i + lane);
        cnt += __popc(bal);
      }
      if (cnt == 0) {
        for (int k = lane; k < a.n_sup; k += 32) sm.kidx[e][k] = (short)k;
      }
    }
    if (lane == 0) {
      sm.kall[e] = e < nb && cnt == 0;
      sm.kcnt[e] = cnt == 0 && e < nb ? a.n_sup : cnt;
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  if (a.pos_w) {
    // the sine embedding of the reference point (x's 128 features, then
    // y's; sin of the even, cos of the odd, which share their frequency:
    // `query_sine_embed`), rounded to bf16 as the chain rounds it
    const int e = tid * 8 / D, k = tid * 8 % D, f = k % (D / 2);
    const float at = sm.ref[e][k / (D / 2)] * 6.28318530717958647692f;
    unsigned u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float dim_t = powf(10000.f, (float)(f + 2 * i) / (float)(D / 2));
      float sn, cs;
      sincosf(at / dim_t, &sn, &cs);
      u[i] = pack2(sn, cs);
    }
    *reinterpret_cast<uint4*>(&sm.ab[e][k]) = make_uint4(u[0], u[1], u[2], u[3]);
  }
  // every block is running, its exchange mbarriers set, before any sends
  cluster.sync();

  // Exchanges: a block sends its columns of an output to every block of
  // the cluster (itself included) as 16-byte asynchronous stores, each
  // counted on the receiver's mbarrier of the exchange, and a block reads
  // an exchange once its mbarrier has counted every block's bytes: no
  // cluster-wide barrier or fence between the phases. Exchange n goes to
  // ex[n % 2]; a block sends exchange n + 1 only after its last read of
  // exchange n, and nobody sends n + 2 before receiving everybody's n + 1.
  auto send = [&](bf16* dst, int x, const uint4& w) {
    const unsigned at = smem_u32(dst), bar = smem_u32(&sm.xbar[x - 1]);
#pragma unroll
    for (int q = 0; q < CL; ++q) st_async(mapa(at, q), w, mapa(bar, q));
  };
  auto xwait_n = [&](int x) { xwait(&sm.xbar[x - 1]); };
  // sends a quad's 8 consecutive bf16 outputs (lanes 4g..4g+3 hold 2
  // each) into row e, column `col` of `buf`, exchange x
  auto push8 = [&](bf16* buf, int x, int stride, int e, int col, float v0,
                   float v1) {
    const unsigned u = pack2(v0, v1), base = lane & ~3;
    const uint4 w = make_uint4(__shfl_sync(0xffffffffu, u, base),
                               __shfl_sync(0xffffffffu, u, base + 1),
                               __shfl_sync(0xffffffffu, u, base + 2),
                               __shfl_sync(0xffffffffu, u, base + 3));
    if ((lane & 3) == 0) send(buf + e * stride + col, x, w);
  };
  bf16* ex0 = sm.ex[0];
  bf16* ex1 = sm.ex[1];
  const int HD = r * DH;       // this head's first column

  // exchange 1: the query position's transform and the pre-projections
  if (a.pos_w)
    gemv<D, XS>(sm, st, w_pos, sm.b_pos, &sm.ab[0][0],
                [&](int e, int c, float v0, float v1) {
                  push8(ex0, 1, XS, e, HD + (c & ~7), v0, v1);
                });
  if (a.aq_w) {
    gemv<D, XS>(sm, st, w_aq, (const bf16*)nullptr, &sm.xb[0][0],
                [&](int e, int c, float v0, float v1) {
                  push8(ex0 + BT * XS, 1, XS, e, HD + (c & ~7), v0, v1);
                });
    gemv<D, XS>(sm, st, w_ak, (const bf16*)nullptr, &sm.xb[0][0],
                [&](int e, int c, float v0, float v1) {
                  push8(ex0 + 2 * BT * XS, 1, XS, e, HD + (c & ~7), v0, v1);
                });
    gemv<D, XS>(sm, st, w_av, (const bf16*)nullptr, &sm.xb[0][0],
                [&](int e, int c, float v0, float v1) {
                  push8(ex0 + 3 * BT * XS, 1, XS, e, HD + (c & ~7), v0, v1);
                });
  }
  xwait_n(1);
  __syncthreads();     // the stages read: free for the next weights
  if (a.aq_w) st.release(w_av);
  else if (a.pos_w) st.release(w_pos);

  // query position; self-attention's query input attn_q(x) + qp in bf16
  if (a.pos_w) {
    layer_norm(&sm.qp[0][0], nullptr, nullptr, ex0, sm.ln[0], warp, lane);
  } else {
    for (int i = tid; i < BT * D; i += NT) sm.qp[i / D][i % D] = 0.f;
  }
  __syncthreads();
  const bf16* k_in = a.aq_w ? ex0 + 2 * BT * XS : &sm.xb[0][0];
  const bf16* v_in = a.aq_w ? ex0 + 3 * BT * XS : &sm.xb[0][0];
  {
    const int e = tid * 8 / D, k = tid * 8 % D;
    float q[8], p[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (a.aq_w) lds8(ex0 + BT * XS + e * XS + k, q);
    else lds8(&sm.xin[e][k], q);
    if (a.pos_w) lds8(&sm.qp[e][k], p);
    *reinterpret_cast<uint4*>(&sm.ab[e][k]) = make_uint4(
        pack2(q[0] + p[0], q[1] + p[1]), pack2(q[2] + p[2], q[3] + p[3]),
        pack2(q[4] + p[4], q[5] + p[5]), pack2(q[6] + p[6], q[7] + p[7]));
  }
  __syncthreads();

  // head r's q, and its k, v row written into the cache at pos
  const size_t head_rows = (size_t)a.cache_len * DH;
  gemv<D, XS>(sm, st, w_sq, sm.b_sq, &sm.ab[0][0],
              [&](int e, int c, float v0, float v1) {
                sm.qh[e][c] = v0 * scale;
                sm.qh[e][c + 1] = v1 * scale;
              });
  auto cache_row = [&](bf16* cache, int e) {
    return cache + (size_t)((e0 + e) * H + r) * head_rows + (size_t)pos * DH;
  };
  gemv<D, XS>(sm, st, w_sk, sm.b_sk, k_in, [&](int e, int c, float v0, float v1) {
    if (e < nb) *reinterpret_cast<unsigned*>(cache_row(a.cache_k, e) + c) = pack2(v0, v1);
  });
  gemv<D, XS>(sm, st, w_sv, sm.b_sv, v_in, [&](int e, int c, float v0, float v1) {
    if (e < nb) *reinterpret_cast<unsigned*>(cache_row(a.cache_v, e) + c) = pack2(v0, v1);
  });
  __syncthreads();
  st.release(w_sv);

  // an attention output (lane l channel l) into row e of `buf`: lanes
  // 0-15 take channels 2l and 2l + 1, lane 4g pushes 8 of them
  auto push_head = [&](bf16* buf, int x, int e, float o) {
    const float v0 = __shfl_sync(0xffffffffu, o, (2 * lane) & 31);
    const float v1 = __shfl_sync(0xffffffffu, o, (2 * lane + 1) & 31);
    const unsigned u = pack2(v0, v1), base = lane & ~3;
    const uint4 w = make_uint4(__shfl_sync(0xffffffffu, u, base),
                               __shfl_sync(0xffffffffu, u, base + 1),
                               __shfl_sync(0xffffffffu, u, base + 2),
                               __shfl_sync(0xffffffffu, u, base + 3));
    if ((lane & 3) == 0 && lane < 16) send(buf + e * XS + HD + 2 * lane, x, w);
  };

  // exchange 2: causal self-attention over slots 0..pos, warp e
  {
    const int e = warp;
    float o = 0.f;
    if (e < nb) {
      const size_t base = (size_t)((e0 + e) * H + r) * head_rows;
      o = attend(sm.qh[e], pos + 1, a.cache_k + base, a.cache_v + base, DH,
                 [](int j) { return j; }, false, lane);
    }
    push_head(ex1, 2, e, o);
  }
  xwait_n(2);
  gemv<D, XS>(sm, st, w_so, sm.b_so, ex1, [&](int e, int c, float v0, float v1) {
    push8(ex0, 3, XS, e, HD + (c & ~7), v0, v1);
  });
  xwait_n(3);
  __syncthreads();
  st.release(w_so);
  layer_norm(&sm.t[0][0], &sm.tb[0][0], &sm.xin[0][0], ex0, sm.ln[1], warp, lane);
  __syncthreads();

  // exchange 4: support cross-attention, head r
  gemv<D, XS>(sm, st, w_uq, sm.b_uq, &sm.tb[0][0],
              [&](int e, int c, float v0, float v1) {
                sm.qh[e][c] = v0 * scale;
                sm.qh[e][c + 1] = v1 * scale;
              });
  __syncthreads();
  st.release(w_uq);
  {
    const int e = warp;
    float o = 0.f;
    if (e < nb) {
      // a masked key's weight exp(-1e9 - max) is 0 beside any unmasked
      // one, so only the unmasked keys are read (all where none is)
      const int b = e0 + e;
      o = attend(sm.qh[e], sm.kcnt[e], a.sup_k + b * a.sup_sb + r * a.sup_sh,
                 a.sup_v + b * a.sup_sb + r * a.sup_sh, a.sup_sn,
                 [&](int j) { return (int)sm.kidx[e][j]; }, sm.kall[e] != 0,
                 lane);
    }
    push_head(ex1, 4, e, o);
  }
  xwait_n(4);
  gemv<D, XS>(sm, st, w_uo, sm.b_uo, ex1, [&](int e, int c, float v0, float v1) {
    push8(ex0, 5, XS, e, HD + (c & ~7), v0, v1);
  });
  xwait_n(5);
  __syncthreads();
  st.release(w_uo);
  layer_norm(&sm.t[0][0], nullptr, &sm.t[0][0], ex0, sm.ln[2], warp, lane);
  __syncthreads();

  // exchange 6: deformable cross-attention, head r: offsets (fp32) from
  // t + qp, attention weights from its bf16 rounding
  {
    const int e = tid * 8 / D, k = tid * 8 % D;
    float t8[8], p8[8];
    lds8(&sm.t[e][k], t8);
    lds8(&sm.qp[e][k], p8);
#pragma unroll
    for (int i = 0; i < 8; ++i) t8[i] += p8[i];
    float4* d4 = reinterpret_cast<float4*>(&sm.tmp[e][k]);
    d4[0] = make_float4(t8[0], t8[1], t8[2], t8[3]);
    d4[1] = make_float4(t8[4], t8[5], t8[6], t8[7]);
    *reinterpret_cast<uint4*>(&sm.ab[e][k]) = make_uint4(
        pack2(t8[0], t8[1]), pack2(t8[2], t8[3]), pack2(t8[4], t8[5]),
        pack2(t8[6], t8[7]));
  }
  __syncthreads();
  gemv_fp32(st, w_off, sm.b_off, &sm.tmp[0][0],
            [&](int e, int c, float v) { sm.off[e][c] = v; });
  gemv<D, XS>(sm, st, w_aw, sm.b_aw, &sm.ab[0][0],
              [&](int e, int c, float v0, float v1) {
                sm.aw[e][c] = v0;
                sm.aw[e][c + 1] = v1;
              });
  __syncthreads();
  st.release(w_aw);
  if (tid < BT * LP) {      // a half-warp an episode: softmax over L * P
    const int e = tid / LP, smp = tid % LP, l = smp / PT;
    const float z = sm.aw[e][smp];
    float mx = z;
#pragma unroll
    for (int o = LP / 2; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float ez = expf(z - mx);
    float sum = ez;
#pragma unroll
    for (int o = LP / 2; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float att = ez / sum;
    const int Wi = a.lvl_w[l], Hi = a.lvl_h[l];
    const float Wf = (float)Wi, Hf = (float)Hi;
    const float lx = sm.ref[e][0] + sm.off[e][2 * smp] / Wf;
    const float ly = sm.ref[e][1] + sm.off[e][2 * smp + 1] / Hf;
    const float x = lx * Wf - 0.5f, y = ly * Hf - 0.5f;
    float x0 = floorf(x), y0 = floorf(y);
    const float fx = x - x0, fy = y - y0;
    // far outside, every corner is out of bounds either way
    x0 = fminf(fmaxf(x0, -2.f), Wf);
    y0 = fminf(fmaxf(y0, -2.f), Hf);
    const int ix = (int)x0, iy = (int)y0;
    const float wgt[4] = {(1.f - fx) * (1.f - fy), fx * (1.f - fy),
                          (1.f - fx) * fy, fx * fy};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int cx = ix + (c & 1), cy = iy + (c >> 1);
      const bool in = cx >= 0 && cx < Wi && cy >= 0 && cy < Hi;
      sm.sw[e][smp][c] = in ? wgt[c] * att : 0.f;
    }
    const int xc = min(max(ix, -1), Wi - 1), yc = min(max(iy, -1), Hi - 1);
    sm.sbase[e][smp] = a.lvl_off[l] + (Wi + 1) + yc * Wi + xc;
  }
  __syncthreads();
  {     // a half-warp a sample: lane (corner c, 8 channels dq) of a quad row
    const int e = warp, h16 = lane & 15, half = lane >> 4;
    const int c = h16 >> 2, dq = h16 & 3;
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
    if (e < nb) {
      const bf16* rows = a.slab + (size_t)((e0 + e) * H + r) * a.slab_rows * QROW;
      uint4 u[LP / 2];
#pragma unroll
      for (int i = 0; i < LP / 2; ++i) {
        const int base = sm.sbase[e][half * (LP / 2) + i];
        u[i] = make_uint4(0u, 0u, 0u, 0u);
        if (base >= 0 && base < a.slab_rows)
          u[i] = __ldg(reinterpret_cast<const uint4*>(
              rows + (size_t)base * QROW + c * DH + dq * 8));
      }
#pragma unroll
      for (int i = 0; i < LP / 2; ++i) {
        const float w = sm.sw[e][half * (LP / 2) + i][c];
        float v[8];
        cvt8(u[i], v);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] = fmaf(w, v[j], acc[j]);
      }
    }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
    if (lane < 4)
      send(ex1 + e * XS + HD + lane * 8, 6,
           make_uint4(pack2(acc[0], acc[1]), pack2(acc[2], acc[3]),
                      pack2(acc[4], acc[5]), pack2(acc[6], acc[7])));
  }
  xwait_n(6);
  gemv<D, XS>(sm, st, w_op, sm.b_op, ex1, [&](int e, int c, float v0, float v1) {
    push8(ex0, 7, XS, e, HD + (c & ~7), v0, v1);
  });
  xwait_n(7);
  __syncthreads();
  st.release(w_op);
  layer_norm(&sm.t[0][0], &sm.tb[0][0], &sm.t[0][0], ex0, sm.ln[3], warp, lane);
  __syncthreads();

  // exchange 8: the FFN's hidden
  gemv<D, XS>(sm, st, w_f1, sm.b_f1, &sm.tb[0][0],
              [&](int e, int c, float v0, float v1) {
                push8(ex1, 8, HS, e, r * FS + (c & ~7), fmaxf(v0, 0.f),
                      fmaxf(v1, 0.f));
              });
  xwait_n(8);
  __syncthreads();
  st.release(w_f1);
  gemv<FF, HS>(sm, st, w_f2, sm.b_f2, ex1, [&](int e, int c, float v0, float v1) {
    push8(ex0, 9, XS, e, HD + (c & ~7), v0, v1);
  });
  xwait_n(9);
  __syncthreads();
  st.release(w_f2);
  layer_norm(&sm.t[0][0], &sm.tb[0][0], &sm.t[0][0], ex0, sm.ln[4], warp, lane);
  __syncthreads();
  {     // the output in bf16; the head reads it as returned
    const int e = tid / DH, k = HD + tid % DH;
    if (e < nb) a.x_out[(size_t)(e0 + e) * D + k] = sm.tb[e][k];
  }

  if (!a.h0_w) return;     // the reference point passes through
  gemv<D, XS>(sm, st, w_h0, sm.b_h0, &sm.tb[0][0],
              [&](int e, int c, float v0, float v1) {
                push8(ex1, 10, XS, e, HD + (c & ~7), fmaxf(v0, 0.f),
                      fmaxf(v1, 0.f));
              });
  xwait_n(10);
  __syncthreads();
  st.release(w_h0);
  gemv<D, XS>(sm, st, w_h1, sm.b_h1, ex1, [&](int e, int c, float v0, float v1) {
    push8(ex0, 11, XS, e, HD + (c & ~7), fmaxf(v0, 0.f), fmaxf(v1, 0.f));
  });
  xwait_n(11);
  if (r != 0) return;
  gemv<D, XS>(sm, st, w_h2, sm.b_h2, ex0, [&](int e, int c, float v0, float v1) {
    if (c == 0) {
      sm.hoff[e][0] = v0;
      sm.hoff[e][1] = v1;
    }
  });
  __syncthreads();
  if (tid < BT * 2) {
    const int e = tid >> 1, c = tid & 1;
    if (e < nb) {
      // sigmoid(offset + inverse_sigmoid(ref)), `Decoder._refine`
      const float x = fminf(fmaxf(sm.ref[e][c], 0.f), 1.f);
      const float inv = logf(fmaxf(x, 1e-5f) / fmaxf(1.f - x, 1e-5f));
      a.ref_out[(size_t)(e0 + e) * 2 + c] = 1.f / (1.f + expf(-(sm.hoff[e][c] + inv)));
    }
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (a refused launch never
// runs, and no later synchronisation reports it).
extern "C" int decode_layer_launch(const DecodeLayerArgs* args, void* stream) {
  static bool sized[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  const int smem = (int)sizeof(Smem);
  if (dev < 64 && !sized[dev]) {
    cudaFuncSetAttribute(decode_layer_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    sized[dev] = true;
  }
  const int clusters = (args->batch + BT - 1) / BT;
  if (clusters > 0) {
    // programmatic dependent launch: this layer's blocks may start while
    // the kernel before it runs, and wait for it in `griddepcontrol.wait`
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(clusters * CL);
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaLaunchKernelEx(&cfg, decode_layer_kernel, *args);
  }
  return (int)cudaGetLastError();
}

// The dynamic shared memory a block takes, for the wrapper's records.
extern "C" int decode_layer_smem_bytes() { return (int)sizeof(Smem); }
