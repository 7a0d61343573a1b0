// Whole multi-scale deformable attention backward, the gradients of
// msda.cu's forward
//   out[b, q, h*Dh:(h+1)*Dh] = sum over levels l, points p and corners c of
//       attn[b, q, h, l, p] * bilin_c * valid_c * value[b, row_c, h, :]
// for the cotangent dout (B, Lq, H*Dh), in one kernel:
//   grad_value[b, s, h, :] = sum over every (q, l, p, c) whose corner is
//       row s of attn * bilin_c * valid_c * dout[b, q, h, :]
//   grad_attn[b, q, h, l, p] = sum_c bilin_c * valid_c * <dout, v_c>
//   grad_loc[..., 0] = attn * W_l * sum_c dbilin_c/dfx * valid_c * <dout, v_c>
//   grad_loc[..., 1] = attn * H_l * sum_c dbilin_c/dfy * valid_c * <dout, v_c>
// with bilin = (1-fx)(1-fy), fx(1-fy), (1-fx)fy, fx fy for corners (0, 0),
// (1, 0), (0, 1), (1, 1); floor passes no gradient and a corner outside its
// level adds nothing (autograd through `ops.msda._quad_bases_and_weights`).
//
// Replaces no Pallas kernel: the JAX package differentiates its quad-row
// core instead (XLA's backward of the corner blend, and the Pallas scatter
// `_scatter_bwd_kernel`, cape_tpu/ops/gather_mxu.py:68). Here that route
// (`quad_gather`'s backward `quad_scatter` plus PyTorch's backward of the
// blend and the corner math) writes the (B*H, Lq, 16, Dh) gathered rows,
// their gradient of the same size and a dozen broadcast products of it,
// about 8 GB of device traffic at a training encoder site; this kernel
// reads what the op must move (the value rows the corners select, the
// locations, the weights, dout) and writes the three gradients once.
//
// Bound: bytes (the multiply-adds are 2 a corner value for grad_value and
// 2 for the dots, far below the card's fp32 rate).
//
// Design. The blocks of the launch have two roles, both recomputing the
// corners and their weights in registers with msda.cu's rounding
// (`__fmul_rn`, `__fsub_rn`, no FMA contraction), so that the corners
// chosen and their weights are the forward's bit for bit:
//  - Value rows (the first blocks): owner computes, on the row lists of
//    rowlist.cuh, as fused.cu's backward does. A block owns a tile of rows
//    of one (b, h, level) slab, scans that level's Lq * P points of
//    (b, h), keys each by the cell of its top-left corner (the tile and a
//    halo of W_l + 1 cells below it; a point with no corner in the level
//    is not listed) and walks, for each of its rows s, the lists of cells
//    s, s - 1, s - W_l, s - W_l - 1 as corners 0-3. A cell index is shared
//    by (x0 = -1, y0) and (W_l - 1, y0 - 1), so each entry's corner is
//    taken only where its recomputed corner lies in the level. Every
//    in-level corner is added once, by the owner of its row, in the same
//    order every run: no atomics, no fp32 buffer in device memory, no zero
//    fill and no cast pass, and the same bits every run. The tiling
//    (`ops.msda_kernel.msda_bwd_plan`) gives each block about the same
//    number of corners (24,576), at most 512 rows, and each warp of it
//    rows.
//  - Points (the other blocks): msda.cu's lanes, a lane per 16 bytes of a
//    head's dout (G lanes a head). A head's lanes take its points in
//    rounds of 4, load the value units of all 16 corners at once (every
//    corner in its level: grad_attn needs the dot of a corner whose
//    weight is 0), dot them with their dout unit and sum the 16 dots over
//    the G lanes in halves (reduce-scatter, 12 shuffles at G = 4), so that
//    lane group g ends with the 4 dots of point g of the round and writes
//    its grad_attn and grad_loc.
// Sums are fp32, rounded once at the store.
//
// Measured (H100 SXM, 700 W, bf16, the training encoder's 4 x 5440 queries
// with locations drawn as the model draws them, `chip_smoke.py`): 0.747 ms
// (3.6% of the 0.027 ms the bytes take), 0.408 ms with uniform locations
// (15 of 16 corners outside), 0.080 ms at the teacher-forced decoder; a
// whole site, forward and backward, 0.83 ms against 7.8 ms for the
// quad-row core under autograd. Throwaway builds without one role: the
// value rows alone took 0.74 of 0.84 ms at the first tiling, the points
// 0.18. The rows' cost is the scan (every tile of a level reads all of its
// entries' locations, twice: to count and to place) and the walk, whose
// warps wait on one list entry, then its location, weight and dout, with
// 16 warps an SM (the lists' shared memory and 126 registers a thread
// allow two blocks). Tiles of 16,384 corners with no cap on their rows:
// 0.84 ms, the decoder 0.14 (one tile a slab left the card unfilled);
// 2,048: 1.43 ms (scans); 49,152: 0.76. Not tried: fp32 atomics into a
// scratch buffer.

#include "rowlist.cuh"

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;
constexpr int kChunk = 4;  // points of a round (role 2)

// The levels, and the value-row role's tiling of each: level l's blocks
// are [first[l], first[l + 1]), tiles[l] tiles of rows[l] rows a slab.
struct Levels {
  int h[kMaxLevels], w[kMaxLevels], start[kMaxLevels];
  int rows[kMaxLevels], tiles[kMaxLevels], split[kMaxLevels];
  int first[kMaxLevels + 1];
};

// A point's corner math, rounded as msda.cu's forward rounds it; 1 - fx
// and 1 - fy are recomputed where they are needed (the same bits).
struct Point {
  float fx, fy;
  int x0, y0;  // clamped to [-2, W] x [-2, H]: a corner outside stays out
};

__device__ __forceinline__ Point point(float2 xy, int Hl, int Wl) {
  const float fW = (float)Wl, fH = (float)Hl;
  const float x = __fsub_rn(__fmul_rn(xy.x, fW), 0.5f);
  const float y = __fsub_rn(__fmul_rn(xy.y, fH), 0.5f);
  const float x0 = floorf(x), y0 = floorf(y);
  Point p;
  p.fx = __fsub_rn(x, x0);
  p.fy = __fsub_rn(y, y0);
  p.x0 = (int)fminf(fmaxf(x0, -2.f), fW);
  p.y0 = (int)fminf(fmaxf(y0, -2.f), fH);
  return p;
}

// Bilinear weight of corner c (without the attention weight), as the
// forward's `(gx * gy) * a` before the last product.
__device__ __forceinline__ float bilin(const Point& p, int c) {
  const float gx = __fsub_rn(1.f, p.fx), gy = __fsub_rn(1.f, p.fy);
  return __fmul_rn(c & 1 ? p.fx : gx, c & 2 ? p.fy : gy);
}

__device__ __forceinline__ bool inside(const Point& p, int c, int Hl,
                                       int Wl) {
  const int cx = p.x0 + (c & 1), cy = p.y0 + (c >> 1);
  return cx >= 0 && cx < Wl && cy >= 0 && cy < Hl;
}

struct Args {
  const void* value;   // (B, S, H, Dh)
  const float2* loc;   // (B, Lq, H, L, P)
  const void* attn;    // (B, Lq, H, L, P)
  const void* dout;    // (B, Lq, H*Dh)
  void* gvalue;        // (B, S, H, Dh)
  float2* gloc;        // (B, Lq, H, L, P)
  void* gattn;         // (B, Lq, H, L, P)
  int S, Lq, H, L, P, G, cap, use_tile, n_lanes;
};

// Role 1: the rows of one (b, h, level) tile of grad_value.
template <bool kBf16>
__device__ __forceinline__ void value_rows(const Args& a, const Levels& lv,
                                           unsigned char* smem) {
  using namespace rowlist;
  using U = Unit<kBf16, 16>;
  using Raw = typename U::Raw;
  constexpr int V = U::kVals;
  // the level, by constant indices
  int l = 0, Hl = 0, Wl = 0, st = 0, rows = 0, tiles = 0, split = 1,
      first = 0;
#pragma unroll
  for (int k = 0; k < kMaxLevels; ++k)
    if (k < a.L && (int)blockIdx.x >= lv.first[k] &&
        (int)blockIdx.x < lv.first[k + 1]) {
      l = k;
      Hl = lv.h[k];
      Wl = lv.w[k];
      st = lv.start[k];
      rows = lv.rows[k];
      tiles = lv.tiles[k];
      split = lv.split[k];
      first = lv.first[k];
    }
  const int G = a.G, C = G * V, HW = Hl * Wl, halo = Wl + 1;
  const int N = a.Lq * a.P;  // entries of a slab: (q, p) of (b, h, l)
  Block blk(smem, a.use_tile, HW, N, C, rows, tiles, a.cap, halo,
            (long long)blockIdx.x - first);
  const Team tm(G, split);
  const int bh = (int)blk.b, b = bh / a.H, h = bh - b * a.H;
  const int LP = a.L * a.P;
  // entry i = q * P + p: its point and its head's dout unit 0
  const long long pt0 = ((long long)b * a.Lq * a.H + h) * LP + l * a.P;
  auto pt = [&](int i) {
    const int q = i / a.P;
    return pt0 + (long long)q * a.H * LP + (i - q * a.P);
  };
  auto dunit = [&](int i) {
    return ((long long)b * a.Lq + i / a.P) * a.H * G + h * G;
  };
  // the key of an entry: the cell of its top-left corner, or none where
  // no corner lies in the level
  auto cell = [&](int i) {
    const Point p = point(__ldg(a.loc + pt(i)), Hl, Wl);
    return p.x0 >= -1 && p.x0 < Wl && p.y0 >= -1 && p.y0 < Hl
               ? p.y0 * Wl + p.x0
               : (int)0x80000000;
  };
  const Raw* dout = reinterpret_cast<const Raw*>(a.dout) + tm.gl;
  // the tile's first row; rows are H * G units apart
  const long long row_units = (long long)a.H * G;
  Raw* out = reinterpret_cast<Raw*>(a.gvalue) +
             ((long long)b * a.S + st + blk.row0) * row_units + h * G;
  const int shift[4] = {0, 1, Wl, Wl + 1};

  for (int s0 = 0;;) {
    blk.sort_by(cell, s0, [](int, int) {});
    auto walk = [&](int r, bool mine) {
      int at0[4], len[4];
      int most = 0;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int k = r + halo - shift[c];
        at0[c] = mine ? blk.begin(k) : 0;
        len[c] = mine ? blk.end(k) - at0[c] : 0;
        most = max(most, len[c]);
      }
      const int steps = __reduce_max_sync(0xffffffffu, most);
      float acc[V];
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = 0.f;
      for (int k0 = 0; k0 < steps; k0 += tm.S) {
        const int pos = k0 + tm.sub;
        int i[4];
        float2 xy[4];
        float at[4];
        Raw d[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          i[c] = pos < len[c] ? blk.at(s0 + blk.list[at0[c] + pos]) : -1;
          const long long e = i[c] >= 0 ? pt(i[c]) : 0;
          xy[c] = i[c] >= 0 ? __ldg(a.loc + e) : make_float2(0.f, 0.f);
          at[c] = i[c] >= 0 ? load1<kBf16>(a.attn, e) : 0.f;
          d[c] = i[c] >= 0 ? __ldg(dout + dunit(i[c])) : U::zero();
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const Point p = point(xy[c], Hl, Wl);
          const float w = i[c] >= 0 && inside(p, c, Hl, Wl)
                              ? __fmul_rn(bilin(p, c), at[c])
                              : 0.f;
          float dv[V];
          U::unpack(d[c], dv);
#pragma unroll
          for (int k = 0; k < V; ++k) acc[k] = fmaf(w, dv[k], acc[k]);
        }
      }
      tm.across<V>(acc);
      if (!mine || tm.sub) return;
      if (a.use_tile)
        blk.add<V>(r, C, tm.gl * V, acc);
      else
        out[r * row_units + tm.gl] = U::pack(acc);
    };
    for (int r0; (r0 = blk.take(tm.R)) < blk.rows;) {
      const int r = r0 + tm.team;
      walk(r, r < blk.rows);
    }
    s0 += a.cap;
    if (s0 >= blk.share) break;
    blk.reset();
  }
  if (a.use_tile) blk.finish<U>(out, C, G, row_units);
}

// x summed over the G lanes of a head, in halves: on entry s[4 * i + c] is
// the lane's part of the dot of point i, corner c; on return the lane
// holds whole dots, of points {0..3} (G = 1), {2u, 2u + 1} in s[0..7]
// (G = 2, u = the lane's top bit) or point 2u + u2 in s[0..3] (G >= 4,
// u2 its next bit).
__device__ __forceinline__ void halves(float s[16], int G, int gl) {
  if (G >= 2) {
    const int o = G >> 1;
    const bool up = gl & o;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float keep = up ? s[8 + k] : s[k], give = up ? s[k] : s[8 + k];
      s[k] = keep + __shfl_xor_sync(0xffffffffu, give, o);
    }
  }
  if (G >= 4) {
    const int o = G >> 2;
    const bool up = gl & o;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float keep = up ? s[4 + k] : s[k], give = up ? s[k] : s[4 + k];
      s[k] = keep + __shfl_xor_sync(0xffffffffu, give, o);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) s[k] = rowlist::Team::sum(s[k], G >> 2);
  }
}

// Role 2: grad_attn and grad_loc of the points of one lane's head.
template <bool kBf16>
__device__ __forceinline__ void point_grads(const Args& a, const Levels& lv,
                                            int t) {
  using U = rowlist::Unit<kBf16, 16>;
  using Raw = typename U::Raw;
  constexpr int V = U::kVals;
  const int G = a.G, Q = a.H * G;
  // a whole warp stays to the end: its lanes share dots by shuffles
  const bool live = t < a.n_lanes;
  const int qr = live ? t / Q : 0;  // (b, q)
  const int j = t - qr * Q;
  const int h = j / G, gl = j - h * G;
  const int b = qr / a.Lq;
  const Raw* vb =
      reinterpret_cast<const Raw*>(a.value) + (long long)b * a.S * Q + j;
  const long long p0 = ((long long)qr * a.H + h) * a.L * a.P;
  float go[V];
  U::unpack(live ? __ldg(reinterpret_cast<const Raw*>(a.dout) + t)
                 : U::zero(),
            go);
  // the point of the round this lane writes: g of points {0..3} (G = 1
  // writes all four, G = 2 two)
  const int gq = G >= 4 ? gl / (G >> 2) : G == 2 ? gl : 0;
  const bool writer = G < 4 || (gl & ((G >> 2) - 1)) == 0;

  for (int l = 0; l < a.L; ++l) {
    int Hl = 0, Wl = 0, st = 0;
#pragma unroll
    for (int m = 0; m < kMaxLevels; ++m)
      if (m == l) {
        Hl = lv.h[m];
        Wl = lv.w[m];
        st = lv.start[m];
      }
    for (int pb = 0; pb < a.P; pb += kChunk) {
      Point pp[kChunk];
      float at[kChunk];
      Raw v[kChunk][4];
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const bool ok = live && pb + i < a.P;
        const long long k = p0 + l * a.P + pb + i;
        pp[i] = point(ok ? __ldg(a.loc + k) : make_float2(-4.f, -4.f), Hl,
                      Wl);
        at[i] = ok ? rowlist::load1<kBf16>(a.attn, k) : 0.f;
        const int base = st + pp[i].y0 * Wl + pp[i].x0;
        const int shift[4] = {0, 1, Wl, Wl + 1};
#pragma unroll
        for (int c = 0; c < 4; ++c)
          v[i][c] = inside(pp[i], c, Hl, Wl)
                        ? __ldg(vb + (long long)(base + shift[c]) * Q)
                        : U::zero();
      }
      float s[16];
#pragma unroll
      for (int i = 0; i < kChunk; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float x[V];
          U::unpack(v[i][c], x);
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < V; ++e) d = fmaf(go[e], x[e], d);
          s[4 * i + c] = d;
        }
      halves(s, G, gl);
      if (!live || !writer) continue;
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        // this lane's dots of point i, if it writes point i
        const bool own = G >= 4 ? i == gq : G == 2 ? (i >> 1) == gq : true;
        if (!own || pb + i >= a.P) continue;
        const int o = G >= 4 ? 0 : G == 2 ? 4 * (i & 1) : 4 * i;
        const Point& p = pp[i];
        const float d0 = s[o], d1 = s[o + 1], d2 = s[o + 2], d3 = s[o + 3];
        const float ga = bilin(p, 0) * d0 + bilin(p, 1) * d1 +
                         bilin(p, 2) * d2 + bilin(p, 3) * d3;
        const float gx = (1.f - p.fy) * (d1 - d0) + p.fy * (d3 - d2);
        const float gy = (1.f - p.fx) * (d2 - d0) + p.fx * (d3 - d1);
        const long long k = p0 + l * a.P + pb + i;
        a.gloc[k] =
            make_float2(at[i] * (float)Wl * gx, at[i] * (float)Hl * gy);
        rowlist::store1<kBf16>(a.gattn, k, ga);
      }
    }
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
msda_backward_kernel(const Args a, const Levels lv) {
  extern __shared__ __align__(16) unsigned char smem[];
  if ((int)blockIdx.x < lv.first[a.L])
    value_rows<kBf16>(a, lv, smem);
  else
    point_grads<kBf16>(
        a, lv, ((int)blockIdx.x - lv.first[a.L]) * blockDim.x + threadIdx.x);
}

}  // namespace

// value and grad_value (B, S, H, Dh) in one dtype (0 = fp32, 1 = bf16),
// loc and grad_loc (B, Lq, H, L, P, 2) fp32, attn and grad_attn
// (B, Lq, H, L, P) and dout (B, Lq, H*Dh) in the value's dtype; all
// contiguous and 16-byte aligned. `shapes` holds the L levels' (height,
// width) pairs, whose cells are the first of the S; rows past them are not
// written. `tiling` holds, per level, the value-row role's rows a tile,
// tiles a slab and groups a row (`ops.msda_kernel.msda_bwd_plan`), which
// also gives `cap` (entries a block lists in a pass), `use_tile`,
// `threads`, `smem_bytes` and `point_blocks`, the blocks of the point role.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for arguments the
// kernel does not take.
extern "C" int msda_backward_launch(
    const void* value, const void* loc, const void* attn, const void* dout,
    void* gvalue, void* gloc, void* gattn, const int* shapes,
    const int* tiling, int B, int S, int Lq, int H, int L, int P, int Dh,
    int G, int cap, int use_tile, int threads, int smem_bytes,
    int point_blocks, int dtype, void* stream) {
  const int vals = dtype == 1 ? 8 : 4;
  if ((dtype != 0 && dtype != 1) || L < 1 || L > kMaxLevels || P < 1 ||
      B < 1 || Lq < 1 || H < 1 || Dh != G * vals || G > 32 || (G & (G - 1)) ||
      threads != kThreads || point_blocks < 1 ||
      (long long)S * H * G > 0x7fffffffLL ||
      (long long)Lq * P > 0x7fffffffLL ||
      (long long)B * Lq * H * L * P > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Levels lv = {};
  int start = 0;
  long long blocks = 0;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = shapes[2 * l];
    lv.w[l] = shapes[2 * l + 1];
    lv.start[l] = start;
    lv.rows[l] = tiling[3 * l];
    lv.tiles[l] = tiling[3 * l + 1];
    lv.split[l] = tiling[3 * l + 2];
    lv.first[l] = (int)blocks;
    const int HW = lv.h[l] * lv.w[l];
    if (lv.h[l] < 1 || lv.w[l] < 1) return (int)cudaErrorInvalidValue;
    const rowlist::Plan p = {lv.rows[l], lv.tiles[l], 1, cap,
                             use_tile,   threads,     smem_bytes, lv.split[l]};
    if (const int err =
            rowlist::check_plan(p, HW, Lq * P, Dh, lv.w[l] + 1, B * H))
      return err;
    start += HW;
    blocks += (long long)B * H * lv.tiles[l];
  }
  lv.first[L] = (int)blocks;
  const long long n_lanes = (long long)B * Lq * H * G;
  if (start > S || (long long)point_blocks * threads < n_lanes ||
      blocks + point_blocks > 0x7fffffffLL ||
      n_lanes + threads > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Args a = {value, (const float2*)loc, attn, dout, gvalue, (float2*)gloc,
            gattn, S, Lq, H, L, P, G, cap, use_tile, (int)n_lanes};
  const rowlist::Plan all = {1, (int)(blocks + point_blocks), 1, cap,
                             use_tile, threads, smem_bytes, 1};
  cudaStream_t s = (cudaStream_t)stream;
  static bool done[2][64] = {};
  const cudaError_t err =
      dtype == 1
          ? rowlist::launch(msda_backward_kernel<true>, done[1], all, 1, s, a,
                            lv)
          : rowlist::launch(msda_backward_kernel<false>, done[0], all, 1, s,
                            a, lv);
  return (int)err;
}
