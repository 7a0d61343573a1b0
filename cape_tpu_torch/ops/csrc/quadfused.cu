// Fused MSDA level sample over the QUAD slab, forward and backward:
//   out[b, r, d]             = sum_c w4[b, r, c] * slab[b, gi[b, r], c*Dh + d]
//   dslab[b, s, c*Dh + d]    = sum over r with gi[b, r] == s of
//                              w4[b, r, c] * dout[b, r, d]
//   dw4[b, r, c]             = sum_d dout[b, r, d] * slab[b, gi[b, r], c*Dh + d]
// A quad row holds the 2x2 bilinear neighbourhood of one grid cell as four
// Dh-wide bands, so one row index serves all four corners. A row index
// outside [0, n) gives a zero output row and dw4 = 0, adds nothing to
// dslab, and is never read.
//
// Replaces the Pallas kernels `_quadfused_fwd_kernel`
// (cape_tpu/ops/msda_fused.py:231, pallas_call at :294) and
// `_quadfused_bwd_kernel` (:249, pallas_call at :313). On the TPU the row
// gather is a one-hot matmul, the blend a lane-repeated weight and the
// corner sum a second matmul; dslab is carried across sequential grid
// steps. Here the forward's thread loads the four bands of its row
// directly, and the backward's rows are owned by blocks.
//
// Bound: bytes. Forward: the quad rows selected (4 * Dh values each), gi,
// w4 and the (BH, N, Dh) output, each once. Backward: the same reads plus
// dout, and dslab (4 * Dh wide) and dw4 written once. The gathered
// (BH, N, 4 * Dh) rows and the (BH, N, 4 * Dh) product w4 x dout stay in
// registers.
//
// Forward: one thread per group of 4 consecutive channels of an output
// row (rows4.cuh); it reads the same group of each of the four bands, so
// the Dh / 4 lanes of a row read 4 runs of Dh * elt contiguous bytes of
// one quad row. Sums are fp32 with one rounding at the store (the TPU
// kernel also rounds each w * g term to the slab dtype before the corner
// sum).
// Backward: `quad_scatter` of the outer products w4[r] x dout[r], with dw4
// as a by-product: the row lists of rowlist.cuh keyed by the quad row
// gi[r]. The lanes of a quad row load it once (only where an entry reaches
// it: a row no entry reaches is stored as zeros unread), and for each
// entry of its list load their 16 bytes of dout[r] and their band's
// w4[r, c], add w * dout to their sums and dot dout with their slab values;
// the lanes of a band add up the dot with shuffles and one stores
// dw4[r, c]. Every in-range r is in exactly one list, so every dw4 value
// is written once; the blocks of tile 0 write dw4 = 0 for an r outside
// [0, n) while they scan. About 5 entries share a quad row at the
// encoder's level 0 (one group of 16 lanes a row); at its levels 2-3
// (n = 273, 73 with N = 21,760, about 300 at level 3) the entries are
// split over a cluster and a row gets more groups.

#include <type_traits>

#include "rowlist.cuh"
#include "rows4.cuh"

using namespace rows4;

namespace {

template <bool kBf16>
__global__ void quadfused_fwd_kernel(const void* __restrict__ slab,
                                     const int* __restrict__ gi,
                                     const void* __restrict__ w4,
                                     void* __restrict__ out, int n, int N,
                                     int lg, long long slab_bs) {
  const int i = blockIdx.x * kThreads + threadIdx.x;  // group in the slab
  if (i >= (N << lg)) return;
  const long long b = blockIdx.y;
  const long long r = b * N + (i >> lg);
  const int q = i & ((1 << lg) - 1);
  const int idx = __ldg(gi + r);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (idx >= 0 && idx < n) {
    const float4 w = load4<kBf16>(w4, r);
    const float wc[4] = {w.x, w.y, w.z, w.w};
    const long long row = (b * slab_bs + idx) << (lg + 2);  // 4 bands
#pragma unroll
    for (int c = 0; c < 4; ++c)
      fma4(acc, wc[c], load4<kBf16>(slab, row + (c << lg) + q));
  }
  store4<kBf16>(out, (r << lg) + q, acc);
}

// The backward on row lists (rowlist.cuh), keyed by the quad row gi.
// A group of G lanes holds a quad row of 4 * Dh values, `units` = 4 * ub
// units of W values, lane gl the units gl + G * j (j < kVPL): unit u lies
// in band u / ub and meets dout unit u % ub (ub = Dh / W). The groups of
// a team (`split` of them) take other entries of the row's list.
template <bool kBf16, int kBytes, int kVPL>
__global__ void __launch_bounds__(rowlist::kThreads, 2)
quadfused_bwd_kernel(const void* __restrict__ slab,
                     const int* __restrict__ gi,
                     const void* __restrict__ w4,
                     const void* __restrict__ dout,
                     void* __restrict__ dslab, void* __restrict__ dw4, int n,
                     int N, int ub, int rows_per_tile, int tiles, int cap,
                     int use_tile, int split, long long slab_bs) {
  using namespace rowlist;
  extern __shared__ __align__(16) unsigned char smem[];
  using U = Unit<kBf16, kBytes>;
  using Raw = typename U::Raw;
  using T = typename std::conditional<kBf16, __nv_bfloat16, float>::type;
  constexpr int W = U::kVals;
  const int units = 4 * ub, C = units * W;
  Block blk(smem, use_tile, n, N, C, rows_per_tile, tiles, cap, 0);
  // G * kVPL == units; a whole warp a team for the rows put aside
  const Team m(units, split), whole(units, 32);
  const int warp = threadIdx.x >> 5;
  // this slab's arrays, so that offsets within them are 32-bit
  const long long b = blk.b;
  const Raw* slabb = reinterpret_cast<const Raw*>(slab) +
                     (b * slab_bs + blk.row0) * units + m.gl;
  const Raw* doutb = reinterpret_cast<const Raw*>(dout) + b * N * ub;
  const T* w4b = reinterpret_cast<const T*>(w4) + b * N * 4;
  T* dw4b = reinterpret_cast<T*>(dw4) + b * N * 4;
  Raw* out = reinterpret_cast<Raw*>(dslab) + (b * n + blk.row0) * units;
  const int lgub = __ffs(ub) - 1;
  int band[kVPL], du[kVPL];
#pragma unroll
  for (int j = 0; j < kVPL; ++j) {
    band[j] = (m.gl + m.G * j) >> lgub;
    du[j] = (m.gl + m.G * j) & (ub - 1);
  }
  const bool first_tile = blk.tile == 0;

  for (int s0 = 0;;) {
    // an index outside [0, n) is in no list: tile 0 writes its dw4
    blk.sort(gi + b * N, s0, [&](int i, int v) {
      if (first_tile && (v < 0 || v >= n)) {
#pragma unroll
        for (int c = 0; c < 4; ++c) store1<kBf16>(dw4b, i * 4 + c, 0.f);
      }
    });
    // one row: the groups of team t take positions first + sub + k * step
    // of its list, 4 in flight a lane (first = 0, step = S for a team on
    // its own; first = w * S, step = warps * S where all the warps share
    // the row, each leaving its sums in `share`)
    auto walk = [&](const Team& t, int r, bool mine, int first, int step,
                    float* share) {
      const int ta = mine ? blk.begin(r) : 0;
      const int len = mine ? blk.end(r) - ta : 0;
      // the warp's teams go in step
      const int most = __reduce_max_sync(0xffffffffu, len);
      float acc[kVPL][W];
#pragma unroll
      for (int j = 0; j < kVPL; ++j)
#pragma unroll
        for (int k = 0; k < W; ++k) acc[j][k] = 0.f;
      // the slab row, read once, and only for a row that entries reach
      float sv[kVPL][W];
      if (len > 0) {
#pragma unroll
        for (int j = 0; j < kVPL; ++j)
          U::unpack(__ldg(slabb + r * units + t.G * j), sv[j]);
      }
      for (int k0 = first; k0 < most; k0 += 4 * step) {
        int i[4];
        Raw d[4][kVPL];
        float w[4][kVPL];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int pos = k0 + t.sub + u * step;
          i[u] = pos < len ? blk.at(s0 + blk.list[ta + pos]) : -1;
#pragma unroll
          for (int j = 0; j < kVPL; ++j) {
            d[u][j] = i[u] >= 0 ? __ldg(doutb + i[u] * ub + du[j]) : U::zero();
            w[u][j] = i[u] >= 0 ? load1<kBf16>(w4b, i[u] * 4 + band[j]) : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          // dslab += w * dout in registers; dw4 = <dout, slab row> over
          // the ub lanes of the band
          float q[kVPL];
#pragma unroll
          for (int j = 0; j < kVPL; ++j) {
            float dv[W];
            U::unpack(d[u][j], dv);
            q[j] = 0.f;
#pragma unroll
            for (int k = 0; k < W; ++k) {
              acc[j][k] += w[u][j] * dv[k];
              q[j] += dv[k] * sv[j][k];
            }
            q[j] = t.sum(q[j], ub);
          }
          if (i[u] >= 0 && (t.gl & (ub - 1)) == 0) {
#pragma unroll
            for (int j = 0; j < kVPL; ++j)
              store1<kBf16>(dw4b, i[u] * 4 + band[j], q[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kVPL; ++j) t.across<W>(acc[j]);
      if (!mine || t.sub) return;
#pragma unroll
      for (int j = 0; j < kVPL; ++j) {
        const int u = t.gl + t.G * j;
        if (share)
#pragma unroll
          for (int k = 0; k < W; ++k) share[u * W + k] = acc[j][k];
        else if (use_tile)
          blk.add<W>(r, C, u * W, acc[j]);
        else
          out[r * units + u] = U::pack(acc[j]);
      }
    };
    // a team per row, R rows a warp
    for (int r0; (r0 = blk.take(m.R)) < blk.rows;) {
      const int r = r0 + m.team;
      bool mine = r < blk.rows;
      if (mine && blk.end(r) - blk.begin(r) > 4 * kLong * m.S) {
        if (m.gl == 0 && m.sub == 0) blk.defer(r);
        mine = false;
      }
      walk(m, r, mine, 0, m.S, nullptr);
    }
    // the rows put aside, each by all the warps
    __syncthreads();
    for (int h = 0; h < blk.deferred(); ++h) {
      const int r = blk.deferred_row(h);
      walk(whole, r, true, warp * whole.S, blk.warps * whole.S,
           blk.part + warp * C);
      __syncthreads();
      for (int u = threadIdx.x; u < units; u += blockDim.x) {
        float a[W];
#pragma unroll
        for (int k = 0; k < W; ++k) a[k] = 0.f;
        for (int v = 0; v < blk.warps; ++v)
#pragma unroll
          for (int k = 0; k < W; ++k) a[k] += blk.part[v * C + u * W + k];
        if (use_tile)
          blk.add<W>(r, C, u * W, a);
        else
          out[r * units + u] = U::pack(a);
      }
      __syncthreads();
    }
    s0 += cap;
    if (s0 >= blk.share) break;
    blk.reset();
  }
  if (use_tile) blk.finish<U>(out, C, units);
}

template <bool kBf16, int kBytes, int kVPL>
cudaError_t bwd(const rowlist::Plan& p, int BH, cudaStream_t stream,
                const void* slab, const void* gi, const void* w4,
                const void* dout, void* dslab, void* dw4, int n, int N,
                int ub, long long slab_bs) {
  static bool done[64] = {};
  return rowlist::launch(quadfused_bwd_kernel<kBf16, kBytes, kVPL>, done, p,
                         BH, stream, slab, (const int*)gi, w4, dout, dslab,
                         dw4, n, N, ub, p.rows_per_tile, p.tiles, p.cap,
                         p.use_tile, p.split, slab_bs);
}

}  // namespace

// slab: BH quad slabs of (n, 4 * Dh) rows of fp32 (dtype 0) or bf16
// (dtype 1), slab b starting `slab_bs` ROWS after slab b - 1 (n for a
// contiguous array); gi (BH, N) int32; w4 (BH, N, 4) and out (BH, N, Dh)
// contiguous, in the slab's dtype. Everything 16-byte aligned; Dh / 4 a
// power of two up to 32; BH at most 65535. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int quadfused_fwd_launch(const void* slab, const void* gi,
                                    const void* w4, void* out, int BH, int n,
                                    int N, int Dh, long long slab_bs,
                                    int dtype, void* stream) {
  int lg, err;
  const dim3 grid = launch_grid(BH, N, Dh, dtype, &lg, &err);
  if (err) return err;
  if (grid.x > 0 && grid.y > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 1) {
      quadfused_fwd_kernel<true><<<grid, kThreads, 0, s>>>(
          slab, (const int*)gi, w4, out, n, N, lg, slab_bs);
    } else {
      quadfused_fwd_kernel<false><<<grid, kThreads, 0, s>>>(
          slab, (const int*)gi, w4, out, n, N, lg, slab_bs);
    }
  }
  return (int)cudaGetLastError();
}

// As above plus dout (BH, N, Dh) in the slab's dtype, and the outputs
// dslab (BH, n, 4 * Dh), contiguous, and dw4 (BH, N, 4), both in the
// slab's dtype and written whole by the kernel. The last 8 ints are the
// plan (rowlist.cuh's `Plan`) of `ops.msda_fused.sample_bwd_plan(BH, n, N,
// 4 * Dh, 0, 1)`.
extern "C" int quadfused_bwd_launch(const void* slab, const void* gi,
                                    const void* w4, const void* dout,
                                    void* dslab, void* dw4, int BH, int n,
                                    int N, int Dh, int rows_per_tile,
                                    int tiles, int cluster, int cap,
                                    int use_tile, int threads, int smem_bytes,
                                    int split, long long slab_bs, int dtype,
                                    void* stream) {
  if ((dtype != 0 && dtype != 1) || log2_groups(Dh) < 0 || BH < 0 ||
      n < 1 || 4LL * Dh * N > 0x7fffffffLL || 4LL * Dh * n > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;   // offsets in a slab are 32-bit
  if (BH == 0) return (int)cudaSuccess;
  const rowlist::Plan p = {rows_per_tile, tiles,   cluster,    cap,
                           use_tile,      threads, smem_bytes, split};
  if (const int err = rowlist::check_plan(p, n, N, 4 * Dh, 0, BH))
    return err;
  const int elt = dtype == 1 ? 2 : 4;
  const int bytes = (Dh * elt) % 16 == 0 ? 16 : 8;   // a lane's unit
  const int ub = Dh * elt / bytes, units = 4 * ub;    // units a band, a row
  const int vpl = units > 32 ? units / 32 : 1;        // units a lane
  cudaStream_t s = (cudaStream_t)stream;
#define QF_BWD(BF, BY, V)                                                   \
  bwd<BF, BY, V>(p, BH, s, slab, gi, w4, dout, dslab, dw4, n, N, ub, slab_bs)
  cudaError_t err;
  if (dtype == 1 && bytes == 8)
    err = QF_BWD(true, 8, 1);
  else if (dtype == 1)
    err = vpl == 1 ? QF_BWD(true, 16, 1) : QF_BWD(true, 16, 2);
  else
    err = vpl == 1 ? QF_BWD(false, 16, 1)
                   : vpl == 2 ? QF_BWD(false, 16, 2) : QF_BWD(false, 16, 4);
#undef QF_BWD
  return (int)err;
}
