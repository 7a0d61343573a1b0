// Fused MSDA level sample over the RAW level slab, forward and backward:
//   out[b, r, :]   = sum_c w4[b, r, c] * slab[b, gi[b, r] + shift_c, :]
//   dslab[b, s, :] = sum over (r, c) with gi[b, r] + shift_c == s of
//                    w4[b, r, c] * dout[b, r, :]
//   dw4[b, r, c]   = <dout[b, r, :], slab[b, gi[b, r] + shift_c, :]>
// with shifts (0, 1, Wl, Wl + 1), the four bilinear corners of flat cell
// gi. A corner whose index lies outside [0, HW) adds nothing to out and to
// dslab and gets dw4 = 0; it is never read.
//
// Replaces the Pallas kernels `_fused_fwd_kernel`
// (cape_tpu/ops/msda_fused.py:88, pallas_call at :165) and
// `_fused_bwd_kernel` (:99, pallas_call at :183). On the TPU the gather is
// a weighted one-hot matrix (four compares over an (R, HW) tile) times
// the slab on the MXU, because Mosaic cannot gather, and the backward
// carries dslab across sequential grid steps. Here the forward's thread
// computes gi + shift_c, tests the range and loads the row, and the
// backward's rows are owned by blocks.
//
// Bound: bytes. Forward: the slab rows the corners select, gi, w4 and
// the (BH, N, Dh) output, each once; the 8 flops a loaded value costs are
// far below the card's fp32 rate. Backward: the same reads plus dout, and
// dslab and dw4 written once. Neither writes the (BH, N, 4 * Dh) gathered
// rows that the quad-row path puts through device memory.
//
// Forward: a thread per 16 bytes of an output row (8 bf16 or 4 fp32
// values; 8 bytes where a bf16 row is), the `units` lanes of a row
// neighbours, rows of all slabs in one flat range: a warp reads each
// corner row as whole 16-byte pieces and stores 32 / units whole
// consecutive output rows, and the decode step's few rows are one short
// launch. What bounds it, measured with throwaway variants
// (built and timed beside this kernel; H100 SXM, 700 W,
// bf16, 64 slabs of 21,760 rows): with 8 bytes a thread, reading gi and
// w4 and writing the output, without any gather, took 0.046 ms, longer
// than this kernel with its gathers at the smallest level (0.043); the
// write alone takes 0.029. So the short chain of each thread (gi and w4,
// the corners, the store) sets the pace, and 16-byte lanes halve the
// chains. Taking 2 or 4 rows a thread, their loads issued together and
// the next rows' gi and w4 loaded ahead, on a grid that walks the rows,
// measured 8-22% slower: the registers it needs cost the warps that hide
// the same latency. The output, the largest array, is stored with a
// streaming hint so that it does not push the slab out of L2. Sums are
// fp32, corners 0-3 in that order, with one rounding at the store.
// Backward: the row lists of rowlist.cuh, keyed by CELL: a block owns a
// tile of raw rows [s0, s1) and lists each entry whose cell gi[r] lies in
// [s0 - Wl - 1, s1), the tile and a halo of Wl + 1 cells (an entry whose
// corners span two tiles is listed by both). The lanes of row s (a group
// of 4 lanes of 16 bytes for Dh = 32 bf16) load it once (only where an
// entry reaches it) and read the four lists of cells s, s - 1, s - Wl and
// s - Wl - 1 as corners 0-3 side by side, one entry of each in flight:
// they add w4[r, c] * dout[r] to their sums and dot dout[r] with the row,
// and the four dots are summed over the group with log2(G) + 1 shuffles.
// Every in-range (r, c) is visited once (by the owner of gi[r] + shift_c),
// so neither sum needs atomics; the blocks of tile 0 write dw4 = 0 for
// the corners outside [0, HW) while they scan. dout[r] is read by up to
// four rows, from L2. About 21 corners land on a row at the encoder's
// level 0 (one group a row), 340 a block at level 3 (HW = 64, the entries
// split over a cluster of 4; a whole warp a row).

#include <type_traits>

#include "rowlist.cuh"
#include "rows4.cuh"

using namespace rows4;

namespace {

// Forward: rows [0, R) of all slabs (R = BH * N), row r of slab r / N;
// lane u of row r is thread (r << lg) + u of the grid.
template <bool kBf16, int kBytes>
__global__ void __launch_bounds__(rowlist::kThreads)
fused_fwd_kernel(const void* __restrict__ slab, const int* __restrict__ gi,
                 const void* __restrict__ w4, void* __restrict__ out, int HW,
                 int N, int Wl, int lg, int R, long long slab_bs) {
  using U = rowlist::Unit<kBf16, kBytes>;
  using Raw = typename U::Raw;
  constexpr int V = U::kVals;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = i >> lg, u = i & ((1 << lg) - 1);
  if (r >= R) return;
  const int g = __ldg(gi + r);
  const float4 w = rows4::load4<kBf16>(w4, r);
  const Raw* sb = reinterpret_cast<const Raw*>(slab) +
                  ((long long)(r / N) * slab_bs << lg) + u;
  const int shift[4] = {0, 1, Wl, Wl + 1};
  Raw v[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const long long idx = (long long)g + shift[c];
    v[c] = idx >= 0 && idx < HW ? __ldg(sb + (idx << lg)) : U::zero();
  }
  const float wc[4] = {w.x, w.y, w.z, w.w};
  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float x[V];
    U::unpack(v[c], x);
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] += wc[c] * x[k];
  }
  __stcs(reinterpret_cast<Raw*>(out) + i, U::pack(acc));
}

// The backward on cell lists (rowlist.cuh): keys are cells, the tile's
// rows and the Wl + 1 cells below them. A group of G = `units` lanes (a
// raw row's units of W values, at most a warp) holds a row s; the groups
// of its team (`split` of them) take other entries of the lists of cells
// s, s - 1, s - Wl, s - Wl - 1, corners 0, 1, 2, 3.
template <bool kBf16, int kBytes>
__global__ void __launch_bounds__(rowlist::kThreads, 2)
fused_bwd_kernel(const void* __restrict__ slab, const int* __restrict__ gi,
                 const void* __restrict__ w4, const void* __restrict__ dout,
                 void* __restrict__ dslab, void* __restrict__ dw4, int HW,
                 int N, int Wl, int units, int rows_per_tile, int tiles,
                 int cap, int use_tile, int split, long long slab_bs) {
  using namespace rowlist;
  extern __shared__ __align__(16) unsigned char smem[];
  using U = Unit<kBf16, kBytes>;
  using Raw = typename U::Raw;
  using T = typename std::conditional<kBf16, __nv_bfloat16, float>::type;
  constexpr int W = U::kVals;
  const int C = units * W, halo = Wl + 1;
  Block blk(smem, use_tile, HW, N, C, rows_per_tile, tiles, cap, halo);
  const Team m(units, split);  // G == units
  // this slab's arrays, so that offsets within them are 32-bit
  const long long b = blk.b;
  const Raw* slabb = reinterpret_cast<const Raw*>(slab) +
                     (b * slab_bs + blk.row0) * units + m.gl;
  const Raw* doutb =
      reinterpret_cast<const Raw*>(dout) + b * N * units + m.gl;
  const T* w4b = reinterpret_cast<const T*>(w4) + b * N * 4;
  T* dw4b = reinterpret_cast<T*>(dw4) + b * N * 4;
  Raw* out = reinterpret_cast<Raw*>(dslab) + (b * HW + blk.row0) * units;
  const int shift[4] = {0, 1, Wl, Wl + 1};
  const bool first_tile = blk.tile == 0;

  for (int s0 = 0;;) {
    // a corner outside [0, HW) is read by no row: tile 0 writes its dw4
    blk.sort(gi + b * N, s0, [&](int i, int v) {
      if (!first_tile) return;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const long long t = (long long)v + shift[c];
        if (t < 0 || t >= HW) store1<kBf16>(dw4b, i * 4 + c, 0.f);
      }
    });
    // one row: the groups of team t take positions sub + k * S of each of
    // its four lists, one of each list in flight a lane (corner c from the
    // list of cell s - shift_c)
    auto walk = [&](const Team& t, int r, bool mine) {
      int a[4], len[4];
      int most = 0;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int k = r + halo - shift[c];
        a[c] = mine ? blk.begin(k) : 0;
        len[c] = mine ? blk.end(k) - a[c] : 0;
        most = max(most, len[c]);
      }
      // the warp's teams go in step
      const int steps = __reduce_max_sync(0xffffffffu, most);
      float acc[W], sv[W];
#pragma unroll
      for (int k = 0; k < W; ++k) acc[k] = 0.f;
      // the slab row, read once, and only for a row that entries reach
      if (most > 0) U::unpack(__ldg(slabb + r * units), sv);
      for (int k0 = 0; k0 < steps; k0 += t.S) {
        const int pos = k0 + t.sub;
        int i[4];
        Raw d[4];
        float w[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          i[c] = pos < len[c] ? blk.at(s0 + blk.list[a[c] + pos]) : -1;
          d[c] = i[c] >= 0 ? __ldg(doutb + i[c] * units) : U::zero();
          w[c] = i[c] >= 0 ? load1<kBf16>(w4b, i[c] * 4 + c) : 0.f;
        }
        float q[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float dv[W];
          U::unpack(d[c], dv);
          q[c] = 0.f;
#pragma unroll
          for (int k = 0; k < W; ++k) {
            acc[k] += w[c] * dv[k];
            q[c] += dv[k] * sv[k];
          }
        }
        // dw4 of the four entries: each dot summed over its group
        t.sum4(q, [&](int c, float v) {
          const int ic = c == 0 ? i[0] : c == 1 ? i[1] : c == 2 ? i[2] : i[3];
          if (ic >= 0) store1<kBf16>(dw4b, ic * 4 + c, v);
        });
      }
      t.across<W>(acc);
      if (!mine || t.sub) return;
      if (use_tile)
        blk.add<W>(r, C, t.gl * W, acc);
      else
        out[r * units + t.gl] = U::pack(acc);
    };
    // a team per row, R rows a warp (putting long rows aside for the whole
    // block, as quadfused.cu does, measured slower here)
    for (int r0; (r0 = blk.take(m.R)) < blk.rows;) {
      const int r = r0 + m.team;
      walk(m, r, r < blk.rows);
    }
    s0 += cap;
    if (s0 >= blk.share) break;
    blk.reset();
  }
  if (use_tile) blk.finish<U>(out, C, units);
}

template <bool kBf16, int kBytes>
cudaError_t bwd(const rowlist::Plan& p, int BH, cudaStream_t stream,
                const void* slab, const void* gi, const void* w4,
                const void* dout, void* dslab, void* dw4, int HW, int N,
                int Wl, int units, long long slab_bs) {
  static bool done[64] = {};
  return rowlist::launch(fused_bwd_kernel<kBf16, kBytes>, done, p, BH,
                         stream, slab, (const int*)gi, w4, dout, dslab, dw4,
                         HW, N, Wl, units, p.rows_per_tile, p.tiles, p.cap,
                         p.use_tile, p.split, slab_bs);
}

}  // namespace

// slab: BH level slabs of (HW, Dh) rows of fp32 (dtype 0) or bf16
// (dtype 1), slab b starting `slab_bs` ROWS after slab b - 1 (HW for a
// contiguous array); gi (BH, N) int32; w4 (BH, N, 4) and out (BH, N, Dh)
// contiguous, in the slab's dtype. Everything 16-byte aligned; Dh / 4 a
// power of two up to 32. `units` lanes a row, `threads` a block and
// `blocks` are the plan's (`ops.msda_fused.sample_fwd_plan`). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments it does not
// take.
extern "C" int fused_fwd_launch(const void* slab, const void* gi,
                                const void* w4, void* out, int BH, int HW,
                                int N, int Wl, int Dh, int units, int threads,
                                int blocks, long long slab_bs, int dtype,
                                void* stream) {
  const int elt = dtype == 1 ? 2 : 4;
  const int bytes = (Dh * elt) % 16 == 0 ? 16 : 8;   // a lane's unit
  int lg = 0;
  while (lg < 5 && (1 << lg) < units) ++lg;
  const long long R = (long long)BH * N;
  if ((dtype != 0 && dtype != 1) || log2_groups(Dh) < 0 || BH < 0 ||
      N < 0 || HW < 0 || Wl < 1 || Dh * elt != units * bytes ||
      (1 << lg) != units || threads > rowlist::kThreads || threads < 32 ||
      threads % 32 || blocks < 0 || (long long)blocks * threads < R * units ||
      (long long)blocks * threads > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;   // lane indices are 32-bit
  if (R == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const int n = (int)R;
  if (dtype == 1 && bytes == 8)
    fused_fwd_kernel<true, 8><<<blocks, threads, 0, s>>>(
        slab, (const int*)gi, w4, out, HW, N, Wl, lg, n, slab_bs);
  else if (dtype == 1)
    fused_fwd_kernel<true, 16><<<blocks, threads, 0, s>>>(
        slab, (const int*)gi, w4, out, HW, N, Wl, lg, n, slab_bs);
  else
    fused_fwd_kernel<false, 16><<<blocks, threads, 0, s>>>(
        slab, (const int*)gi, w4, out, HW, N, Wl, lg, n, slab_bs);
  return (int)cudaGetLastError();
}

// As above plus dout (BH, N, Dh) in the slab's dtype, and the outputs
// dslab (BH, HW, Dh), contiguous, and dw4 (BH, N, 4), both in the slab's
// dtype and written whole by the kernel. The last 8 ints are the plan
// (rowlist.cuh's `Plan`) of `ops.msda_fused.sample_bwd_plan(BH, HW, N, Dh,
// Wl + 1, 4)`.
extern "C" int fused_bwd_launch(const void* slab, const void* gi,
                                const void* w4, const void* dout,
                                void* dslab, void* dw4, int BH, int HW,
                                int N, int Wl, int Dh, int rows_per_tile,
                                int tiles, int cluster, int cap, int use_tile,
                                int threads, int smem_bytes, int split,
                                long long slab_bs, int dtype, void* stream) {
  if ((dtype != 0 && dtype != 1) || log2_groups(Dh) < 0 || BH < 0 ||
      HW < 1 || Wl < 1 || 4LL * Dh * N > 0x7fffffffLL ||
      (long long)Dh * HW > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;   // offsets in a slab are 32-bit
  if (BH == 0) return (int)cudaSuccess;
  const rowlist::Plan p = {rows_per_tile, tiles,   cluster,    cap,
                           use_tile,      threads, smem_bytes, split};
  if (const int err = rowlist::check_plan(p, HW, N, Dh, Wl + 1, BH))
    return err;
  const int elt = dtype == 1 ? 2 : 4;
  const int bytes = (Dh * elt) % 16 == 0 ? 16 : 8;   // a lane's unit
  const int units = Dh * elt / bytes;                 // at most 32
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (dtype == 1 && bytes == 8)
    err = bwd<true, 8>(p, BH, s, slab, gi, w4, dout, dslab, dw4, HW, N, Wl,
                       units, slab_bs);
  else if (dtype == 1)
    err = bwd<true, 16>(p, BH, s, slab, gi, w4, dout, dslab, dw4, HW, N, Wl,
                        units, slab_bs);
  else
    err = bwd<false, 16>(p, BH, s, slab, gi, w4, dout, dslab, dw4, HW, N,
                         Wl, units, slab_bs);
  return (int)err;
}
