// Whole multi-scale deformable attention forward, from the sampling
// locations to the output in one kernel:
//   out[b, q, h*Dh:(h+1)*Dh] = sum over levels l, points p and the four
//       bilinear corners c of attn[b, q, h, l, p] * bilin_c * valid_c *
//       value[b, start_l + cy_c * W_l + cx_c, h, :]
// with grid_sample's align_corners=False zeros padding: x = loc_x * W_l -
// 0.5, y = loc_y * H_l - 0.5, corners (floor(x) + {0, 1}, floor(y) +
// {0, 1}), each valid when it lies inside the level.
//
// Replaces the Pallas kernel `_msda_kernel` (cape_tpu/ops/msda_pallas.py:48,
// pallas_call at :133), which takes the clipped flat corner indices,
// bilinear x attention weights and validity mask prepared in XLA (12 bytes
// a corner) and gathers from one (b, h) value slab held in VMEM.
//
// Bound: bytes. What the op must move is the sampling locations (8 bytes
// a point), the attention weights (2 bytes a point in bf16), the value rows
// the corners select and the output: about 100 MB at the serving encoder's
// batch of 8 (0.03 ms at 3.35 TB/s), where the prepared corners alone
// were 267 MB. So the corners are computed here, in registers, and never
// stored; the value is read in the (B, S, H, Dh) layout the projection
// writes and the output written as (B, Lq, H*Dh), so that neither needs a
// transpose.
//
// Design. A lane owns 16 bytes of an output row of H*Dh values (8 bf16 or 4
// fp32; `rowlist::Unit`): the G = Dh * elt / 16 lanes of a head (a power
// of two up to 32, so a head never spans two warps), and the H*G lanes of
// a query, are neighbours, so a thread's unit of the output is its global
// index and a warp stores whole rows (one 512-byte row a warp at H = 8,
// Dh = 32, bf16). Consecutive queries are consecutive warps: the
// encoder's queries are the cells of its levels in raster order, so the
// neighbouring queries of a block sample neighbouring cells and L1 serves
// the repeats. A head's lanes walk its L*P points in rounds of
// R = min(G, kChunk) points: lane u reads the location and weight of point
// u % R alone, does its corner math in fp32 and puts the four weights and
// the top-left row into shared memory, where every lane of the head reads
// the R points' corners (the corner math is done once a point, not once a
// lane); then each lane issues the loads of all 4*R corners at once (16
// independent 16-byte loads in flight a lane at R = 4), skipping a corner
// that lies outside its level or whose weight is 0, and loads the next
// round's location and weight before the round's multiply-adds. Sums are
// fp32, rounded once at the store. The corner math rounds as PyTorch does
// (`__fmul_rn`, `__fsub_rn`: no contraction into an FMA), so the corners
// chosen and their weights are those of the plain version
// (`ops/msda_kernel.py`), bit for bit, and only the order of the sum
// differs.
//
// Measured (throwaway builds timed beside this one; H100
// SXM, 700 W, bf16, the serving encoder's 8 x 5440 queries): 0.17 ms
// with model-like locations, 0.14 with uniform ones (15 of 16 corners
// skipped), 0.06 with no value load at all. The multiply-adds and bf16
// unpacking (16 instructions a corner a lane) and the corner math keep it
// bound by instructions at 0.14; with model-like locations the 22 M
// fetches of 64-byte head rows through L1 take about as long. Not kept
// (model-like locations): branches that skip the multiply-adds of a
// skipped corner, with blocks of 512 threads and the level table in
// shared memory (30% slower; 33% with the blocks taking 4 x 4 patches of
// queries), two rounds of loads in flight (14%), 80 or 64 registers a
// thread (spills; 51%, 116%); 2 points a round measured the same.

#include "rowlist.cuh"

namespace {

constexpr int kMaxLevels = 8;
constexpr int kChunk = 4;     // points whose corners are loaded together
constexpr int kThreads = 256;

struct Levels {
  int h[kMaxLevels], w[kMaxLevels], start[kMaxLevels];
};

// One point's corners: the flat value row of its top-left corner and the
// four weights (bilinear x attention, 0 where the corner lies outside its
// level), in the order (0, 0), (1, 0), (0, 1), (1, 1).
struct Corners {
  float4 w;
  int base;
};

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
msda_forward_kernel(const void* __restrict__ value,
                    const float2* __restrict__ loc,
                    const void* __restrict__ attn, void* __restrict__ out,
                    const Levels lv, int S, int Lq, int H, int L, int P,
                    int G, int n_lanes) {
  using U = rowlist::Unit<kBf16, 16>;
  using Raw = typename U::Raw;
  constexpr int V = U::kVals;
  __shared__ Corners sh[kThreads];
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  // a whole warp stays to the end: its lanes share corners through `sh`
  const bool live = t < n_lanes;
  const int Q = H * G;     // lanes a query
  const int qr = live ? t / Q : 0;    // (b, q)
  const int j = t - qr * Q;           // lane within the query
  const int h = j / G, unit = j - h * G;
  const int b = qr / Lq;
  // the lane's unit of value row 0 of batch b; row s is s * Q units on
  const Raw* vb =
      reinterpret_cast<const Raw*>(value) + (long long)b * S * Q + j;
  const long long p0 = ((long long)qr * H + h) * L * P;  // first point
  // the R = min(G, kChunk) points of a round are computed by the first R
  // lanes of the head (lane `unit` computes point unit % R) and read by all
  const int R = G < kChunk ? G : kChunk;
  const int mine = unit % R;
  const Corners* head = sh + (threadIdx.x - unit);

  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.f;

  // the lane's own point of the round at (l, p): location and weight
  float2 xy = make_float2(0.f, 0.f);
  float a = 0.f;
  auto fetch = [&](int l, int p) {
    const bool ok = live && p + mine < P;
    const long long k = p0 + l * P + p + mine;
    xy = ok ? __ldg(loc + k) : make_float2(0.f, 0.f);
    a = ok ? rowlist::load1<kBf16>(attn, k) : 0.f;
  };

  int l = 0, p = 0;
  fetch(0, 0);
  while (l < L) {
    // the level's entry, by constant indices (a dynamic index into the
    // parameters would copy them to local memory)
    int Hl = 0, Wl = 0, st = 0;
#pragma unroll
    for (int m = 0; m < kMaxLevels; ++m)
      if (m == l) {
        Hl = lv.h[m];
        Wl = lv.w[m];
        st = lv.start[m];
      }
    {
      const float fW = (float)Wl, fH = (float)Hl;
      const float x = __fsub_rn(__fmul_rn(xy.x, fW), 0.5f);
      const float y = __fsub_rn(__fmul_rn(xy.y, fH), 0.5f);
      const float x0 = floorf(x), y0 = floorf(y);
      const float fx = __fsub_rn(x, x0), fy = __fsub_rn(y, y0);
      const float gx = __fsub_rn(1.f, fx), gy = __fsub_rn(1.f, fy);
      // clamped so that the int conversion is exact; a corner outside the
      // level stays outside (and NaN becomes an invalid -2)
      const int xi = (int)fminf(fmaxf(x0, -2.f), fW);
      const int yi = (int)fminf(fmaxf(y0, -2.f), fH);
      const bool vx0 = xi >= 0 && xi < Wl, vx1 = xi + 1 >= 0 && xi + 1 < Wl;
      const bool vy0 = yi >= 0 && yi < Hl, vy1 = yi + 1 >= 0 && yi + 1 < Hl;
      Corners c;
      c.base = st + yi * Wl + xi;
      c.w.x = vx0 && vy0 ? __fmul_rn(__fmul_rn(gx, gy), a) : 0.f;
      c.w.y = vx1 && vy0 ? __fmul_rn(__fmul_rn(fx, gy), a) : 0.f;
      c.w.z = vx0 && vy1 ? __fmul_rn(__fmul_rn(gx, fy), a) : 0.f;
      c.w.w = vx1 && vy1 ? __fmul_rn(__fmul_rn(fx, fy), a) : 0.f;
      __syncwarp();              // the last round's reads are done
      sh[threadIdx.x] = c;
      __syncwarp();
    }
    const int shift[4] = {0, 1, Wl, Wl + 1};
    float wt[kChunk][4];
    Raw v[kChunk][4];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const Corners c = i < R ? head[i] : Corners{};
      wt[i][0] = c.w.x;
      wt[i][1] = c.w.y;
      wt[i][2] = c.w.z;
      wt[i][3] = c.w.w;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[i][k] = wt[i][k] != 0.f ? __ldg(vb + (c.base + shift[k]) * Q)
                                  : U::zero();
    }
    // the next round's location and weight, while the corners load
    p += R;
    if (p >= P) {
      p = 0;
      ++l;
    }
    if (l < L) fetch(l, p);
#pragma unroll
    for (int i = 0; i < kChunk; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float x[V];
        U::unpack(v[i][k], x);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = fmaf(wt[i][k], x[e], acc[e]);
      }
  }
  if (live) reinterpret_cast<Raw*>(out)[t] = U::pack(acc);
}

template <bool kBf16>
cudaError_t launch(const void* value, const void* loc, const void* attn,
                   void* out, const Levels& lv, int S, int Lq, int H, int L,
                   int P, int G, int n_lanes, int threads, int blocks,
                   cudaStream_t stream) {
  msda_forward_kernel<kBf16><<<blocks, threads, 0, stream>>>(
      value, (const float2*)loc, attn, out, lv, S, Lq, H, L, P, G, n_lanes);
  return cudaGetLastError();
}

}  // namespace

// value (B, S, H, Dh) and out (B, Lq, H*Dh) in one dtype (0 = fp32,
// 1 = bf16), loc (B, Lq, H, L, P, 2) fp32, attn (B, Lq, H, L, P) in the
// value's dtype; all contiguous and 16-byte aligned. `shapes` holds the L
// levels' (height, width) pairs, whose cells are the first of the S. The
// launch geometry (G lanes a head, `threads` a block, `blocks`) is
// `ops.msda_kernel.msda_plan`'s. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int msda_forward_launch(const void* value, const void* loc,
                                   const void* attn, void* out,
                                   const int* shapes, int B, int S, int Lq,
                                   int H, int L, int P, int Dh, int G,
                                   int threads, long long blocks, int dtype,
                                   void* stream) {
  const int vals = dtype == 1 ? 8 : 4;
  if ((dtype != 0 && dtype != 1) || L < 1 || L > kMaxLevels || P < 1 ||
      B < 0 || Lq < 0 || H < 1 || Dh != G * vals || G > 32 || (G & (G - 1)) ||
      threads < 32 ||
      threads > kThreads || threads % 32 ||
      (long long)S * H * G > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Levels lv = {};
  int start = 0;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = shapes[2 * l];
    lv.w[l] = shapes[2 * l + 1];
    if (lv.h[l] < 1 || lv.w[l] < 1) return (int)cudaErrorInvalidValue;
    lv.start[l] = start;
    start += lv.h[l] * lv.w[l];
  }
  if (start > S) return (int)cudaErrorInvalidValue;
  // a lane's index, its query's and its value offset are 32-bit
  const long long n_lanes = (long long)B * Lq * H * G;
  if (n_lanes + threads > 0x7fffffffLL || blocks * threads < n_lanes)
    return (int)cudaErrorInvalidValue;
  if (n_lanes == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const int n = (int)n_lanes, nb = (int)blocks;
  cudaError_t err =
      dtype == 1 ? launch<true>(value, loc, attn, out, lv, S, Lq, H, L, P, G,
                                n, threads, nb, s)
                 : launch<false>(value, loc, attn, out, lv, S, Lq, H, L, P,
                                 G, n, threads, nb, s);
  return (int)err;
}
