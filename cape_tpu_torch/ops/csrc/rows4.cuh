// Shared by the forward kernels of fused.cu and quadfused.cu: a thread's
// unit of work is a group of 4 consecutive values of a row, moved in one
// 8-byte (bf16) or 16-byte (fp32) access and held as fp32 in registers.
// Group index `i` counts groups from the start of the array, so the array
// must be 16-byte aligned and every row a whole number of groups.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rows4 {

template <bool kBf16>
__device__ __forceinline__ float4 load4(const void* __restrict__ p,
                                        long long i) {
  if constexpr (kBf16) {
    // a bf16 is the top half of an fp32: value 2k is the low half of
    // word k, value 2k+1 the high half
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p) + i);
    return make_float4(__uint_as_float(x.x << 16),
                       __uint_as_float(x.x & 0xffff0000u),
                       __uint_as_float(x.y << 16),
                       __uint_as_float(x.y & 0xffff0000u));
  } else {
    return __ldg(reinterpret_cast<const float4*>(p) + i);
  }
}

// One rounding (to nearest even) for bf16; fp32 is stored as it is.
template <bool kBf16>
__device__ __forceinline__ void store4(void* __restrict__ p, long long i,
                                       float4 v) {
  if constexpr (kBf16) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 x;
    x.x = *reinterpret_cast<const uint32_t*>(&lo);
    x.y = *reinterpret_cast<const uint32_t*>(&hi);
    reinterpret_cast<uint2*>(p)[i] = x;
  } else {
    reinterpret_cast<float4*>(p)[i] = v;
  }
}

__device__ __forceinline__ void fma4(float4& acc, float w, float4 v) {
  acc.x += w * v.x;
  acc.y += w * v.y;
  acc.z += w * v.z;
  acc.w += w * v.w;
}

// Launch geometry of the two forward kernels: blockIdx.y is the slab,
// blockIdx.x * kThreads + threadIdx.x the group within the slab's N rows.
constexpr int kThreads = 256;

// log2 of Dh / 4 when Dh / 4 is a power of two in [1, 32], else -1.
inline int log2_groups(int Dh) {
  if (Dh <= 0 || Dh % 4) return -1;
  const int gpr = Dh / 4;
  for (int lg = 0; lg <= 5; ++lg)
    if ((1 << lg) == gpr) return lg;
  return -1;
}

// The grid for BH slabs of N rows of Dh values, or *err set to
// cudaErrorInvalidValue for arguments the kernels do not take.
inline dim3 launch_grid(int BH, int N, int Dh, int dtype, int* lg, int* err) {
  *lg = log2_groups(Dh);
  const long long groups = (long long)N << (*lg < 0 ? 0 : *lg);
  if (*lg < 0 || (dtype != 0 && dtype != 1) || BH < 0 || BH > 65535 ||
      N < 0 || groups > 0x7fffffffLL - kThreads) {
    *err = (int)cudaErrorInvalidValue;
    return dim3(0, 0, 1);
  }
  *err = 0;
  return dim3((unsigned)((groups + kThreads - 1) / kThreads), (unsigned)BH, 1);
}

}  // namespace rows4
