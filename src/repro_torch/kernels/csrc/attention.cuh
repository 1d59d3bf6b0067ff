// Shared device code of the attention kernels: 16-byte loads of bf16 or
// f32 rows into f32 registers, 64-row tiles staged in shared memory as
// f32 (row-major or transposed), f32 stores back to the input type, and
// half-warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace repro {

constexpr float kNegInf = -1e30f;   // the reference's masked score

// Elements per 16-byte vector load.
template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));

__device__ __forceinline__ void load_vec(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* o) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Round to nearest even, as torch's .to(bfloat16) does.
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// N consecutive floats from shared memory, as wide loads where aligned.
template <int N>
__device__ __forceinline__ void load_smem(const float* p, float* o) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      o[i] = v.x; o[i + 1] = v.y; o[i + 2] = v.z; o[i + 3] = v.w;
    }
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    o[0] = v.x; o[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = p[i];
  }
}

// Rows [row0, row0 + 64) of a (L, D) matrix into dst[d][r] (stride 64),
// zeros past L. Consecutive threads take consecutive rows, so the
// transposed stores hit consecutive banks.
template <typename T, int D, int THREADS>
__device__ __forceinline__ void load_transposed(const T* __restrict__ src,
                                                int row0, int L,
                                                float* __restrict__ dst,
                                                int tid) {
  constexpr int V = kVec<T>;
  constexpr int CH = D / V;
#pragma unroll
  for (int i = tid; i < 64 * CH; i += THREADS) {
    const int r = i % 64, ch = i / 64;
    float x[V];
    if (row0 + r < L) {
      load_vec(src + (size_t)(row0 + r) * D + ch * V, x);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) dst[(ch * V + e) * 64 + r] = x[e];
  }
}

// Rows [row0, row0 + 64) of a (L, D) matrix into dst[r][d], zeros past L;
// coalesced loads.
template <typename T, int D, int THREADS>
__device__ __forceinline__ void load_rows(const T* __restrict__ src,
                                          int row0, int L,
                                          float* __restrict__ dst, int tid) {
  constexpr int V = kVec<T>;
  constexpr int CH = D / V;
#pragma unroll
  for (int i = tid; i < 64 * CH; i += THREADS) {
    const int r = i / CH, ch = i % CH;
    float x[V];
    if (row0 + r < L) {
      load_vec(src + (size_t)(row0 + r) * D + ch * V, x);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) dst[r * D + ch * V + e] = x[e];
  }
}

// Reductions over the `width` lanes of an aligned lane group.
template <int width>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = width / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int width>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = width / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace repro
