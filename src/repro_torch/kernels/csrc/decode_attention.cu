// Decode attention: one query token per (batch row, q head) against a KV
// cache, each batch row with its own valid length; out and log-sum-exp.
//
// Replaces the TPU kernel repro/kernels/decode_attention/kernel.py:
// decode_attention_pallas (body _kernel). Same outputs: out (B, Hq, D) in
// the input type, lse (B, Hq) in f32; cache rows >= cache_len[b] are
// ignored (a row of length 0 gives out 0, as the TPU kernel does).
//
// What bounds it on the card: bytes. Each call reads the valid prefix of
// K and V once (at B = 4, 2 kv heads, width 64, 512 rows: 1 MB in bf16)
// for 2 * Hq * D FLOPs per row: about 7 FLOPs per byte, far below the
// card's ~295. The TPU kernel grouped the G query heads that share a kv
// head into the rows of one (G x D) @ (D x BK) product so that each K/V
// tile is fetched once for all of them; this kernel keeps that grouping:
// one block per (kv head, batch row) stages each 64-row K/V tile in
// shared memory once and all G query heads use it. The loop runs over
// the row's valid prefix only, with the online softmax in f32 (running
// max, sum and rescale kept per head in shared memory). With B * Hkv = 8
// blocks at the generator's shapes the card is mostly idle: splitting
// the cache over more blocks and merging with the lse (flash-decoding,
// ref.py's combine_partial_attention) is the next step for speed.
#include "attention.cuh"

namespace {

using repro::kNegInf;

constexpr int BK = 64;                 // cache rows per tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_OUT = 4;             // outputs per thread: G * D <= 1024

template <int D>
size_t smem_bytes(int G) {
  // Qs [G][D], Ks [BK][D + 1], Vs [BK][D], Ss [G][BK], m/l/alpha [G] each
  return sizeof(float) *
         ((size_t)G * D + BK * (D + 1) + BK * D + (size_t)G * BK + 3 * G);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ cache_len,
              T* __restrict__ out, float* __restrict__ lse, int Hq, int Hkv,
              int S, float scale) {
  constexpr int KS = D + 1;            // odd stride: conflict-free K reads
  constexpr int V = repro::kVec<T>;
  constexpr int CH = D / V;
  const int G = Hq / Hkv;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + G * D;
  float* Vs = Ks + BK * KS;
  float* Ss = Vs + BK * D;
  float* Ms = Ss + G * BK;
  float* Ls = Ms + G;
  float* As = Ls + G;

  const int n = min(max(cache_len[b], 0), S);
  const size_t q_off = ((size_t)b * Hq + (size_t)hk * G) * D;
  for (int i = tid; i < G * D; i += THREADS)
    Qs[i] = repro::to_float(q[q_off + i]);
  for (int g = tid; g < G; g += THREADS) {
    Ms[g] = kNegInf;
    Ls[g] = 0.f;
  }
  float acc[MAX_OUT];
#pragma unroll
  for (int o = 0; o < MAX_OUT; ++o) acc[o] = 0.f;

  const size_t kv_off = ((size_t)b * Hkv + hk) * S * D;
  const T* kb = k + kv_off;
  const T* vb = v + kv_off;
  for (int k0 = 0; k0 < n; k0 += BK) {
    const int rows = min(BK, n - k0);
    __syncthreads();                   // last tile's readers are done
    for (int i = tid; i < BK * CH; i += THREADS) {
      const int r = i / CH, ch = i % CH;
      float xk[V], xv[V];
      if (r < rows) {
        repro::load_vec(kb + (size_t)(k0 + r) * D + ch * V, xk);
        repro::load_vec(vb + (size_t)(k0 + r) * D + ch * V, xv);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) xk[e] = xv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        Ks[r * KS + ch * V + e] = xk[e];
        Vs[r * D + ch * V + e] = xv[e];
      }
    }
    __syncthreads();

    // scores: consecutive threads take consecutive cache rows of one head
    for (int i = tid; i < G * BK; i += THREADS) {
      const int g = i / BK, c = i % BK;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s = fmaf(Qs[g * D + d], Ks[c * KS + d], s);
      Ss[i] = c < rows ? s * scale : kNegInf;
    }
    __syncthreads();

    // online softmax: one warp per head, two rows per lane
    for (int g = warp; g < G; g += WARPS) {
      float* sg = Ss + g * BK;
      const float a = sg[lane], c = sg[lane + 32];
      const float mo = Ms[g];
      const float mn = fmaxf(mo, repro::group_max<32>(fmaxf(a, c)));
      const float pa = expf(a - mn), pc = expf(c - mn);
      sg[lane] = pa;
      sg[lane + 32] = pc;
      const float sum = repro::group_sum<32>(pa + pc);
      if (lane == 0) {
        const float alpha = expf(mo - mn);
        As[g] = alpha;
        Ls[g] = Ls[g] * alpha + sum;
        Ms[g] = mn;
      }
    }
    __syncthreads();

    // P.V: consecutive threads take consecutive columns of one head
#pragma unroll
    for (int o = 0; o < MAX_OUT; ++o) {
      const int i = tid + o * THREADS;
      if (i < G * D) {
        const int g = i / D, d = i % D;
        const float* pg = Ss + g * BK;
        float x = acc[o] * As[g];
        for (int c = 0; c < rows; ++c) x = fmaf(pg[c], Vs[c * D + d], x);
        acc[o] = x;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int o = 0; o < MAX_OUT; ++o) {
    const int i = tid + o * THREADS;
    if (i < G * D)
      repro::store_as(out + q_off + i, acc[o] / fmaxf(Ls[i / D], 1e-30f));
  }
  for (int g = tid; g < G; g += THREADS)
    lse[(size_t)b * Hq + (size_t)hk * G + g] =
        Ms[g] + logf(fmaxf(Ls[g], 1e-30f));
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v,
           const void* cache_len, void* out, void* lse, int B, int Hq,
           int Hkv, int S, float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  if (G * D > MAX_OUT * THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<D>(G);
  auto kern = decode_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<dim3(Hkv, B), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(cache_len),
      static_cast<T*>(out), static_cast<float*>(lse), Hq, Hkv, S, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. D: 32 or 64. Tensors contiguous,
// q (B, Hq, D), k/v (B, Hkv, S, D), cache_len int32 (B,), out like q,
// lse (B, Hq).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* cache_len,
    void* out, void* lse, int B, int Hq, int Hkv, int S, int D, int dtype,
    float scale, void* stream) {
  if (B == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_DECODE_CASE(T, CODE, DIM)                                     \
  if (dtype == CODE && D == DIM)                                            \
    return launch<T, DIM>(q, k, v, cache_len, out, lse, B, Hq, Hkv, S,      \
                          scale, s);
  REPRO_DECODE_CASE(float, 0, 32)
  REPRO_DECODE_CASE(float, 0, 64)
  REPRO_DECODE_CASE(__nv_bfloat16, 1, 32)
  REPRO_DECODE_CASE(__nv_bfloat16, 1, 64)
#undef REPRO_DECODE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
