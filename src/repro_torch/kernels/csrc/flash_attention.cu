// Flash attention forward: causal (or full) GQA attention with its
// log-sum-exp, online softmax over key tiles.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py:
// flash_attention_fwd_pallas (body _fwd_kernel). Same outputs: out in the
// input type, lse = m + log(l) in f32, causal positions right-aligned
// (query i sits at Lkv - Lq + i), masked scores -1e30 as in the reference.
//
// What bounds it on the card: at the prefill shapes of the generator
// (B = 4, 14 query / 2 kv heads of width 64, L <= 512) a call moves a few
// MB and does about a GFLOP, so on paper neither bytes nor operations take
// more than a few microseconds. This first kernel does the products in f32
// on the CUDA cores, as the TPU kernel does them in f32 from bf16 inputs
// (kernel.py:47-62), so it agrees with the plain version to f32 rounding;
// it is bound by f32 FMA issue and shared-memory traffic, well above the
// tensor-core bound. Moving QK^T and P.V to bf16 wgmma is a later change.
//
// Design. One block of 256 threads per (query tile of 64 rows, q head,
// batch row); the kv head is h / (Hq / Hkv). The TPU kernel carried
// (m, l, acc) in VMEM across a sequential grid axis of kv tiles; here one
// block loops over the kv tiles itself and keeps them in registers. Q is
// staged once in shared memory, each K/V tile of 64 rows per step, all as
// f32: K and Q transposed ([d][row]) so that each thread's 4x4 register
// tile of scores reads two float4 per d. Thread (ty, tx) owns query rows
// 4ty..4ty+3 and key columns 4tx..4tx+3 of a tile; the 16 threads of a row
// group sit in one half-warp, so row max and sum are shuffles. P goes
// through shared memory to the P.V product, where the same thread owns
// D/16 output columns of its 4 rows. Fully masked causal tiles are not
// visited: the loop ends at the tile's last visible key. Ragged lengths
// need no padding: rows and keys past the end are masked.
#include "attention.cuh"

namespace {

using repro::kNegInf;

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;    // 16 x 16 threads, 4 x 4 scores each
constexpr int PS = BK + 4;      // row stride of P (keeps float4 alignment)

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(D * BQ + D * BK + BK * D + BQ * PS);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int Hq, int Hkv, int Lq, int Lkv,
                 int causal, float scale) {
  constexpr int DPT = D / 16;   // output columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [D][BQ]
  float* Ks = Qs + D * BQ;                       // [D][BK]
  float* Vs = Ks + D * BK;                       // [BK][D]
  float* Ps = Vs + BK * D;                       // [BQ][PS]

  const int nqt = (Lq + BQ - 1) / BQ;
  const int q0 = (nqt - 1 - (int)blockIdx.x) * BQ;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int off = Lkv - Lq;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  const size_t bh = (size_t)b * Hq + h;
  const T* qb = q + bh * Lq * D;
  const T* kb = k + ((size_t)b * Hkv + hk) * Lkv * D;
  const T* vb = v + ((size_t)b * Hkv + hk) * Lkv * D;

  repro::load_transposed<T, D, THREADS>(qb, q0, Lq, Qs, tid);

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) acc[i][dd] = 0.f;
  }

  // keys past the tile's last query position are masked for every row
  const int kend = causal ? min(Lkv, q0 + BQ + off) : Lkv;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();            // last tile's readers are done
    repro::load_transposed<T, D, THREADS>(kb, k0, Lkv, Ks, tid);
    repro::load_rows<T, D, THREADS>(vb, k0, Lkv, Vs, tid);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qs[d * BQ + ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&Ks[d * BK + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i + off;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        const bool ok = kpos < Lkv && (!causal || kpos <= qpos);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = repro::group_max<16>(mx);
      const float mn = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - mn);
        rs += s[i][j];
      }
      rs = repro::group_sum<16>(rs);
      l[i] = l[i] * alpha + rs;
      m[i] = mn;
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) acc[i][dd] *= alpha;
      *reinterpret_cast<float4*>(&Ps[(ty * 4 + i) * PS + tx * 4]) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        repro::load_smem<4>(&Ps[(ty * 4 + i) * PS + c], p[i]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[DPT];
        repro::load_smem<DPT>(&Vs[(c + jj) * D + tx * DPT], vv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int dd = 0; dd < DPT; ++dd)
            acc[i][dd] = fmaf(p[i][jj], vv[dd], acc[i][dd]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Lq) continue;
    const float li = fmaxf(l[i], 1e-30f);
    T* o = out + (bh * Lq + r) * D + tx * DPT;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) repro::store_as(o + dd, acc[i][dd] / li);
    if (tx == 0) lse[bh * Lq + r] = m[i] + logf(li);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out,
           void* lse, int B, int Hq, int Hkv, int Lq, int Lkv, int causal,
           float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kern = flash_fwd_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((Lq + BQ - 1) / BQ, Hq, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), Hq, Hkv, Lq, Lkv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. D: 32 or 64. Tensors contiguous,
// q (B, Hq, Lq, D), k/v (B, Hkv, Lkv, D), out like q, lse (B, Hq, Lq).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int B, int Hq, int Hkv, int Lq, int Lkv, int D, int dtype, int causal,
    float scale, void* stream) {
  if (B == 0 || Lq == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_CASE(T, CODE, DIM)                                      \
  if (dtype == CODE && D == DIM)                                            \
    return launch<T, DIM>(q, k, v, out, lse, B, Hq, Hkv, Lq, Lkv, causal,   \
                          scale, s);
  REPRO_FLASH_CASE(float, 0, 32)
  REPRO_FLASH_CASE(float, 0, 64)
  REPRO_FLASH_CASE(__nv_bfloat16, 1, 32)
  REPRO_FLASH_CASE(__nv_bfloat16, 1, 64)
#undef REPRO_FLASH_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
