// Flash attention backward: dq, dk and dv of causal (or full) GQA
// attention from the forward's saved (out, lse).
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py:
// flash_attention_bwd_pallas (bodies _dq_kernel and _dkv_kernel), together
// with the two steps the reference does outside Pallas: delta =
// rowsum(dO * O) (kernel.py:195) and the sum of the per-query-head dk / dv
// over each group (kernel.py:233-235). The FA2 formulas, every product in
// f32 from bf16 or f32 inputs, as the TPU kernel does them:
//   P  = exp(S * scale - lse) with S = Q K^T, masked to 0 (causal
//        positions right-aligned: query i sits at Lkv - Lq + i; keys past
//        Lkv and rows past Lq are masked, so ragged lengths need no pad);
//   dV = P^T dO,   dP = dO V^T,   dS = P * (dP - delta) * scale,
//   dQ = dS K,     dK = dS^T Q,
// with dk and dv summed over the G = Hq / Hkv query heads that share a kv
// head. dq comes out in q's type, dk and dv in k's.
//
// What bounds it on the card: at the training shape (B 2, 14 / 2 heads of
// 64, L 4096, bf16) a call moves about 68 MB and needs about 150 GFLOP for
// the five causal products, so on paper the tensor cores bound it (about
// 0.15 ms at 989 TFLOP/s). This first kernel does its products in f32 on
// the CUDA cores, as the forward does, and computes S and dP once in each
// of its two kernels (seven products instead of five), so it is bound by
// f32 FMA issue and shared-memory traffic, far above that bound. bf16
// wgmma is a later change.
//
// Design. The TPU grid carried dq across a sequential kv axis, and dk / dv
// per query head across a sequential q axis, then reduced the heads in the
// wrapper. Blocks here run in parallel and in no order, so every sum stays
// inside one block and is taken in a fixed order (f32 results repeat from
// run to run; no atomics, no per-head intermediates):
//  (a) dq_kernel, one block of 256 threads per (64-row query tile, q head,
//      batch row). It computes delta for its rows first (and writes it out
//      for (b)), then loops over the visible kv tiles as the forward does,
//      holding its (D x 64) tile of dq^T in registers.
//  (b) dkv_kernel, one block per (64-key tile, kv head, batch row), launched
//      after (a) on the same stream. It loops over the G query heads and,
//      for each, over the query tiles from the first one that sees the key
//      tile, holding dk^T and dv^T in registers; each is written once,
//      already summed over the group.
// Tiles are staged in shared memory as f32, transposed ([d][row], stride
// 64), so that every product reads float4s: a 4x4 score tile per thread
// from two transposed tiles, and a (D/16 x 4) gradient tile per thread
// from a transposed tile and a row-major 64 x 64 tile of P or dS. (a)
// takes 84 KB and (b) 101 KB of shared memory at D = 64 (above the 48 KB
// default, so the launcher raises the limit), two blocks per SM each.
#include "attention.cuh"

namespace {

constexpr int BT = 64;          // rows of a query or key tile
constexpr int THREADS = 256;    // 16 x 16 threads
constexpr int PS = BT + 4;      // row stride of the P / dS tiles (float4)

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (size_t)(4 * D * BT + BT * PS + 2 * BT);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (size_t)(4 * D * BT + 2 * BT * PS + 2 * BT);
}

// s[i][j] = sum_d A[d][a0 + i] * B[d][b0 + j] over two transposed tiles.
template <int D>
__device__ __forceinline__ void tile4x4(const float* __restrict__ A, int a0,
                                        const float* __restrict__ B, int b0,
                                        float (&s)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float4 a = *reinterpret_cast<const float4*>(&A[d * BT + a0]);
    const float4 c = *reinterpret_cast<const float4*>(&B[d * BT + b0]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
  }
}

// acc[i][j] += sum_x At[d0 + i][x] * M[x][m0 + j], x over the 64 rows:
// rows d0.. of a transposed (D x 64) tile times a row-major 64 x 64 tile.
template <int R>
__device__ __forceinline__ void accumulate(const float* __restrict__ At,
                                           int d0,
                                           const float* __restrict__ M,
                                           int m0, float (&acc)[R][4]) {
#pragma unroll 2
  for (int x = 0; x < BT; x += 4) {
    float a[R][4];
#pragma unroll
    for (int i = 0; i < R; ++i)
      repro::load_smem<4>(&At[(d0 + i) * BT + x], a[i]);
#pragma unroll
    for (int xx = 0; xx < 4; ++xx) {
      float m[4];
      repro::load_smem<4>(&M[(x + xx) * PS + m0], m);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(a[i][xx], m[j], acc[i][j]);
    }
  }
}

// P and dS of one score; `ok` false gives 0 for both.
__device__ __forceinline__ void p_ds(float s, float dp, float lse,
                                     float delta, float scale, bool ok,
                                     float& p, float& ds) {
  p = ok ? expf(s * scale - lse) : 0.f;
  ds = p * (dp - delta) * scale;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ out,
          const T* __restrict__ dout, const float* __restrict__ lse,
          float* __restrict__ delta, T* __restrict__ dq, int Hq, int Hkv,
          int Lq, int Lkv, int causal, float scale) {
  constexpr int R = D / 16;     // head dims of dq^T per thread
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);   // [D][BT]
  float* dOt = Qt + D * BT;                      // [D][BT]
  float* Kt = dOt + D * BT;                      // [D][BT]
  float* Vt = Kt + D * BT;                       // [D][BT]
  float* dSt = Vt + D * BT;                      // [BT keys][PS]: dS^T
  float* lse_s = dSt + BT * PS;                  // [BT]
  float* delta_s = lse_s + BT;                   // [BT]

  const int nqt = (Lq + BT - 1) / BT;
  const int q0 = (nqt - 1 - (int)blockIdx.x) * BT;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int off = Lkv - Lq;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  const size_t rows = ((size_t)b * Hq + h) * Lq;    // row 0 of (b, h)
  const size_t kvrows = ((size_t)b * Hkv + hk) * Lkv;

  repro::load_transposed<T, D, THREADS>(q + rows * D, q0, Lq, Qt, tid);
  repro::load_transposed<T, D, THREADS>(dout + rows * D, q0, Lq, dOt, tid);

  // delta = rowsum(dO * O) in f32, four threads per row; written out for
  // the dk / dv kernel
  {
    constexpr int V = repro::kVec<T>;
    constexpr int PER = D / 4;
    const int r = tid / 4, part = tid % 4;
    const bool ok = q0 + r < Lq;
    float acc = 0.f;
    if (ok) {
      const size_t base = (rows + q0 + r) * D + part * PER;
#pragma unroll
      for (int e = 0; e < PER; e += V) {
        float o[V], g[V];
        repro::load_vec(out + base + e, o);
        repro::load_vec(dout + base + e, g);
#pragma unroll
        for (int u = 0; u < V; ++u) acc = fmaf(o[u], g[u], acc);
      }
    }
    acc = repro::group_sum<4>(acc);
    if (part == 0) {
      delta_s[r] = acc;
      lse_s[r] = ok ? lse[rows + q0 + r] : 0.f;
      if (ok) delta[rows + q0 + r] = acc;
    }
  }

  float acc[R][4];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // keys past the tile's last query position are masked for every row
  const int kend = causal ? min(Lkv, q0 + BT + off) : Lkv;
  for (int k0 = 0; k0 < kend; k0 += BT) {
    __syncthreads();            // last tile's readers are done
    repro::load_transposed<T, D, THREADS>(k + kvrows * D, k0, Lkv, Kt, tid);
    repro::load_transposed<T, D, THREADS>(v + kvrows * D, k0, Lkv, Vt, tid);
    __syncthreads();

    // transposed scores: keys 4ty + i, queries 4tx + j
    float s[4][4], dp[4][4];
    tile4x4<D>(Kt, ty * 4, Qt, tx * 4, s);
    tile4x4<D>(Vt, ty * 4, dOt, tx * 4, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kpos = k0 + ty * 4 + i;
      float p[4], ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx * 4 + j;
        const bool ok = kpos < Lkv && q0 + r < Lq &&
                        (!causal || kpos <= q0 + r + off);
        p_ds(s[i][j], dp[i][j], lse_s[r], delta_s[r], scale, ok, p[j],
             ds[j]);
      }
      *reinterpret_cast<float4*>(&dSt[(ty * 4 + i) * PS + tx * 4]) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();
    // dq^T[d][r] += sum_c K^T[d][c] dS^T[c][r]
    accumulate<R>(Kt, ty * R, dSt, tx * 4, acc);
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = q0 + tx * 4 + j;
    if (r >= Lq) continue;
    T* o = dq + (rows + r) * D + ty * R;
#pragma unroll
    for (int i = 0; i < R; ++i) repro::store_as(o + i, acc[i][j]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           T* __restrict__ dk, T* __restrict__ dv, int Hq, int Hkv, int Lq,
           int Lkv, int causal, float scale) {
  constexpr int R = D / 16;     // head dims of dk^T / dv^T per thread
  extern __shared__ float4 smem4[];
  float* Kt = reinterpret_cast<float*>(smem4);   // [D][BT]
  float* Vt = Kt + D * BT;                       // [D][BT]
  float* Qt = Vt + D * BT;                       // [D][BT]
  float* dOt = Qt + D * BT;                      // [D][BT]
  float* Ps = dOt + D * BT;                      // [BT queries][PS]
  float* dSs = Ps + BT * PS;                     // [BT queries][PS]
  float* lse_s = dSs + BT * PS;                  // [BT]
  float* delta_s = lse_s + BT;                   // [BT]

  const int k0 = blockIdx.x * BT;   // causal: the first tiles are longest
  const int hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int off = Lkv - Lq;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t kvrows = ((size_t)b * Hkv + hk) * Lkv;

  repro::load_transposed<T, D, THREADS>(k + kvrows * D, k0, Lkv, Kt, tid);
  repro::load_transposed<T, D, THREADS>(v + kvrows * D, k0, Lkv, Vt, tid);

  float dk_acc[R][4], dv_acc[R][4];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // causal: query rows before k0 - off see none of this tile's keys
  const int qfirst = causal ? max(0, k0 - off) / BT * BT : 0;
  for (int g = 0; g < G; ++g) {
    const size_t rows = ((size_t)b * Hq + hk * G + g) * Lq;
    for (int q0 = qfirst; q0 < Lq; q0 += BT) {
      __syncthreads();          // last tile's readers are done
      repro::load_transposed<T, D, THREADS>(q + rows * D, q0, Lq, Qt, tid);
      repro::load_transposed<T, D, THREADS>(dout + rows * D, q0, Lq, dOt,
                                            tid);
      if (tid < BT) {
        const bool ok = q0 + tid < Lq;
        lse_s[tid] = ok ? lse[rows + q0 + tid] : 0.f;
        delta_s[tid] = ok ? delta[rows + q0 + tid] : 0.f;
      }
      __syncthreads();

      // scores: queries 4ty + i, keys 4tx + j
      float s[4][4], dp[4][4];
      tile4x4<D>(Qt, ty * 4, Kt, tx * 4, s);
      tile4x4<D>(dOt, ty * 4, Vt, tx * 4, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        float p[4], ds[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kpos = k0 + tx * 4 + j;
          const bool ok = kpos < Lkv && q0 + r < Lq &&
                          (!causal || kpos <= q0 + r + off);
          p_ds(s[i][j], dp[i][j], lse_s[r], delta_s[r], scale, ok, p[j],
               ds[j]);
        }
        *reinterpret_cast<float4*>(&Ps[r * PS + tx * 4]) =
            make_float4(p[0], p[1], p[2], p[3]);
        *reinterpret_cast<float4*>(&dSs[r * PS + tx * 4]) =
            make_float4(ds[0], ds[1], ds[2], ds[3]);
      }
      __syncthreads();
      // dv^T[d][c] += sum_r dO^T[d][r] P[r][c];
      // dk^T[d][c] += sum_r Q^T[d][r] dS[r][c]
      accumulate<R>(dOt, ty * R, Ps, tx * 4, dv_acc);
      accumulate<R>(Qt, ty * R, dSs, tx * 4, dk_acc);
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = k0 + tx * 4 + j;
    if (c >= Lkv) continue;
    T* dk_row = dk + (kvrows + c) * D + ty * R;
    T* dv_row = dv + (kvrows + c) * D + ty * R;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      repro::store_as(dk_row + i, dk_acc[i][j]);
      repro::store_as(dv_row + i, dv_acc[i][j]);
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const void* lse, void* delta, void* dq,
           void* dk, void* dv, int B, int Hq, int Hkv, int Lq, int Lkv,
           int causal, float scale, cudaStream_t stream) {
  constexpr size_t s_dq = dq_smem_bytes<D>(), s_dkv = dkv_smem_bytes<D>();
  auto kdq = dq_kernel<T, D>;
  auto kdkv = dkv_kernel<T, D>;
  cudaError_t e = allow_smem(kdq, s_dq);
  if (e == cudaSuccess) e = allow_smem(kdkv, s_dkv);
  if (e != cudaSuccess) return static_cast<int>(e);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const float* lt = static_cast<const float*>(lse);
  float* dt = static_cast<float*>(delta);
  if (Lq > 0) {
    kdq<<<dim3((Lq + BT - 1) / BT, Hq, B), THREADS, s_dq, stream>>>(
        qt, kt, vt, static_cast<const T*>(out), dot, lt, dt,
        static_cast<T*>(dq), Hq, Hkv, Lq, Lkv, causal, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // dk and dv are written whole, zeros where no query sees a key
  if (Lkv > 0) {
    kdkv<<<dim3((Lkv + BT - 1) / BT, Hkv, B), THREADS, s_dkv, stream>>>(
        qt, kt, vt, dot, lt, dt, static_cast<T*>(dk), static_cast<T*>(dv),
        Hq, Hkv, Lq, Lkv, causal, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. D: 32 or 64. Tensors contiguous, all of
// one dtype but lse and delta: q, out, dout, dq (B, Hq, Lq, D); k, v, dk,
// dv (B, Hkv, Lkv, D); lse (B, Hq, Lq) f32 from the forward; delta
// (B, Hq, Lq) f32 scratch, written here.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int Hq, int Hkv, int Lq, int Lkv, int D, int dtype,
    int causal, float scale, void* stream) {
  if (B == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_BWD_CASE(T, CODE, DIM)                                  \
  if (dtype == CODE && D == DIM)                                            \
    return launch<T, DIM>(q, k, v, out, dout, lse, delta, dq, dk, dv, B,    \
                          Hq, Hkv, Lq, Lkv, causal, scale, s);
  REPRO_FLASH_BWD_CASE(float, 0, 32)
  REPRO_FLASH_BWD_CASE(float, 0, 64)
  REPRO_FLASH_BWD_CASE(__nv_bfloat16, 1, 32)
  REPRO_FLASH_BWD_CASE(__nv_bfloat16, 1, 64)
#undef REPRO_FLASH_BWD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
