// Fused retrieve: the whole CFT-RAG retrieval step in one launch.
//
// Replaces the TPU kernel repro/kernels/fused_retrieve/kernel.py:
// fused_retrieve_ragged_pallas (body _fused_kernel_sp -> _arena_probe ->
// _context_tail with _up_walk/_down_walk). Per (tree_id, hash) query:
// route into the ragged arena, probe, bump the hit slot's temperature,
// read the CSR window of up to max_locs nodes, and walk an n-step
// ancestor window and an n-step BFS descendant window per node.
//
// What bounds it on the card: chains of dependent 4-byte gathers (probe
// rows, CSR row, then per node up to 2n parent/entity reads and the BFS
// reads) into tables of 0.5-5 MB that stay whole in the 50 MB L2, plus
// the launch; the bytes that must move are a few dozen per query and the
// copy of the temperature table the wrapper makes. The TPU design
// prefetched the routing tables into SMEM, gathered through one-hot MXU
// matmuls over f32-staged tables and merged arena tiles across a
// sequential grid axis. Here one thread per query follows its own chain
// straight through L2: routing is two scalar loads, the probe is two
// 16-byte loads, the bump is an int32 atomicAdd (exact in any order), and
// the BFS frontier lives in a per-thread array of kMaxN entries. Many
// queries in flight hide the gather latency; nothing is staged.
#include "arena_probe.cuh"

namespace {

constexpr int kMaxLocs = 16;   // compile-time cap on max_locs
constexpr int kMaxN = 8;       // compile-time cap on n (BFS buffer size)

struct Forest {
  const int* __restrict__ parent;         // (N,)
  const int* __restrict__ entity_id;      // (N,)
  const int* __restrict__ child_offsets;  // (NC,)
  const int* __restrict__ child_index;    // (C,)
  int N, NC, C;
};

// Append src's children to the BFS buffer while it has room (at most n
// children per push, as the reference's unrolled push).
__device__ __forceinline__ int push_children(const Forest& f, int src,
                                             int* buf, int w, int n) {
  const long long s = src < 0 ? 0 : src;
  const int lo = __ldg(f.child_offsets + repro::clamp_index(s, f.NC));
  const int hi = __ldg(f.child_offsets + repro::clamp_index(s + 1, f.NC));
  for (int k = 0; k < n; ++k) {
    const int idx = lo + k;
    if (idx < hi && w < n)
      buf[w++] = __ldg(f.child_index + repro::clamp_index(idx, f.C));
  }
  return w;
}

__global__ void fused_retrieve_kernel(
    const int* __restrict__ h, const int* __restrict__ tree_ids, int B,
    const int* __restrict__ bucket_offsets, const int* __restrict__ tree_nb,
    int T, const int* __restrict__ fps, const int* __restrict__ heads,
    int A, int S, int* __restrict__ temperature,
    const int* __restrict__ csr_offsets, int R1,
    const int* __restrict__ csr_nodes, int L, Forest f, int max_locs, int n,
    bool* __restrict__ hit_out, int* __restrict__ loc_out,
    int* __restrict__ up_out, int* __restrict__ down_out) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= B) return;

  // routing: out-of-range trees probe tree 0 and are masked to misses
  const int t_raw = tree_ids[q];
  const bool in_range = t_raw >= 0 && t_raw < T;
  const int t = in_range ? t_raw : 0;
  const int off = __ldg(bucket_offsets + t);
  const uint32_t mask = (uint32_t)(__ldg(tree_nb + t) - 1);
  const repro::Probe p =
      repro::probe_arena((uint32_t)h[q], off, mask, fps, heads, A, S);
  const bool vhit = p.hit && in_range;
  if (vhit) atomicAdd(temperature + p.row * S + p.slot, 1);
  hit_out[q] = vhit;

  // CSR window; a miss reads the empty sentinel row R
  const int R = R1 - 1;
  int lo = 0, count = 0;
  if (vhit) {
    const long long e = repro::clamp_index(p.head, R + 1);
    lo = __ldg(csr_offsets + e);
    count = __ldg(csr_offsets + (e + 1 < R ? e + 1 : R)) - lo;
  }
#pragma unroll 1
  for (int k = 0; k < max_locs; ++k) {
    const long long o = (long long)q * max_locs + k;
    const int node = (vhit && k < count)
        ? __ldg(csr_nodes + repro::clamp_index((long long)lo + k, L))
        : repro::kNull;
    loc_out[o] = node;
    int* up = up_out + o * n;
    int* down = down_out + o * n;

    // ancestors, nearest first
    int cur = node;
    for (int j = 0; j < n; ++j) {
      const int par = cur == repro::kNull
          ? repro::kNull : __ldg(f.parent + repro::clamp_index(cur, f.N));
      up[j] = par == repro::kNull
          ? repro::kNull : __ldg(f.entity_id + repro::clamp_index(par, f.N));
      cur = par;
    }

    // descendants, level order
    int buf[kMaxN];
    int w = node == repro::kNull ? 0 : push_children(f, node, buf, 0, n);
    for (int i = 0; i < n; ++i) {
      const int c = i < w ? buf[i] : repro::kNull;
      if (c != repro::kNull) {
        down[i] = __ldg(f.entity_id + repro::clamp_index(c, f.N));
        w = push_children(f, c, buf, w, n);
      } else {
        down[i] = repro::kNull;
      }
    }
  }
}

}  // namespace

extern "C" int fused_retrieve_max_locs() { return kMaxLocs; }
extern "C" int fused_retrieve_max_n() { return kMaxN; }

extern "C" int fused_retrieve_launch(
    const void* h, const void* tree_ids, int B, const void* bucket_offsets,
    const void* tree_nb, int T, const void* fps, const void* heads, int A,
    int S, void* temperature, const void* csr_offsets, int R1,
    const void* csr_nodes, int L, const void* parent, const void* entity_id,
    int N, const void* child_offsets, int NC, const void* child_index, int C,
    int max_locs, int n, void* hit, void* loc, void* up, void* down,
    void* stream) {
  if (max_locs < 0 || max_locs > kMaxLocs || n < 0 || n > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0) {
    const Forest f{static_cast<const int*>(parent),
                   static_cast<const int*>(entity_id),
                   static_cast<const int*>(child_offsets),
                   static_cast<const int*>(child_index), N, NC, C};
    const int threads = 256;
    const int blocks = (B + threads - 1) / threads;
    fused_retrieve_kernel<<<blocks, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(h), static_cast<const int*>(tree_ids), B,
        static_cast<const int*>(bucket_offsets),
        static_cast<const int*>(tree_nb), T, static_cast<const int*>(fps),
        static_cast<const int*>(heads), A, S, static_cast<int*>(temperature),
        static_cast<const int*>(csr_offsets), R1,
        static_cast<const int*>(csr_nodes), L, f, max_locs, n,
        static_cast<bool*>(hit), static_cast<int*>(loc),
        static_cast<int*>(up), static_cast<int*>(down));
  }
  return static_cast<int>(cudaGetLastError());
}
