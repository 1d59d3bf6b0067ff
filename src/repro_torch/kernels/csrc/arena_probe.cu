// Arena probe: pre-routed cuckoo-filter lookup over the ragged bucket arena.
//
// Replaces the TPU kernel repro/kernels/cuckoo_lookup/kernel.py:
// cuckoo_lookup_arena_pallas (body _arena_kernel -> _arena_probe). Same
// outputs: hit, and head/bucket/slot of the first match by slot priority;
// on a miss head -1, bucket i2, slot S-1.
//
// What bounds it on the card: per query, two dependent 16-byte gathers
// from the fingerprint table and one 4-byte gather from the head table,
// into tables of 0.1-1.5 MB that stay whole in the 50 MB L2 — and, at a
// few thousand queries per request, the launch itself. The TPU design
// staged the int tables as f32 for one-hot MXU gathers and streamed the
// arena in VMEM tiles with a cross-tile priority merge; none of that is
// needed here. One thread per query loads its two candidate rows directly
// (a 16-byte vector load each for S = 4), so the kernel moves only the
// bytes the probe needs, in one launch with no padding.
#include "arena_probe.cuh"

namespace {

__global__ void arena_probe_kernel(
    const int* __restrict__ h, const int* __restrict__ row_offsets,
    const int* __restrict__ masks, const int* __restrict__ fps,
    const int* __restrict__ heads, int A, int S, int B,
    bool* __restrict__ hit, int* __restrict__ head,
    int* __restrict__ bucket, int* __restrict__ slot) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= B) return;
  const repro::Probe p = repro::probe_arena(
      (uint32_t)h[q], row_offsets[q], (uint32_t)masks[q], fps, heads, A, S);
  hit[q] = p.hit;
  head[q] = p.head;
  bucket[q] = p.bucket;
  slot[q] = p.slot;
}

}  // namespace

extern "C" int arena_probe_launch(
    const void* h, const void* row_offsets, const void* masks,
    const void* fps, const void* heads, int A, int S, int B,
    void* hit, void* head, void* bucket, void* slot, void* stream) {
  if (B > 0) {
    const int threads = 256;
    const int blocks = (B + threads - 1) / threads;
    arena_probe_kernel<<<blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(h), static_cast<const int*>(row_offsets),
        static_cast<const int*>(masks), static_cast<const int*>(fps),
        static_cast<const int*>(heads), A, S, B, static_cast<bool*>(hit),
        static_cast<int*>(head), static_cast<int*>(bucket),
        static_cast<int*>(slot));
  }
  return static_cast<int>(cudaGetLastError());
}
