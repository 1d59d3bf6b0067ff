// Shared device code of the port's retrieval kernels: the 32-bit hash
// pipeline (bit-identical to repro_torch/core/hashing.py) and the
// slot-priority probe of one query against the ragged bucket arena.
//
// Tables are int32 and read straight from device memory. A fingerprint
// row of S = 4 slots is one 16-byte load; other S fall back to a loop.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace repro {

constexpr int kNull = -1;
constexpr uint32_t kFpMask = (1u << 12) - 1;   // 12-bit fingerprints
constexpr uint32_t kGolden = 0x9E3779B9u;

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h = (h ^ (h >> 16)) * 0x7FEB352Du;          // splitmix32 finalizer
  h = (h ^ (h >> 15)) * 0x846CA68Bu;
  return h ^ (h >> 16);
}

__device__ __forceinline__ uint32_t fingerprint(uint32_t h) {
  const uint32_t fp = mix32(h ^ kGolden) & kFpMask;
  return fp == 0u ? 1u : fp;                  // 0 marks an empty slot
}

__device__ __forceinline__ long long clamp_index(long long i, long long n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

struct Probe {
  bool hit;
  int head;        // CSR row payload of the match, -1 on a miss
  int bucket;      // tree-local bucket: i1 or i2 on a hit, i2 on a miss
  int slot;        // slot of the match, S - 1 on a miss
  long long row;   // arena row of (bucket, slot)
};

// First match over [row(off + i1) slots | row(off + i2) slots]. Candidate
// rows are clamped into the arena, as the plain torch gather clamps them.
__device__ __forceinline__ Probe probe_arena(
    uint32_t h, int off, uint32_t mask, const int* __restrict__ fps,
    const int* __restrict__ heads, int A, int S) {
  const uint32_t fp = fingerprint(h);
  const uint32_t i1 = mix32(h) & mask;
  const uint32_t i2 = (i1 ^ mix32(fp)) & mask;
  const long long r1 = clamp_index((long long)off + i1, A);
  const long long r2 = clamp_index((long long)off + i2, A);
  int first = 2 * S;
  if (S == 4 && (reinterpret_cast<uintptr_t>(fps) & 15) == 0) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(fps) + r1);
    const int4 b = __ldg(reinterpret_cast<const int4*>(fps) + r2);
    const int f[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int k = 7; k >= 0; --k)
      if ((uint32_t)f[k] == fp) first = k;
  } else {
    for (int k = 2 * S - 1; k >= 0; --k) {
      const long long r = k < S ? r1 : r2;
      if ((uint32_t)__ldg(fps + r * S + (k < S ? k : k - S)) == fp) first = k;
    }
  }
  Probe p;
  if (first < 2 * S) {
    const bool in1 = first < S;
    p.hit = true;
    p.bucket = (int)(in1 ? i1 : i2);
    p.slot = in1 ? first : first - S;
    p.row = in1 ? r1 : r2;
    p.head = __ldg(heads + p.row * S + p.slot);
  } else {
    p.hit = false;
    p.head = kNull;
    p.bucket = (int)i2;
    p.slot = S - 1;
    p.row = r2;
  }
  return p;
}

}  // namespace repro
