// The row-owner search shared by K1/K3 (packed_adj.cu) and K2
// (fused_update.cu).
//
// Both kernels apply a wave's writes in one launch: a block owns each
// wave row, takes its image into shared memory, overlays the patches that
// the row-sorted patch stream holds for that row, and stores the row once.
// The owner finds its row's patches with one round of evenly spaced
// probes, one per thread, instead of a binary search (one dependent load
// per level).  The stream contract that makes the probes sound:
//   - in-range entries (rows in [0, n)) are sorted ascending;
//   - a negative entry is a drop and may sit anywhere (K2's builder marks
//     an enforce row's run and a run's overflow tail with -1);
//   - an entry >= n is a drop and comes after every in-range entry.
// So a probe that reads v in [0, r) proves that no entry at or before it
// holds r, one that reads v > r (drops >= n included) proves it for every
// entry from it on, and a negative probe proves nothing.  The owner then
// scans the positions between the tightest two bounds, one position per
// thread, a block of positions per round.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace jv {

constexpr int kOwnerThreads = 256;             // threads per block, owners and patch blocks alike
constexpr int kOwnerWarps = kOwnerThreads / 32;

// This thread's probe position in a stream of p entries.
__device__ __forceinline__ int probe_pos(int p) {
  return static_cast<int>(static_cast<long long>(threadIdx.x) * p / kOwnerThreads);
}

// This thread's probe value (issue it early: it depends on nothing).
__device__ __forceinline__ int32_t probe_load(const int32_t* __restrict__ rows, int p) {
  return p > 0 ? rows[probe_pos(p)] : -1;
}

// Reduce the block's probes of row r into per-warp bounds in shared memory;
// read them with owner_bounds after the next __syncthreads.
__device__ __forceinline__ void probe_reduce(int32_t v, int p, int32_t r, int* s_lo, int* s_hi) {
  const int q = probe_pos(p);
  int lo = (v >= 0 && v < r) ? q + 1 : 0;
  int hi = (p > 0 && v > r) ? q : p;
  lo = __reduce_max_sync(0xffffffffu, lo);
  hi = __reduce_min_sync(0xffffffffu, hi);
  if ((threadIdx.x & 31) == 0) {
    s_lo[threadIdx.x >> 5] = lo;
    s_hi[threadIdx.x >> 5] = hi;
  }
}

// The stream positions [lo, hi) that can hold row r; the same in every thread.
__device__ __forceinline__ void owner_bounds(const int* s_lo, const int* s_hi, int& lo, int& hi) {
  lo = s_lo[0];
  hi = s_hi[0];
#pragma unroll
  for (int w = 1; w < kOwnerWarps; ++w) {
    lo = max(lo, s_lo[w]);
    hi = min(hi, s_hi[w]);
  }
}

}  // namespace jv
