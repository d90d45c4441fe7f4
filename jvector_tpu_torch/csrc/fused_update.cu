// K2: in-place update of the build's fused SQ4 code table.
//
// Replaces the TPU kernel jvector_tpu/ops/pallas/scatter_rows.py
// (_fused_update_kernel, entry fused_update_inplace).  The table is
// [N, T, 128] uint8: row i holds the packed SQ4 codes of node i's neighbors,
// slot s (the adjacency slot) in bytes [s*MP, (s+1)*MP).  At d=128,
// MP = 64 and T = 32: a 4 KB row.
//
// Contract:
//   Wave images: full row images wave_img[i] land on rows wave_rows[i]
//            (distinct rows).
//   Patches: backlink slot patches in a stream sorted by row (see
//            row_owner.cuh for where drops may sit): patch j writes
//            patch_src[j] to bytes [patch_slots[j]*MP, +MP) of row
//            patch_rows[j], over the wave image where the row has one.
//   Enforce images: er_img[i] lands on row er_rows[i] and wins over both
//            (a wave row that is also an enforce row takes the enforce
//            image alone; duplicate enforce rows carry identical images).
//   Callers keep patches out of enforce rows and give each (row, slot) at
//   most one patch; the order of patches within the stream is then
//   immaterial, and the kernel does not keep it.
//   Rows outside [0, n) are dropped, as are slots outside the row.
//
// Bound: at the 1M main path a wave moves W = 512 row images of 4 KB, up
// to W*M = 16,384 slot patches of 64 B and up to W enforce images of 4 KB,
// each read once and written once, 10.4 MB in all: 3.1 us at 3.35 TB/s,
// about one launch.  So a call costs a launch plus the dependent trips to
// device memory, and the design cuts both.
//
// Design: one launch, kOwnerThreads = 256 threads a block, three roles by
// block index.
//   Blocks [0, n_wave) own the wave rows.  Block i loads its row image into
//   shared memory (one 16-byte vector a thread at T = 32), one probe of the
//   patch stream a thread and the enforce rows, all in one trip; a row that
//   is also an enforce row is left to its enforce owner.  Otherwise the
//   block finds its row's patches between the probes' bounds, overlays them
//   (one thread a patch, MP/16 vectors) and stores the row once, coalesced.
//   Blocks [n_wave, n_wave + n_er) copy one enforce image each.
//   The remaining blocks take the patch stream, MP/16 threads a patch (4 at
//   MP = 64, so 8 patches a warp), one 16-byte vector a thread, every load
//   issued at once.  Drops exit.
//   A patch on a wave row is thus written twice, by its threads and inside
//   its owner's row store, with the same bytes, so the order of the two
//   writes does not matter and no block waits for another.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_owner.cuh"

namespace {

using jv::kOwnerThreads;

struct Args {
  int4* table;
  long long n, row_vecs;  // rows, 16-byte vectors a row
  const int32_t* wave_rows;
  const int4* wave_img;
  int n_wave;
  const int32_t* patch_rows;
  const int32_t* patch_slots;
  const int4* patch_src;
  int p, slot_vecs;  // patches, 16-byte vectors a slot (MP / 16)
  const int32_t* er_rows;
  const int4* er_img;
  int n_er;
};

__device__ __forceinline__ void own_wave_row(int i, const Args& a) {
  extern __shared__ int4 s_row[];
  __shared__ int s_lo[jv::kOwnerWarps], s_hi[jv::kOwnerWarps];
  const int t = threadIdx.x;
  const int32_t r = a.wave_rows[i];
  const int32_t v = jv::probe_load(a.patch_rows, a.p);
  bool enforced = false;
  for (int k = t; k < a.n_er; k += kOwnerThreads) enforced |= a.er_rows[k] == r;
  const int4* img = a.wave_img + static_cast<long long>(i) * a.row_vecs;
  for (long long x = t; x < a.row_vecs; x += kOwnerThreads) s_row[x] = img[x];
  if (r < 0 || r >= a.n) return;  // the whole block: every thread read the same r
  jv::probe_reduce(v, a.p, r, s_lo, s_hi);
  if (__syncthreads_or(enforced)) return;  // the enforce image wins; its owner writes the row
  int lo, hi;
  jv::owner_bounds(s_lo, s_hi, lo, hi);
  const long long slots_per_row = a.row_vecs / a.slot_vecs;
  for (int j = lo + t; j < hi; j += kOwnerThreads) {
    const int32_t row = a.patch_rows[j];
    const int32_t slot = a.patch_slots[j];
    if (row == r && slot >= 0 && slot < slots_per_row) {
      const int4* src = a.patch_src + static_cast<long long>(j) * a.slot_vecs;
      for (int q = 0; q < a.slot_vecs; ++q) s_row[static_cast<long long>(slot) * a.slot_vecs + q] = src[q];
    }
  }
  __syncthreads();
  int4* dst = a.table + static_cast<long long>(r) * a.row_vecs;
  for (long long x = t; x < a.row_vecs; x += kOwnerThreads) dst[x] = s_row[x];
}

__device__ __forceinline__ void copy_enforce_row(int i, const Args& a) {
  const int32_t r = a.er_rows[i];
  if (r < 0 || r >= a.n) return;
  const int4* img = a.er_img + static_cast<long long>(i) * a.row_vecs;
  int4* dst = a.table + static_cast<long long>(r) * a.row_vecs;
  for (long long x = threadIdx.x; x < a.row_vecs; x += kOwnerThreads) dst[x] = img[x];
}

// Thread `tid` of the patch blocks: vector q of patch k.
__device__ __forceinline__ void apply_patch(long long tid, const Args& a) {
  const long long k = tid / a.slot_vecs;
  const int q = static_cast<int>(tid - k * a.slot_vecs);
  if (k >= a.p) return;
  const int32_t row = a.patch_rows[k];
  const int32_t slot = a.patch_slots[k];
  const int4 val = a.patch_src[tid];  // = patch_src[k * slot_vecs + q]
  if (row < 0 || row >= a.n || slot < 0 || slot >= a.row_vecs / a.slot_vecs) return;
  a.table[static_cast<long long>(row) * a.row_vecs + static_cast<long long>(slot) * a.slot_vecs + q] = val;
}

__global__ void __launch_bounds__(kOwnerThreads) fused_update_kernel(Args a) {
  const int b = blockIdx.x;
  if (b < a.n_wave) {
    own_wave_row(b, a);
  } else if (b < a.n_wave + a.n_er) {
    copy_enforce_row(b - a.n_wave, a);
  } else {
    apply_patch(static_cast<long long>(b - a.n_wave - a.n_er) * kOwnerThreads + threadIdx.x, a);
  }
}

}  // namespace

// One launch on the caller's stream (none when there is nothing to write).
// Needs row_bytes and mp to be positive multiples of 16; the wave owner
// stages a row in shared memory, so rows above 227 KB are refused (by
// cudaFuncSetAttribute).  Returns the launch error.
extern "C" int jv_fused_update(void* table, long long n, long long row_bytes, const void* wave_rows,
                               const void* wave_img, int n_wave, const void* patch_rows,
                               const void* patch_slots, const void* patch_src, int p, int mp,
                               const void* er_rows, const void* er_img, int n_er, void* stream) {
  if (row_bytes % 16 || mp % 16 || mp <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<int4*>(table),
               n,
               row_bytes / 16,
               static_cast<const int32_t*>(wave_rows),
               static_cast<const int4*>(wave_img),
               n_wave,
               static_cast<const int32_t*>(patch_rows),
               static_cast<const int32_t*>(patch_slots),
               static_cast<const int4*>(patch_src),
               p,
               mp / 16,
               static_cast<const int32_t*>(er_rows),
               static_cast<const int4*>(er_img),
               n_er};
  const long long patch_threads = static_cast<long long>(p) * (mp / 16);
  const long long blocks = n_wave + n_er + (patch_threads + kOwnerThreads - 1) / kOwnerThreads;
  if (blocks == 0) return 0;
  const size_t smem = n_wave > 0 ? static_cast<size_t>(row_bytes) : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(fused_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fused_update_kernel<<<static_cast<unsigned>(blocks), kOwnerThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
