// K4a / K4b / K7: in-place row and slot scatters into a device table.
//
// Replaces the TPU kernels in jvector_tpu/ops/pallas/scatter_rows.py:
//   jv_scatter_rows  <- _scatter_kernel (entries scatter_rows3_inplace, K4a,
//                       on [N, T, 128] u8 tables, and scatter_rows_inplace,
//                       K4b, on [N, K] tables of any dtype);
//   jv_scatter_slots <- _scatter_slots_kernel (entry scatter_slots_inplace,
//                       K7).
//
// Contract:
//   jv_scatter_rows:  table[idx[i]] = payload[i]: row_bytes bytes per row.
//   jv_scatter_slots: bytes [off[i]*itemsize, +slot_bytes) of row idx[i]
//                     take payload[i] (slot_bytes = Kp * itemsize).
//   Rows outside [0, n) are dropped; a slot that does not lie inside its
//   row is dropped whole.  Duplicate rows in one call race: callers pass
//   unique rows, or duplicates that carry identical images (the TPU
//   kernel's DMAs complete in no fixed order either).
//
// Design: the TPU kernel issues one HBM->HBM DMA per row from one core and
// drains them at the end.  Here one warp copies one payload row: the
// block loads its own indices, each lane moves every 32nd vector.  The
// vector width is chosen per row, uniformly across the warp: 16-byte int4
// copies when both addresses and the byte count are 16-byte multiples
// (K4a's 3,072-byte rows at d = 96, 192 vectors, 6 per lane), else 4-byte,
// else single bytes.  Nothing is staged in shared memory and the kernel
// allocates nothing.
//
// Bound: bytes.  K4a at the 1M d=96 build moves up to B = 17,408 rows of
// 3 KB in and out per wave (about 107 MB, 32 us at 3.35 TB/s); only rows
// that land are read and written.  TMA or cp.async bulk copies are later
// work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps, one payload row each

__device__ __forceinline__ void copy_span(uint8_t* __restrict__ dst, const uint8_t* __restrict__ src,
                                          long long nbytes, int lane) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src) |
                      static_cast<uintptr_t>(nbytes);
  if ((a & 15) == 0) {
    int4* d = reinterpret_cast<int4*>(dst);
    const int4* s = reinterpret_cast<const int4*>(src);
    for (long long v = lane; v < nbytes / 16; v += 32) d[v] = s[v];
  } else if ((a & 3) == 0) {
    uint32_t* d = reinterpret_cast<uint32_t*>(dst);
    const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
    for (long long v = lane; v < nbytes / 4; v += 32) d[v] = s[v];
  } else {
    for (long long v = lane; v < nbytes; v += 32) dst[v] = src[v];
  }
}

__global__ void scatter_rows_kernel(uint8_t* __restrict__ table, long long n, long long row_bytes,
                                    const int32_t* __restrict__ idx, const uint8_t* __restrict__ payload,
                                    int b) {
  const long long i = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (i >= b) return;
  const long long r = idx[i];
  if (r < 0 || r >= n) return;
  copy_span(table + r * row_bytes, payload + i * row_bytes, row_bytes, threadIdx.x & 31);
}

__global__ void scatter_slots_kernel(uint8_t* __restrict__ table, long long n, long long row_bytes,
                                     const int32_t* __restrict__ idx, const int32_t* __restrict__ off,
                                     int itemsize, long long slot_bytes, const uint8_t* __restrict__ payload,
                                     int b) {
  const long long i = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (i >= b) return;
  const long long r = idx[i];
  const long long o = static_cast<long long>(off[i]) * itemsize;
  if (r < 0 || r >= n || o < 0 || o + slot_bytes > row_bytes) return;
  copy_span(table + r * row_bytes + o, payload + i * slot_bytes, slot_bytes, threadIdx.x & 31);
}

unsigned blocks_for(int b) { return static_cast<unsigned>((static_cast<long long>(b) * 32 + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int jv_scatter_rows(void* table, long long n, long long row_bytes, const void* idx, const void* payload,
                               int b, void* stream) {
  if (b > 0) {
    scatter_rows_kernel<<<blocks_for(b), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint8_t*>(table), n, row_bytes, static_cast<const int32_t*>(idx),
        static_cast<const uint8_t*>(payload), b);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int jv_scatter_slots(void* table, long long n, long long row_bytes, const void* idx, const void* off,
                                int itemsize, long long slot_bytes, const void* payload, int b, void* stream) {
  if (b > 0) {
    scatter_slots_kernel<<<blocks_for(b), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint8_t*>(table), n, row_bytes, static_cast<const int32_t*>(idx),
        static_cast<const int32_t*>(off), itemsize, slot_bytes, static_cast<const uint8_t*>(payload), b);
  }
  return static_cast<int>(cudaGetLastError());
}
