// K4a / K4b / K7: in-place row and slot scatters into a device table.
//
// Replaces the TPU kernels in jvector_tpu/ops/pallas/scatter_rows.py:
//   jv_scatter without offsets <- _scatter_kernel (entries
//       scatter_rows3_inplace, K4a, on [N, T, 128] u8 tables, and
//       scatter_rows_inplace, K4b, on [N, K] tables of any dtype);
//   jv_scatter with offsets <- _scatter_slots_kernel (entry
//       scatter_slots_inplace, K7).
//
// Contract:
//   rows:  table[idx[i]] = payload[i]: row_bytes bytes per row.
//   slots: bytes [off[i]*itemsize, +slot_bytes) of row idx[i] take
//          payload[i] (slot_bytes = Kp * itemsize).
//   Rows outside [0, n) are dropped; a slot that does not lie inside its
//   row is dropped whole.  Duplicate rows in one call race: callers pass
//   unique rows, or duplicates that carry identical images (the TPU
//   kernel's DMAs complete in no fixed order either).
//
// Design: the TPU kernel issues one HBM->HBM DMA per row from one core and
// drains them at the end.  Here a group of L lanes copies one item (a
// payload row or slot), so a warp carries 32 / L items.  L is planned on
// the host (ops/kernels/scatter_rows.py `_scatter`) as the least power of two
// that covers the item's vectors at the widest width its byte count and
// the host-visible addresses allow, capped at 32: 1 lane for a 4-byte
// slot, 4 for a 48-byte slot, 16 for a 256-byte row, 32 for K4a's
// 3,072-byte rows (192 vectors, 6 a lane).  The host also sizes the grid;
// the entry switches to the template instance of its L.  Each group then
// picks its own vector width, 16, 4 or 1 bytes, from the alignment of its
// destination, source and byte count: a K7 slot's offset differs from item
// to item, so a misaligned item copies with narrower vectors inside its L
// lanes and no code assumes one width a warp.  A lane keeps up to four
// 16-byte loads in flight before it stores them.  Indices, offsets and the
// payload are read once (ld.global.nc); the stores are plain (streaming
// stores, st.global.cs, measured no different on the H100 at any of the
// five path shapes).  Nothing is staged in shared memory and the kernel
// allocates nothing.
//
// Bound: bytes and sectors.  K4a at a 1M d=96 build wave moves up to
// B = 17,408 rows of 3 KB in and out (about 107 MB, 32 us at 3.35 TB/s).
// A scattered 4-byte slot still costs the 32-byte sector it lands in,
// filled and written back, so K7's 16,384 one-element slots cost about
// 1 MB of traffic, not 0.26 MB, and a launch (about 1 us) more than both.
// TMA and bulk copies (cp.async.bulk) pay for tiles of kilobytes; at
// 4-256 bytes an item their descriptor, barrier and issue cost more than
// the copy, so plain vector loads and stores move every item.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;

struct Scatter {
  uint8_t* table;
  long long n;
  long long row_bytes;
  const int32_t* idx;
  const int32_t* off;  // null for whole rows
  int itemsize;
  long long item_bytes;
  const uint8_t* payload;
  int b;
};

template <int L>
__device__ __forceinline__ void copy_item(uint8_t* __restrict__ dst, const uint8_t* __restrict__ src,
                                          long long nbytes, int lane) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src) |
                      static_cast<uintptr_t>(nbytes);
  if ((a & 15) == 0) {  // four loads in flight a lane before their stores (K4a: 6 vectors a lane)
    int4* d = reinterpret_cast<int4*>(dst);
    const int4* s = reinterpret_cast<const int4*>(src);
    const long long nv = nbytes / 16;
    for (long long v = lane; v < nv; v += 4 * L) {
      int4 x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (v + u * L < nv) x[u] = __ldg(s + v + u * L);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (v + u * L < nv) d[v + u * L] = x[u];
    }
  } else if ((a & 3) == 0) {
    uint32_t* d = reinterpret_cast<uint32_t*>(dst);
    const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
    for (long long v = lane; v < nbytes / 4; v += L) d[v] = __ldg(s + v);
  } else {
    for (long long v = lane; v < nbytes; v += L) dst[v] = __ldg(src + v);
  }
}

template <int L, bool kSlots>
__global__ void __launch_bounds__(kMaxThreads) scatter_kernel(const Scatter p) {
  const long long i = static_cast<long long>((static_cast<unsigned long long>(blockIdx.x) * blockDim.x + threadIdx.x) / L);
  if (i >= p.b) return;
  const long long r = __ldg(p.idx + i);
  if (r < 0 || r >= p.n) return;
  long long o = 0;
  if constexpr (kSlots) {
    o = static_cast<long long>(__ldg(p.off + i)) * p.itemsize;
    if (o < 0 || o + p.item_bytes > p.row_bytes) return;
  }
  copy_item<L>(p.table + r * p.row_bytes + o, p.payload + i * p.item_bytes, p.item_bytes, threadIdx.x % L);
}

template <bool kSlots>
void launch(const Scatter& p, int lanes, int blocks, int threads, cudaStream_t s) {
  switch (lanes) {
    case 1: scatter_kernel<1, kSlots><<<blocks, threads, 0, s>>>(p); break;
    case 2: scatter_kernel<2, kSlots><<<blocks, threads, 0, s>>>(p); break;
    case 4: scatter_kernel<4, kSlots><<<blocks, threads, 0, s>>>(p); break;
    case 8: scatter_kernel<8, kSlots><<<blocks, threads, 0, s>>>(p); break;
    case 16: scatter_kernel<16, kSlots><<<blocks, threads, 0, s>>>(p); break;
    default: scatter_kernel<32, kSlots><<<blocks, threads, 0, s>>>(p); break;
  }
}

// Refuses a plan that is not a power-of-two lane group of at most 32 lanes,
// whole warps of at most kMaxThreads threads a block, or a grid that does
// not cover the b items; then launches on `device` (switched to only when
// it is not current, and switched back after) and `stream`.
template <bool kSlots>
int launch_on(const Scatter& p, long long b, long long lanes, long long blocks, long long threads, int device,
              cudaStream_t stream) {
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) || threads < 32 || threads > kMaxThreads || threads % 32 ||
      blocks < 1 || blocks > 0x7fffffffLL || blocks * threads / lanes < b) {
    return cudaErrorInvalidValue;
  }
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  launch<kSlots>(p, static_cast<int>(lanes), static_cast<int>(blocks), static_cast<int>(threads), stream);
  err = cudaGetLastError();
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

}  // namespace

// K4a / K4b (off == null: whole rows, item_bytes == row_bytes) and K7
// (slots): b items in groups of `lanes` lanes, `blocks` blocks of
// `threads` threads, on card `device` and `stream`.
extern "C" int jv_scatter(void* table, long long n, long long row_bytes, const void* idx, const void* off,
                          long long itemsize, long long item_bytes, const void* payload, long long b,
                          long long lanes, long long blocks, long long threads, int device, void* stream) {
  if (b <= 0) return 0;
  if (b > 0x7fffffffLL) return cudaErrorInvalidValue;
  const Scatter p{static_cast<uint8_t*>(table), n, row_bytes, static_cast<const int32_t*>(idx),
                  static_cast<const int32_t*>(off), static_cast<int>(itemsize), item_bytes,
                  static_cast<const uint8_t*>(payload), static_cast<int>(b)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return off ? launch_on<true>(p, b, lanes, blocks, threads, device, s)
             : launch_on<false>(p, b, lanes, blocks, threads, device, s);
}
