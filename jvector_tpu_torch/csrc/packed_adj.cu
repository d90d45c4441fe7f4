// K1 and K3: one build wave's in-place writes to the packed adjacency table
// and, for K1, the w2 table beside it.
//
// Replaces the TPU kernels of jvector_tpu/ops/pallas/packed_adj.py:
//   K1 _packed_update_kernel      (entry packed_adj_update_inplace)      -> jv_packed_adj_update
//   K3 _packed_update_kernel_now2 (entry packed_adj_only_update_inplace) -> jv_packed_adj_only_update
// K3 is K1 without the w2 table (the larger-than-memory build keeps no
// fused tables): one kernel, the w2 writes compiled out by a template flag.
// Layout, as on the TPU: adj and w2t are [N/8, 8, 128] int32 ("physical
// rows" of 8 sublanes).  An adj sublane holds neighbor ids in lanes [0:R]
// and float32 score bits in lanes [64:64+R]; a w2t sublane holds float32
// bits of the neighbors' per-node constants in lanes [0:R].
//
// Contract:
//   Wave images: whole 8-sublane images a_adj[i] (/ a_w2[i]) land on
//            physical row a_rows[i] (the wave's rows, distinct).
//   Patches: a stream sorted by physical row p_prow (see row_owner.cuh for
//            where drops may sit).  Patch j either sets one id / score
//            (/ w2) at lane p_slot[j] of sublane p_sub[j] (p_img[j] < 0), or
//            replaces the whole sublane with the enforce images
//            e_adj[p_img[j]] (/ e_w2[p_img[j]]).  Patches land over the wave
//            images, so a wave row keeps its patches and an enforce image
//            on a wave row wins over that row's image.
//   Callers keep appends out of enforce sublanes and give each
//   (row, sublane, lane) at most one append; the order of patches within
//   the stream is then immaterial, and the kernel does not keep it.
//   Rows outside [0, n_prows) are dropped, as are patches whose sublane,
//   slot or image index is out of range.
//
// Bound: at the 1M path a wave moves W/8 = 64 images of 8 KB (K1; 4 KB
// for K3) and P = 16,896 patches of 28 bytes, 2.69 MB in all: 0.80 us at
// 3.35 TB/s, below one launch.  So a call costs a launch plus the
// dependent trips to device memory, and the design cuts both.
//
// Design: one launch, kOwnerThreads = 256 threads a block, two roles by
// block index.
//   Blocks [0, n_a) own the wave rows.  Block i loads its 4 KB adj (and
//   4 KB w2) image with one 16-byte vector per thread, and in the same trip
//   one probe of the patch stream per thread; it stages the image in shared
//   memory, finds its row's patches between the probes' bounds, overlays
//   them (scalar patches by their thread, sublane images by the warp, one
//   16-byte vector a lane) and stores the row once, coalesced.  Three trips
//   to memory: image and probes, the scanned patches, the sublane images.
//   The remaining blocks take the stream, one thread per patch, every
//   field loaded at once: a scalar patch is two (K3) or three (K1) 4-byte
//   stores, a sublane image is copied by the thread's warp.  Drops exit.
//   A patch on a wave row is thus written twice, by its thread and inside
//   its owner's row store, with the same bytes, so the order of the two
//   writes does not matter and no block waits for another.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_owner.cuh"

namespace {

using jv::kOwnerThreads;

constexpr int kRowVecs = 8 * 128 * 4 / 16;  // int4 vectors in one physical row (= 256)
constexpr int kSubVecs = 128 * 4 / 16;      // int4 vectors in one sublane (= 32)
static_assert(kRowVecs == kOwnerThreads, "an owner thread holds one vector of each table");
static_assert(kSubVecs == 32, "a warp copies one sublane image, a vector a lane");

struct Stream {
  const int32_t* prow;
  const int32_t* sub;
  const int32_t* slot;
  const int32_t* id;
  const int32_t* sc;
  const int32_t* w2;
  const int32_t* img;
  int p;
  const int4* e_adj;
  const int4* e_w2;
  int n_e;
};

// The fields of patch j (all loads issued together); `in` false gives a no-op patch.
struct Patch {
  int32_t row, sub, slot, id, sc, w2, img;
};

template <bool kW2>
__device__ __forceinline__ Patch load_patch(const Stream& s, long long j, bool in) {
  Patch q{-1, -1, -1, 0, 0, 0, -1};
  if (in) {
    q.row = s.prow[j];
    q.sub = s.sub[j];
    q.slot = s.slot[j];
    q.id = s.id[j];
    q.sc = s.sc[j];
    if (kW2) q.w2 = s.w2[j];
    q.img = s.img[j];
  }
  return q;
}

__device__ __forceinline__ bool scalar_ok(const Patch& q) { return q.img < 0 && q.slot >= 0 && q.slot < 64; }

// Whole-warp copy of the sublane images whose lanes have `mine` set: image
// e[img] of the source lane goes to sublane vector base (a multiple of 32)
// of dst.  Every lane of the warp must call it.
template <bool kW2>
__device__ __forceinline__ void copy_images(bool mine, int32_t img, long long base, const Stream& s,
                                            int4* dst_adj, int4* dst_w2) {
  const int lane = threadIdx.x & 31;
  unsigned m = __ballot_sync(0xffffffffu, mine);
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const long long e = static_cast<long long>(__shfl_sync(0xffffffffu, img, src)) * kSubVecs + lane;
    const long long d = __shfl_sync(0xffffffffu, base, src) + lane;
    dst_adj[d] = s.e_adj[e];
    if (kW2) dst_w2[d] = s.e_w2[e];
  }
}

template <bool kW2>
__device__ void own_wave_row(int i, int4* adj, int4* w2t, long long n_prows, const int32_t* a_rows,
                             const int4* a_adj, const int4* a_w2, const Stream& s) {
  __shared__ int4 s_adj[kRowVecs];
  __shared__ int4 s_w2[kW2 ? kRowVecs : 1];
  __shared__ int s_lo[jv::kOwnerWarps], s_hi[jv::kOwnerWarps];
  const int t = threadIdx.x;
  const int32_t r = a_rows[i];
  const int4 va = a_adj[static_cast<long long>(i) * kRowVecs + t];
  int4 vw{};
  if (kW2) vw = a_w2[static_cast<long long>(i) * kRowVecs + t];
  const int32_t v = jv::probe_load(s.prow, s.p);
  if (r < 0 || r >= n_prows) return;  // the whole block: every thread read the same r
  s_adj[t] = va;
  if (kW2) s_w2[t] = vw;
  jv::probe_reduce(v, s.p, r, s_lo, s_hi);
  __syncthreads();
  int lo, hi;
  jv::owner_bounds(s_lo, s_hi, lo, hi);
  int* w_adj = reinterpret_cast<int*>(s_adj);
  int* w_w2 = reinterpret_cast<int*>(s_w2);
  for (int base = lo; base < hi; base += kOwnerThreads) {  // the same trip count in every thread
    const int j = base + t;
    const Patch q = load_patch<kW2>(s, j, j < hi);
    const bool mine = q.row == r && q.sub >= 0 && q.sub < 8;
    if (mine && scalar_ok(q)) {
      w_adj[q.sub * 128 + q.slot] = q.id;
      w_adj[q.sub * 128 + 64 + q.slot] = q.sc;
      if (kW2) w_w2[q.sub * 128 + q.slot] = q.w2;
    }
    copy_images<kW2>(mine && q.img >= 0 && q.img < s.n_e, q.img, static_cast<long long>(q.sub) * kSubVecs, s,
                     s_adj, s_w2);
  }
  __syncthreads();
  adj[static_cast<long long>(r) * kRowVecs + t] = s_adj[t];
  if (kW2) w2t[static_cast<long long>(r) * kRowVecs + t] = s_w2[t];
}

template <bool kW2>
__device__ void apply_patch(long long j, int32_t* adj, int32_t* w2t, long long n_prows, const Stream& s) {
  const Patch q = load_patch<kW2>(s, j, j < s.p);
  const bool ok = q.row >= 0 && q.row < n_prows && q.sub >= 0 && q.sub < 8;
  const long long base = (static_cast<long long>(q.row) * 8 + q.sub) * 128;  // word offset of the sublane
  if (ok && scalar_ok(q)) {
    adj[base + q.slot] = q.id;
    adj[base + 64 + q.slot] = q.sc;
    if (kW2) w2t[base + q.slot] = q.w2;
  }
  copy_images<kW2>(ok && q.img >= 0 && q.img < s.n_e, q.img, base / 4, s, reinterpret_cast<int4*>(adj),
                   reinterpret_cast<int4*>(w2t));
}

template <bool kW2>
__global__ void __launch_bounds__(kOwnerThreads)
    packed_update_kernel(int4* __restrict__ adj, int4* __restrict__ w2t, long long n_prows,
                         const int32_t* __restrict__ a_rows, const int4* __restrict__ a_adj,
                         const int4* __restrict__ a_w2, int n_a, Stream s) {
  if (static_cast<int>(blockIdx.x) < n_a) {
    own_wave_row<kW2>(blockIdx.x, adj, w2t, n_prows, a_rows, a_adj, a_w2, s);
  } else {
    const long long j = static_cast<long long>(blockIdx.x - n_a) * kOwnerThreads + threadIdx.x;
    apply_patch<kW2>(j, reinterpret_cast<int32_t*>(adj), reinterpret_cast<int32_t*>(w2t), n_prows, s);
  }
}

// One launch on the caller's stream (none when there is nothing to write);
// the w2 arguments are ignored (and may be null) when kW2 is false.
// Returns the launch error.
template <bool kW2>
int launch(void* adj, void* w2t, long long n_prows, const void* a_rows, const void* a_adj, const void* a_w2,
           int n_a, const void* p_prow, const void* p_sub, const void* p_slot, const void* p_id, const void* p_sc,
           const void* p_w2, const void* p_img, int p, const void* e_adj, const void* e_w2, int n_e,
           void* stream) {
  const long long blocks = n_a + (static_cast<long long>(p) + kOwnerThreads - 1) / kOwnerThreads;
  if (blocks == 0) return 0;
  const Stream s{static_cast<const int32_t*>(p_prow), static_cast<const int32_t*>(p_sub),
                 static_cast<const int32_t*>(p_slot), static_cast<const int32_t*>(p_id),
                 static_cast<const int32_t*>(p_sc),   static_cast<const int32_t*>(p_w2),
                 static_cast<const int32_t*>(p_img),  p,
                 static_cast<const int4*>(e_adj),     static_cast<const int4*>(e_w2),
                 n_e};
  packed_update_kernel<kW2><<<static_cast<unsigned>(blocks), kOwnerThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int4*>(adj), static_cast<int4*>(w2t), n_prows, static_cast<const int32_t*>(a_rows),
      static_cast<const int4*>(a_adj), static_cast<const int4*>(a_w2), n_a, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1: adjacency + w2 tables.
extern "C" int jv_packed_adj_update(void* adj, void* w2t, long long n_prows, const void* a_rows,
                                    const void* a_adj, const void* a_w2, int n_a, const void* p_prow,
                                    const void* p_sub, const void* p_slot, const void* p_id,
                                    const void* p_sc, const void* p_w2, const void* p_img, int p,
                                    const void* e_adj, const void* e_w2, int n_e, void* stream) {
  return launch<true>(adj, w2t, n_prows, a_rows, a_adj, a_w2, n_a, p_prow, p_sub, p_slot, p_id, p_sc, p_w2,
                      p_img, p, e_adj, e_w2, n_e, stream);
}

// K3: the adjacency table alone.
extern "C" int jv_packed_adj_only_update(void* adj, long long n_prows, const void* a_rows, const void* a_adj,
                                         int n_a, const void* p_prow, const void* p_sub, const void* p_slot,
                                         const void* p_id, const void* p_sc, const void* p_img, int p,
                                         const void* e_adj, int n_e, void* stream) {
  return launch<false>(adj, nullptr, n_prows, a_rows, a_adj, nullptr, n_a, p_prow, p_sub, p_slot, p_id, p_sc,
                       nullptr, p_img, p, e_adj, nullptr, n_e, stream);
}
