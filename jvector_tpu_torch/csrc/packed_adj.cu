// K1 and K3: one build wave's in-place writes to the packed adjacency table
// and, for K1, the w2 table beside it.
//
// Replaces the TPU kernels of jvector_tpu/ops/pallas/packed_adj.py:
//   K1 _packed_update_kernel      (entry packed_adj_update_inplace)      -> jv_packed_adj_update
//   K3 _packed_update_kernel_now2 (entry packed_adj_only_update_inplace) -> jv_packed_adj_only_update
// K3 is K1 without the w2 table (the larger-than-memory build keeps no
// fused tables); both entries share the two phase kernels below, the w2
// writes compiled out by a template flag.  Layout, as on the TPU: adj and
// w2t are [N/8, 8, 128] int32 ("physical rows" of 8 sublanes).  An adj
// sublane holds neighbor ids in lanes [0:R] and float32 score bits in lanes
// [64:64+R]; a w2t sublane holds float32 bits of the neighbors' per-node
// constants in lanes [0:R].
//
// Contract (the phase order is the contract):
//   Phase A: whole 8-sublane images a_adj[i] (/ a_w2[i]) land on physical
//            row a_rows[i] (the wave's rows, one contiguous aligned block).
//   Phase B: a patch stream SORTED by physical row p_prow.  Patch j either
//            sets one id / score (/ w2) at lane p_slot[j] of sublane
//            p_sub[j] (p_img[j] < 0), or replaces the whole sublane with
//            the enforce images e_adj[p_img[j]] (/ e_w2[p_img[j]]).
//            Phase B lands after phase A; within one physical row the
//            patches apply in stream order, so a later patch to the same
//            (row, sublane, lane) wins, as on the TPU.
//   Rows outside [0, n_prows) are dropped, as are patches whose sublane,
//   slot or image index is out of range.
//
// Design: what the TPU kernels spent on VMEM read-modify-write chunking
// (p_last, 256-patch chunks) has no counterpart here.  Phase A is one block
// per physical row, copying 4 KB per table with 16-byte vector loads.  Phase
// B is one warp per run of equal rows in the sorted stream: the warp walks
// its run in order, a sublane image is 512 B = one 16-byte vector per lane,
// a scalar patch is two (K3) or three (K1) 4-byte stores by lane 0, and
// __syncwarp() between patches orders the warp's writes.  Runs touch
// disjoint rows, so warps never race.  One launch per phase, in order, on
// the caller's stream; the kernels allocate nothing.
//
// Bound: at the 1M path a wave moves W/8 = 64 images of 4 KB (K3) or 8 KB
// (K1) plus P = 16,896 patches (a few MB at most), so a call is bound by
// launch latency and scattered 16-byte transactions, not by compute.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowVecs = 8 * 128 * 4 / 16;  // int4 vectors in one physical row
constexpr int kSubVecs = 128 * 4 / 16;      // int4 vectors in one sublane (= 32)

template <bool kW2>
__global__ void phase_a_kernel(int4* __restrict__ adj, int4* __restrict__ w2t, long long n_prows,
                               const int32_t* __restrict__ a_rows, const int4* __restrict__ a_adj,
                               const int4* __restrict__ a_w2) {
  const long long i = blockIdx.x;
  const long long r = a_rows[i];
  if (r < 0 || r >= n_prows) return;
  for (int t = threadIdx.x; t < kRowVecs; t += blockDim.x) {
    adj[r * kRowVecs + t] = a_adj[i * kRowVecs + t];
    if (kW2) w2t[r * kRowVecs + t] = a_w2[i * kRowVecs + t];
  }
}

template <bool kW2>
__global__ void phase_b_kernel(int32_t* __restrict__ adj, int32_t* __restrict__ w2t, long long n_prows,
                               int p, const int32_t* __restrict__ p_prow, const int32_t* __restrict__ p_sub,
                               const int32_t* __restrict__ p_slot, const int32_t* __restrict__ p_id,
                               const int32_t* __restrict__ p_sc, const int32_t* __restrict__ p_w2,
                               const int32_t* __restrict__ p_img, const int4* __restrict__ e_adj,
                               const int4* __restrict__ e_w2, int n_e) {
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= p) return;
  const int32_t r = p_prow[warp];
  if (r < 0 || r >= n_prows) return;
  if (warp > 0 && p_prow[warp - 1] == r) return;  // not the start of a run
  for (long long j = warp; j < p && p_prow[j] == r; ++j) {
    const int32_t sub = p_sub[j];
    const int32_t img = p_img[j];
    if (sub >= 0 && sub < 8) {
      const long long base = (static_cast<long long>(r) * 8 + sub) * 128;
      if (img >= 0) {
        if (img < n_e) {
          reinterpret_cast<int4*>(adj + base)[lane] = e_adj[static_cast<long long>(img) * kSubVecs + lane];
          if (kW2) reinterpret_cast<int4*>(w2t + base)[lane] = e_w2[static_cast<long long>(img) * kSubVecs + lane];
        }
      } else if (lane == 0) {
        const int32_t slot = p_slot[j];
        if (slot >= 0 && slot < 64) {
          adj[base + slot] = p_id[j];
          adj[base + 64 + slot] = p_sc[j];
          if (kW2) w2t[base + slot] = p_w2[j];
        }
      }
    }
    __syncwarp();
  }
}

// Both phases on the caller's stream; the w2 arguments are ignored (and may
// be null) when kW2 is false.  Returns the first launch error.
template <bool kW2>
int launch_phases(void* adj, void* w2t, long long n_prows, const void* a_rows, const void* a_adj,
                  const void* a_w2, int n_a, const void* p_prow, const void* p_sub, const void* p_slot,
                  const void* p_id, const void* p_sc, const void* p_w2, const void* p_img, int p,
                  const void* e_adj, const void* e_w2, int n_e, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_a > 0) {
    phase_a_kernel<kW2><<<n_a, 256, 0, s>>>(static_cast<int4*>(adj), static_cast<int4*>(w2t), n_prows,
                                            static_cast<const int32_t*>(a_rows),
                                            static_cast<const int4*>(a_adj), static_cast<const int4*>(a_w2));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (p > 0) {
    const int threads = 256;  // 8 warps, one patch position each
    const long long blocks = (static_cast<long long>(p) * 32 + threads - 1) / threads;
    phase_b_kernel<kW2><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        static_cast<int32_t*>(adj), static_cast<int32_t*>(w2t), n_prows, p,
        static_cast<const int32_t*>(p_prow), static_cast<const int32_t*>(p_sub),
        static_cast<const int32_t*>(p_slot), static_cast<const int32_t*>(p_id),
        static_cast<const int32_t*>(p_sc), static_cast<const int32_t*>(p_w2),
        static_cast<const int32_t*>(p_img), static_cast<const int4*>(e_adj),
        static_cast<const int4*>(e_w2), n_e);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1: adjacency + w2 tables.
extern "C" int jv_packed_adj_update(void* adj, void* w2t, long long n_prows, const void* a_rows,
                                    const void* a_adj, const void* a_w2, int n_a, const void* p_prow,
                                    const void* p_sub, const void* p_slot, const void* p_id,
                                    const void* p_sc, const void* p_w2, const void* p_img, int p,
                                    const void* e_adj, const void* e_w2, int n_e, void* stream) {
  return launch_phases<true>(adj, w2t, n_prows, a_rows, a_adj, a_w2, n_a, p_prow, p_sub, p_slot, p_id, p_sc,
                             p_w2, p_img, p, e_adj, e_w2, n_e, stream);
}

// K3: the adjacency table alone.
extern "C" int jv_packed_adj_only_update(void* adj, long long n_prows, const void* a_rows, const void* a_adj,
                                         int n_a, const void* p_prow, const void* p_sub, const void* p_slot,
                                         const void* p_id, const void* p_sc, const void* p_img, int p,
                                         const void* e_adj, int n_e, void* stream) {
  return launch_phases<false>(adj, nullptr, n_prows, a_rows, a_adj, nullptr, n_a, p_prow, p_sub, p_slot, p_id,
                              p_sc, nullptr, p_img, p, e_adj, nullptr, n_e, stream);
}
