// K8: the beam step's frontier filter: which of a step's candidates are
// valid and seen for the first time.
//
// Replaces no TPU kernel.  The JAX package computes the same mask in jnp
// (jvector_tpu/graph/searcher.py: _dedup_new and the mask around it in
// _step), which XLA fuses on the TPU.  In PyTorch the same composition is
// about sixteen ATen calls a step, whose [Q, C, L] and [Q, C, T] bool
// intermediates went through device memory and back: most of the device
// time of a BQ search with a 90-wide beam on the H100 (PERF.md).  The
// plain twin (ops/kernels/frontier.py, frontier_filter_ref) is that
// composition.
//
// Contract, for each query row q and candidate i < C = E * R:
//   valid[i] = nbrs[q, i] >= 0 and active[q, i / R]
//   dup[i]   = nbrs[q, i] equals an id of beam[q, :] or history[q, :], or
//              the id of a valid candidate j < i of the same row
//   fresh[q, i]   = valid[i] and not dup[i]          (bool, 0 or 1)
//   new_ids[q, i] = fresh ? nbrs[q, i] : -1
//   safe[q, i]    = fresh ? nbrs[q, i] : 0
// An invalid candidate is never fresh, so only ids >= 0 are looked up and
// the -1 padding of the beam and the history matches none of them.
//
// Bound: bytes and integer compares, not the tensor cores.  At the BQ
// cell's serve shape (Q = 10,000, C = 56, L = 90, T = 256) the inputs are
// 16.1 MB and the outputs 5.0 MB: 6.3 us at 3.35 TB/s.  The compares
// number Q * C * (L + T + (C - 1) / 2), 209 M: 12.5 us at one int32
// compare a lane and clock (64 lanes an SM, 132 SMs, 1.98 GHz, the clock
// of the data sheet's 67 TFLOP/s of float32).  A row whose pop
// slots are all empty (54% of the BQ cell's lane-steps) needs neither its
// beam nor its history, so the work the data asks for is about half that.
//
// Design: one warp a query row, four rows a 128-thread block, so the grid
// is thousands of blocks at the serve shapes.
// - A lane holds K candidates (positions c0 + 32k + lane, K = 1..16 from
//   the wrapper: the least power of two that covers C, so one chunk of
//   32K candidates at every shape the port sends; a wider C is walked in
//   chunks), already masked to -1 where invalid.  A warp whose chunk holds
//   no valid candidate writes "not fresh" and reads nothing more.
// - The row's beam and history are copied into the warp's slice of
//   shared memory by cp.async (16 bytes a lane where the row is 16-byte
//   aligned, else 4), each padded with -1 to a multiple of four ids: one
//   tile, read once, at the serve and build shapes.  Every lane then
//   reads the same 16-byte word at a time (a broadcast: no bank
//   conflicts) and compares its K candidates with its four ids.  Where
//   L + T outgrows the warp's tile (the wrapper caps it at 2,048 ids,
//   32 KB a block; filtered widening at L = 1,600), the beam and history
//   are walked through the tile in turns, as they are again for each
//   further chunk of a C wider than 512.
// - Same-step duplicates: each candidate of the chunk is broadcast by a
//   warp shuffle and compared with the lanes' own candidates at higher
//   positions only; earlier chunks, where there are any, are reloaded and
//   compared whole.  Nothing goes through device memory between the
//   compares and the three outputs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // query rows a block, one warp each
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSmem = 48 * 1024;  // the default dynamic shared memory limit
constexpr unsigned kAll = 0xffffffffu;

struct Frontier {
  const int32_t* nbrs;    // [q, c]
  const uint8_t* active;  // [q, e] bool
  const int32_t* beam;    // [q, l]
  const int32_t* hist;    // [q, t]
  uint8_t* fresh;         // [q, c] bool
  int32_t* new_ids;       // [q, c]
  int32_t* safe;          // [q, c]
  long long q;
  int c, e, r, l, t;
  int tile;  // ids of shared memory a warp, a multiple of 4
};

__device__ __forceinline__ void cp_async4(int32_t* dst, const int32_t* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(int32_t* dst, const int32_t* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Starts the copy of n ids from src into dst (16-byte aligned shared
// memory), padded with -1 to a multiple of 4; returns the padded count.
__device__ __forceinline__ int stage(int32_t* dst, const int32_t* src, int n, int lane) {
  const int padded = (n + 3) & ~3;
  int head = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    head = n & ~3;
    for (int i = 4 * lane; i < head; i += 128) cp_async16(dst + i, src + i);
  }
  for (int i = head + lane; i < padded; i += 32) {
    if (i < n) cp_async4(dst + i, src + i);
    else dst[i] = -1;
  }
  return padded;
}

// The lane's K candidates of the chunk at c0: the id where valid, else -1.
template <int K>
__device__ __forceinline__ void load_cands(int (&v)[K], const Frontier& p, const int32_t* nrow,
                                           const uint8_t* arow, int c0, int lane) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = c0 + 32 * k + lane;
    int x = -1;
    if (i < p.c) {
      const int id = __ldg(nrow + i);
      if (id >= 0 && __ldg(arow + i / p.r)) x = id;
    }
    v[k] = x;
  }
}

// dup[k] |= cand[k] is one of the n ids (a multiple of 4) at s.
template <int K>
__device__ __forceinline__ void against(bool (&dup)[K], const int (&cand)[K], const int32_t* s, int n) {
  const int4* s4 = reinterpret_cast<const int4*>(s);
#pragma unroll 4
  for (int j = 0; j < n / 4; ++j) {
    const int4 v = s4[j];
#pragma unroll
    for (int k = 0; k < K; ++k) dup[k] |= (v.x == cand[k]) | (v.y == cand[k]) | (v.z == cand[k]) | (v.w == cand[k]);
  }
}

// dup[k] |= cand[k] equals one of the warp's candidates x (n of them in
// position order); with kLower, only one at a lower position than cand[k]
// (x is then the same chunk as cand).
template <int K, bool kLower>
__device__ __forceinline__ void cross(bool (&dup)[K], const int (&cand)[K], const int (&x)[K], int n, int lane) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    const int m = min(n - 32 * kk, 32);
    if (m <= 0) break;
    for (int src = 0; src < m; ++src) {
      const int v = __shfl_sync(kAll, x[kk], src);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (kLower && k < kk) continue;
        const bool hit = v == cand[k];
        dup[k] |= (kLower && k == kk) ? (hit && src < lane) : hit;
      }
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads) frontier_kernel(const Frontier p) {
  extern __shared__ int4 smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long q = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (q >= p.q) return;  // whole warps only: no block-wide barrier follows
  int32_t* s = reinterpret_cast<int32_t*>(smem) + warp * p.tile;
  const long long row = q * p.c;
  const int32_t* nrow = p.nbrs + row;
  const uint8_t* arow = p.active + q * p.e;
  const int32_t* brow = p.beam + q * p.l;
  const int32_t* hrow = p.hist + q * p.t;
  constexpr int kChunk = 32 * K;
  for (int c0 = 0; c0 < p.c; c0 += kChunk) {
    int cand[K];
    bool dup[K];
    load_cands<K>(cand, p, nrow, arow, c0, lane);
    bool any = false;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      dup[k] = false;
      any |= cand[k] >= 0;
    }
    if (__any_sync(kAll, any)) {
      int seg = 0, off = 0;  // the beam (0), then the history (1): off ids into it
      while (seg < 2) {
        int fill = 0;
        while (seg < 2 && fill < p.tile) {
          const int n = seg ? p.t : p.l;
          const int take = min(n - off, p.tile - fill);
          fill += stage(s + fill, (seg ? hrow : brow) + off, take, lane);
          off += take;
          if (off == n) {
            ++seg;
            off = 0;
          }
        }
        cp_async_wait_all();
        __syncwarp();
        against<K>(dup, cand, s, fill);
        __syncwarp();  // the tile is read before the next copy lands
      }
      for (int e0 = 0; e0 < c0; e0 += kChunk) {
        int x[K];
        load_cands<K>(x, p, nrow, arow, e0, lane);
        cross<K, false>(dup, cand, x, kChunk, lane);
      }
      cross<K, true>(dup, cand, cand, p.c - c0, lane);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = c0 + 32 * k + lane;
      if (i < p.c) {
        const bool f = cand[k] >= 0 && !dup[k];
        p.fresh[row + i] = f;
        p.new_ids[row + i] = f ? cand[k] : -1;
        p.safe[row + i] = f ? cand[k] : 0;
      }
    }
  }
}

}  // namespace

// K8 on q query rows of c = e * r candidates, with k candidates a lane
// (1, 2, 4, 8 or 16) and tile ids of shared memory a warp (a multiple of
// 4), on card `device` and `stream`.  Refuses any other plan, or a shape
// whose sizes do not fit the kernel's 32-bit counts.
extern "C" int jv_frontier(const void* nbrs, const void* active, const void* beam, const void* hist, void* fresh,
                           void* new_ids, void* safe, long long q, long long c, long long e, long long r, long long l,
                           long long t, long long k, long long tile, int device, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (q < 0 || c < 0 || e < 1 || r < 1 || c != e * r || l < 0 || t < 0) return bad;
  if (c > 0x7fffffffLL || l > 0x7fffffffLL || t > 0x7fffffffLL) return bad;
  if ((k != 1 && k != 2 && k != 4 && k != 8 && k != 16) || tile < 4 || tile % 4 || kWarps * tile * 4 > kMaxSmem)
    return bad;
  if (q == 0 || c == 0) return 0;
  const long long blocks = (q + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return bad;
  const Frontier p{static_cast<const int32_t*>(nbrs), static_cast<const uint8_t*>(active),
                   static_cast<const int32_t*>(beam), static_cast<const int32_t*>(hist),
                   static_cast<uint8_t*>(fresh), static_cast<int32_t*>(new_ids), static_cast<int32_t*>(safe),
                   q, static_cast<int>(c), static_cast<int>(e), static_cast<int>(r), static_cast<int>(l),
                   static_cast<int>(t), static_cast<int>(tile)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned g = static_cast<unsigned>(blocks);
  const size_t bytes = static_cast<size_t>(kWarps) * tile * 4;
  switch (k) {
    case 1: frontier_kernel<1><<<g, kThreads, bytes, s>>>(p); break;
    case 2: frontier_kernel<2><<<g, kThreads, bytes, s>>>(p); break;
    case 4: frontier_kernel<4><<<g, kThreads, bytes, s>>>(p); break;
    case 8: frontier_kernel<8><<<g, kThreads, bytes, s>>>(p); break;
    default: frontier_kernel<16><<<g, kThreads, bytes, s>>>(p); break;
  }
  err = cudaGetLastError();
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}
