// K5: PQ assemble-and-sum (ADC scoring).
//
// Replaces the TPU kernel jvector_tpu/ops/pallas/adc_kernel.py
// (_adc_kernel, entry adc_score_pallas):
//
//     out[q, c] = sum_m luts[q, m, codes[q, c, m]]
//
// luts [Q, M, K] float32 (each query's [M, K] table contiguous; the query
// stride may be 0 for one table shared by all queries), codes [Q, C, M]
// uint8 (K <= 256), out [Q, C] float32.  One float32 accumulator per
// candidate starts at 0 and adds the table entries for m ascending, the
// Pallas kernel's loop, so the output equals adc_score_ordered (the plain
// twin in ops/adc.py) bit for bit.  The TPU kernel's one-hot
// compare-and-reduce only stood in for a gather Mosaic lacked; Hopper
// gathers from shared memory directly.
//
// Bound: device-memory bytes, nearly all of them the LUTs.  A query's
// table is M*K*4 bytes (16 KB at M = 16, 24 KB at M = 24) against its C*M
// code bytes (896 at the serve shape) and C*4 output bytes; the sums are
// C*M shared-memory gathers and adds.  At the centroid scan (Q = 1, C ~ 1M) the gathers bind instead:
// 16M random 4-byte reads of a 1 KB row conflict ~3.5-way on the 32 banks.
//
// Design:
// - TMA bulk copies.  One producer lane issues one
//   cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes for a
//   whole table, completing on the stage's `full` mbarrier, so no thread
//   spends registers or issue slots on staging.  A table whose address or
//   size is not a multiple of 16 bytes takes 4-byte cp.async copies from
//   all 32 producer lanes instead, each lane arriving on the same barrier
//   when its copies land.
// - A ring of two table stages in dynamic shared memory (Hopper's opt-in
//   227 KB a block, set once a device): warp 0 refills a stage when the
//   consumer warps have arrived on its `empty` mbarrier, so a block's next
//   table is in flight while it scores the current one.  A table larger
//   than one block may hold (M > 226 at K = 256) streams in 112-subspace
//   M-chunks, each a stage; a candidate's partial sum then passes through
//   out[q, c], which only its thread touches, so the order is kept.
// - Persistent grid: as many blocks as fit on the 132 SMs at once, never
//   more than the work items, each walking items b, b + grid, ...  An item
//   is a query's candidates, or a slice of them where too few queries
//   would leave SMs idle.  Measured on the H100: more resident blocks of
//   two stages beat deeper rings in fewer blocks, and carrying the code
//   blocks through the ring gained nothing (PERF.md).
// - One table for every query (a query stride of 0, or Q = 1): warp 0
//   copies it once a block and then scores with the other warps.
// - Consumers: one thread owns one candidate's sum.  Its code row is read
//   straight from [Q, C, M] in 16-byte vectors when M % 16 == 0 and the
//   codes are 16-byte aligned, 8-byte vectors when M % 8 == 0 (M = 24),
//   bytes otherwise.  The first 32 bytes of a thread's first two rows are
//   loaded before the wait on the stage's barrier, and each later row's
//   two candidates ahead of its sum, so the code loads overlap the
//   table's arrival and each other.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSmem = 232448;  // Hopper's opt-in dynamic shared memory a block
constexpr int kMaxStages = 4;
constexpr int kBarBytes = 128;  // full and empty barriers (2 x 4 x 8 bytes), padded: the ring starts 128-byte aligned
constexpr int kMaxThreads = 32 + 256;  // the producer warp and up to 8 consumer warps
static_assert(2 * kMaxStages * 8 <= kBarBytes, "the barriers outgrow their bytes");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Announce `bytes` of bulk copies completing on `bar` (the producer's one arrival).
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// One TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned), completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

// One lane's share of a copy of `n` floats in 4-byte cp.async steps; the
// lane's arrival on `bar` fires when its copies have landed.
__device__ __forceinline__ void lane_load(float* dst, const float* src, int n, int lane, uint64_t* bar) {
  for (int i = lane; i < n; i += 32) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst + i)), "l"(src + i) : "memory");
  }
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar)) : "memory");
}

template <int V>
struct Vec;
template <>
struct Vec<16> {
  using T = uint4;
};
template <>
struct Vec<8> {
  using T = uint2;
};
template <>
struct Vec<1> {
  using T = uint8_t;
};

// acc += lut[m][byte m of w] for the word's four subspaces, in order.
__device__ __forceinline__ float add_word(float acc, const float* lut, int k, uint32_t w) {
  acc += lut[w & 0xffu];
  acc += lut[k + ((w >> 8) & 0xffu)];
  acc += lut[2 * k + ((w >> 16) & 0xffu)];
  acc += lut[3 * k + (w >> 24)];
  return acc;
}

__device__ __forceinline__ float add_vec(float acc, const float* lut, int k, uint4 v) {
  acc = add_word(acc, lut, k, v.x);
  acc = add_word(acc, lut + 4 * k, k, v.y);
  acc = add_word(acc, lut + 8 * k, k, v.z);
  return add_word(acc, lut + 12 * k, k, v.w);
}

__device__ __forceinline__ float add_vec(float acc, const float* lut, int k, uint2 v) {
  acc = add_word(acc, lut, k, v.x);
  return add_word(acc, lut + 4 * k, k, v.y);
}

__device__ __forceinline__ float add_vec(float acc, const float* lut, int, uint8_t v) { return acc + lut[v]; }

// The first 32 bytes of a candidate's code row, loaded ahead of the sum.
template <int V>
struct Row {
  static constexpr int kPre = 32 / V;
  typename Vec<V>::T v[kPre];
};

template <int V>
__device__ __forceinline__ void load_row(Row<V>& r, const uint8_t* row, int nv) {
  const auto* p = reinterpret_cast<const typename Vec<V>::T*>(row);
#pragma unroll
  for (int j = 0; j < Row<V>::kPre; ++j) {
    if (j < nv) r.v[j] = p[j];
  }
}

template <int V>
__device__ __forceinline__ float sum_row(float acc, const float* lut, int k, const Row<V>& r, const uint8_t* row,
                                         int nv) {
  const auto* p = reinterpret_cast<const typename Vec<V>::T*>(row);
#pragma unroll
  for (int j = 0; j < Row<V>::kPre; ++j) {
    if (j < nv) acc = add_vec(acc, lut + j * V * k, k, r.v[j]);
  }
  for (int j = Row<V>::kPre; j < nv; ++j) acc = add_vec(acc, lut + j * V * k, k, p[j]);
  return acc;
}

// Work item i is query i / split, candidates [(i % split) * slice, + slice).
template <int V>
__global__ void __launch_bounds__(kMaxThreads) adc_ring_kernel(const float* __restrict__ luts, long long lut_q_stride,
                                                               const uint8_t* __restrict__ codes,
                                                               float* __restrict__ out, int c, int m, int k,
                                                               int m_chunk, int split, int slice, int stages,
                                                               int n_items, bool bulk, bool shared) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  float* ring = reinterpret_cast<float*>(smem + kBarBytes);
  const int stage_floats = (m_chunk * k + 31) / 32 * 32;  // 128-byte stages
  const int n_chunks = (m + m_chunk - 1) / m_chunk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      bar_init(&full[s], bulk ? 1 : 32);
      if (!shared) bar_init(&empty[s], blockDim.x / 32 - 1);  // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (shared) {  // one table for every query: warp 0 copies it once, then every warp scores
    if (warp == 0) {
      if (!bulk) {
        lane_load(ring, luts, m * k, lane, &full[0]);
      } else if (lane == 0) {
        bar_expect(&full[0], static_cast<uint32_t>(m) * k * 4u);
        bulk_copy(ring, luts, static_cast<uint32_t>(m) * k * 4u, &full[0]);
      }
    }
  } else if (warp == 0) {  // producer: fill the ring, `stages` tables ahead of the consumers
    // A bulk copy needs one lane; the others leave, so that no idle lane
    // trails the ring by two phases of a barrier and waits on the wrong one.
    if (bulk && lane != 0) return;
    int t = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const float* lut_q = luts + static_cast<long long>(item / split) * lut_q_stride;
      for (int ch = 0; ch < n_chunks; ++ch, ++t) {
        const int s = t % stages;
        if (t >= stages) bar_wait(&empty[s], (t / stages - 1) & 1);
        const int n = min(m_chunk, m - ch * m_chunk) * k;
        const float* src = lut_q + static_cast<long long>(ch) * m_chunk * k;
        float* dst = ring + s * stage_floats;
        if (bulk) {
          bar_expect(&full[s], static_cast<uint32_t>(n) * 4u);
          bulk_copy(dst, src, static_cast<uint32_t>(n) * 4u, &full[s]);
        } else {
          lane_load(dst, src, n, lane, &full[s]);
        }
      }
    }
    return;
  }

  const int ct = shared ? threadIdx.x : threadIdx.x - 32;
  const int nct = shared ? blockDim.x : blockDim.x - 32;
  int t = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const long long qi = item / split;
    const int lo = (item % split) * slice, hi = min(c, lo + slice);
    float* out_q = out + qi * c;
    for (int ch = 0; ch < n_chunks; ++ch, ++t) {
      const int s = shared ? 0 : t % stages;
      const int m0 = ch * m_chunk, nv = min(m_chunk, m - m0) / V;
      const uint8_t* rows = codes + qi * c * m + m0;
      // this thread's first two code rows are in flight before the wait, and
      // each later row two candidates ahead of its sum
      int cand = lo + ct;
      Row<V> cur, nxt;
      if (cand < hi) load_row(cur, rows + static_cast<long long>(cand) * m, nv);
      if (cand + nct < hi) load_row(nxt, rows + static_cast<long long>(cand + nct) * m, nv);
      bar_wait(&full[s], shared ? 0 : (t / stages) & 1);
      const float* lut = ring + s * stage_floats;
      while (cand < hi) {
        const float acc = ch == 0 ? 0.f : out_q[cand];
        out_q[cand] = sum_row(acc, lut, k, cur, rows + static_cast<long long>(cand) * m, nv);
        cand += nct;
        cur = nxt;
        if (cand + nct < hi) load_row(nxt, rows + static_cast<long long>(cand + nct) * m, nv);
      }
      __syncwarp();
      if (lane == 0 && !shared) bar_arrive(&empty[s]);
    }
  }
}

constexpr int kMaxDevices = 64;

template <int V>
int launch(const float* luts, long long lut_q_stride, const uint8_t* codes, float* out, int q, int c, int m, int k,
           int m_chunk, int split, int slice, int stages, int threads, int blocks, bool bulk, bool shared,
           size_t smem, cudaStream_t stream) {
  // Opt in to the whole 227 KB once a device (a racing second opt-in is harmless).
  static bool opted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(adc_ring_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[dev] = true;
  }
  adc_ring_kernel<V><<<blocks, threads, smem, stream>>>(luts, lut_q_stride, codes, out, c, m, k, m_chunk, split,
                                                        slice, stages, q * split, bulk, shared);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch K5 with the wrapper's plan: m_chunk subspaces a ring stage,
// `stages` stages, each query's candidates in `split` slices of `slice`,
// `threads` threads a block (one producer warp and the consumers; all
// consumers for a shared table), `blocks` blocks, code loads of `vec`
// bytes, TMA bulk copies when `bulk`.  A query stride of 0 shares one
// table.  A plan the kernel cannot run is refused with
// cudaErrorInvalidValue.
extern "C" int jv_adc_score_planned(const void* luts, long long lut_q_stride, const void* codes, void* out, int q,
                                    int c, int m, int k, int m_chunk, int split, int slice, int stages, int threads,
                                    int blocks, int vec, int bulk, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (q <= 0 || c <= 0 || m <= 0 || k <= 0 || k > 256) return bad;
  if (m_chunk <= 0 || m_chunk > m || stages < 1 || stages > kMaxStages) return bad;
  const int n_chunks = (m + m_chunk - 1) / m_chunk;
  const bool shared = lut_q_stride == 0 && n_chunks == 1;
  if (threads < (shared ? 32 : 64) || threads > kMaxThreads || threads % 32 != 0) return bad;
  if (split < 1 || slice < 1 || static_cast<long long>(split) * slice < c || blocks < 1) return bad;
  if (static_cast<long long>(q) * split > 0x7fffffff || blocks > q * split) return bad;
  if (vec != 1 && vec != 8 && vec != 16) return bad;
  const uintptr_t cp = reinterpret_cast<uintptr_t>(codes), lp = reinterpret_cast<uintptr_t>(luts);
  if (m % vec != 0 || m_chunk % vec != 0 || cp % vec != 0) return bad;
  const long long last = static_cast<long long>(m - (n_chunks - 1) * m_chunk) * k * 4;
  if (bulk && (lp % 16 != 0 || (lut_q_stride * 4) % 16 != 0 || (static_cast<long long>(m_chunk) * k * 4) % 16 != 0 ||
               last % 16 != 0)) {
    return bad;
  }
  const long long smem = kBarBytes + static_cast<long long>(stages) * ((m_chunk * k + 31) / 32 * 128);
  if (smem > kMaxSmem) return bad;
  const float* l = static_cast<const float*>(luts);
  const uint8_t* cd = static_cast<const uint8_t*>(codes);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 16) return launch<16>(l, lut_q_stride, cd, o, q, c, m, k, m_chunk, split, slice, stages, threads, blocks,
                                   bulk != 0, shared, smem, s);
  if (vec == 8) return launch<8>(l, lut_q_stride, cd, o, q, c, m, k, m_chunk, split, slice, stages, threads, blocks,
                                 bulk != 0, shared, smem, s);
  return launch<1>(l, lut_q_stride, cd, o, q, c, m, k, m_chunk, split, slice, stages, threads, blocks, bulk != 0,
                   shared, smem, s);
}
