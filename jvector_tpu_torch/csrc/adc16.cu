// K6: LUT16 (4-bit PQ) assemble-and-sum.
//
// Replaces the TPU kernel jvector_tpu/ops/pallas/adc16_kernel.py
// (_adc16_kernel, entry adc16_pallas):
//
//     out[q, c] = sum_j luts[q, j, lo(codes[q, j, c])] + luts[q, j, 16 + hi(codes[q, j, c])]
//
// luts [Q, MP, 32] float32 (row j: the 16 entries of subspace 2j, then the
// 16 of subspace 2j+1; the query stride may be 0 for one table shared by
// all queries, the cosine norm), codes [Q, MP, C] uint8 (two 4-bit codes a
// byte, subspace-major, so C is the minor dim), out [Q, C] float32.
//
// Order: one float32 accumulator a candidate starts at 0 and walks j
// ascending; for each byte it adds the entry of the smaller nibble first,
// the low one on a tie.  That is the Pallas kernel's order (it walks
// k = 0..15 adding lut[k] where lo == k, then lut[16 + k] where hi == k,
// and exact zeros elsewhere), so the output equals adc16_ordered (the
// plain twin in ops/adc16.py) bit for bit.  The TPU kernel's one-hot
// compare-and-select and its pad of MP to 8 sublanes only worked around
// Mosaic (no vector gather, 8-row aligned dynamic slices); neither is
// carried over.
//
// Bound: device-memory bytes on paper, the SMs' instruction rate in
// practice.  At the 200k serve shape (Q = 4096, MP = 32, C = 64) the
// tables are 16.8 MB, the codes 8.4 MB and the output 1.0 MB: 7.8 us at
// 3.35 TB/s; off a shared table (the cosine norm) the codes and the
// output alone: 2.8 us.  But a code byte costs two shared-memory gathers,
// two adds and the order's choice, about 13 instructions, so the
// instruction rate sets the pace: the shared-table shape moves a third of
// the serve shape's bytes and takes nearly as long (PERF.md), and the
// memory trips hide under the sums.
//
// Design (the launch plan comes from the wrapper, ops/kernels/adc16.py):
// - An item is one query's tile of tpq * V candidates; a block holds qpb
//   items side by side, tpq threads each (whole warps), and a thread owns
//   V consecutive candidates (1 or 2 on the paths: a byte or half-word of
//   each code row; two give each thread two independent chains of adds).
//   Blocks are small (four queries at the serve shapes, one at the
//   micro's), so that the grid fills the 132 SMs at every shape and each
//   SM keeps many warps; a block walks item groups b, b + grid, ...
// - Both trips at once, in few large copies: thread 0 asks for the
//   group's tables with one TMA bulk copy (cp.async.bulk ...
//   mbarrier::complete_tx; one a query where the tables do not lie end to
//   end) and for its code rows with one more (where an item is a whole
//   query, C a multiple of 16 and the codes 16-byte aligned; otherwise
//   each thread reads its own code bytes from device memory, its first
//   rows asked for before the wait).  Tables off a 16-byte boundary come
//   by 4-byte cp.async from every thread instead.  Bulk copies of a few
//   hundred bytes each (a ring of 8-row stages) measured 2-4x slower: the
//   TMA unit takes its time for every copy.
// - The order's choice is made on the two gather addresses (a compare and
//   two selects), and each row's offset is added after it, so that it
//   folds into the gathers' immediate offsets; a thread loads 16 code rows
//   ahead of their sums.  A warp lies inside one item, so its lanes gather
//   from one table row, whose 16 low (or high) entries sit in 16 banks;
//   equal nibbles broadcast: no bank conflicts.
// - One shared table (a query stride of 0): one copy a block, and the grid
//   at most four blocks an SM.
// - C <= 4 (the entry scores, C = 1): no copies; one thread a candidate
//   gathers its 2 * MP entries from device memory, a fraction of its
//   query's table sectors (adc16_direct_kernel).
// - Tables that outgrow a block's 48 KB (one query, MP > 383) are copied
//   in chunks of rows; a candidate's sum stays in its thread's register
//   from the first row to the last, so the order is kept at any MP.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kRow = 32;             // floats a paired table row
constexpr int kBarBytes = 16;        // the mbarrier, padded: the tables start 16-byte aligned
constexpr int kMaxSmem = 48 * 1024;  // the default dynamic shared memory limit
constexpr int kUnroll = 16;          // code rows a thread reads ahead of its sums
constexpr int kPrefetchRows = 32;    // code rows asked for before the wait when read from device memory

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

// Announce `bytes` of bulk copies completing on `bar` (thread 0's arrival).
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

// This thread's share of a copy of `n` floats in 4-byte cp.async steps.
__device__ __forceinline__ void copy_floats(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst + i)), "l"(src + i) : "memory");
  }
}

// This thread's arrival on `bar`, once its cp.async copies have landed.
__device__ __forceinline__ void arrive_after_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ float lds(uint32_t addr) {
  float x;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(x) : "r"(addr));
  return x;
}

// x * 4 + base in one instruction: written out, the compiler rebuilds
// (b & 15) * 4 as (b * 4) & 60 beside the b & 15 that the compare needs.
__device__ __forceinline__ uint32_t mad4(uint32_t x, uint32_t base) {
  uint32_t y;
  asm("mad.lo.u32 %0, %1, 4, %2;" : "=r"(y) : "r"(x), "r"(base));
  return y;
}

// acc plus the two entries of byte b in row `off` (bytes) of the table at
// shared address `tab`, the smaller nibble's first (the low one on a tie):
// the Pallas kernel's order.  The choice is made on the addresses within
// the row, and the row's offset added after it, so that it folds into the
// gathers' immediate offsets.
__device__ __forceinline__ float add_byte(float acc, uint32_t tab, uint32_t b, uint32_t off) {
  const uint32_t lo = b & 15u, hi = b >> 4;
  const uint32_t at_lo = mad4(lo, tab), at_hi = mad4(hi, tab + 64u);
  const bool hi_first = hi < lo;
  acc += lds((hi_first ? at_hi : at_lo) + off);
  return acc + lds((hi_first ? at_lo : at_hi) + off);
}

template <int V>
__device__ __forceinline__ void add_word(float (&acc)[V], uint32_t tab, uint32_t w, uint32_t off) {
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = add_byte(acc[k], tab, V == 1 ? w : (w >> (8 * k)) & 0xffu, off);
}

// The V code bytes of a thread's candidates in one row, from shared or
// device memory.
template <int V, bool kGlobal>
__device__ __forceinline__ uint32_t load_code(const uint8_t* p) {
  if constexpr (V == 2) {
    return kGlobal ? __ldg(reinterpret_cast<const unsigned short*>(p)) : *reinterpret_cast<const uint16_t*>(p);
  } else {
    return kGlobal ? __ldg(p) : *p;
  }
}

// Rows [0, N) of the thread's candidates: the N code loads first (row r at
// codes + r * c), then the sums, row by row.
template <int V, bool kGlobal, int N>
__device__ __forceinline__ void sum_rows(float (&acc)[V], uint32_t tab, const uint8_t* codes, int c) {
  uint32_t w[N];
#pragma unroll
  for (int r = 0; r < N; ++r) w[r] = load_code<V, kGlobal>(codes + static_cast<long long>(r) * c);
#pragma unroll
  for (int r = 0; r < N; ++r) add_word<V>(acc, tab, w[r], r * kRow * 4u);
}

// Rows [0, n) of the table at shared address `tab`: groups of kUnroll,
// then of 8, then one by one (MP = 32 and 24 take no single rows).
template <int V, bool kGlobal>
__device__ __forceinline__ void sum_all(float (&acc)[V], uint32_t tab, const uint8_t* codes, int c, int n) {
  int r = 0;
  for (; r + kUnroll <= n; r += kUnroll) {
    sum_rows<V, kGlobal, kUnroll>(acc, tab + r * kRow * 4u, codes + static_cast<long long>(r) * c, c);
  }
  for (; r + 8 <= n; r += 8) {
    sum_rows<V, kGlobal, 8>(acc, tab + r * kRow * 4u, codes + static_cast<long long>(r) * c, c);
  }
  for (; r < n; ++r) sum_rows<V, kGlobal, 1>(acc, tab + r * kRow * 4u, codes + static_cast<long long>(r) * c, c);
}

struct Args {
  const float* luts;
  long long lut_q_stride;  // floats
  const uint8_t* codes;
  float* out;
  int mp, c, tpq, qpb, tiles, rows;
  long long items;
  bool shared;  // one table for every query, copied once a block
  bool bulk;    // tables by TMA bulk copies, else 4-byte cp.async
};

// Item i is query i / tiles, candidates [(i % tiles) * tpq * V, + tpq * V);
// item group g is items g * qpb + s (s < qpb).  Block b takes groups b,
// b + grid, ...; for each it copies `rows` table (and, kStaged, code) rows
// at a time.
template <int V, bool kStaged>
__global__ void __launch_bounds__(kMaxThreads, 1) adc16_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* tables = reinterpret_cast<float*>(smem + kBarBytes);
  uint8_t* code_rows = smem + kBarBytes + (a.shared ? 1 : a.qpb) * a.rows * kRow * 4;
  const int slot = threadIdx.x / a.tpq, t = threadIdx.x - slot * a.tpq;
  const uint32_t tab = smem_u32(tables + (a.shared ? 0 : slot * a.rows * kRow));
  const long long n_groups = (a.items + a.qpb - 1) / a.qpb;
  // a block's tables lie end to end where items are whole queries and the tables dense
  const bool dense = a.tiles == 1 && a.rows == a.mp && a.lut_q_stride == static_cast<long long>(a.mp) * kRow;
  if (threadIdx.x == 0) {
    bar_init(bar, 1 + blockDim.x);  // thread 0's expect_tx and every thread's cp.async arrival
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  int phase = 0;
  bool have_table = false;  // the shared table, once copied
  for (long long g = blockIdx.x; g < n_groups; g += gridDim.x) {
    const long long first = g * a.qpb;
    const int live_items = static_cast<int>(min(static_cast<long long>(a.qpb), a.items - first));
    const long long item = first + slot;
    const long long q = item / a.tiles;
    const int cb = static_cast<int>(item % a.tiles) * a.tpq * V + t * V;
    const bool live = slot < live_items && cb < a.c;
    const uint8_t* col = a.codes + (q * a.mp) * a.c + cb;  // row j of this thread's candidates at col + j * c
    if constexpr (!kStaged) {  // the first code rows on their way into L1 before the wait
      if (live) {
        for (int r = 0; r < min(a.mp, kPrefetchRows); ++r) {
          asm volatile("prefetch.global.L1 [%0];" ::"l"(col + static_cast<long long>(r) * a.c));
        }
      }
    }
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.f;
    for (int j0 = 0; j0 < a.mp; j0 += a.rows, ++phase) {
      const int nr = min(a.rows, a.mp - j0);
      __syncthreads();  // the barrier's init is visible, and no thread still reads the last rows
      const int n_tab = have_table ? 0 : a.shared ? 1 : live_items;
      if (threadIdx.x == 0) {
        const uint32_t tab_bytes = a.bulk ? static_cast<uint32_t>(n_tab) * nr * kRow * 4u : 0u;
        const uint32_t code_bytes = kStaged ? static_cast<uint32_t>(live_items) * nr * a.c : 0u;
        bar_expect(bar, tab_bytes + code_bytes);
        if (a.bulk && n_tab > 0) {
          if (a.shared || dense) {  // the block's tables lie end to end: one copy
            bulk_copy(tables, a.luts + (a.shared ? 0 : first * a.lut_q_stride) + static_cast<long long>(j0) * kRow,
                      tab_bytes, bar);
          } else {
            for (int s = 0; s < n_tab; ++s) {
              bulk_copy(tables + s * a.rows * kRow,
                        a.luts + (first + s) / a.tiles * a.lut_q_stride + static_cast<long long>(j0) * kRow,
                        static_cast<uint32_t>(nr) * kRow * 4u, bar);
            }
          }
        }
        if (kStaged) bulk_copy(code_rows, a.codes + (first * a.mp + j0) * a.c, code_bytes, bar);
      }
      if (!a.bulk) {
        for (int s = 0; s < n_tab; ++s) {
          copy_floats(tables + s * a.rows * kRow,
                      a.luts + (a.shared ? 0 : (first + s) / a.tiles * a.lut_q_stride) +
                          static_cast<long long>(j0) * kRow,
                      nr * kRow);
        }
      }
      arrive_after_copies(bar);
      have_table = a.shared;
      bar_wait(bar, phase & 1);
      if (live) {
        if constexpr (kStaged) {
          // staged codes imply tiles == 1: the item's code rows [j0, j0 + nr) lie at slot * nr * c
          sum_all<V, false>(acc, tab, code_rows + slot * nr * a.c + t * V, a.c, nr);
        } else {
          sum_all<V, true>(acc, tab, col + static_cast<long long>(j0) * a.c, a.c, nr);
        }
      }
    }
    if (live) {
      float* o = a.out + q * a.c + cb;
      if constexpr (V == 2) {
        *reinterpret_cast<float2*>(o) = make_float2(acc[0], acc[1]);
      } else {
        *o = acc[0];
      }
    }
  }
}

// Rows [0, N) of one candidate gathered straight from device memory: the N
// code bytes first (row r at col + r * c), then the 2N gathers, each row's
// pair in the order's order, then the adds.
template <int N>
__device__ __forceinline__ float direct_rows(float acc, const float* tab, const uint8_t* col, int c) {
  uint32_t b[N];
#pragma unroll
  for (int r = 0; r < N; ++r) b[r] = __ldg(col + static_cast<long long>(r) * c);
  float first[N], second[N];
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const uint32_t lo = b[r] & 15u, hi = b[r] >> 4;
    const float* at_lo = tab + r * kRow + lo;
    const float* at_hi = tab + r * kRow + 16 + hi;
    const bool hi_first = hi < lo;
    first[r] = __ldg(hi_first ? at_hi : at_lo);
    second[r] = __ldg(hi_first ? at_lo : at_hi);
  }
#pragma unroll
  for (int r = 0; r < N; ++r) {
    acc += first[r];
    acc += second[r];
  }
  return acc;
}

// One thread a candidate (i = q * c + cand), its table entries gathered
// straight from device memory: for C too small to pay for copying whole
// tables (the entry scores, C = 1), where a query's candidates touch a
// fraction of its table's sectors.
__global__ void __launch_bounds__(kMaxThreads, 1) adc16_direct_kernel(const Args a) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= a.items) return;
  const long long q = i / a.c;
  const uint8_t* col = a.codes + q * a.mp * a.c + (i - q * a.c);
  const float* tab = a.luts + q * a.lut_q_stride;
  float acc = 0.f;
  int r = 0;
  for (; r + 8 <= a.mp; r += 8) acc = direct_rows<8>(acc, tab + r * kRow, col + static_cast<long long>(r) * a.c, a.c);
  for (; r < a.mp; ++r) acc = direct_rows<1>(acc, tab + r * kRow, col + static_cast<long long>(r) * a.c, a.c);
  a.out[i] = acc;
}

}  // namespace

// Launch K6 with the wrapper's plan, plan[] = {direct, v, tpq, qpb, rows,
// stage_codes, shared, blocks}: with `direct`, one thread a candidate in
// blocks of tpq threads gathering from device memory; else V candidates a
// thread (1 or 2), tpq threads an item of tpq * V candidates, qpb items
// a block, `rows` table rows copied at a time (MP unless one query's tables
// outgrow the block), code rows by a bulk copy when `stage_codes`, one
// table for every query when `shared` (its query stride 0), `blocks`
// blocks walking the item groups.  On card `device` (switched to only
// when it is not current, and back after) and `stream`.  A plan the kernel
// cannot run is refused with cudaErrorInvalidValue.
extern "C" int jv_adc16(const void* luts, long long lut_q_stride, const void* codes, void* out, int q, int mp, int c,
                        const int* plan, int device, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  const int direct = plan[0], v = plan[1], tpq = plan[2], qpb = plan[3], rows = plan[4], stage_codes = plan[5];
  const int shared = plan[6], blocks = plan[7];
  if (q <= 0 || mp <= 0 || c <= 0 || lut_q_stride < 0 || (shared && lut_q_stride != 0)) return bad;
  if ((v != 1 && v != 2) || tpq < 32 || tpq % 32 != 0 || qpb < 1 || tpq * qpb > kMaxThreads) return bad;
  const uintptr_t cp = reinterpret_cast<uintptr_t>(codes);
  if (c % v != 0 || cp % v != 0 || rows < 1 || rows > mp) return bad;
  Args a{static_cast<const float*>(luts), lut_q_stride, static_cast<const uint8_t*>(codes), static_cast<float*>(out),
         mp, c, tpq, qpb, (c + tpq * v - 1) / (tpq * v), rows, 0, shared != 0,
         reinterpret_cast<uintptr_t>(luts) % 16 == 0 && (lut_q_stride * 4) % 16 == 0};
  a.items = static_cast<long long>(q) * (direct ? c : a.tiles);
  const long long n_groups = direct ? (a.items + tpq - 1) / tpq : (a.items + qpb - 1) / qpb;
  if (blocks < 1 || blocks > n_groups || (direct && (blocks != n_groups || v != 1 || qpb != 1))) return bad;
  if (rows < mp && (qpb != 1 || shared)) return bad;  // only one query's own tables come in chunks of rows
  if (stage_codes && (direct || a.tiles != 1 || c % 16 != 0 || cp % 16 != 0)) return bad;
  const long long smem = direct ? 0 : kBarBytes + static_cast<long long>(a.shared ? 1 : qpb) * rows * kRow * 4 +
                                          (stage_codes ? static_cast<long long>(qpb) * rows * c : 0);
  if (smem > kMaxSmem) return bad;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned threads = static_cast<unsigned>(tpq * qpb);
  const size_t bytes = static_cast<size_t>(smem);
  if (direct) {
    adc16_direct_kernel<<<blocks, threads, 0, s>>>(a);
  } else if (stage_codes) {
    if (v == 2) adc16_kernel<2, true><<<blocks, threads, bytes, s>>>(a);
    else adc16_kernel<1, true><<<blocks, threads, bytes, s>>>(a);
  } else {
    if (v == 2) adc16_kernel<2, false><<<blocks, threads, bytes, s>>>(a);
    else adc16_kernel<1, false><<<blocks, threads, bytes, s>>>(a);
  }
  err = cudaGetLastError();
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}
