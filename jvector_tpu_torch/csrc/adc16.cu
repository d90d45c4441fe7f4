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
// byte, subspace-major, so C is the minor dim), out [Q, C] float32.  Each
// thread sums over j in ascending order in float32, adding the pair
// (lo entry + hi entry) of each byte.
//
// Design: the TPU kernel's 32-way one-hot compare-and-select and its pad
// of MP to 8 sublanes only worked around Mosaic (no vector gather, 8-row
// aligned dynamic slices); neither is carried over.  A block of 256
// threads serves qpb = 256 / tc queries, tc = C rounded up to a warp (at
// most 256): it stages their paired LUTs in shared memory (MP * 128 bytes
// a query, 4 KB at MP = 32; one copy when the stride is 0), then each
// thread owns one candidate column c of one query and walks j, reading
// codes[q, j, c] (neighbouring threads read neighbouring bytes) and
// gathering two entries of row j from shared memory.  A warp never spans
// two queries and the 32 floats of a row sit in 32 banks, so the gathers
// are conflict-free (equal nibbles broadcast).  C > 256 spreads over
// several candidate tiles per query; MP > 384 (over 48 KB of LUT) stages
// in MP-chunks, each thread adding a chunk's partial sum to out[q, c],
// which only that thread touches.
//
// Bound: bytes.  At the 200k serve shape (Q = 4096, MP = 32, C = 64) the
// LUTs are 16.8 MB against 8.4 MB of codes and 1.0 MB of output, about
// 7.8 us at 3.35 TB/s; the 2 * MP adds per candidate are negligible.
// Keeping LUTs resident across beam steps, fusing the fused-row gather
// into the kernel and tensor-core forms are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRow = 32;                        // floats per subspace pair
constexpr int kSmemFloats = 48 * 1024 / 4;      // the default dynamic shared memory limit
constexpr int kMaxChunk = kSmemFloats / kRow;   // 384 subspace pairs
constexpr int kSms = 132;

template <bool kVec>
__global__ void adc16_kernel(const float* __restrict__ luts, long long lut_q_stride,
                             const uint8_t* __restrict__ codes, float* __restrict__ out, int q,
                             int mp, int c, int tc, int qpb, int mp_chunk) {
  extern __shared__ float lut_s[];
  const int qi = threadIdx.x / tc;  // the block's query slot of this thread
  const int lane = threadIdx.x - qi * tc;
  const long long q0 = static_cast<long long>(blockIdx.x) * qpb;
  const int q_here = static_cast<int>(q - q0 < qpb ? q - q0 : qpb);
  const bool shared_table = lut_q_stride == 0;
  const int tables = shared_table ? 1 : q_here;
  const int first = blockIdx.y * tc + lane;
  const int step = gridDim.y * tc;
  for (int j0 = 0; j0 < mp; j0 += mp_chunk) {
    const int jc = mp - j0 < mp_chunk ? mp - j0 : mp_chunk;
    const int per_table = jc * kRow;  // floats staged per table (a multiple of 4)
    if (kVec) {
      const int per4 = per_table / 4;
      for (int i = threadIdx.x; i < tables * per4; i += blockDim.x) {
        const int t = i / per4, r = i - t * per4;
        const float4* src = reinterpret_cast<const float4*>(
            luts + (q0 + t) * lut_q_stride + static_cast<long long>(j0) * kRow);
        reinterpret_cast<float4*>(lut_s + t * mp_chunk * kRow)[r] = src[r];
      }
    } else {
      for (int i = threadIdx.x; i < tables * per_table; i += blockDim.x) {
        const int t = i / per_table, r = i - t * per_table;
        lut_s[t * mp_chunk * kRow + r] = luts[(q0 + t) * lut_q_stride + static_cast<long long>(j0) * kRow + r];
      }
    }
    __syncthreads();
    if (qi < q_here) {
      const long long qq = q0 + qi;
      const float* lut_q = lut_s + (shared_table ? 0 : qi * mp_chunk * kRow);
      const uint8_t* codes_q = codes + (qq * mp + j0) * c;
      float* out_q = out + qq * c;
      for (int cand = first; cand < c; cand += step) {
        float acc = j0 == 0 ? 0.f : out_q[cand];
        const uint8_t* col = codes_q + cand;
#pragma unroll 4
        for (int j = 0; j < jc; ++j) {
          const uint32_t b = __ldg(col + static_cast<long long>(j) * c);
          acc += lut_q[j * kRow + (b & 15u)] + lut_q[j * kRow + 16 + (b >> 4)];
        }
        out_q[cand] = acc;
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int jv_adc16_score(const void* luts, long long lut_q_stride, const void* codes, void* out,
                              int q, int mp, int c, void* stream) {
  if (q <= 0 || mp <= 0 || c <= 0 || lut_q_stride < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tc = c >= kThreads ? kThreads : ((c + 31) / 32) * 32;
  const int mp_chunk = mp < kMaxChunk ? mp : kMaxChunk;
  int qpb = kThreads / tc;
  const int fit = kSmemFloats / (mp_chunk * kRow);  // tables that fit in shared memory (>= 1)
  if (lut_q_stride != 0 && qpb > fit) qpb = fit;
  const long long blocks = (static_cast<long long>(q) + qpb - 1) / qpb;
  const int tiles = (c + tc - 1) / tc;
  const int cap = blocks >= kSms * 8 ? 1 : static_cast<int>((kSms * 8) / blocks);
  dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(tiles < cap ? tiles : cap));
  const size_t smem = static_cast<size_t>(lut_q_stride != 0 ? qpb : 1) * mp_chunk * kRow * sizeof(float);
  const bool vec = (lut_q_stride % 4 == 0) && (reinterpret_cast<uintptr_t>(luts) % 16 == 0);
  const float* l = static_cast<const float*>(luts);
  const uint8_t* cd = static_cast<const uint8_t*>(codes);
  float* o = static_cast<float*>(out);
  if (vec) {
    adc16_kernel<true><<<grid, tc * qpb, smem, s>>>(l, lut_q_stride, cd, o, q, mp, c, tc, qpb, mp_chunk);
  } else {
    adc16_kernel<false><<<grid, tc * qpb, smem, s>>>(l, lut_q_stride, cd, o, q, mp, c, tc, qpb, mp_chunk);
  }
  return static_cast<int>(cudaGetLastError());
}
