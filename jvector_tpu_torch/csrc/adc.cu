// K5: PQ assemble-and-sum (ADC scoring).
//
// Replaces the TPU kernel jvector_tpu/ops/pallas/adc_kernel.py
// (_adc_kernel, entry adc_score_pallas):
//
//     out[q, c] = sum_m luts[q, m, codes[q, c, m]]
//
// luts [Q, M, K] float32 (the query's lookup tables; the query stride may be
// 0 for one table shared by all queries), codes [Q, C, M] uint8 (K <= 256),
// out [Q, C] float32.  The sum runs over m in ascending order in float32.
//
// Design: the TPU kernel's one-hot compare-and-reduce only worked around
// Mosaic's lack of a vector gather, and its [Q, M, C] transpose only served
// Mosaic's sublane rule; neither is carried over.  Hopper gathers from
// shared memory directly.  Block (x = query, y = candidate tile) stages the
// query's LUT in shared memory (M*K*4 bytes, 16 KB at M=16, K=256; in
// M-chunks of at most 48 KB when larger), then each thread scores its
// candidates: it reads the candidate's code row straight from [Q, C, M]
// (one 16-byte vector per 16 subspaces when M % 16 == 0, bytes otherwise)
// and sums lut_s[m*K + code].  With M-chunks, a thread adds each chunk's
// partial sum to out[q, c], which only that thread touches.  Large C (the
// cleanup's centroid scan: Q=1, C ~ 1M) spreads over several tiles per
// query, capped so the LUT is re-staged by at most ~8 blocks per SM.
//
// Bound: bytes.  At the serve shape (Q=4096, C=56, M=16, K=256) the LUTs
// are 67.1 MB against 3.7 MB of codes and 0.9 MB of output, so the kernel
// is bound by reading each query's LUT once (about 21 us at 3.35 TB/s);
// the C*M adds are negligible.  Keeping LUTs resident across beam steps or
// tensor-core formulations are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSmemFloats = 48 * 1024 / 4;  // the default dynamic shared memory limit
constexpr int kSms = 132;

__device__ __forceinline__ float sum_word(const float* lut_s, int k, int m, uint32_t word) {
  float s = 0.f;
#pragma unroll
  for (int t = 0; t < 4; ++t) s += lut_s[(m + t) * k + ((word >> (8 * t)) & 0xffu)];
  return s;
}

template <bool kVec16, bool kLut16>
__global__ void adc_kernel(const float* __restrict__ luts, long long lut_q_stride,
                           const uint8_t* __restrict__ codes, float* __restrict__ out, int c, int m,
                           int k, int m_chunk) {
  extern __shared__ float lut_s[];
  const long long q = blockIdx.x;
  const float* lut_q = luts + q * lut_q_stride;
  const uint8_t* codes_q = codes + q * c * m;
  float* out_q = out + q * c;
  const int first = blockIdx.y * blockDim.x + threadIdx.x;
  const int step = gridDim.y * blockDim.x;
  for (int m0 = 0; m0 < m; m0 += m_chunk) {
    const int mc = min(m_chunk, m - m0);
    const float* src = lut_q + static_cast<long long>(m0) * k;
    if (kLut16) {
      const float4* src4 = reinterpret_cast<const float4*>(src);
      float4* dst4 = reinterpret_cast<float4*>(lut_s);
      for (int i = threadIdx.x; i < mc * k / 4; i += blockDim.x) dst4[i] = src4[i];
    } else {
      for (int i = threadIdx.x; i < mc * k; i += blockDim.x) lut_s[i] = src[i];
    }
    __syncthreads();
    for (int cand = first; cand < c; cand += step) {
      const uint8_t* row = codes_q + static_cast<long long>(cand) * m + m0;
      float acc = m0 == 0 ? 0.f : out_q[cand];
      if (kVec16) {
        for (int j = 0; j < mc; j += 16) {
          const uint4 v = *reinterpret_cast<const uint4*>(row + j);
          acc += sum_word(lut_s, k, j, v.x);
          acc += sum_word(lut_s, k, j + 4, v.y);
          acc += sum_word(lut_s, k, j + 8, v.z);
          acc += sum_word(lut_s, k, j + 12, v.w);
        }
      } else {
        for (int j = 0; j < mc; ++j) acc += lut_s[j * k + row[j]];
      }
      out_q[cand] = acc;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int jv_adc_score(const void* luts, long long lut_q_stride, const void* codes, void* out,
                            int q, int c, int m, int k, void* stream) {
  if (q <= 0 || c <= 0 || m <= 0 || k <= 0 || k > kSmemFloats) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec16 = (m % 16 == 0) && (reinterpret_cast<uintptr_t>(codes) % 16 == 0);
  int m_chunk = m < kSmemFloats / k ? m : kSmemFloats / k;
  if (vec16) m_chunk = m_chunk >= 16 ? m_chunk / 16 * 16 : 0;
  if (m_chunk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool lut16 = (k % 4 == 0) && (lut_q_stride % 4 == 0) &&
                     (reinterpret_cast<uintptr_t>(luts) % 16 == 0);
  const int threads = c >= 256 ? 256 : ((c + 31) / 32) * 32;
  const int tiles = (c + threads - 1) / threads;
  const int cap = q >= kSms * 8 ? 1 : (kSms * 8) / q;
  dim3 grid(static_cast<unsigned>(q), static_cast<unsigned>(tiles < cap ? tiles : cap));
  const size_t smem = static_cast<size_t>(m_chunk) * k * sizeof(float);
  const float* l = static_cast<const float*>(luts);
  const uint8_t* cd = static_cast<const uint8_t*>(codes);
  float* o = static_cast<float*>(out);
  if (vec16 && lut16) {
    adc_kernel<true, true><<<grid, threads, smem, s>>>(l, lut_q_stride, cd, o, c, m, k, m_chunk);
  } else if (vec16) {
    adc_kernel<true, false><<<grid, threads, smem, s>>>(l, lut_q_stride, cd, o, c, m, k, m_chunk);
  } else if (lut16) {
    adc_kernel<false, true><<<grid, threads, smem, s>>>(l, lut_q_stride, cd, o, c, m, k, m_chunk);
  } else {
    adc_kernel<false, false><<<grid, threads, smem, s>>>(l, lut_q_stride, cd, o, c, m, k, m_chunk);
  }
  return static_cast<int>(cudaGetLastError());
}
