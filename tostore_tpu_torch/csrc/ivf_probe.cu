// IVF bucket-scan kernels for Hopper (sm_90a): the port's K3 and K4.
//
// K3 `ivf_bucket_probe` replaces tostore_tpu/ops/ivfprobe.py::_kernel
// (called by bucket_probe_scores). For query b and probe p it scores the
// contiguous bucket block probes[b, p] of the corpus copy [C, cap, D]:
//
//     out[b, p, j] = (q[b] . x[probes[b, p], j]) * scale[probe, j] + bias[probe, j]
//
// with f32 accumulation: f32 rows multiply in f32 FMA (never TF32), bf16
// products are exact in f32, int8 rows widen exactly. alpha is already
// folded into q (the wrapper casts q to bf16 for bf16 and int8 buckets,
// as the JAX package does), and the scale applies before the bias.
//
// K4 `ivf_adc` replaces tostore_tpu/ops/ivfprobe.py::_adc_kernel (called
// by adc_bucket_scores): PQ asymmetric distances over the probed bucket's
// codes,
//
//     out[b, p, j] = -sum_m tab[b, p, m, code[probe, m, j]] + bias[probe, j]
//
// with codes [C, M, cap] u8, or [C, M/2, cap] with two 4-bit codes per
// byte (high nibble = subspace 2r, low nibble = 2r+1; the table stays in
// natural subspace order). The TPU kernel had no per-lane gather and used
// a one-hot matmul; here the (query, probe) table sits in shared memory
// and each thread looks its codes up directly, summing in f32 in subspace
// order.
//
// What bounds them on an H100 SXM (3.35 TB/s HBM): both read each probed
// bucket once per (query, probe), 3 MB of bf16 rows (K3) or 95-190 KB of
// codes (K4) at C = 1024, cap = 1984, D = 768, and do little arithmetic on
// it, so they are memory- and latency-bound. The design is the simple one:
//   - K3: one CTA per (b, p, 64-row tile of cap); q_b is staged in shared
//     memory as f32; a warp takes one row at a time with 16-byte loads
//     along D, then a shuffle reduce. Queries probing the same bucket meet
//     its rows in L2 only by chance; grouping queries by bucket and the
//     tensor cores are left for later.
//   - K4: one CTA per (b, p, 1024-column tile); the table is loaded into
//     shared memory in chunks of subspaces that fit ADC_SMEM (dynamic
//     shared memory above 48 KB is opted into per launch), one thread per
//     code column, four columns per thread.
// A probe id outside [0, C) scores every entry NEG_INF instead of reading
// out of bounds.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int K3_ROWS = 64;  // bucket rows per CTA
constexpr int K4_CPT = 4;    // code columns per thread
constexpr int K4_COLS = THREADS * K4_CPT;
constexpr float NEG_INF = -FLT_MAX;  // float32 min, as runtime.NEG_INF

template <typename VT> struct Probe;
template <> struct Probe<float> {
  using Q = float;
  static constexpr int V = 4;  // row elements per 16-byte load
  __device__ static float acc(const uint4& raw, const float* qs, float a) {
    const float* x = reinterpret_cast<const float*>(&raw);
    const float4 q4 = *reinterpret_cast<const float4*>(qs);
    a = fmaf(q4.x, x[0], a);
    a = fmaf(q4.y, x[1], a);
    a = fmaf(q4.z, x[2], a);
    return fmaf(q4.w, x[3], a);
  }
};
template <> struct Probe<__nv_bfloat16> {
  using Q = __nv_bfloat16;
  static constexpr int V = 8;
  __device__ static float acc(const uint4& raw, const float* qs, float a) {
    const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 q4 = *reinterpret_cast<const float4*>(qs + 4 * h);
      a = fmaf(q4.x, __bfloat162float(x[4 * h + 0]), a);
      a = fmaf(q4.y, __bfloat162float(x[4 * h + 1]), a);
      a = fmaf(q4.z, __bfloat162float(x[4 * h + 2]), a);
      a = fmaf(q4.w, __bfloat162float(x[4 * h + 3]), a);
    }
    return a;
  }
};
template <> struct Probe<int8_t> {
  using Q = __nv_bfloat16;
  static constexpr int V = 16;
  __device__ static float acc(const uint4& raw, const float* qs, float a) {
    const int8_t* x = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const float4 q4 = *reinterpret_cast<const float4*>(qs + 4 * h);
      a = fmaf(q4.x, static_cast<float>(x[4 * h + 0]), a);
      a = fmaf(q4.y, static_cast<float>(x[4 * h + 1]), a);
      a = fmaf(q4.z, static_cast<float>(x[4 * h + 2]), a);
      a = fmaf(q4.w, static_cast<float>(x[4 * h + 3]), a);
    }
    return a;
  }
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// grid: x = 64-row tile of cap, y = probe p, z = query b
template <typename VT>
__global__ void __launch_bounds__(THREADS)
ivf_bucket_probe_kernel(const typename Probe<VT>::Q* __restrict__ q,
                        const int32_t* __restrict__ probes, const VT* __restrict__ vecs,
                        const float* __restrict__ bias, const float* __restrict__ scale,
                        int n_probes, int n_buckets, int cap, int d, float* __restrict__ out) {
  extern __shared__ __align__(16) float qs[];
  const int b = blockIdx.z;
  const int p = blockIdx.y;
  const int row0 = blockIdx.x * K3_ROWS;
  const int row_end = min(cap, row0 + K3_ROWS);
  float* o = out + ((long long)b * n_probes + p) * cap;
  const int probe = probes[(long long)b * n_probes + p];
  if (probe < 0 || probe >= n_buckets) {
    for (int r = row0 + threadIdx.x; r < row_end; r += THREADS) o[r] = NEG_INF;
    return;
  }
  for (int i = threadIdx.x; i < d; i += THREADS) qs[i] = to_float(q[(long long)b * d + i]);
  __syncthreads();

  constexpr int V = Probe<VT>::V;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long bucket = (long long)probe * cap;
  for (int r = row0 + warp; r < row_end; r += WARPS) {
    const VT* row = vecs + (bucket + r) * d;
    float a = 0.0f;
#pragma unroll 4
    for (int c = lane * V; c < d; c += 32 * V) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(row + c));
      a = Probe<VT>::acc(raw, qs + c, a);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
    if (lane == 0) {
      if (scale != nullptr) a = __fmul_rn(a, scale[bucket + r]);
      o[r] = __fadd_rn(a, bias[bucket + r]);
    }
  }
}

// grid: x = 1024-column tile of cap, y = probe p, z = query b
__global__ void __launch_bounds__(THREADS)
ivf_adc_kernel(const float* __restrict__ tabs, const int32_t* __restrict__ probes,
               const uint8_t* __restrict__ codes, const float* __restrict__ bias,
               int n_probes, int n_buckets, int m, int k, int cap, int packed, int m_chunk,
               float* __restrict__ out) {
  extern __shared__ __align__(16) float ts[];
  const int b = blockIdx.z;
  const int p = blockIdx.y;
  const int col0 = blockIdx.x * K4_COLS;
  const long long bp = (long long)b * n_probes + p;
  float* o = out + bp * cap;
  const int probe = probes[bp];
  if (probe < 0 || probe >= n_buckets) {
    for (int j = 0; j < K4_CPT; ++j) {
      const int col = col0 + j * THREADS + threadIdx.x;
      if (col < cap) o[col] = NEG_INF;
    }
    return;
  }
  const int rows = packed ? m / 2 : m;
  const uint8_t* cb = codes + (long long)probe * rows * cap;
  const float* tab = tabs + bp * m * k;
  float acc[K4_CPT];
#pragma unroll
  for (int j = 0; j < K4_CPT; ++j) acc[j] = 0.0f;

  for (int m0 = 0; m0 < m; m0 += m_chunk) {
    const int mc = min(m_chunk, m - m0);
    __syncthreads();  // the previous chunk's lookups are done
    for (int i = threadIdx.x; i < mc * k; i += THREADS) ts[i] = tab[(long long)m0 * k + i];
    __syncthreads();
    if (packed) {
      for (int r = m0 / 2; r < (m0 + mc) / 2; ++r) {
        const uint8_t* crow = cb + (long long)r * cap;
        const float* t_hi = ts + (2 * r - m0) * k;
        const float* t_lo = t_hi + k;
#pragma unroll
        for (int j = 0; j < K4_CPT; ++j) {
          const int col = col0 + j * THREADS + threadIdx.x;
          if (col < cap) {
            const unsigned byte = crow[col];
            acc[j] += t_hi[byte >> 4];
            acc[j] += t_lo[byte & 0xFu];
          }
        }
      }
    } else {
      for (int mm = 0; mm < mc; ++mm) {
        const uint8_t* crow = cb + (long long)(m0 + mm) * cap;
        const float* t = ts + mm * k;
#pragma unroll
        for (int j = 0; j < K4_CPT; ++j) {
          const int col = col0 + j * THREADS + threadIdx.x;
          if (col < cap) acc[j] += t[min((int)crow[col], k - 1)];
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < K4_CPT; ++j) {
    const int col = col0 + j * THREADS + threadIdx.x;
    if (col < cap) o[col] = __fadd_rn(-acc[j], bias[(long long)probe * cap + col]);
  }
}

template <typename VT>
int launch_probe(const void* q, const int32_t* probes, const void* vecs, const float* bias,
                 const float* scale, int b, int p, int c, int cap, int d, float* out,
                 cudaStream_t stream) {
  if (d % Probe<VT>::V != 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = (size_t)d * sizeof(float);
  auto kernel = ivf_bucket_probe_kernel<VT>;
  if (bytes > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((cap + K3_ROWS - 1) / K3_ROWS, p, b);
  kernel<<<grid, THREADS, bytes, stream>>>(static_cast<const typename Probe<VT>::Q*>(q), probes,
                                           static_cast<const VT*>(vecs), bias, scale, p, c, cap,
                                           d, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32 rows (q float32), 1 = bfloat16 rows (q bfloat16),
// 2 = int8 rows (q bfloat16). probes: [b, p] int32; vecs: [c, cap, d];
// bias, scale: [c, cap] float32 (scale may be null); out: [b, p, cap].
extern "C" int ivf_bucket_probe(const void* q, const int32_t* probes, const void* vecs, int dtype,
                                const float* bias, const float* scale, int b, int p, int c,
                                int cap, int d, float* out, void* stream) {
  if (b <= 0 || p <= 0 || b > 65535 || p > 65535 || cap <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_probe<float>(q, probes, vecs, bias, scale, b, p, c, cap, d, out, s);
    case 1:
      return launch_probe<__nv_bfloat16>(q, probes, vecs, bias, scale, b, p, c, cap, d, out, s);
    case 2:
      return launch_probe<int8_t>(q, probes, vecs, bias, scale, b, p, c, cap, d, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// tabs: [b, p, m, k] float32 (natural subspace order); probes: [b, p]
// int32; codes: [c, m, cap] u8, or [c, m/2, cap] when packed (k == 16);
// bias: [c, cap]; m_chunk: subspaces per shared-memory chunk (even when
// packed); out: [b, p, cap].
extern "C" int ivf_adc(const float* tabs, const int32_t* probes, const uint8_t* codes,
                       const float* bias, int b, int p, int c, int m, int k, int cap, int packed,
                       int m_chunk, float* out, void* stream) {
  if (b <= 0 || p <= 0 || b > 65535 || p > 65535 || cap <= 0 || m <= 0 || k <= 0 ||
      k > 256 || m_chunk <= 0 || (packed && (k != 16 || m % 2 || m_chunk % 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = (size_t)m_chunk * k * sizeof(float);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ivf_adc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((cap + K4_COLS - 1) / K4_COLS, p, b);
  ivf_adc_kernel<<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      tabs, probes, codes, bias, p, c, m, k, cap, packed, m_chunk, out);
  return static_cast<int>(cudaGetLastError());
}
