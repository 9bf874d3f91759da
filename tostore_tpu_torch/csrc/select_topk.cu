// Top-k selection with jax.lax.top_k's contract for Hopper (sm_90a): the
// port's `select_topk`.
//
// No TPU kernel: it replaces jax.lax.top_k, with which the JAX package ends
// every search route (tostore_tpu/ops/topk.py:659 after K2, :599 after K1,
// :496 after K5, :202 / :217 / :231 in the exact scan, :797 after the lane
// scan; tostore_tpu/vector/ivf.py, vector/pq.py, parallel/sharded.py and
// parallel/sharded_ivf.py). ops/topk.py::top_k_first launches it for every
// selection on a CUDA tensor; its plain version is ops/topk.py::_select_exact.
//
// For each row of scores s [rows, n] (f32, contiguous), the k best in IEEE
// totalOrder descending (NaN first, 0.0 before -0.0), the lower position
// first among equal scores, both for which candidates make the k-th place
// and for their order: values [rows, k] f32, bit for bit the inputs, and
// positions [rows, k] int64. Exact for every score: misses at NEG_INF are
// ordered by position like any other score.
//
// A score maps to a 32-bit unsigned order key (the bits of a negative float
// with all but the sign flipped, as ops/topk.py::_order_key, then the sign
// flipped so that unsigned order is totalOrder), and a candidate to the
// 64-bit key (order key << 32) | (2^32 - 1 - position), unique in its row:
// the larger key is the better candidate. One CTA takes one row:
//   1. Radix select: a shared-memory histogram of 11, then 11, then 10 bits
//      of the order key, each over the scores whose higher bits equal the
//      digits found so far, gives the digit of the k-th best key and the
//      count strictly above it. It stops as soon as the scores above the
//      k-th's bin and those in it fit the shared buffer (`buf` 64-bit keys).
//   2. Collect: one more read of the row puts those scores' keys into the
//      buffer, in any order. Where more than `buf` scores share the k-th's
//      exact key (rows of equal scores, a search's misses), the read goes
//      in row order instead, a block-wide prefix scan a tile keeping the
//      first of the equal scores, so the lower positions win; it stops
//      once all k are in the buffer.
//   3. A bitonic sort of the buffer, descending; the first k keys are
//      written out, values decoded from the key (the map is a bijection).
// A k above `buf` (at most SELECT_CAP) takes chunks of `buf`: each chunk
// selects, by the same steps, among the candidates whose key is below the
// last key written.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM): reading the scores once;
// the operations are a few integer instructions a score. This design reads
// a row 2 to 4 times (1 to 3 histograms and the collect), later reads often
// from L2, and its shared-memory atomics serialize where a warp's scores
// share a bin. Splitting a long row over several CTAs and staging it in
// shared memory are left for a later design.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BINS = 2048;         // 11-bit digits
constexpr int SELECT_CAP = 8192;   // largest buffer: 64-bit keys a CTA sorts in shared memory
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t b = __float_as_uint(v);
  return (b ^ (static_cast<uint32_t>(static_cast<int32_t>(b) >> 31) & 0x7FFFFFFFu)) ^ 0x80000000u;
}

__device__ __forceinline__ float key_value(uint32_t u) {
  const uint32_t k = u ^ 0x80000000u;
  return __uint_as_float(k ^ (static_cast<uint32_t>(static_cast<int32_t>(k) >> 31) & 0x7FFFFFFFu));
}

__device__ __forceinline__ uint64_t cand_key(uint32_t u, int pos) {
  return (static_cast<uint64_t>(u) << 32) | (0xFFFFFFFFu - static_cast<uint32_t>(pos));
}

// The block's shared scalars.
struct Ctl {
  uint32_t prefix;  // the digits of the k-th best order key found so far
  int level;        // bits below the prefix (32: no digit yet)
  int above;        // candidates whose key's bits above `level` exceed the prefix
  int cnt;          // candidates whose key's bits above `level` equal it
  int filled;       // keys in the buffer
  int warp[33];     // block scan: the warps' sums, then the total
};

// Exclusive prefix sum of x over the block, in thread order; total gets the
// sum. Every thread of the block calls it.
template <int THREADS>
__device__ __forceinline__ int block_excl_scan(int x, int* warp, int& total) {
  constexpr int NW = THREADS / 32;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) warp[w] = inc;
  __syncthreads();
  if (w == 0) {
    const int v = lane < NW ? warp[lane] : 0;
    int s = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += y;
    }
    if (lane < NW) warp[lane] = s - v;
    if (lane == 31) warp[32] = s;
  }
  __syncthreads();
  const int r = warp[w] + inc - x;
  total = warp[32];
  __syncthreads();  // warp[] is reused by the next scan
  return r;
}

// Appends key where take, one shared atomic a warp. Every lane of the warp
// calls it.
__device__ __forceinline__ void append(bool take, uint64_t key, uint64_t* buf, int* filled) {
  const unsigned mask = __ballot_sync(FULL, take);
  if (mask == 0) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(mask) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(filled, __popc(mask));
  base = __shfl_sync(FULL, base, leader);
  if (take) buf[base + __popc(mask & ((1u << lane) - 1u))] = key;
}

// The four consecutive scores of the row at p0 (any past n read as 0).
template <bool VEC>
__device__ __forceinline__ void load4(const float* row, int n, int p0, float (&v)[4]) {
  if (VEC) {  // n % 4 == 0 and the row 16-byte aligned
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p0 < n) q = __ldg(reinterpret_cast<const float4*>(row + p0));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = p0 + c < n ? __ldg(row + p0 + c) : 0.f;
  }
}

// After a histogram of `bits`-bit digits at `shift`: the bin of the m-th
// best key, scanning from the highest bin down, and the counts above it
// and in it, into ctl.
template <int THREADS>
__device__ __forceinline__ void find_bin(const int* hist, int m, int bits, int shift, Ctl& ctl) {
  constexpr int PER = BINS / THREADS;
  const int top = BINS - 1 - static_cast<int>(threadIdx.x) * PER;  // this thread's highest bin
  int local = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) local += hist[top - j];
  const int above0 = ctl.above;
  const uint32_t prefix0 = ctl.prefix;
  int total;
  int run = above0 + block_excl_scan<THREADS>(local, ctl.warp, total);
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int h = hist[top - j];
    if (run < m && run + h >= m) {  // exactly one bin of the block crosses m
      ctl.prefix = (prefix0 << bits) | static_cast<uint32_t>(top - j);
      ctl.level = shift;
      ctl.above = run;
      ctl.cnt = h;
    }
    run += h;
  }
  __syncthreads();
}

// Sorts buf[0, count) descending (bitonic, padded with 0 keys to a power
// of two: a real key is never 0, its low word is 2^32 - 1 - position > 0).
template <int THREADS>
__device__ __forceinline__ void sort_desc(uint64_t* buf, int count) {
  int p = 1;
  while (p < count) p <<= 1;
  for (int i = count + threadIdx.x; i < p; i += THREADS) buf[i] = 0;
  __syncthreads();
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < p / 2; i += THREADS) {
        const int lo = ((i & ~(stride - 1)) << 1) | (i & (stride - 1));
        const int hi = lo + stride;
        const uint64_t a = buf[lo], b = buf[hi];
        if ((lo & size) == 0 ? a < b : a > b) {
          buf[lo] = b;
          buf[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

template <int THREADS, bool VEC>
__global__ void __launch_bounds__(THREADS)
select_topk_kernel(const float* __restrict__ s, int n, int k, int cap,
                   float* __restrict__ out_v, long long* __restrict__ out_p) {
  extern __shared__ uint64_t buf[];                    // [cap]
  int* hist = reinterpret_cast<int*>(buf + cap);       // [BINS]
  __shared__ Ctl ctl;
  const int tid = threadIdx.x;
  const float* row = s + static_cast<long long>(blockIdx.x) * n;
  float* ov = out_v + static_cast<long long>(blockIdx.x) * k;
  long long* op = out_p + static_cast<long long>(blockIdx.x) * k;
  bool bounded = false;  // chunks after the first: only keys below `bound`
  uint64_t bound = 0;

  for (int off = 0; off < k; off += cap) {
    const int m = min(cap, k - off);
    if (tid == 0) {
      ctl.prefix = 0;
      ctl.level = 32;
      ctl.above = 0;
      ctl.cnt = n - off;  // the candidates after the last chunk
      ctl.filled = 0;
    }
    __syncthreads();

    // 1. radix select, until the candidates at the k-th's bin and above fit
    for (int pass = 0; pass < 3 && ctl.above + ctl.cnt > cap; ++pass) {
      const int shift = pass == 0 ? 21 : (pass == 1 ? 10 : 0);
      const int bits = pass == 2 ? 10 : 11;
      const uint32_t prefix = ctl.prefix;
      const int level = ctl.level;
      for (int i = tid; i < BINS; i += THREADS) hist[i] = 0;
      __syncthreads();
      for (int base = 0; base < n; base += 4 * THREADS) {
        const int p0 = base + 4 * tid;
        float v[4];
        load4<VEC>(row, n, p0, v);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint32_t u = order_key(v[c]);
          if (p0 + c < n && (!bounded || cand_key(u, p0 + c) < bound) &&
              (level == 32 || (u >> level) == prefix))
            atomicAdd(&hist[(u >> shift) & ((1u << bits) - 1u)], 1);
        }
      }
      __syncthreads();
      find_bin<THREADS>(hist, m, bits, shift, ctl);
    }

    // 2. collect
    const uint32_t prefix = ctl.prefix;
    const int level = ctl.level, above = ctl.above;
    if (above + ctl.cnt <= cap) {  // every candidate at the k-th's bin and above
      for (int base = 0; base < n; base += 4 * THREADS) {
        const int p0 = base + 4 * tid;
        float v[4];
        load4<VEC>(row, n, p0, v);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint32_t u = order_key(v[c]);
          const uint64_t key = cand_key(u, p0 + c);
          append(p0 + c < n && (!bounded || key < bound) &&
                     (level == 32 || (u >> level) >= prefix),
                 key, buf, &ctl.filled);
        }
      }
    } else {  // level == 0: prefix is the k-th's key; the first `need` equal to it
      const int need = m - above;
      int taken = 0, found = 0;
      for (int base = 0; base < n; base += 4 * THREADS) {
        const int p0 = base + 4 * tid;
        float v[4];
        load4<VEC>(row, n, p0, v);
        uint32_t u[4];
        bool gt[4], eq[4];
        int g = 0, e = 0;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          u[c] = order_key(v[c]);
          const bool ok = p0 + c < n && (!bounded || cand_key(u[c], p0 + c) < bound);
          gt[c] = ok && u[c] > prefix;
          eq[c] = ok && u[c] == prefix;
          g += gt[c];
          e += eq[c];
        }
        int total;  // counts a tile fit 16 bits: gt in the high half, eq in the low
        const int ex = block_excl_scan<THREADS>((g << 16) | e, ctl.warp, total);
        int rank = taken + (ex & 0xFFFF);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          append(gt[c] || (eq[c] && rank < need), cand_key(u[c], p0 + c), buf, &ctl.filled);
          rank += eq[c];
        }
        taken += total & 0xFFFF;
        found += total >> 16;
        if (found == above && taken >= need) break;  // uniform: from the scan's totals
      }
    }
    __syncthreads();

    // 3. sort and write
    sort_desc<THREADS>(buf, ctl.filled);
    for (int i = tid; i < m; i += THREADS) {
      const uint64_t key = buf[i];
      ov[off + i] = key_value(static_cast<uint32_t>(key >> 32));
      op[off + i] = static_cast<long long>(0xFFFFFFFFu - static_cast<uint32_t>(key));
    }
    bound = buf[m - 1];
    bounded = true;
    __syncthreads();
  }
}

template <int THREADS, bool VEC>
int launch(const float* s, long long rows, int n, int k, int cap, float* out_v,
           long long* out_p, cudaStream_t stream) {
  const size_t bytes = static_cast<size_t>(cap) * sizeof(uint64_t) + BINS * sizeof(int);
  auto kernel = select_topk_kernel<THREADS, VEC>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<static_cast<unsigned>(rows), THREADS, bytes, stream>>>(s, n, k, cap, out_v, out_p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// s: [rows, n] float32, contiguous; 1 <= k <= n; threads: 128 or 512 a CTA
// (one CTA a row); cap: the buffer, a power of two up to SELECT_CAP keys
// (a k above it takes chunks of cap). out_v: [rows, k] float32; out_p:
// [rows, k] int64. Launches on `stream`, allocates nothing. Returns a
// cudaError_t.
extern "C" int select_topk(const float* s, long long rows, int n, int k, int threads, int cap,
                           float* out_v, long long* out_p, void* stream) {
  if (rows <= 0 || rows > 0x7FFFFFFFll || n <= 0 || n == 0x7FFFFFFF || k <= 0 || k > n ||
      cap <= 0 || cap > SELECT_CAP || (cap & (cap - 1)) || (threads != 128 && threads != 512))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(s) % 16 == 0;
  if (threads == 512)
    return vec ? launch<512, true>(s, rows, n, k, cap, out_v, out_p, st)
               : launch<512, false>(s, rows, n, k, cap, out_v, out_p, st);
  return vec ? launch<128, true>(s, rows, n, k, cap, out_v, out_p, st)
             : launch<128, false>(s, rows, n, k, cap, out_v, out_p, st);
}
