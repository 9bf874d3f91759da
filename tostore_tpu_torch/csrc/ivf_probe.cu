// IVF bucket-scan kernels for Hopper (sm_90a): the port's K3 and K4.
//
// K3 `ivf_bucket_probe` replaces tostore_tpu/ops/ivfprobe.py::_kernel
// (called by bucket_probe_scores). For query b and probe p it scores the
// contiguous bucket block probes[b, p] of the corpus copy [C, cap, D]:
//
//     out[b, p, j] = (q[b] . x[probes[b, p], j]) * scale[probe, j] + bias[probe, j]
//
// with f32 accumulation: f32 rows multiply in f32 FMA (never TF32), bf16
// products are exact in f32, int8 rows widen exactly to bf16. alpha is
// already folded into q (the wrapper casts q to bf16 for bf16 and int8
// buckets, as the JAX package does), and the scale applies before the bias.
//
// K4 `ivf_adc` replaces tostore_tpu/ops/ivfprobe.py::_adc_kernel (called
// by adc_bucket_scores): PQ asymmetric distances over the probed bucket's
// codes,
//
//     out[b, p, j] = -sum_m tab[b, p, m, code[probe, m, j]] + bias[probe, j]
//
// with codes [C, M, cap] u8, or [C, M/2, cap] with two 4-bit codes per
// byte (high nibble = subspace 2r, low nibble = 2r+1; the table stays in
// natural subspace order). Tables arrive in bf16 (the values the Pallas
// kernel's one-hot product sees); sums are f32, in subspace order.
//
// Both take the B * P (query, probe) pairs grouped by bucket: the wrapper
// sorts the probe ids stably (ops/ivfprobe.py bucket_groups) and hands
// over the sorted ids and the pair order. A run of equal ids is one bucket
// and the queries that probe it. Every CTA finds the runs itself, by
// comparing neighbours in the sorted list, and compacts their starts into
// shared memory (build_runs), so the call needs no host sync; persistent
// CTAs then walk (run, tile) work items. A probe id outside [0, C) makes a
// run that scores NEG_INF and reads nothing.
//
// What bounds them on an H100 SXM (3.35 TB/s HBM, 989 TFLOP/s dense bf16):
// reading each distinct probed bucket once (3 MB of bf16 rows or 95-190 KB
// of codes at the 1M / C = 1024 layout) and, for K4, each pair's table;
// the arithmetic is far below the tensor cores' rate. The design:
//   - K3, bf16 and int8 rows: a producer warpgroup's one thread keeps TMA
//     loads in flight into a ring of [128 rows x 64 k] row tiles of the
//     bucket, viewed as [C * cap, D] (128-byte swizzle for bf16; int8 raw,
//     widened exactly to bf16 in the swizzle by the consumers), beside the
//     same 64 k of the run's queries, which the wrapper gathered into a
//     [B * P, D] bf16 tensor in sorted order (TMA boxes of 8 queries). Two
//     consumer warpgroups run wgmma m64nNk16 with the rows as A and the
//     queries as B, N in {8, 16, 24, 32, 64} by run length; a run longer
//     than 64 takes chunks of 64 queries and re-reads the row tile from
//     L2. The epilogue applies scale, then bias, in registers and writes
//     out[b, p, rows] through the pair order. So a bucket is read from HBM
//     once per run and row tile, not once per (query, probe).
//   - K3, f32 rows (TF32 would break their exactness): CUDA-core FMA,
//     grouped the same way: a CTA stages up to 16 of the run's queries in
//     shared memory as f32 and each warp reads a bucket row once per such
//     chunk and dots it with every staged query.
//   - K4: a CTA takes (run segment, 512-column tile) items, a run cut
//     into segments of K4_SEG pairs so that a bucket that many queries
//     probe does not hold one CTA up. A producer warp keeps two rings
//     loaded ahead of the consumers: the segment's code tile ([M or M/2
//     rows, 512] u8; by TMA where cap is a multiple of 16, else by the
//     warp's loads), up to two tiles deep, and each pair's bf16 table in
//     chunks of subspaces (cp.async.bulk), up to four chunks deep; so the
//     next item's codes and tables arrive while this one's lookups run.
//     Four consumer warps; a thread owns 4 columns: one 32-bit word of
//     codes per row. The table's P stride is a parameter: a non-residual
//     index's table broadcast over P (stride 0) is read, not copied P
//     times. Codes of more than ~350 rows do not fit one tile in shared
//     memory (the launch is refused).
//     Lookups of a warp into a K = 256 table land on random banks
//     (chip_smoke.py prints the measured wavefronts per lookup); K = 16
//     tables span 8 banks and never conflict.

#include <algorithm>
#include <cfloat>
#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float NEG_INF = -FLT_MAX;  // float32 min, as runtime.NEG_INF
constexpr int RUN_MAX = 4096;        // sorted pairs per launch (the wrapper slices longer lists)
constexpr int RUN_BYTES = (RUN_MAX + 64) * 4;  // run starts, their end, 32 warp counts

// Compact the starts of the runs of equal ids in sorted[0, n) into
// starts[0, n_runs) and set starts[n_runs] = n; seg > 0 also cuts a run
// at every multiple of seg, so that no run holds more than seg pairs.
// Every thread of the CTA calls it (blockDim.x a multiple of 32, at most
// 1024); returns n_runs.
__device__ int build_runs(const int32_t* __restrict__ sorted, int n, int32_t* starts,
                          int seg = 0) {
  int32_t* warp_cnt = starts + RUN_MAX + 1;
  const int warps = blockDim.x / 32;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int base = 0;
  for (int i0 = 0; i0 < n; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    const bool start =
        i < n && (i == 0 || sorted[i] != sorted[i - 1] || (seg > 0 && i % seg == 0));
    const unsigned mask = __ballot_sync(0xffffffffu, start);
    if (lane == 0) warp_cnt[warp] = __popc(mask);
    __syncthreads();
    int off = base, total = 0;
    for (int w = 0; w < warps; ++w) {
      if (w < warp) off += warp_cnt[w];
      total += warp_cnt[w];
    }
    if (start) starts[off + __popc(mask & ((1u << lane) - 1u))] = i;
    base += total;
    __syncthreads();  // warp_cnt is rewritten by the next round
  }
  if (threadIdx.x == 0) starts[base] = n;
  __syncthreads();
  return base;
}

// A dead run (probe id outside [0, C)): NEG_INF for each of its pairs over
// entries [col0, col1) of cap, written by threads tid of `threads`.
__device__ void write_dead(const int32_t* __restrict__ order, int s0, int len, int col0,
                           int col1, int cap, float* __restrict__ out, int tid, int threads) {
  const int w = min(col1, cap) - col0;
  for (int e = tid; e < len * w; e += threads)
    out[static_cast<long long>(order[s0 + e / w]) * cap + col0 + e % w] = NEG_INF;
}

// ------------------------------------------------------------------------
// The pairs grouped by bucket (plain version: ops/ivfprobe.py bucket_groups)
// ------------------------------------------------------------------------

constexpr int G_THREADS = 1024;
constexpr int G_ROWS = 32;  // query rows each CTA gathers

// Pairs [s0, s0 + n) of probes ([B, P], int32 or int64 when wide, pair
// (b, p) at probes + b * sb + p * sp), n <= RUN_MAX: ids[i] and order[i]
// of the i-th pair in
// ascending (id, pair) order, which is the stable sort by id, ids clamped
// to [-1, C]; with qs, also each sorted pair's query row q[order[i] / P]
// (row_bytes) into qs[i]. Every CTA sorts the keys in shared memory
// (bitonic) and gathers G_ROWS rows; CTA 0 writes ids and order.
__global__ void __launch_bounds__(G_THREADS)
ivf_group_kernel(const void* __restrict__ probes, int wide, long long sb, long long sp, int s0,
                 int n, int n_buckets, int n_probes, const unsigned char* __restrict__ q,
                 int row_bytes,
                 int32_t* __restrict__ ids, int32_t* __restrict__ order,
                 unsigned char* __restrict__ qs) {
  __shared__ unsigned long long keys[RUN_MAX];
  int np2 = 1;
  while (np2 < n) np2 <<= 1;
  for (int i = threadIdx.x; i < np2; i += blockDim.x) {
    unsigned long long key = ~0ull;  // padding sorts last
    if (i < n) {
      const long long at = (s0 + i) / n_probes * sb + (s0 + i) % n_probes * sp;
      long long id = wide ? static_cast<const long long*>(probes)[at]
                          : static_cast<const int32_t*>(probes)[at];
      id = id < -1 ? -1 : (id > n_buckets ? n_buckets : id);
      key = (static_cast<unsigned long long>(id + 1) << 32) | static_cast<uint32_t>(s0 + i);
    }
    keys[i] = key;
  }
  __syncthreads();
  for (int size = 2; size <= np2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < np2 / 2; i += blockDim.x) {
        const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
        const unsigned long long a = keys[lo], b = keys[hi];
        if ((a > b) == ((lo & size) == 0)) {
          keys[lo] = b;
          keys[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      ids[i] = static_cast<int32_t>(keys[i] >> 32) - 1;
      order[i] = static_cast<int32_t>(keys[i] & 0xFFFFFFFFu);
    }
  if (qs == nullptr) return;
  const int chunks = row_bytes / 16;
  const int r0 = blockIdx.x * G_ROWS, r1 = min(n, r0 + G_ROWS);
  for (int e = threadIdx.x; e < (r1 - r0) * chunks; e += blockDim.x) {
    const int r = r0 + e / chunks, ch = e % chunks;
    const long long b = static_cast<long long>(keys[r] & 0xFFFFFFFFu) / n_probes;
    reinterpret_cast<uint4*>(qs + static_cast<long long>(r) * row_bytes)[ch] =
        reinterpret_cast<const uint4*>(q + b * row_bytes)[ch];
  }
}

// The pre-pass for pairs [s0, s0 + n): with q, G_ROWS query rows a CTA.
int launch_group(const void* probes, int wide, long long sb, long long sp, int s0, int n, int c,
                 int p, const void* q, int row_bytes, int32_t* ids, int32_t* order, void* qs,
                 cudaStream_t stream) {
  const int grid = q == nullptr ? 1 : (n + G_ROWS - 1) / G_ROWS;
  ivf_group_kernel<<<grid, G_THREADS, 0, stream>>>(
      probes, wide, sb, sp, s0, n, c, p, static_cast<const unsigned char*>(q), row_bytes, ids + s0,
      order + s0,
      q == nullptr ? nullptr
                   : static_cast<unsigned char*>(qs) + static_cast<long long>(s0) * row_bytes);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------------
// K3, bf16 and int8 rows: TMA ring + wgmma
// ------------------------------------------------------------------------

constexpr int K3_ROWS = 128;  // bucket rows per tile: a 64-row half per consumer warpgroup
constexpr int KT = 64;        // depth columns per stage: 128 bytes of bf16
constexpr int K3_STAGES = 6;
constexpr int K3_QMAX = 64;   // queries per product chunk
constexpr int K3_CONSUMERS = 2;
constexpr int K3_THREADS = 128 * (K3_CONSUMERS + 1);

// Shared memory: K3_STAGES x [row tile | query k-slice], 1024-aligned for
// the 128-byte swizzle; int8 only: the widened tiles [warpgroup][2] of
// 64 x 64 bf16; the run table; the full and empty barriers.
template <bool I8> struct K3Smem {
  static constexpr int R_BYTES = K3_ROWS * KT * (I8 ? 1 : 2);
  static constexpr int Q_BYTES = K3_QMAX * KT * 2;
  static constexpr int STAGE = R_BYTES + Q_BYTES;
  static constexpr int W_TILE = 64 * KT * 2;
  static constexpr int W_OFF = K3_STAGES * STAGE;
  static constexpr int RUN_OFF = W_OFF + (I8 ? K3_CONSUMERS * 2 * W_TILE : 0);
  static constexpr int BAR_OFF = RUN_OFF + RUN_BYTES;
  static constexpr int BYTES = BAR_OFF + 2 * K3_STAGES * 8 + 1024;  // + alignment slack
  static_assert(R_BYTES % 1024 == 0 && STAGE % 1024 == 0, "swizzle atoms");
  static_assert(BAR_OFF % 8 == 0 && BYTES <= 232448, "shared memory");
};

// the product's query width for a chunk of nq queries (TMA boxes of 8)
__host__ __device__ __forceinline__ int k3_width(int nq) {
  return nq <= 8 ? 8 : nq <= 16 ? 16 : nq <= 24 ? 24 : nq <= 32 ? 32 : 64;
}

// What a consumer thread needs to write its accumulator: the run's place
// in the pair order, its bucket's row tile and the thread's two rows.
struct K3Tile {
  const int32_t* order;
  int s0, c0, nq;           // run start, chunk offset within the run, queries in the chunk
  int row_a, row_b;         // the thread's two bucket rows (row_b = row_a + 8)
  float bi_a, bi_b, sc_a, sc_b;
  bool has_scale;
};

// One chunk of a run's queries (width N) against the row tile: the
// k-steps of the ring, then the epilogue. `it` is the ring position.
template <bool I8, int N>
__device__ __forceinline__ void k3_chunk(unsigned char* smem, uint64_t* full, uint64_t* empty,
                                         int& it, int k_steps, int wg, int t, const K3Tile& tl,
                                         int cap, float* __restrict__ out) {
  using S = K3Smem<I8>;
  const int l = t % 32;
  float acc[N / 2];
  const int it0 = it;
  for (int ks = 0; ks < k_steps; ++ks, ++it) {
    const int s = it % K3_STAGES;
    mbar_wait(&full[s], (it / K3_STAGES) & 1);
    unsigned char* st = smem + s * S::STAGE;
    const unsigned char* a_tile;
    if constexpr (I8) {
      // the wgmma that last read this buffer (step it - 2) is done
      unsigned char* w = smem + S::W_OFF + (wg * 2 + (it & 1)) * S::W_TILE;
      const unsigned char* raw = st + wg * 64 * KT;
#pragma unroll
      for (int c = t; c < 64 * 8; c += 128) {
        const int r = c / 8, ch = c % 8;
        widen8(w + r * 128 + ((ch ^ (r & 7)) * 16), raw + r * KT + ch * 8);
      }
      fence_async_shared();
      bar_sync(1 + wg, 128);
      a_tile = w;
    } else {
      a_tile = st + wg * 64 * 128;
    }
    const uint64_t da = sw128_desc(a_tile);
    const uint64_t db = sw128_desc(st + S::R_BYTES);
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
      Wgmma<N>::mma(acc, da + 2 * kk, db + 2 * kk, (ks > 0 || kk > 0) ? 1 : 0);
    wg_commit();
    fence_regs(acc);
    if (it > it0) {
      wg_wait<1>();
      fence_regs(acc);
      if (l == 0) mbar_arrive(&empty[(it - 1) % K3_STAGES]);
    }
  }
  wg_wait<0>();
  fence_regs(acc);
  if (l == 0) mbar_arrive(&empty[(it - 1) % K3_STAGES]);

  // element i: row row_a (+8 when bit 1 of i), query 2 (l % 4) + 8 (i >> 2) + (i & 1)
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int qi = 2 * (l % 4) + 8 * (i >> 2) + (i & 1);
    const bool hi = (i >> 1) & 1;
    const int row = hi ? tl.row_b : tl.row_a;
    if (qi >= tl.nq || row >= cap) continue;
    float x = acc[i];
    if (tl.has_scale) x = __fmul_rn(x, hi ? tl.sc_b : tl.sc_a);
    const long long pair = tl.order[tl.s0 + tl.c0 + qi];
    out[pair * cap + row] = __fadd_rn(x, hi ? tl.bi_b : tl.bi_a);
  }
}

// grid: persistent CTAs over (run, 128-row tile) work items
template <bool I8>
__global__ void __launch_bounds__(K3_THREADS, 1)
ivf_probe_wgmma_kernel(const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap qmap,
                       const int32_t* __restrict__ sorted, const int32_t* __restrict__ order,
                       const float* __restrict__ bias, const float* __restrict__ scale, int n,
                       int n_buckets, int cap, int d, float* __restrict__ out) {
  using S = K3Smem<I8>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  int32_t* starts = reinterpret_cast<int32_t*>(smem + S::RUN_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  uint64_t* empty = full + K3_STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < K3_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], K3_CONSUMERS * 4);  // lane 0 of every consumer warp
    }
    fence_barrier_init();
  }
  const int n_runs = build_runs(sorted, n, starts);  // its __syncthreads cover the init
  const int tiles = (cap + K3_ROWS - 1) / K3_ROWS;
  const int k_steps = (d + KT - 1) / KT;
  const int items = n_runs * tiles;
  const int wg = threadIdx.x / 128;

  if (wg == K3_CONSUMERS) {
    // ---- producer: one thread keeps the ring full
    if (threadIdx.x != K3_CONSUMERS * 128) return;
    int it = 0;
    for (int w = blockIdx.x; w < items; w += gridDim.x) {
      const int s0 = starts[w / tiles], len = starts[w / tiles + 1] - s0;
      const int id = sorted[s0];
      if (id < 0 || id >= n_buckets) continue;
      const int row = id * cap + (w % tiles) * K3_ROWS;
      for (int c0 = 0; c0 < len; c0 += K3_QMAX) {
        const int nq = k3_width(min(K3_QMAX, len - c0));
        for (int ks = 0; ks < k_steps; ++ks, ++it) {
          const int s = it % K3_STAGES;
          if (it >= K3_STAGES) mbar_wait(&empty[s], ((it / K3_STAGES) + 1) & 1);
          unsigned char* st = smem + s * S::STAGE;
          mbar_expect_tx(&full[s], S::R_BYTES + nq * KT * 2);
          tma_load_2d(st, &vmap, &full[s], ks * KT, row);
          for (int j = 0; j < nq; j += 8)
            tma_load_2d(st + S::R_BYTES + j * 128, &qmap, &full[s], ks * KT, s0 + c0 + j);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg scores rows 64 wg .. 64 wg + 63 of each tile
  const int t = threadIdx.x % 128;
  const int rloc = 64 * wg + 16 * (t / 32) + (t % 32) / 4;
  int it = 0;
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    const int tile = w % tiles;
    const int s0 = starts[w / tiles], len = starts[w / tiles + 1] - s0;
    const int id = sorted[s0];
    if (id < 0 || id >= n_buckets) {
      write_dead(order, s0, len, tile * K3_ROWS, (tile + 1) * K3_ROWS, cap, out, threadIdx.x,
                 K3_CONSUMERS * 128);
      continue;
    }
    K3Tile tl;
    tl.order = order;
    tl.s0 = s0;
    tl.row_a = tile * K3_ROWS + rloc;
    tl.row_b = tl.row_a + 8;
    const long long bb = static_cast<long long>(id) * cap;
    tl.has_scale = scale != nullptr;
    tl.bi_a = tl.row_a < cap ? bias[bb + tl.row_a] : 0.0f;
    tl.bi_b = tl.row_b < cap ? bias[bb + tl.row_b] : 0.0f;
    tl.sc_a = tl.has_scale && tl.row_a < cap ? scale[bb + tl.row_a] : 1.0f;
    tl.sc_b = tl.has_scale && tl.row_b < cap ? scale[bb + tl.row_b] : 1.0f;
    for (int c0 = 0; c0 < len; c0 += K3_QMAX) {
      tl.c0 = c0;
      tl.nq = min(K3_QMAX, len - c0);
      switch (k3_width(tl.nq)) {
        case 8: k3_chunk<I8, 8>(smem, full, empty, it, k_steps, wg, t, tl, cap, out); break;
        case 16: k3_chunk<I8, 16>(smem, full, empty, it, k_steps, wg, t, tl, cap, out); break;
        case 24: k3_chunk<I8, 24>(smem, full, empty, it, k_steps, wg, t, tl, cap, out); break;
        case 32: k3_chunk<I8, 32>(smem, full, empty, it, k_steps, wg, t, tl, cap, out); break;
        default: k3_chunk<I8, 64>(smem, full, empty, it, k_steps, wg, t, tl, cap, out); break;
      }
    }
  }
}

// ------------------------------------------------------------------------
// K3, f32 rows: grouped CUDA-core FMA
// ------------------------------------------------------------------------

constexpr int F_THREADS = 256;
constexpr int F_ROWS = 64;  // bucket rows per tile: 8 per warp
constexpr int F_Q = 16;     // most queries staged at once

// grid: persistent CTAs over (run, 64-row tile) work items. q: [n, d] f32
// in sorted order; fq <= F_Q queries staged per chunk.
__global__ void __launch_bounds__(F_THREADS)
ivf_probe_f32_kernel(const float* __restrict__ q, const int32_t* __restrict__ sorted,
                     const int32_t* __restrict__ order, const float* __restrict__ vecs,
                     const float* __restrict__ bias, const float* __restrict__ scale, int n,
                     int n_buckets, int cap, int d, int fq, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char fsmem[];
  int32_t* starts = reinterpret_cast<int32_t*>(fsmem);
  float* qs = reinterpret_cast<float*>(fsmem + RUN_BYTES);
  const int n_runs = build_runs(sorted, n, starts);
  const int tiles = (cap + F_ROWS - 1) / F_ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int w = blockIdx.x; w < n_runs * tiles; w += gridDim.x) {
    const int row0 = (w % tiles) * F_ROWS;
    const int s0 = starts[w / tiles], len = starts[w / tiles + 1] - s0;
    const int id = sorted[s0];
    if (id < 0 || id >= n_buckets) {
      write_dead(order, s0, len, row0, row0 + F_ROWS, cap, out, threadIdx.x, F_THREADS);
      continue;
    }
    const long long bb = static_cast<long long>(id) * cap;
    for (int c0 = 0; c0 < len; c0 += fq) {
      const int nq = min(fq, len - c0);
      __syncthreads();  // the previous chunk's reads of qs are done
      const float4* src = reinterpret_cast<const float4*>(q + static_cast<long long>(s0 + c0) * d);
      for (int i = threadIdx.x; i < nq * d / 4; i += F_THREADS)
        reinterpret_cast<float4*>(qs)[i] = src[i];
      __syncthreads();
      for (int row = row0 + warp; row < min(cap, row0 + F_ROWS); row += F_THREADS / 32) {
        const float* x = vecs + (bb + row) * d;
        float acc[F_Q];
#pragma unroll
        for (int j = 0; j < F_Q; ++j) acc[j] = 0.0f;
        for (int c = lane * 4; c < d; c += 128) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(x + c));
#pragma unroll
          for (int j = 0; j < F_Q; ++j) {
            if (j < nq) {
              const float4 qq = *reinterpret_cast<const float4*>(qs + j * d + c);
              acc[j] = fmaf(qq.x, v.x, acc[j]);
              acc[j] = fmaf(qq.y, v.y, acc[j]);
              acc[j] = fmaf(qq.z, v.z, acc[j]);
              acc[j] = fmaf(qq.w, v.w, acc[j]);
            }
          }
        }
        float mine = 0.0f;
#pragma unroll
        for (int j = 0; j < F_Q; ++j) {
          if (j < nq) {
            float a = acc[j];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
            if (lane == j) mine = a;
          }
        }
        if (lane < nq) {
          if (scale != nullptr) mine = __fmul_rn(mine, scale[bb + row]);
          out[static_cast<long long>(order[s0 + c0 + lane]) * cap + row] =
              __fadd_rn(mine, bias[bb + row]);
        }
      }
    }
  }
}

// ------------------------------------------------------------------------
// K4: PQ ADC lookups
// ------------------------------------------------------------------------

constexpr int K4_CONSUMERS = 128;             // 4 warps: a 32-bit word of codes per thread and row
constexpr int K4_THREADS = K4_CONSUMERS + 32;  // and one producer warp
constexpr int K4_COLS = 4 * K4_CONSUMERS;
constexpr int K4_BOX = 256;                    // TMA box width (columns)
// Pairs of a run per work item: a CTA walks an item's pairs one after the
// other, so a bucket that many queries probe is cut into several items (its
// code tile read by each, from L2 after the first) so that no CTA holds the
// call up with a long run. On an H100 2 beat 4, 8 and whole runs at B = 8
// and 64 (ivf_sweep.py).
constexpr int K4_SEG = 2;
constexpr int K4_MAX_CODE_STAGES = 2;
constexpr int K4_MAX_TAB_STAGES = 4;
constexpr size_t K4_TWO_PER_SM = 113 * 1024;  // shared memory of a CTA when two share an SM

// Shared memory: the run table; the full and empty barriers of the code
// ring and the table ring; the table ring (tab_stages chunks of m_chunk *
// kp bf16); the code ring (code_stages tiles [K4_COLS / 256][rows_alloc]
// [256], 128-byte aligned for TMA).
constexpr int K4_BAR_OFF = RUN_BYTES;
constexpr int K4_TAB_OFF = K4_BAR_OFF + 2 * (K4_MAX_CODE_STAGES + K4_MAX_TAB_STAGES) * 8;
__host__ __device__ __forceinline__ int k4_code_off(int tab_elems, int tab_stages) {
  return (K4_TAB_OFF + tab_stages * tab_elems * 2 + 127) & ~127;
}

// grid: persistent CTAs over (run segment, 512-column tile) work items.
// tabs: bf16 tables, pair (b, p) at tabs + b * tab_b + p * tab_p, rows of
// kp >= k entries (kp a multiple of 8); m_chunk subspaces per table chunk
// (even when packed); codes: [C * rows, cap] u8, through cmap when use_map.
// The producer warp walks the same items as the consumers and keeps the
// code ring (code_stages tiles) and the table ring (tab_stages chunks)
// loaded ahead of them; the consumers look up and write.
__global__ void __launch_bounds__(K4_THREADS)
ivf_adc_kernel(const __grid_constant__ CUtensorMap cmap, int use_map,
               const uint8_t* __restrict__ codes, const __nv_bfloat16* __restrict__ tabs,
               long long tab_b, long long tab_p, int n_probes,
               const int32_t* __restrict__ sorted, const int32_t* __restrict__ order,
               const float* __restrict__ bias, int n, int n_buckets, int m, int k, int kp,
               int cap, int packed, int m_chunk, int rows_alloc, int box_rows, int code_stages,
               int tab_stages, float* __restrict__ out) {
  extern __shared__ __align__(1024) unsigned char ksmem[];
  int32_t* starts = reinterpret_cast<int32_t*>(ksmem);
  uint64_t* code_full = reinterpret_cast<uint64_t*>(ksmem + K4_BAR_OFF);
  uint64_t* code_empty = code_full + K4_MAX_CODE_STAGES;
  uint64_t* tab_full = code_empty + K4_MAX_CODE_STAGES;
  uint64_t* tab_empty = tab_full + K4_MAX_TAB_STAGES;
  const int tab_elems = m_chunk * kp;
  __nv_bfloat16* tab_s = reinterpret_cast<__nv_bfloat16*>(ksmem + K4_TAB_OFF);
  unsigned char* code_s = ksmem + k4_code_off(tab_elems, tab_stages);
  const int code_bytes = rows_alloc * K4_COLS;
  const int rows = packed ? m / 2 : m;
  const int t = threadIdx.x;
  if (t == 0) {
    for (int s = 0; s < K4_MAX_CODE_STAGES; ++s) {
      mbar_init(&code_full[s], 1);
      mbar_init(&code_empty[s], K4_CONSUMERS / 32);  // lane 0 of every consumer warp
    }
    for (int s = 0; s < K4_MAX_TAB_STAGES; ++s) {
      mbar_init(&tab_full[s], 1);
      mbar_init(&tab_empty[s], K4_CONSUMERS / 32);
    }
    fence_barrier_init();
  }
  const int n_runs = build_runs(sorted, n, starts, K4_SEG);
  const int tiles = (cap + K4_COLS - 1) / K4_COLS;
  const int n_chunks = (m + m_chunk - 1) / m_chunk;
  const int items = n_runs * tiles;
  int ic = 0, it = 0;  // code tiles and table chunks so far

  if (t >= K4_CONSUMERS) {
    // ---- producer warp: lane 0 issues the copies (all lanes copy codes
    // that TMA cannot take)
    const int lane = t - K4_CONSUMERS;
    for (int w = blockIdx.x; w < items; w += gridDim.x) {
      const int col0 = (w % tiles) * K4_COLS;
      const int s0 = starts[w / tiles], len = starts[w / tiles + 1] - s0;
      const int id = sorted[s0];
      if (id < 0 || id >= n_buckets) continue;
      const int cs = ic % code_stages;
      if (ic >= code_stages) mbar_wait(&code_empty[cs], ((ic / code_stages) + 1) & 1);
      unsigned char* slot = code_s + cs * code_bytes;
      const long long crow = static_cast<long long>(id) * rows;
      if (use_map) {
        if (lane == 0) {
          mbar_expect_tx(&code_full[cs], static_cast<uint32_t>(code_bytes));
          for (int h = 0; h < K4_COLS / K4_BOX; ++h)
            for (int r0 = 0; r0 < rows_alloc; r0 += box_rows)
              tma_load_2d(slot + (h * rows_alloc + r0) * K4_BOX, &cmap, &code_full[cs],
                          col0 + h * K4_BOX, static_cast<int>(crow + r0));
        }
      } else {
        for (int e = lane; e < rows * K4_COLS; e += 32) {
          const int r = e / K4_COLS, col = e % K4_COLS;
          const int gc = col0 + col;
          slot[((col / K4_BOX) * rows_alloc + r) * K4_BOX + col % K4_BOX] =
              gc < cap ? codes[(crow + r) * cap + gc] : 0;
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&code_full[cs]);  // releases the lanes' writes
      }
      ++ic;
      for (int s = 0; s < len * n_chunks; ++s, ++it) {
        const int ts = it % tab_stages;
        if (it >= tab_stages) mbar_wait(&tab_empty[ts], ((it / tab_stages) + 1) & 1);
        if (lane != 0) continue;
        const int pair = order[s0 + s / n_chunks];
        const int ch = s % n_chunks;
        const int mc = min(m_chunk, m - ch * m_chunk);
        const __nv_bfloat16* src = tabs + (pair / n_probes) * tab_b + (pair % n_probes) * tab_p +
                                   static_cast<long long>(ch) * m_chunk * kp;
        const uint32_t bytes = static_cast<uint32_t>(mc * kp * 2);
        mbar_expect_tx(&tab_full[ts], bytes);
        bulk_load(tab_s + ts * tab_elems, src, bytes, &tab_full[ts]);
      }
    }
    return;
  }

  // ---- consumers: thread t owns columns 4t .. 4t + 3 of each tile, held
  // in half t / 64 of the code tile, word t % 64 of each row
  const int l = t % 32;
  const int my_off = (t / 64) * rows_alloc * K4_BOX + 4 * (t % 64);
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    const int col0 = (w % tiles) * K4_COLS;
    const int s0 = starts[w / tiles], len = starts[w / tiles + 1] - s0;
    const int id = sorted[s0];
    if (id < 0 || id >= n_buckets) {
      write_dead(order, s0, len, col0, col0 + K4_COLS, cap, out, t, K4_CONSUMERS);
      continue;
    }
    const int cs = ic % code_stages;
    mbar_wait(&code_full[cs], (ic / code_stages) & 1);
    const unsigned char* my_codes = code_s + cs * code_bytes + my_off;
    const int col = col0 + 4 * t;
    const long long brow = static_cast<long long>(id) * cap;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int s = 0; s < len * n_chunks; ++s, ++it) {
      const int ts = it % tab_stages;
      mbar_wait(&tab_full[ts], (it / tab_stages) & 1);
      const __nv_bfloat16* tb = tab_s + ts * tab_elems;
      const int ch = s % n_chunks;
      const int m0 = ch * m_chunk;
      const int mc = min(m_chunk, m - m0);
      if (packed) {
#pragma unroll 4
        for (int r = m0 / 2; r < (m0 + mc) / 2; ++r) {
          const uint32_t word = *reinterpret_cast<const uint32_t*>(my_codes + r * K4_BOX);
          const __nv_bfloat16* t_hi = tb + (2 * r - m0) * kp;
          const __nv_bfloat16* t_lo = t_hi + kp;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t byte = (word >> (8 * j)) & 0xFFu;
            acc[j] += __bfloat162float(t_hi[byte >> 4]);
            acc[j] += __bfloat162float(t_lo[byte & 0xFu]);
          }
        }
      } else {
#pragma unroll 4
        for (int mm = 0; mm < mc; ++mm) {
          const uint32_t word =
              *reinterpret_cast<const uint32_t*>(my_codes + (m0 + mm) * K4_BOX);
          const __nv_bfloat16* tr = tb + mm * kp;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[j] += __bfloat162float(
                tr[min(static_cast<int>((word >> (8 * j)) & 0xFFu), k - 1)]);
        }
      }
      __syncwarp();
      if (l == 0) mbar_arrive(&tab_empty[ts]);
      if (ch == n_chunks - 1) {
        float* o = out + static_cast<long long>(order[s0 + s / n_chunks]) * cap;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (col + j < cap) o[col + j] = __fadd_rn(-acc[j], bias[brow + col + j]);
          acc[j] = 0.0f;
        }
      }
    }
    __syncwarp();
    if (l == 0) mbar_arrive(&code_empty[cs]);
    ++ic;
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  return sms;
}

// persistent grid: what fits on the card at once, at most one CTA per item
template <typename Kernel>
int persistent_grid(Kernel kernel, int threads, size_t smem, long long items) {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) !=
      cudaSuccess)
    return 0;
  const long long ctas = static_cast<long long>(sm_count()) * per_sm;
  return static_cast<int>(items < ctas ? items : ctas);
}

template <bool I8>
int launch_probe_wgmma(const void* q, const int32_t* sorted, const int32_t* order,
                       const void* vecs, const float* bias, const float* scale, int n, int c,
                       int cap, int d, float* out, cudaStream_t stream) {
  if ((d * (I8 ? 1 : 2)) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap vmap, qmap;
  int err = make_map(&vmap, vecs,
                     I8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                     I8 ? 1 : 2, static_cast<long long>(c) * cap, d, K3_ROWS, KT,
                     I8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  err = make_map(&qmap, q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, n, d, 8, KT,
                 CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  auto kernel = ivf_probe_wgmma_kernel<I8>;
  constexpr int bytes = K3Smem<I8>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = persistent_grid(kernel, K3_THREADS, bytes,
                                   static_cast<long long>(n) * ((cap + K3_ROWS - 1) / K3_ROWS));
  if (grid <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<grid, K3_THREADS, bytes, stream>>>(vmap, qmap, sorted, order, bias, scale, n, c, cap,
                                              d, out);
  return static_cast<int>(cudaGetLastError());
}

int launch_probe_f32(const float* q, const int32_t* sorted, const int32_t* order,
                     const float* vecs, const float* bias, const float* scale, int n, int c,
                     int cap, int d, float* out, cudaStream_t stream) {
  constexpr size_t budget = 200 * 1024;
  if (d % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int fq = static_cast<int>(
      (budget - RUN_BYTES) / (static_cast<size_t>(d) * 4) < F_Q
          ? (budget - RUN_BYTES) / (static_cast<size_t>(d) * 4)
          : F_Q);
  if (fq < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = RUN_BYTES + static_cast<size_t>(fq) * d * 4;
  cudaError_t e = cudaFuncSetAttribute(ivf_probe_f32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = persistent_grid(ivf_probe_f32_kernel, F_THREADS, bytes,
                                   static_cast<long long>(n) * ((cap + F_ROWS - 1) / F_ROWS));
  if (grid <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  ivf_probe_f32_kernel<<<grid, F_THREADS, bytes, stream>>>(q, sorted, order, vecs, bias, scale, n,
                                                           c, cap, d, fq, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch's K3 for sorted pairs (sorted, order, the query rows q in
// their order; n <= RUN_MAX).
static int launch_probe(const void* q, const int32_t* sorted, const int32_t* order,
                        const void* vecs, int dtype, const float* bias, const float* scale, int n,
                        int c, int cap, int d, float* out, cudaStream_t s) {
  switch (dtype) {
    case 0:
      return launch_probe_f32(static_cast<const float*>(q), sorted, order,
                              static_cast<const float*>(vecs), bias, scale, n, c, cap, d, out, s);
    case 1:
      return launch_probe_wgmma<false>(q, sorted, order, vecs, bias, scale, n, c, cap, d, out, s);
    case 2:
      return launch_probe_wgmma<true>(q, sorted, order, vecs, bias, scale, n, c, cap, d, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One launch's K4 for sorted pairs (sorted, order; n <= RUN_MAX).
static int launch_adc(const void* tabs, long long tab_b, long long tab_p, int n_probes,
                      const int32_t* sorted, const int32_t* order, const uint8_t* codes,
                      const float* bias, int n, int c, int m, int k, int kp, int cap, int packed,
                      int m_chunk, float* out, cudaStream_t stream) {
  const int rows = packed ? m / 2 : m;
  const int n_box = (rows + 255) / 256;
  const int box_rows = (rows + n_box - 1) / n_box;
  const int rows_alloc = n_box * box_rows;
  const int use_map = cap % 16 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  CUtensorMap cmap = {};
  if (use_map) {
    const int err = make_map(&cmap, codes, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                             static_cast<long long>(c) * rows, cap, box_rows, K4_BOX,
                             CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err != 0) return err;
  }
  if (static_cast<long long>(m_chunk) * kp > 32768) return static_cast<int>(cudaErrorInvalidValue);
  // Rings: two CTAs per SM where the code tile allows it (one CTA's four
  // consumer warps alone leave the lookups' latency exposed), with the
  // deepest rings that fit that; else the deepest that fit one CTA.
  int code_stages = K4_MAX_CODE_STAGES, tab_stages = K4_MAX_TAB_STAGES;
  const auto smem_bytes = [&]() {
    return static_cast<size_t>(k4_code_off(m_chunk * kp, tab_stages)) +
           static_cast<size_t>(code_stages) * rows_alloc * K4_COLS;
  };
  const auto shrink_to = [&](size_t limit) {
    code_stages = K4_MAX_CODE_STAGES;
    tab_stages = K4_MAX_TAB_STAGES;
    while (smem_bytes() > limit && code_stages > 1) --code_stages;
    while (smem_bytes() > limit && tab_stages > 2) --tab_stages;
    return smem_bytes() <= limit;
  };
  if (!shrink_to(K4_TWO_PER_SM)) shrink_to(232448);
  const size_t bytes = smem_bytes();
  if (bytes > 232448) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(ivf_adc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = persistent_grid(ivf_adc_kernel, K4_THREADS, bytes,
                                   static_cast<long long>(n) * ((cap + K4_COLS - 1) / K4_COLS));
  if (grid <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  ivf_adc_kernel<<<grid, K4_THREADS, bytes, stream>>>(
      cmap, use_map, codes, static_cast<const __nv_bfloat16*>(tabs), tab_b, tab_p, n_probes,
      sorted, order, bias, n, c, m, k, kp, cap, packed, m_chunk, rows_alloc, box_rows,
      code_stages, tab_stages, out);
  return static_cast<int>(cudaGetLastError());
}

// The pairs of probes ([b, p], int32, or int64 when wide; pair (b, p) at
// probes + b * sb + p * sp) go through the grouping pre-pass and the
// kernel in slices of RUN_MAX; ids and order ([b * p] int32) are
// scratch, and so is qs for K3.
static bool bad_pairs(int b, int p, int c) {
  return b <= 0 || p <= 0 || c <= 0 || static_cast<long long>(b) * p > 0x7FFFFFFFll;
}

// K3. dtype: 0 = float32 rows (q float32), 1 = bfloat16 rows (q
// bfloat16), 2 = int8 rows (q bfloat16). q: [b, d]; vecs: [c, cap, d];
// bias, scale: [c, cap] float32 (scale may be null); qs: [b * p, d] of
// q's type; out: [b, p, cap]. Returns a cudaError_t.
extern "C" int ivf_bucket_probe(const void* q, const void* probes, int wide, long long sb,
                                long long sp, int b, int p, const void* vecs, int dtype,
                                const float* bias, const float* scale, int c, int cap, int d,
                                int32_t* ids, int32_t* order, void* qs, float* out,
                                void* stream) {
  if (bad_pairs(b, p, c) || cap <= 0 || d <= 0 || dtype < 0 || dtype > 2 ||
      static_cast<long long>(c) * cap > 0x7FFFFFFFll)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_bytes = d * (dtype == 0 ? 4 : 2);
  for (int s0 = 0; s0 < b * p; s0 += RUN_MAX) {
    const int n = std::min(RUN_MAX, b * p - s0);
    int err = launch_group(probes, wide, sb, sp, s0, n, c, p, q, row_bytes, ids, order, qs, s);
    if (err != 0) return err;
    const unsigned char* qs0 = static_cast<const unsigned char*>(qs);
    err = launch_probe(qs0 + static_cast<long long>(s0) * row_bytes,
                       ids + s0, order + s0, vecs, dtype, bias, scale, n, c, cap, d, out, s);
    if (err != 0) return err;
  }
  return 0;
}

// K4. tabs: bf16, pair (b, p)'s [m, kp] table at tabs + b * tab_b + p *
// tab_p (elements; tab_p may be 0), kp >= k a multiple of 8, 16-byte
// aligned; codes: [c, m, cap] u8, or [c, m/2, cap] when packed (k == 16);
// bias: [c, cap]; m_chunk: subspaces per table chunk (even when packed);
// out: [b, p, cap]. Returns a cudaError_t.
extern "C" int ivf_adc(const void* tabs, long long tab_b, long long tab_p, const void* probes,
                       int wide, long long sb, long long sp, int b, int p, const uint8_t* codes,
                       const float* bias, int c, int m, int k, int kp, int cap, int packed,
                       int m_chunk, int32_t* ids, int32_t* order, float* out, void* stream) {
  if (bad_pairs(b, p, c) || cap <= 0 || m <= 0 || k <= 0 || k > 256 || kp < k || kp % 8 ||
      tab_b % 8 || tab_p % 8 || m_chunk <= 0 || (packed && (k != 16 || m % 2 || m_chunk % 2)) ||
      static_cast<long long>(c) * (packed ? m / 2 : m) > 0x7FFFFFFFll ||
      reinterpret_cast<uintptr_t>(tabs) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int s0 = 0; s0 < b * p; s0 += RUN_MAX) {
    const int n = std::min(RUN_MAX, b * p - s0);
    int err = launch_group(probes, wide, sb, sp, s0, n, c, p, nullptr, 0, ids, order, nullptr, s);
    if (err != 0) return err;
    err = launch_adc(tabs, tab_b, tab_p, p, ids + s0, order + s0, codes, bias, n, c, m, k, kp,
                     cap, packed, m_chunk, out, s);
    if (err != 0) return err;
  }
  return 0;
}

// The grouping pre-pass alone (to hold it against bucket_groups): ids and
// order of probes' pairs, sorted within each slice of RUN_MAX.
extern "C" int ivf_group_pairs(const void* probes, int wide, long long sb, long long sp, int b,
                               int p, int c, int32_t* ids, int32_t* order, void* stream) {
  if (bad_pairs(b, p, c)) return static_cast<int>(cudaErrorInvalidValue);
  for (int s0 = 0; s0 < b * p; s0 += RUN_MAX) {
    const int err = launch_group(probes, wide, sb, sp, s0, std::min(RUN_MAX, b * p - s0), c, p,
                                 nullptr, 0, ids, order, nullptr,
                                 static_cast<cudaStream_t>(stream));
    if (err != 0) return err;
  }
  return 0;
}
