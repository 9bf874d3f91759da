// Lane top-k scan kernels for Hopper (sm_90a): the port's K5 and K6, and
// K1 and K2 for f32 corpora (`lane_topk_acc_f32`, `lane_topk_emit_f32`).
// bf16 and int8 corpora take K1 and K2 of lane_scan.cuh (TMA, wgmma, warp
// specialisation); f32 ones stay on this template's f32 FMA, because TF32
// would break their exactness.
//
// K1 `lane_topk_acc_f32` replaces tostore_tpu/ops/topk.py::_lane_topk_kernel
// (called by fused_flat_topk); K2 `lane_topk_emit_f32` replaces
// tostore_tpu/ops/topk.py::_lane_topk_block_kernel (called by
// _fused_block_emit); K5 `lane_topk_group` replaces
// tostore_tpu/ops/topk.py::_lane_topk_group_kernel (called by
// _fused_group_emit); K6 `lane_topk_group_pipe` replaces
// experiments/_exp_pipe.py::_pipe_kernel (called by pipe_topk). All compute,
// for every corpus block of `blk_n` rows,
//
//     s[b, row] = alpha * (row_scale[row] * (q[b] . c[row])) + bias[row]
//
// with f32 accumulation, and take each lane's top-2 within the block (lane
// = row % 128, ties to the lower row, as `v > best` in _block_lane_top2).
// K2 writes every block's per-lane top-2 to [B_pad, n_blocks * 256]. K1
// folds them into a running per-lane top-T with the reference's bubble
// insert. K5 and K6 fold them, with the reference's sorted 4-way merge, into
// a running per-lane top-2 over each group of `gsz` blocks and write one
// [B_pad, 256] tile per group. A TPU grid walks the blocks in order on one
// core; here CTAs run in parallel, so the block range is split across CTAs.
// K1's splits each keep their own per-lane top-T in their slice of the
// output; the wrapper (ops/topk.py) takes the final top-k over all splits'
// lists, or for k > T first merges them per lane into the reference's
// per-lane top-T: the same result as the reference, ties aside. K5 and K6
// give each CTA whole groups, so their candidates are the reference's.
//
// What bounds them on an H100 SXM (data sheet: 3.35 TB/s HBM, 989 TFLOP/s
// dense bf16): at B <= 32 (K1) the corpus is read once, 1.54 GB at
// 1M x 768 bf16, so about 0.46 ms of HBM time is the floor and the dot is
// far below the tensor cores' rate. K2 and K5 at B = 256 do 403 GFLOP per
// scan, close to the ridge. The design:
//   - bf16 and int8 corpora (K5, K6) run on the tensor cores through WMMA
//     (bf16 in, f32 accumulate, m16n16k16; int8 rows widen exactly to bf16
//     in shared memory); f32 corpora use f32 FMA, because TF32 would break
//     their exactness.
//   - The corpus streams through a ring of STAGES shared-memory tiles
//     filled by cp.async, so several tiles are in flight per CTA while the
//     current one is multiplied: what a memory-bound scan needs. A CTA's
//     blocks are contiguous rows, so the ring runs across 128-row tiles and
//     blocks without draining.
//   - Each CTA serves BM queries (f32 K1: 8 for a batch of up to 8, else
//     16; f32 K2, K5, K6: 32), so the corpus is read once per query tile; query
//     tiles of one split are adjacent in the launch order and meet the same
//     corpus rows in L2. Registers bound BM: two CTAs per SM leave 128 a
//     thread, and each (query, lane) pair a thread selects for costs five.
//     K5 keeps a running top-2 per pair besides the block's, another four
//     registers, so it runs one CTA per SM (255 registers a thread); at
//     1M rows its 16 groups x B/32 query tiles fill one wave at most.
//   - Scores never leave the SM: a [BM, 128] score tile in shared memory
//     feeds the per-lane selection, one thread per (lane, half of the
//     query tile), which keeps its pairs' selection state in registers.
//     K1's running lists sit in its output slice in global memory
//     (L2-resident) and are touched only when a block's candidate beats
//     the list's last entry, which each thread keeps in a register; an
//     update then reads the list into registers with independent loads.
//   - K6 is K5 with the scoring and the selection on different warps
//     (warp specialization): 8 MMA warps score tile t+1 into one of two
//     [32, 128] score tiles while 8 selection warps reduce tile t from the
//     other, handing them over with named barriers (bar.sync / bar.arrive).
//     With 512 threads a CTA has 128 registers a thread, so the selection
//     warps keep the group's running top-2 in shared memory, each thread
//     its own entries. It answers on this card the question the TPU's
//     software pipeline answered "no" to (tostore_tpu/ops/topk.py:105-119):
//     does overlapping the selection with the matmul pay?

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int LANE = 128;
constexpr int THREADS = 256;
constexpr int GROUPS = THREADS / LANE;  // threads per lane in the selection
constexpr int STAGES = 4;
constexpr float NEG_INF = -FLT_MAX;  // float32 min, as runtime.NEG_INF
constexpr int SP = LANE + 4;         // score tile row pitch (floats)

// Per corpus type: query element type, depth columns per pipeline step
// (KC), shared-memory row pitch in elements (KP, padded by 16 bytes so
// rows start on distinct banks and every WMMA pointer stays 32-byte
// aligned), and the bytes of one staged corpus tile.
template <typename CT> struct Cfg;
template <> struct Cfg<__nv_bfloat16> {
  using Q = __nv_bfloat16;
  static constexpr int KC = 64, KP = 72;
  static constexpr int C_STAGE = LANE * KP * 2;
  static constexpr int CB = 0;  // no conversion buffer
};
template <> struct Cfg<int8_t> {
  using Q = __nv_bfloat16;
  static constexpr int KC = 64, KP = 72;
  static constexpr int C_STAGE = LANE * KC;   // raw int8 rows
  static constexpr int CB = LANE * KP * 2;    // the tile widened to bf16
};
template <> struct Cfg<float> {
  using Q = float;
  static constexpr int KC = 32, KP = 36;
  static constexpr int C_STAGE = LANE * KP * 4;
  static constexpr int CB = 0;
};

template <typename CT, int BM> struct Layout {
  using C = Cfg<CT>;
  static constexpr int Q_STAGE = BM * C::KP * (int)sizeof(typename C::Q);
  static constexpr int STAGE = Q_STAGE + C::C_STAGE;
  static constexpr int S_OFF = STAGES * STAGE;
  static constexpr int CB_OFF = S_OFF + BM * SP * 4;
  static constexpr int BYTES = CB_OFF + C::CB;
  static_assert(Q_STAGE % 128 == 0 && STAGE % 128 == 0 && CB_OFF % 128 == 0, "alignment");
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = full ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying step `it`'s tiles into `stage`: query rows [b0, b0+BM)
// (zeros past b_pad) and corpus rows [row0, row0+128), columns [k0, k0+KC).
template <typename CT, int BM>
__device__ __forceinline__ void issue_step(unsigned char* stage,
                                           const typename Cfg<CT>::Q* __restrict__ q,
                                           const CT* __restrict__ corpus, int b0, int b_pad,
                                           long long row0, int k0, int d) {
  using C = Cfg<CT>;
  using Q = typename C::Q;
  constexpr int QV = 16 / (int)sizeof(Q);  // query elements per 16 bytes
  Q* qs = reinterpret_cast<Q*>(stage);
  for (int i = threadIdx.x; i < BM * (C::KC / QV); i += THREADS) {
    const int r = i / (C::KC / QV);
    const int c = (i % (C::KC / QV)) * QV;
    const bool live = b0 + r < b_pad;
    cp_async16(qs + r * C::KP + c, q + (long long)(live ? b0 + r : 0) * d + k0 + c, live);
  }
  unsigned char* cs = stage + Layout<CT, BM>::Q_STAGE;
  constexpr int CV = 16 / (int)sizeof(CT);  // corpus elements per 16 bytes
  constexpr int PITCH = sizeof(CT) == 1 ? C::KC : C::KP;
  for (int i = threadIdx.x; i < LANE * (C::KC / CV); i += THREADS) {
    const int r = i / (C::KC / CV);
    const int c = (i % (C::KC / CV)) * CV;
    cp_async16(reinterpret_cast<CT*>(cs) + r * PITCH + c, corpus + (row0 + r) * d + k0 + c,
               true);
  }
}

// The reference's sorted 4-way merge (topk.py:403-421): the running pair
// (r1 >= r2) and a block's (m1 >= m2) -> the union's top-2, two compares.
// The running pair wins a tie for the top; the second is the larger of the
// tops' loser and the winner's second, the loser winning a tie.
__device__ __forceinline__ void merge_top2(float& r1, float& r2, int& i1, int& i2, float m1,
                                           float m2, int g1, int g2) {
  const bool w = r1 >= m1;
  const float c2a = w ? m1 : r1;
  const int j2a = w ? g1 : i1;
  const float c2b = w ? r2 : m2;
  const int j2b = w ? i2 : g2;
  if (!w) {
    r1 = m1;
    i1 = g1;
  }
  const bool w2 = c2a >= c2b;
  r2 = w2 ? c2a : c2b;
  i2 = w2 ? j2a : j2b;
}

__device__ __forceinline__ void widen_int8x16(__nv_bfloat16* dst, const int8_t* src) {
  __align__(16) int8_t v[16];
  *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(src);
  __align__(16) __nv_bfloat16 w[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) w[e] = __float2bfloat16(static_cast<float>(v[e]));
  reinterpret_cast<uint4*>(dst)[0] = reinterpret_cast<const uint4*>(w)[0];
  reinterpret_cast<uint4*>(dst)[1] = reinterpret_cast<const uint4*>(w)[1];
}

// grid: x = query tile (BM rows of q), y = split (a contiguous range of
// corpus blocks). T > 0: K1, a running per-lane top-T per split; T == 0:
// K2, every block's per-lane top-2 written out; T == 0 and GROUP: K5, each
// split one group, its running per-lane top-2 written out at its end.
template <typename CT, int BM, int T, bool GROUP>
__global__ void __launch_bounds__(THREADS, GROUP ? 1 : 2)
lane_topk_kernel(const typename Cfg<CT>::Q* __restrict__ q, const CT* __restrict__ corpus,
                 const float* __restrict__ bias, const float* __restrict__ scale,
                 float alpha, int b_pad, int d, int blk_n, int n_blocks,
                 int blocks_per_split, float* __restrict__ out_s,
                 int32_t* __restrict__ out_i) {
  constexpr bool ACC = T > 0;
  using C = Cfg<CT>;
  using L = Layout<CT, BM>;
  constexpr bool MMA = sizeof(CT) != 4;
  constexpr int HB = BM / GROUPS;  // query rows per thread in the selection
  // WMMA m16n16k16 (bf16 and int8: K5, BM = 32): each of the 8 warps
  // scores 16 corpus rows for the MF query row tiles
  constexpr int FM = 16, FN = 16;
  constexpr int MF = BM / FM;
  extern __shared__ __align__(128) unsigned char smem[];
  float* ss = reinterpret_cast<float*>(smem + L::S_OFF);

  const int tid = threadIdx.x;
  const int lane = tid % LANE;
  const int group = tid / LANE;
  const int warp = tid / 32;
  const int b0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int blk_lo = split * blocks_per_split;
  const int blk_hi = min(n_blocks, blk_lo + blocks_per_split);
  const int rows_per_lane = blk_n / LANE;
  const int k_steps = d / C::KC;
  const long long row_base = (long long)blk_lo * blk_n;
  const int steps = (blk_hi - blk_lo) * rows_per_lane * k_steps;

  // K1: this split's lists, laid out [b_pad][split][t][128]
  // entry t of (query b, lane): ((b * n_splits + split) * T + t) * 128 + lane
  const auto list_at = [&](int b) {
    return ((long long)b * gridDim.y + split) * T * LANE + lane;
  };
  float thr[ACC ? HB : 1];
  if constexpr (ACC) {
#pragma unroll
    for (int j = 0; j < HB; ++j) {
      thr[j] = NEG_INF;
      const int b = b0 + group * HB + j;
      if (b < b_pad)
        for (int t = 0; t < T; ++t) {
          out_s[list_at(b) + t * LANE] = NEG_INF;
          out_i[list_at(b) + t * LANE] = 0;
        }
    }
  }

  float best[HB], best2[HB];
  int bidx[HB], bidx2[HB];
  // K5: the group's running per-lane top-2; it starts at (NEG_INF, row 0),
  // as the reference's scratch does, so a lane that only saw dead rows
  // reports index 0
  float r1[GROUP ? HB : 1], r2[GROUP ? HB : 1];
  int i1[GROUP ? HB : 1], i2[GROUP ? HB : 1];
  if constexpr (GROUP) {
#pragma unroll
    for (int j = 0; j < HB; ++j) {
      r1[j] = NEG_INF; r2[j] = NEG_INF; i1[j] = 0; i2[j] = 0;
    }
  }

  using namespace nvcuda;
  wmma::fragment<wmma::accumulator, FM, FN, 16, float> acc[MMA ? MF : 1];
  float facc[MMA ? 1 : HB];
  if constexpr (MMA) {
#pragma unroll
    for (int m = 0; m < MF; ++m) wmma::fill_fragment(acc[m], 0.0f);
  } else {
#pragma unroll
    for (int j = 0; j < HB; ++j) facc[j] = 0.0f;
  }

  auto issue = [&](int it) {
    const int tile = it / k_steps;
    issue_step<CT, BM>(smem + (it % STAGES) * L::STAGE, q, corpus, b0, b_pad,
                       row_base + (long long)tile * LANE, (it % k_steps) * C::KC, d);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) issue(s);
    cp_async_commit();
  }

  for (int it = 0; it < steps; ++it) {
    cp_async_wait<STAGES - 2>();  // this thread's copies for step `it` landed
    __syncthreads();              // everyone's did; step it-1's stage is free
    if (it + STAGES - 1 < steps) issue(it + STAGES - 1);
    cp_async_commit();

    unsigned char* stage = smem + (it % STAGES) * L::STAGE;
    if constexpr (MMA) {
      const __nv_bfloat16* qs = reinterpret_cast<const __nv_bfloat16*>(stage);
      const __nv_bfloat16* cs;
      if constexpr (sizeof(CT) == 1) {
        __nv_bfloat16* cb = reinterpret_cast<__nv_bfloat16*>(smem + L::CB_OFF);
        const int8_t* raw = reinterpret_cast<const int8_t*>(stage + L::Q_STAGE);
        for (int i = tid; i < LANE * (C::KC / 16); i += THREADS) {
          const int r = i / (C::KC / 16);
          const int c = (i % (C::KC / 16)) * 16;
          widen_int8x16(cb + r * C::KP + c, raw + r * C::KC + c);
        }
        __syncthreads();
        cs = cb;
      } else {
        cs = reinterpret_cast<const __nv_bfloat16*>(stage + L::Q_STAGE);
      }
#pragma unroll
      for (int kk = 0; kk < C::KC; kk += 16) {
        wmma::fragment<wmma::matrix_b, FM, FN, 16, __nv_bfloat16, wmma::col_major> bf;
        wmma::load_matrix_sync(bf, cs + warp * FN * C::KP + kk, C::KP);
#pragma unroll
        for (int m = 0; m < MF; ++m) {
          wmma::fragment<wmma::matrix_a, FM, FN, 16, __nv_bfloat16, wmma::row_major> af;
          wmma::load_matrix_sync(af, qs + m * FM * C::KP + kk, C::KP);
          wmma::mma_sync(acc[m], af, bf, acc[m]);
        }
      }
    } else {
      // thread (row = lane, query group) accumulates HB dot products
      const float* qs = reinterpret_cast<const float*>(stage);
      const float* cs = reinterpret_cast<const float*>(stage + L::Q_STAGE);
#pragma unroll
      for (int kk = 0; kk < C::KC; kk += 4) {
        const float4 c4 = *reinterpret_cast<const float4*>(cs + lane * C::KP + kk);
#pragma unroll
        for (int j = 0; j < HB; ++j) {
          const float4 q4 =
              *reinterpret_cast<const float4*>(qs + (group * HB + j) * C::KP + kk);
          facc[j] = fmaf(q4.x, c4.x, facc[j]);
          facc[j] = fmaf(q4.y, c4.y, facc[j]);
          facc[j] = fmaf(q4.z, c4.z, facc[j]);
          facc[j] = fmaf(q4.w, c4.w, facc[j]);
        }
      }
    }
    if ((it + 1) % k_steps != 0) continue;

    // a 128-row tile is scored: raw dot products to the score tile
    if constexpr (MMA) {
#pragma unroll
      for (int m = 0; m < MF; ++m) {
        wmma::store_matrix_sync(ss + m * FM * SP + warp * FN, acc[m], SP, wmma::mem_row_major);
        wmma::fill_fragment(acc[m], 0.0f);
      }
    } else {
#pragma unroll
      for (int j = 0; j < HB; ++j) {
        ss[(group * HB + j) * SP + lane] = facc[j];
        facc[j] = 0.0f;
      }
    }
    __syncthreads();
    // (the next tile's score store comes after at least one more barrier
    // at the top of the loop, which every thread reaches after this read)

    const int tile = it / k_steps;
    const int ri = tile % rows_per_lane;
    const long long row = row_base + (long long)tile * LANE + lane;
    const float bi = bias[row];
    const float sc = scale != nullptr ? scale[row] : 1.0f;
#pragma unroll
    for (int j = 0; j < HB; ++j) {
      float v = ss[(group * HB + j) * SP + lane];
      if (scale != nullptr) v = __fmul_rn(v, sc);
      v = __fadd_rn(__fmul_rn(alpha, v), bi);
      if (ri == 0) {
        best[j] = v; bidx[j] = 0; best2[j] = NEG_INF; bidx2[j] = 0;
      } else if (v > best[j]) {
        best2[j] = best[j]; bidx2[j] = bidx[j]; best[j] = v; bidx[j] = ri;
      } else if (v > best2[j]) {
        best2[j] = v; bidx2[j] = ri;
      }
    }
    if (ri != rows_per_lane - 1) continue;

    // the block is done: emit (K2) or fold into the running lists (K1)
    const int blk = blk_lo + tile / rows_per_lane;
    const long long n_base = (long long)blk * blk_n;
#pragma unroll
    for (int j = 0; j < HB; ++j) {
      const int b = b0 + group * HB + j;
      if (b >= b_pad) continue;
      const int g1 = (int)(n_base + bidx[j] * LANE + lane);
      const int g2 = (int)(n_base + bidx2[j] * LANE + lane);
      if constexpr (ACC) {
        // bubble-insert (best, g1) then (best2, g2) into the list, sorted
        // descending. best2 <= best, so nothing changes unless best beats
        // the last entry; then the list is read into registers with
        // independent loads, updated there and written back.
        if (!(best[j] > thr[j])) continue;
        float* ls = out_s + list_at(b);
        int32_t* li = out_i + list_at(b);
        float cs[T];
        int ci[T];
#pragma unroll
        for (int t = 0; t < T; ++t) {
          cs[t] = ls[t * LANE];
          ci[t] = li[t * LANE];
        }
        const float cand_v[2] = {best[j], best2[j]};
        const int cand_i[2] = {g1, g2};
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float v = cand_v[c];
          int gi = cand_i[c];
#pragma unroll
          for (int t = 0; t < T; ++t) {
            const bool swap = v > cs[t];
            const float tv = cs[t];
            const int ti = ci[t];
            cs[t] = swap ? v : tv;
            ci[t] = swap ? gi : ti;
            v = swap ? tv : v;
            gi = swap ? ti : gi;
          }
        }
#pragma unroll
        for (int t = 0; t < T; ++t) {
          ls[t * LANE] = cs[t];
          li[t * LANE] = ci[t];
        }
        thr[j] = cs[T - 1];
      } else if constexpr (GROUP) {
        merge_top2(r1[j], r2[j], i1[j], i2[j], best[j], best2[j], g1, g2);
        if (blk == blk_hi - 1) {
          const long long o = ((long long)b * gridDim.y + split) * 2 * LANE + lane;
          out_s[o] = r1[j];
          out_i[o] = i1[j];
          out_s[o + LANE] = r2[j];
          out_i[o + LANE] = i2[j];
        }
      } else {
        const long long o = (long long)b * n_blocks * 2 * LANE + (long long)blk * 2 * LANE + lane;
        out_s[o] = best[j];
        out_i[o] = g1;
        out_s[o + LANE] = best2[j];
        out_i[o + LANE] = g2;
      }
    }
  }
  cp_async_wait<0>();
}

template <typename CT, int BM, int T, bool GROUP>
int launch(const void* q, const void* corpus, const float* bias, const float* scale,
           float alpha, int b_pad, int d, int blk_n, int n_blocks, int blocks_per_split,
           int n_splits, float* out_s, int32_t* out_i, cudaStream_t stream) {
  if (d % Cfg<CT>::KC != 0 || blk_n % LANE != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = lane_topk_kernel<CT, BM, T, GROUP>;
  constexpr int bytes = Layout<CT, BM>::BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((b_pad + BM - 1) / BM, n_splits);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const typename Cfg<CT>::Q*>(q), static_cast<const CT*>(corpus), bias, scale,
      alpha, b_pad, d, blk_n, n_blocks, blocks_per_split, out_s, out_i);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int T, bool GROUP>
int dispatch(const void* q, const void* corpus, int dtype, const float* bias,
             const float* scale, float alpha, int b_pad, int d, int blk_n, int n_blocks,
             int blocks_per_split, int n_splits, float* out_s, int32_t* out_i, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float, BM, T, GROUP>(q, corpus, bias, scale, alpha, b_pad, d, blk_n,
                                         n_blocks, blocks_per_split, n_splits, out_s, out_i, s);
    case 1:
      return launch<__nv_bfloat16, BM, T, GROUP>(q, corpus, bias, scale, alpha, b_pad, d,
                                                 blk_n, n_blocks, blocks_per_split, n_splits,
                                                 out_s, out_i, s);
    case 2:
      return launch<int8_t, BM, T, GROUP>(q, corpus, bias, scale, alpha, b_pad, d, blk_n,
                                          n_blocks, blocks_per_split, n_splits, out_s, out_i, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// K6: K5 with the scoring and the selection on different warps.
// ---------------------------------------------------------------------------

constexpr int PIPE_BM = 32;
constexpr int PIPE_THREADS = 2 * THREADS;  // 8 MMA warps, then 8 selection warps
constexpr int BAR_RING = 1;                // MMA warps only: the copy ring
constexpr int BAR_FULL = 2;                // + parity: a score tile is written
constexpr int BAR_EMPTY = 4;               // + parity: a score tile was read

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Shared memory: the copy ring, two score tiles, the int8 widening buffer,
// then the running top-2 of every (query, lane): scores [2][BM][128], then
// indices [2][BM][128].
template <typename CT> struct PipeLayout {
  using L = Layout<CT, PIPE_BM>;
  static constexpr int S_OFF = STAGES * L::STAGE;
  static constexpr int S_BYTES = PIPE_BM * SP * 4;
  static constexpr int CB_OFF = S_OFF + 2 * S_BYTES;
  static constexpr int R_OFF = CB_OFF + Cfg<CT>::CB;
  static constexpr int BYTES = R_OFF + 4 * PIPE_BM * LANE * 4;
  static_assert(S_BYTES % 128 == 0 && CB_OFF % 128 == 0 && R_OFF % 128 == 0, "alignment");
};

// grid: x = query tile (32 rows of q), y = group (gsz blocks, gsz divides
// n_blocks). Tile t of the group is the t-th run of 128 corpus rows; the
// MMA warps write its scores to score tile t & 1 and the selection warps
// read it from there. Handoff: FULL[t & 1] (MMA arrive, selection sync)
// says tile t is written; EMPTY[t & 1] (selection arrive, MMA sync) says it
// was read, so tile t + 2 may overwrite it.
template <typename CT>
__global__ void __launch_bounds__(PIPE_THREADS, 1)
lane_topk_group_pipe_kernel(const typename Cfg<CT>::Q* __restrict__ q,
                            const CT* __restrict__ corpus, const float* __restrict__ bias,
                            float alpha, int b_pad, int d, int blk_n, int gsz,
                            float* __restrict__ out_s, int32_t* __restrict__ out_i) {
  constexpr int BM = PIPE_BM;
  using C = Cfg<CT>;
  using L = Layout<CT, BM>;
  using P = PipeLayout<CT>;
  constexpr bool MMA = sizeof(CT) != 4;
  constexpr int HB = BM / GROUPS;  // query rows per thread (selection and f32 dot)
  constexpr int FM = 16, FN = 16, MF = BM / FM;
  extern __shared__ __align__(128) unsigned char smem[];

  const int b0 = blockIdx.x * BM;
  const int grp = blockIdx.y;
  const int rows_per_lane = blk_n / LANE;
  const int k_steps = d / C::KC;
  const long long row_base = (long long)grp * gsz * blk_n;
  const int tiles = gsz * rows_per_lane;

  if (threadIdx.x < THREADS) {
    // ---- MMA warps: copy ring and scoring
    const int tid = threadIdx.x;
    const int lane = tid % LANE;
    const int group = tid / LANE;
    const int warp = tid / 32;
    const int steps = tiles * k_steps;
    using namespace nvcuda;
    wmma::fragment<wmma::accumulator, FM, FN, 16, float> acc[MMA ? MF : 1];
    float facc[MMA ? 1 : HB];
    if constexpr (MMA) {
#pragma unroll
      for (int m = 0; m < MF; ++m) wmma::fill_fragment(acc[m], 0.0f);
    } else {
#pragma unroll
      for (int j = 0; j < HB; ++j) facc[j] = 0.0f;
    }
    auto issue = [&](int it) {
      issue_step<CT, BM>(smem + (it % STAGES) * L::STAGE, q, corpus, b0, b_pad,
                         row_base + (long long)(it / k_steps) * LANE, (it % k_steps) * C::KC, d);
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < steps) issue(s);
      cp_async_commit();
    }
    for (int it = 0; it < steps; ++it) {
      cp_async_wait<STAGES - 2>();
      bar_sync(BAR_RING, THREADS);  // every MMA thread's copies landed; stage it-1 is free
      if (it + STAGES - 1 < steps) issue(it + STAGES - 1);
      cp_async_commit();

      unsigned char* stage = smem + (it % STAGES) * L::STAGE;
      if constexpr (MMA) {
        const __nv_bfloat16* qs = reinterpret_cast<const __nv_bfloat16*>(stage);
        const __nv_bfloat16* cs;
        if constexpr (sizeof(CT) == 1) {
          __nv_bfloat16* cb = reinterpret_cast<__nv_bfloat16*>(smem + P::CB_OFF);
          const int8_t* raw = reinterpret_cast<const int8_t*>(stage + L::Q_STAGE);
          for (int i = tid; i < LANE * (C::KC / 16); i += THREADS) {
            const int r = i / (C::KC / 16);
            const int c = (i % (C::KC / 16)) * 16;
            widen_int8x16(cb + r * C::KP + c, raw + r * C::KC + c);
          }
          bar_sync(BAR_RING, THREADS);
          cs = cb;
        } else {
          cs = reinterpret_cast<const __nv_bfloat16*>(stage + L::Q_STAGE);
        }
#pragma unroll
        for (int kk = 0; kk < C::KC; kk += 16) {
          wmma::fragment<wmma::matrix_b, FM, FN, 16, __nv_bfloat16, wmma::col_major> bf;
          wmma::load_matrix_sync(bf, cs + warp * FN * C::KP + kk, C::KP);
#pragma unroll
          for (int m = 0; m < MF; ++m) {
            wmma::fragment<wmma::matrix_a, FM, FN, 16, __nv_bfloat16, wmma::row_major> af;
            wmma::load_matrix_sync(af, qs + m * FM * C::KP + kk, C::KP);
            wmma::mma_sync(acc[m], af, bf, acc[m]);
          }
        }
      } else {
        const float* qs = reinterpret_cast<const float*>(stage);
        const float* cs = reinterpret_cast<const float*>(stage + L::Q_STAGE);
#pragma unroll
        for (int kk = 0; kk < C::KC; kk += 4) {
          const float4 c4 = *reinterpret_cast<const float4*>(cs + lane * C::KP + kk);
#pragma unroll
          for (int j = 0; j < HB; ++j) {
            const float4 q4 =
                *reinterpret_cast<const float4*>(qs + (group * HB + j) * C::KP + kk);
            facc[j] = fmaf(q4.x, c4.x, facc[j]);
            facc[j] = fmaf(q4.y, c4.y, facc[j]);
            facc[j] = fmaf(q4.z, c4.z, facc[j]);
            facc[j] = fmaf(q4.w, c4.w, facc[j]);
          }
        }
      }
      if ((it + 1) % k_steps != 0) continue;

      // tile t is scored: hand it to the selection warps
      const int t = it / k_steps;
      float* ss = reinterpret_cast<float*>(smem + P::S_OFF + (t & 1) * P::S_BYTES);
      if (t >= 2) bar_sync(BAR_EMPTY + (t & 1), PIPE_THREADS);
      if constexpr (MMA) {
#pragma unroll
        for (int m = 0; m < MF; ++m) {
          wmma::store_matrix_sync(ss + m * FM * SP + warp * FN, acc[m], SP, wmma::mem_row_major);
          wmma::fill_fragment(acc[m], 0.0f);
        }
      } else {
#pragma unroll
        for (int j = 0; j < HB; ++j) {
          ss[(group * HB + j) * SP + lane] = facc[j];
          facc[j] = 0.0f;
        }
      }
      __threadfence_block();  // the tile's stores before the handoff
      bar_arrive(BAR_FULL + (t & 1), PIPE_THREADS);
    }
    cp_async_wait<0>();
    return;
  }

  // ---- selection warps: thread (lane, half of the query tile)
  const int tid = threadIdx.x - THREADS;
  const int lane = tid % LANE;
  const int group = tid / LANE;
  float* rs = reinterpret_cast<float*>(smem + P::R_OFF);                    // [2][BM][128]
  int* ri = reinterpret_cast<int*>(smem + P::R_OFF + 2 * BM * LANE * 4);  // [2][BM][128]
  const auto at = [&](int slot, int j) { return (slot * BM + group * HB + j) * LANE + lane; };
#pragma unroll
  for (int j = 0; j < HB; ++j) {
    rs[at(0, j)] = NEG_INF;
    rs[at(1, j)] = NEG_INF;
    ri[at(0, j)] = 0;
    ri[at(1, j)] = 0;
  }
  float best[HB], best2[HB];
  int bidx[HB], bidx2[HB];
  for (int t = 0; t < tiles; ++t) {
    const int r = t % rows_per_lane;
    const float bi = bias[row_base + (long long)t * LANE + lane];
    const float* ss = reinterpret_cast<const float*>(smem + P::S_OFF + (t & 1) * P::S_BYTES);
    bar_sync(BAR_FULL + (t & 1), PIPE_THREADS);
#pragma unroll
    for (int j = 0; j < HB; ++j) {
      const float v = __fadd_rn(__fmul_rn(alpha, ss[(group * HB + j) * SP + lane]), bi);
      if (r == 0) {
        best[j] = v; bidx[j] = 0; best2[j] = NEG_INF; bidx2[j] = 0;
      } else if (v > best[j]) {
        best2[j] = best[j]; bidx2[j] = bidx[j]; best[j] = v; bidx[j] = r;
      } else if (v > best2[j]) {
        best2[j] = v; bidx2[j] = r;
      }
    }
    if (t + 2 < tiles) {
      __threadfence_block();  // the tile's reads before it may be overwritten
      bar_arrive(BAR_EMPTY + (t & 1), PIPE_THREADS);
    }
    if (r != rows_per_lane - 1) continue;

    // a block is done: fold its per-lane top-2 into the group's
    const long long n_base = row_base + (long long)(t / rows_per_lane) * blk_n;
    const bool last = t == tiles - 1;
#pragma unroll
    for (int j = 0; j < HB; ++j) {
      const int b = b0 + group * HB + j;
      if (b >= b_pad) continue;
      float r1 = rs[at(0, j)], r2 = rs[at(1, j)];
      int i1 = ri[at(0, j)], i2 = ri[at(1, j)];
      merge_top2(r1, r2, i1, i2, best[j], best2[j], (int)(n_base + bidx[j] * LANE + lane),
                 (int)(n_base + bidx2[j] * LANE + lane));
      if (last) {
        const long long o = ((long long)b * gridDim.y + grp) * 2 * LANE + lane;
        out_s[o] = r1;
        out_i[o] = i1;
        out_s[o + LANE] = r2;
        out_i[o + LANE] = i2;
      } else {
        rs[at(0, j)] = r1;
        rs[at(1, j)] = r2;
        ri[at(0, j)] = i1;
        ri[at(1, j)] = i2;
      }
    }
  }
}

template <typename CT>
int launch_pipe(const void* q, const void* corpus, const float* bias, float alpha, int b_pad,
                int d, int blk_n, int n_blocks, int gsz, float* out_s, int32_t* out_i,
                cudaStream_t stream) {
  if (d % Cfg<CT>::KC != 0 || blk_n % LANE != 0 || gsz < 1 || n_blocks % gsz != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = lane_topk_group_pipe_kernel<CT>;
  constexpr int bytes = PipeLayout<CT>::BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((b_pad + PIPE_BM - 1) / PIPE_BM, n_blocks / gsz);
  kernel<<<grid, PIPE_THREADS, bytes, stream>>>(
      static_cast<const typename Cfg<CT>::Q*>(q), static_cast<const CT*>(corpus), bias, alpha,
      b_pad, d, blk_n, gsz, out_s, out_i);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f32 corpora (q float32). scale may be null. tile_b: query rows per CTA,
// 8 (B_pad = 8) or 16; t_cands: 8 or 16. out_s/out_i: [b_pad, n_splits,
// t_cands, 128].
extern "C" int lane_topk_acc_f32(const void* q, const void* corpus, const float* bias,
                                 const float* scale, float alpha, int b_pad, int d, int blk_n,
                                 int n_blocks, int blocks_per_split, int n_splits, int tile_b,
                                 int t_cands, float* out_s, int32_t* out_i, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LANE_TOPK_ACC(BM, T)                                                                \
  if (tile_b == BM && t_cands == T)                                                          \
    return launch<float, BM, T, false>(q, corpus, bias, scale, alpha, b_pad, d, blk_n,       \
                                       n_blocks, blocks_per_split, n_splits, out_s, out_i, s);
  LANE_TOPK_ACC(8, 8)
  LANE_TOPK_ACC(8, 16)
  LANE_TOPK_ACC(16, 8)
  LANE_TOPK_ACC(16, 16)
#undef LANE_TOPK_ACC
  return static_cast<int>(cudaErrorInvalidValue);
}

// f32 corpora, 32 query rows per CTA. out_s/out_i: [b_pad, n_blocks * 256];
// block j's lane l top-1 at j*256 + l, top-2 at j*256 + 128 + l.
extern "C" int lane_topk_emit_f32(const void* q, const void* corpus, const float* bias,
                                  const float* scale, float alpha, int b_pad, int d, int blk_n,
                                  int n_blocks, int blocks_per_split, int n_splits,
                                  float* out_s, int32_t* out_i, void* stream) {
  return launch<float, 32, 0, false>(q, corpus, bias, scale, alpha, b_pad, d, blk_n, n_blocks,
                                     blocks_per_split, n_splits, out_s, out_i,
                                     static_cast<cudaStream_t>(stream));
}

// 32 query rows per CTA, one CTA per (query tile, group of gsz blocks; the
// last group may be shorter). scale may be null. out_s/out_i:
// [b_pad, n_groups * 256]; group g's lane l top-1 at g*256 + l, top-2 at
// g*256 + 128 + l.
extern "C" int lane_topk_group(const void* q, const void* corpus, int dtype, const float* bias,
                               const float* scale, float alpha, int b_pad, int d, int blk_n,
                               int n_blocks, int gsz, float* out_s, int32_t* out_i,
                               void* stream) {
  if (gsz < 1) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<32, 0, true>(q, corpus, dtype, bias, scale, alpha, b_pad, d, blk_n, n_blocks,
                               gsz, (n_blocks + gsz - 1) / gsz, out_s, out_i, stream);
}

// K5's candidates for gsz dividing n_blocks, no row scale; dtype as above.
extern "C" int lane_topk_group_pipe(const void* q, const void* corpus, int dtype,
                                    const float* bias, float alpha, int b_pad, int d, int blk_n,
                                    int n_blocks, int gsz, float* out_s, int32_t* out_i,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_pipe<float>(q, corpus, bias, alpha, b_pad, d, blk_n, n_blocks, gsz, out_s,
                                out_i, s);
    case 1:
      return launch_pipe<__nv_bfloat16>(q, corpus, bias, alpha, b_pad, d, blk_n, n_blocks, gsz,
                                        out_s, out_i, s);
    case 2:
      return launch_pipe<int8_t>(q, corpus, bias, alpha, b_pad, d, blk_n, n_blocks, gsz, out_s,
                                 out_i, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
