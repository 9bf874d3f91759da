// The flat lane top-k scan for Hopper (sm_90a), bf16 and int8 corpora: the
// port's K1 `lane_topk_acc` (lane_scan_acc.cu) and K2 `lane_topk_emit`
// (lane_scan_emit.cu), one kernel template. f32 corpora keep the FMA
// template of lane_topk.cu (TF32 would break their exactness).
//
// K1 replaces tostore_tpu/ops/topk.py::_lane_topk_kernel (called by
// fused_flat_topk); K2 replaces tostore_tpu/ops/topk.py::_lane_topk_block_kernel
// (called by _fused_block_emit). Both compute, for every corpus block of
// `blk_n` rows,
//
//     s[b, row] = alpha * (row_scale[row] * (q[b] . c[row])) + bias[row]
//
// with f32 accumulation, and each lane's top-2 within the block (lane = row
// % 128, ties to the lower row, as `v > best` in _block_lane_top2). K2
// writes every block's per-lane top-2 to [B_pad, n_blocks * 256]; K1 folds
// them into a running per-lane top-T with the reference's bubble insert,
// one set of lists per split of the block range (ops/topk.py merges the
// splits). Accumulators start at float32 min, and a lane that saw only dead
// rows reports row 0.
//
// What bounds them on an H100 SXM (3.35 TB/s HBM, 989 TFLOP/s dense bf16):
// at B <= 32 (K1) reading the corpus once, 1.61 GB at 1M x 768 bf16, about
// 0.48 ms; the dot products are far below the tensor cores' rate. K2 at
// B = 256 does 412 GFLOP, 0.42 ms at the dense rate, beside the same read:
// it sits on the ridge, so both the reads and the tensor cores matter. The
// design:
//   - Warp specialisation. A CTA has three warpgroups: two consumers and one
//     producer, whose one thread keeps TMA loads (cp.async.bulk.tensor) in
//     flight into a ring of 8 stages, each [128 corpus rows x 64 k] (16 KB
//     of bf16, SWIZZLE_128B) beside the query tile's same 64 k, with a
//     full and an empty mbarrier per stage. setmaxnreg moves registers
//     from the producer to the consumers at run time; ptxas still compiles
//     every path to the launch bound's 168 registers a thread, which K2's
//     64-query selection state fits.
//   - The corpus is wgmma's operand A and the queries operand B, both
//     K-major in shared memory as they lie in HBM, so nothing is
//     transposed. Consumer warpgroup w takes rows 64w..64w+63 of each
//     128-row tile, half the lanes, as m64nNk16 with N the query width:
//     K1 runs N = B_pad in {8, 16, 24, 32}, so one CTA serves every query
//     of a batch and the corpus is read once at B = 32; K2 runs N = 64.
//   - The query tile streams through the ring with the corpus (its 64-k
//     slice, NQ x 128 B from L2, beside each corpus tile), so one kernel
//     takes any depth D. A variant that kept the [NQ, D] tile resident in
//     shared memory measured the same on the card (K1 B = 32 and K2 B =
//     256 within 0.5%), so the simpler form stays.
//   - Every k-step is one wgmma commit group; the stage goes back to the
//     producer when the next step's wait_group 1 shows it done, so the
//     products of step s + 1 are issued before step s is waited for. The
//     selection of a tile does not overlap the products of the next one:
//     two accumulator sets that would allow it do not fit K2's 64-query
//     state in 168 registers (it spilled, and ran 4x slower on the card),
//     and K1 is bound by the corpus read, which the producer keeps going
//     while the consumers select.
//   - Selection on the accumulator registers. The m64nNk16 accumulator
//     keeps each thread on the same two rows (lanes) and N/4 queries from
//     tile to tile, so each thread applies scale, alpha and bias in
//     registers and keeps the block's top-2 of its N/2 (lane, query) pairs
//     there: scores never go through shared memory, and no __syncthreads
//     runs after the start. The two in-block row indices of a pair share
//     one register (16 bits each). The producer keeps loading while the
//     consumers select, which is what a memory-bound scan needs.
//   - K1's per-split lists sit in its output slice. A split of at most T/2
//     blocks (1M rows: 4 blocks per CTA) writes each block's pair into two
//     slots of its own, once, unsorted, in a list of 2 slots per block (half
//     the candidates of T = 16 slots for the final top-k); a longer split
//     keeps T slots sorted by the reference's bubble insert, touched only
//     when a block's candidate beats the list's last entry, which each
//     thread keeps in a register. (Read back and rewritten at every block
//     end, the lists cost 0.6 GB of HBM traffic at B = 32, more than L2
//     holds.)
//   - Persistent CTAs: one CTA per SM (the ring takes 136-192 KB of shared
//     memory), each walking a contiguous range of blocks, in ascending row
//     order as the tie rule needs. K2's query tiles of one range are
//     adjacent in the launch order and meet the same rows in L2.
//   - int8 rows arrive raw by TMA (8 KB a stage); each consumer warpgroup
//     widens its 64 rows exactly to bf16 into a double-buffered tile in
//     the 128-byte swizzle, then runs the same wgmma.
// The mbarrier, TMA, wgmma and widening helpers are hopper.cuh's, shared
// with the IVF kernels of ivf_probe.cu.

#pragma once

#include <cfloat>
#include <cstdint>

#include "hopper.cuh"

namespace lane_scan {

using namespace hopper;

constexpr int LANE = 128;
constexpr int KT = 64;          // depth columns per stage: 128 bytes of bf16
constexpr int STAGES = 8;
constexpr int CONSUMERS = 2;    // warpgroups: rows 0-63 and 64-127 of a tile
constexpr int THREADS = 128 * (CONSUMERS + 1);  // and one producer warpgroup
constexpr float NEG_INF = -FLT_MAX;  // float32 min, as runtime.NEG_INF

// Shared memory: STAGES x [corpus tile | query k-slice], each 1024-aligned
// for the 128-byte swizzle; int8 only: the widened tiles [warpgroup][2] of
// 64 x 64 bf16; then the full and empty barriers.
template <bool I8, int NQ> struct Smem {
  static constexpr int C_BYTES = LANE * KT * (I8 ? 1 : 2);
  static constexpr int Q_BYTES = NQ * KT * 2;
  static constexpr int STAGE = C_BYTES + Q_BYTES;
  static constexpr int W_TILE = 64 * KT * 2;
  static constexpr int W_OFF = STAGES * STAGE;
  static constexpr int BAR_OFF = W_OFF + (I8 ? CONSUMERS * 2 * W_TILE : 0);
  static constexpr int BYTES = BAR_OFF + 2 * STAGES * 8 + 1024;  // + alignment slack
  static_assert(Q_BYTES % 1024 == 0 && C_BYTES % 1024 == 0, "swizzle atoms");
  static_assert(BYTES <= 232448, "shared memory");
};

// grid: x = query tile (NQ queries), y = split (a contiguous range of
// blocks). T > 0: K1, a per-lane top-T per split, out laid out
// [b_pad][split][W][128] with W = 2 * blocks_per_split where that is at
// most T (every block's pair in its own two slots), else W = T (the
// reference's sorted bubble insert); T == 0: K2, every block's per-lane top-2, out
// [b_pad][n_blocks * 256] (block j's lane l top-1 at j*256 + l, top-2 at
// j*256 + 128 + l). Queries at or past b_pad are scored and not written.
template <bool I8, int NQ, int T>
__global__ void __launch_bounds__(THREADS, 1)
lane_scan_kernel(const __grid_constant__ CUtensorMap cmap,
                 const __grid_constant__ CUtensorMap qmap, const float* __restrict__ bias,
                 const float* __restrict__ scale, float alpha, int b_pad, int d, int blk_n,
                 int n_blocks, int blocks_per_split, float* __restrict__ out_s,
                 int32_t* __restrict__ out_i) {
  constexpr bool ACC = T > 0;
  using S = Smem<I8, NQ>;
  constexpr int R = NQ / 2;  // accumulator elements (lane, query pairs) per thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  uint64_t* empty = full + STAGES;

  const int qt = blockIdx.x;
  const int split = blockIdx.y;
  const int blk_lo = split * blocks_per_split;
  const int blk_hi = min(n_blocks, blk_lo + blocks_per_split);
  const int rows_per_lane = blk_n / LANE;
  const int k_steps = d / KT;
  const int tiles = max(0, blk_hi - blk_lo) * rows_per_lane;
  const long long row_base = static_cast<long long>(blk_lo) * blk_n;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // ---- producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == CONSUMERS * 128) {
      int it = 0;
      for (int tile = 0; tile < tiles; ++tile) {
        const int row = static_cast<int>(row_base + static_cast<long long>(tile) * LANE);
        for (int ks = 0; ks < k_steps; ++ks, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) + 1) & 1);
          unsigned char* st = smem + s * S::STAGE;
          mbar_expect_tx(&full[s], S::STAGE);
          tma_load_2d(st, &cmap, &full[s], ks * KT, row);
          tma_load_2d(st + S::C_BYTES, &qmap, &full[s], ks * KT, qt * NQ);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg scores rows 64wg..64wg+63 of every tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int t = threadIdx.x % 128;
    const int l = t % 32;
    // element i of the accumulator: row (lane) lane0 + 8 * ((i >> 1) & 1),
    // query b0 + c0 + 8 * (i >> 2) + (i & 1)
    const int lane0 = 64 * wg + 16 * (t / 32) + l / 4;
    const int c0 = 2 * (l % 4);
    const int b0 = qt * NQ;
    const auto query = [&](int i) { return b0 + c0 + 8 * (i >> 2) + (i & 1); };
    const auto lane_of = [&](int i) { return lane0 + 8 * ((i >> 1) & 1); };
    // K1: a split of at most T/2 blocks keeps every block's pair, each in
    // its own two slots of a list of W = 2 * blocks_per_split (unsorted:
    // the wrapper's top-k needs no order), so no list is read back; longer
    // splits run the reference's bubble insert into W = T slots
    const bool direct = 2 * blocks_per_split <= T;
    const int list_w = direct ? 2 * blocks_per_split : T;
    // entry tt of (query b, lane): ((b * n_splits + split) * W + tt) * 128 + lane
    const auto list_at = [&](int b, int lane) {
      return ((static_cast<long long>(b) * gridDim.y + split) * list_w) * LANE + lane;
    };

    float best[R], best2[R];
    uint32_t bidx[R];  // in-block rows: the top's in the low 16 bits, the second's high
    float thr[ACC ? R : 1];
    if constexpr (ACC) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        thr[i] = NEG_INF;
        const int b = query(i);
        if (b < b_pad)
          for (int tt = direct ? 2 * (blk_hi - blk_lo) : 0; tt < list_w; ++tt) {
            out_s[list_at(b, lane_of(i)) + tt * LANE] = NEG_INF;
            out_i[list_at(b, lane_of(i)) + tt * LANE] = 0;
          }
      }
    }

    // fold one scored tile (v: its products) into each pair's block top-2;
    // at a block's last tile, emit (K2) or fold into the lists (K1)
    const auto select = [&](const float (&v)[R], int tile, float bi0, float bi1, float sc0,
                            float sc1) {
      const int ri = tile % rows_per_lane;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const bool hi = (i >> 1) & 1;
        float x = v[i];
        if (scale != nullptr) x = __fmul_rn(x, hi ? sc1 : sc0);
        x = __fadd_rn(__fmul_rn(alpha, x), hi ? bi1 : bi0);
        if (ri == 0) {
          best[i] = x;
          best2[i] = NEG_INF;
          bidx[i] = 0;
        } else if (x > best[i]) {
          best2[i] = best[i];
          best[i] = x;
          bidx[i] = (bidx[i] << 16) | static_cast<uint32_t>(ri);
        } else if (x > best2[i]) {
          best2[i] = x;
          bidx[i] = (bidx[i] & 0xFFFFu) | (static_cast<uint32_t>(ri) << 16);
        }
      }
      if (ri != rows_per_lane - 1) return;

      const int blk = blk_lo + tile / rows_per_lane;
      const long long n_base = static_cast<long long>(blk) * blk_n;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int b = query(i);
        if (b >= b_pad) continue;
        const int lane = lane_of(i);
        const int g1 = static_cast<int>(n_base + (bidx[i] & 0xFFFFu) * LANE + lane);
        const int g2 = static_cast<int>(n_base + (bidx[i] >> 16) * LANE + lane);
        if constexpr (ACC) {
          float* ls = out_s + list_at(b, lane);
          int32_t* li = out_i + list_at(b, lane);
          if (direct) {
            const int slot = 2 * (blk - blk_lo) * LANE;
            ls[slot] = best[i];
            li[slot] = g1;
            ls[slot + LANE] = best2[i];
            li[slot + LANE] = g2;
            continue;
          }
          // bubble-insert (best, g1) then (best2, g2) into the list, sorted
          // descending; best2 <= best, so nothing changes unless best beats
          // the last entry
          if (!(best[i] > thr[i])) continue;
          float cs[T];
          int ci[T];
#pragma unroll
          for (int tt = 0; tt < T; ++tt) {
            cs[tt] = ls[tt * LANE];
            ci[tt] = li[tt * LANE];
          }
          const float cand_v[2] = {best[i], best2[i]};
          const int cand_i[2] = {g1, g2};
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float x = cand_v[c];
            int gi = cand_i[c];
#pragma unroll
            for (int tt = 0; tt < T; ++tt) {
              const bool swap = x > cs[tt];
              const float tv = cs[tt];
              const int ti = ci[tt];
              cs[tt] = swap ? x : tv;
              ci[tt] = swap ? gi : ti;
              x = swap ? tv : x;
              gi = swap ? ti : gi;
            }
          }
#pragma unroll
          for (int tt = 0; tt < T; ++tt) {
            ls[tt * LANE] = cs[tt];
            li[tt * LANE] = ci[tt];
          }
          thr[i] = cs[T - 1];
        } else {
          const long long o = static_cast<long long>(b) * n_blocks * 2 * LANE +
                              static_cast<long long>(blk) * 2 * LANE + lane;
          out_s[o] = best[i];
          out_i[o] = g1;
          out_s[o + LANE] = best2[i];
          out_i[o + LANE] = g2;
        }
      }
    };

    // Every k-step is one wgmma commit group; groups complete in order.
    // After committing step it, wait_group 1 means step it - 1 is done: its
    // stage goes back to the producer.
    float acc[R];
    int it = 0;
    for (int tile = 0; tile < tiles; ++tile) {
      const long long row0 = row_base + static_cast<long long>(tile) * LANE;
      // this tile's bias and scale, loaded while the products run
      const float bi0 = bias[row0 + lane0];
      const float bi1 = bias[row0 + lane0 + 8];
      float sc0 = 1.0f, sc1 = 1.0f;
      if (scale != nullptr) {
        sc0 = scale[row0 + lane0];
        sc1 = scale[row0 + lane0 + 8];
      }
      for (int ks = 0; ks < k_steps; ++ks, ++it) {
        const int s = it % STAGES;
        mbar_wait(&full[s], (it / STAGES) & 1);
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
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          bar_sync(1 + wg, 128);
          a_tile = w;
        } else {
          a_tile = st + wg * 64 * 128;
        }
        const uint64_t da = sw128_desc(a_tile);
        const uint64_t db = sw128_desc(st + S::C_BYTES);
        fence_regs(acc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk)
          Wgmma<NQ>::mma(acc, da + 2 * kk, db + 2 * kk, (ks > 0 || kk > 0) ? 1 : 0);
        wg_commit();
        fence_regs(acc);
        if (ks > 0) {
          wg_wait<1>();
          fence_regs(acc);
          if (l == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
        }
      }
      wg_wait<0>();
      fence_regs(acc);
      if (l == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
      select(acc, tile, bi0, bi1, sc0, sc1);
    }
  }
}

// q: [q_rows, d] bf16 (q_rows a multiple of NQ); corpus: [n_rows, d] bf16 or
// int8; grid (q_rows / NQ, n_splits).
template <bool I8, int NQ, int T>
int launch_scan(const void* q, const void* corpus, const float* bias, const float* scale,
                float alpha, int q_rows, int b_pad, int d, int n_rows, int blk_n, int n_blocks,
                int blocks_per_split, int n_splits, float* out_s, int32_t* out_i,
                cudaStream_t stream) {
  if (d % KT != 0 || blk_n % LANE != 0 || blk_n / LANE > 0xFFFF || q_rows % NQ != 0 ||
      b_pad > q_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap cmap, qmap;
  int err = make_map(&cmap, corpus,
                     I8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                     I8 ? 1 : 2, n_rows, d, LANE, KT,
                     I8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  err = make_map(&qmap, q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, q_rows, d, NQ, KT,
                 CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  auto kernel = lane_scan_kernel<I8, NQ, T>;
  constexpr int bytes = Smem<I8, NQ>::BYTES;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(q_rows / NQ, n_splits);
  kernel<<<grid, THREADS, bytes, stream>>>(cmap, qmap, bias, scale, alpha, b_pad, d, blk_n,
                                           n_blocks, blocks_per_split, out_s, out_i);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lane_scan
