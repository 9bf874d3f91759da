// The grouped lane top-2 scans for Hopper (sm_90a), bf16 and int8 corpora:
// the port's K5 `lane_topk_group` and K6 `lane_topk_group_pipe`, one kernel
// template of the lane_scan.cuh family. f32 corpora keep the FMA kernels of
// lane_topk.cu (TF32 would break their exactness).
//
// K5 replaces tostore_tpu/ops/topk.py::_lane_topk_group_kernel (called by
// _fused_group_emit); K6 replaces experiments/_exp_pipe.py::_pipe_kernel
// (called by pipe_topk). Both compute, for every group of `gsz` consecutive
// corpus blocks of `blk_n` rows and every lane (row % 128), the top-2 of
//
//     s[b, row] = alpha * (row_scale[row] * (q[b] . c[row])) + bias[row]
//
// as the reference finds it: each block's per-lane top-2 (`v > best`, ties
// to the lower row), folded block by block, in ascending order, into a
// running pair that starts at (float32 min, row 0) with the reference's
// sorted 4-way merge (tostore_tpu/ops/topk.py:403-421). The output is one
// [B_pad, 256] tile per group, the lanes' tops, then their seconds; the
// last group may hold fewer blocks (K5).
//
// What bounds them on an H100 SXM (3.35 TB/s HBM, 989 TFLOP/s dense bf16):
// the corpus read once, 1.61 GB at 1M x 768 bf16 (0.48 ms), beside 412
// GFLOP at B = 256 (0.42 ms): the ridge, as K2. A group is serial along its
// blocks, and 1M rows at gsz 32 make 16 groups, so whole groups cannot fill
// 132 SMs. The design:
//   - A group is split by lanes, not by blocks: a CTA takes rows 64h ..
//     64h + 63 of every 128-row tile of its group (lane half h), for one
//     tile of NQ = 32 or 64 queries, and walks the group's blocks in
//     ascending order, so its candidates, ties included, are the
//     reference's. The grid is groups x 2 halves x query tiles CTAs (128 at
//     1M rows for B = 256 with NQ = 64 and for B = 128 with NQ = 32); the
//     CTAs of one group are adjacent in the launch order and meet the same
//     rows in L2.
//   - Scoring as K2's: one producer thread keeps TMA loads in flight into
//     a ring of 8 stages, each [64 corpus rows x 64 k] (SWIZZLE_128B)
//     beside the query tile's same 64 k, with a full and an empty mbarrier
//     per stage; one consumer warpgroup runs wgmma m64nNQk16 with the corpus
//     as operand A and the queries as operand B, every k-step one commit
//     group. A CTA has 256 threads (the consumer warpgroup and the
//     producer's), so ptxas may give a thread up to 255 registers.
//   - Selection on the accumulator registers, as K2's: scale, alpha and
//     bias applied in registers, the block's (best, second, packed rows) of
//     a thread's NQ/2 (lane, query) pairs kept there.
//   - The running pair of every (lane, query) sits in shared memory (16
//     bytes a pair, 64 KB at NQ = 64), each thread its own entries, touched
//     once a block: four more registers a pair would not fit beside the
//     NQ = 64 selection state.
//   - K6 keeps two accumulator sets and folds the scores of tile t in four
//     slices between the first four k-steps of tile t + 1, whose wgmmas are
//     then in flight (at a depth under four k-steps, 256 columns, it runs
//     K5's order): the question of the TPU experiment (does overlapping
//     the selection with the products pay?) asked of this card. Its
//     arithmetic and order are K5's, so its candidates equal K5's bit for
//     bit.
//   - int8 rows arrive raw by TMA (4 KB a stage) and the consumers widen
//     them exactly to bf16 into a double-buffered tile in the 128-byte
//     swizzle, as lane_scan.cuh does. A stuck mbarrier traps (hopper.cuh).

#include "lane_scan.cuh"

namespace lane_group {

using namespace hopper;
using lane_scan::KT;
using lane_scan::LANE;
using lane_scan::NEG_INF;
using lane_scan::STAGES;

constexpr int HALF = 64;      // corpus rows (lanes) of a tile that one CTA takes
constexpr int THREADS = 256;  // the consumer warpgroup, then the producer's
constexpr int SLICES = 4;     // K6: parts of a tile's selection, one per k-step

// Shared memory: STAGES x [corpus half tile | query k-slice], each
// 1024-aligned for the 128-byte swizzle; int8 only: two widened tiles of
// 64 x 64 bf16; the running pairs, [4][NQ / 2][128] words (top score,
// second score, top row, second row; element i of thread t at i * 128 + t);
// then the full and empty barriers.
template <bool I8, int NQ> struct Smem {
  static constexpr int C_BYTES = HALF * KT * (I8 ? 1 : 2);
  static constexpr int Q_BYTES = NQ * KT * 2;
  static constexpr int STAGE = C_BYTES + Q_BYTES;
  static constexpr int W_TILE = HALF * KT * 2;
  static constexpr int W_OFF = STAGES * STAGE;
  static constexpr int RUN_OFF = W_OFF + (I8 ? 2 * W_TILE : 0);
  static constexpr int RUN_WORDS = (NQ / 2) * 128;
  static constexpr int BAR_OFF = RUN_OFF + 4 * RUN_WORDS * 4;
  static constexpr int BYTES = BAR_OFF + 2 * STAGES * 8 + 1024;  // + alignment slack
  static_assert(Q_BYTES % 1024 == 0 && C_BYTES % 1024 == 0, "swizzle atoms");
  static_assert(BYTES <= 232448, "shared memory");
};

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

// What a consumer thread knows for the whole kernel.
struct Env {
  unsigned char* smem;
  uint64_t* full;
  uint64_t* empty;
  const float* bias;
  const float* scale;
  float alpha;
  int t, l;            // thread of the warpgroup, lane of the warp
  int lane0;           // accumulator element i: lane lane0 + 8 * ((i >> 1) & 1)
  int q0;              // and query q0 + 8 * (i >> 2) + (i & 1)
  int b_pad, k_steps, rows_per_lane, blk_n;
  int group_row;       // the group's first corpus row
  float* rs1;          // running pairs in shared memory
  float* rs2;
  int* ri1;
  int* ri2;
};

// One 128-row tile of the group: its row within the block, the block's
// first corpus row, the thread's two rows' bias and scale.
struct Tile {
  int ri, n_base;
  float bi0, bi1, sc0, sc1;
};

template <int R> struct Pairs {
  float best[R], best2[R];
  uint32_t bidx[R];  // in-block rows: the top's in the low 16 bits, the second's high
};

__device__ __forceinline__ Tile load_tile(const Env& e, int tile) {
  Tile c;
  c.ri = tile % e.rows_per_lane;
  c.n_base = e.group_row + (tile / e.rows_per_lane) * e.blk_n;
  const long long row = static_cast<long long>(e.group_row) + tile * LANE + e.lane0;
  c.bi0 = e.bias[row];
  c.bi1 = e.bias[row + 8];
  c.sc0 = 1.0f;
  c.sc1 = 1.0f;
  if (e.scale != nullptr) {
    c.sc0 = e.scale[row];
    c.sc1 = e.scale[row + 8];
  }
  return c;
}

// A block's pairs start at (float32 min, float32 min, rows 0 and 0): the
// first row's score then enters as the reference's `v > best` sweep has it.
template <int R> __device__ __forceinline__ void reset_pairs(Pairs<R>& p) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    p.best[i] = NEG_INF;
    p.best2[i] = NEG_INF;
    p.bidx[i] = 0;
  }
}

// Fold elements [LO, HI) of a scored tile (v: its products) into each
// pair's block top-2. Selects only, no branch: K6 runs it while wgmmas are
// in flight. Without row scales sc0 = sc1 = 1, an exact product.
template <int R, int LO, int HI>
__device__ __forceinline__ void fold_tile(Pairs<R>& p, const float (&v)[R], const Tile& c,
                                          float alpha) {
  const uint32_t ri = static_cast<uint32_t>(c.ri);
#pragma unroll
  for (int i = LO; i < HI; ++i) {
    const bool hi = (i >> 1) & 1;
    const float x = __fadd_rn(__fmul_rn(alpha, __fmul_rn(v[i], hi ? c.sc1 : c.sc0)),
                              hi ? c.bi1 : c.bi0);
    const bool top = x > p.best[i];
    const bool second = x > p.best2[i];
    const uint32_t idx = p.bidx[i];
    p.best2[i] = top ? p.best[i] : (second ? x : p.best2[i]);
    p.bidx[i] = top ? ((idx << 16) | ri) : (second ? ((idx & 0xFFFFu) | (ri << 16)) : idx);
    p.best[i] = top ? x : p.best[i];
  }
}

// A block is done: fold its per-lane top-2 into the group's running pair
// and start the next block's pairs.
template <int R>
__device__ __forceinline__ void fold_block(Pairs<R>& p, const Tile& c, const Env& e) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int lane = e.lane0 + 8 * ((i >> 1) & 1);
    const int g1 = c.n_base + static_cast<int>(p.bidx[i] & 0xFFFFu) * LANE + lane;
    const int g2 = c.n_base + static_cast<int>(p.bidx[i] >> 16) * LANE + lane;
    const int o = i * 128 + e.t;
    float r1 = e.rs1[o], r2 = e.rs2[o];
    int i1 = e.ri1[o], i2 = e.ri2[o];
    merge_top2(r1, r2, i1, i2, p.best[i], p.best2[i], g1, g2);
    e.rs1[o] = r1;
    e.rs2[o] = r2;
    e.ri1[o] = i1;
    e.ri2[o] = i2;
  }
  reset_pairs(p);
}

// The group is done: the thread's running pairs go to the group's [256]
// tile of each of its queries, out_s / out_i at query 0's.
template <int R>
__device__ __forceinline__ void write_group(const Env& e, float* out_s, int32_t* out_i,
                                            long long out_stride) {
#pragma unroll 1
  for (int i = 0; i < R; ++i) {
    const int b = e.q0 + 8 * (i >> 2) + (i & 1);
    if (b >= e.b_pad) continue;
    const int o = i * 128 + e.t;
    const long long at = b * out_stride + e.lane0 + 8 * ((i >> 1) & 1);
    out_s[at] = e.rs1[o];
    out_i[at] = e.ri1[o];
    out_s[at + LANE] = e.rs2[o];
    out_i[at + LANE] = e.ri2[o];
  }
}

// Ring step `it`: wait for its stage, start its four wgmmas into acc as one
// commit group (`first`: the tile's first step, which overwrites acc).
template <bool I8, int NQ>
__device__ __forceinline__ void mma_step(const Env& e, float (&acc)[NQ / 2], int it,
                                           bool first) {
  using S = Smem<I8, NQ>;
  const int s = it % STAGES;
  mbar_wait(&e.full[s], (it / STAGES) & 1);
  unsigned char* st = e.smem + s * S::STAGE;
  const unsigned char* a_tile = st;
  if constexpr (I8) {
    // the wgmma that last read this buffer (step it - 2) is done
    unsigned char* w = e.smem + S::W_OFF + (it & 1) * S::W_TILE;
#pragma unroll
    for (int c = e.t; c < HALF * 8; c += 128) {
      const int r = c / 8, ch = c % 8;
      widen8(w + r * 128 + ((ch ^ (r & 7)) * 16), st + r * KT + ch * 8);
    }
    fence_async_shared();
    bar_sync(1, 128);
    a_tile = w;
  }
  const uint64_t da = sw128_desc(a_tile);
  const uint64_t db = sw128_desc(st + S::C_BYTES);
  fence_regs(acc);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk)
    Wgmma<NQ>::mma(acc, da + 2 * kk, db + 2 * kk, (!first || kk > 0) ? 1 : 0);
  wg_commit();
  fence_regs(acc);
}

// After step `it` was committed: step it - 1 is done, its stage goes back
// to the producer.
template <int R> __device__ __forceinline__ void retire_prev(const Env& e, float (&acc)[R], int it) {
  wg_wait<1>();
  fence_regs(acc);
  if (e.l == 0) mbar_arrive(&e.empty[(it - 1) % STAGES]);
}

// The tile's last step is done: every wgmma is, and its stage goes back.
template <int R> __device__ __forceinline__ void retire_all(const Env& e, float (&acc)[R], int it) {
  wg_wait<0>();
  fence_regs(acc);
  if (e.l == 0) mbar_arrive(&e.empty[(it - 1) % STAGES]);
}

// All k-steps of one tile's products into acc, nothing overlapped.
template <bool I8, int NQ>
__device__ __forceinline__ void mma_tile(const Env& e, float (&acc)[NQ / 2], int& it) {
  for (int ks = 0; ks < e.k_steps; ++ks, ++it) {
    mma_step<I8, NQ>(e, acc, it, ks == 0);
    if (ks > 0) retire_prev(e, acc, it);
  }
  retire_all(e, acc, it);
}

// K6, one turn (k_steps >= SLICES): the products of tile `tile` go into
// `cur` while the scores of tile - 1, complete in `prev`, are folded in
// SLICES parts, one after each of the first k-steps' wgmmas is started, with
// no branch between a step's start and its retire. `it` is the ring position,
// `pc` the previous tile.
template <bool I8, int NQ>
__device__ __forceinline__ void pipe_turn(const Env& e, Pairs<NQ / 2>& p, float (&cur)[NQ / 2],
                                          float (&prev)[NQ / 2], int tile, int& it, Tile& pc) {
  constexpr int R = NQ / 2;
  static_assert(SLICES == 4, "one step below per slice");
  const Tile cc = load_tile(e, tile);
  mma_step<I8, NQ>(e, cur, it, true);
  fold_tile<R, 0, R / 4>(p, prev, pc, e.alpha);
  ++it;
  mma_step<I8, NQ>(e, cur, it, false);
  fold_tile<R, R / 4, R / 2>(p, prev, pc, e.alpha);
  retire_prev(e, cur, it);
  ++it;
  mma_step<I8, NQ>(e, cur, it, false);
  fold_tile<R, R / 2, 3 * R / 4>(p, prev, pc, e.alpha);
  retire_prev(e, cur, it);
  ++it;
  mma_step<I8, NQ>(e, cur, it, false);
  fold_tile<R, 3 * R / 4, R>(p, prev, pc, e.alpha);
  retire_prev(e, cur, it);
  ++it;
  for (int ks = SLICES; ks < e.k_steps; ++ks, ++it) {
    mma_step<I8, NQ>(e, cur, it, false);
    retire_prev(e, cur, it);
  }
  retire_all(e, cur, it);
  if (pc.ri == e.rows_per_lane - 1) fold_block(p, pc, e);
  pc = cc;
}

// grid: x = (group * 2 + lane half) * q_tiles + query tile. out:
// [b_pad][n_groups * 256], group g's lane l top-1 at g*256 + l, top-2 at
// g*256 + 128 + l. Queries at or past b_pad are scored and not written.
template <bool I8, int NQ, bool PIPE>
__global__ void __launch_bounds__(THREADS, 1)
lane_scan_group_kernel(const __grid_constant__ CUtensorMap cmap,
                       const __grid_constant__ CUtensorMap qmap, const float* __restrict__ bias,
                       const float* __restrict__ scale, float alpha, int b_pad, int d, int blk_n,
                       int n_blocks, int gsz, int q_tiles, float* __restrict__ out_s,
                       int32_t* __restrict__ out_i) {
  using S = Smem<I8, NQ>;
  constexpr int R = NQ / 2;  // accumulator elements (lane, query pairs) per thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  uint64_t* empty = full + STAGES;

  const int qt = blockIdx.x % q_tiles;
  const int half = (blockIdx.x / q_tiles) & 1;
  const int grp = blockIdx.x / (2 * q_tiles);
  const int n_groups = gridDim.x / (2 * q_tiles);
  const int blk_lo = grp * gsz;
  const int blk_hi = min(n_blocks, blk_lo + gsz);
  const int rows_per_lane = blk_n / LANE;
  const int k_steps = d / KT;
  const int tiles = (blk_hi - blk_lo) * rows_per_lane;
  const int group_row = blk_lo * blk_n;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // lane 0 of every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer: one thread keeps the ring full
    if (threadIdx.x != 128) return;
    int it = 0;
    for (int tile = 0; tile < tiles; ++tile) {
      const int row = group_row + tile * LANE + half * HALF;
      for (int ks = 0; ks < k_steps; ++ks, ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) + 1) & 1);
        unsigned char* st = smem + s * S::STAGE;
        mbar_expect_tx(&full[s], S::STAGE);
        tma_load_2d(st, &cmap, &full[s], ks * KT, row);
        tma_load_2d(st + S::C_BYTES, &qmap, &full[s], ks * KT, qt * NQ);
      }
    }
    return;
  }

  // ---- consumers: one warpgroup scores rows 64 half .. 64 half + 63 of every tile
  Env e;
  e.smem = smem;
  e.full = full;
  e.empty = empty;
  e.bias = bias;
  e.scale = scale;
  e.alpha = alpha;
  e.t = threadIdx.x;
  e.l = e.t % 32;
  e.lane0 = HALF * half + 16 * (e.t / 32) + e.l / 4;
  e.q0 = qt * NQ + 2 * (e.l % 4);
  e.b_pad = b_pad;
  e.k_steps = k_steps;
  e.rows_per_lane = rows_per_lane;
  e.blk_n = blk_n;
  e.group_row = group_row;
  e.rs1 = reinterpret_cast<float*>(smem + S::RUN_OFF);
  e.rs2 = e.rs1 + S::RUN_WORDS;
  e.ri1 = reinterpret_cast<int*>(e.rs2 + S::RUN_WORDS);
  e.ri2 = e.ri1 + S::RUN_WORDS;
  // the running pairs start at (float32 min, row 0), as the reference's
  // scratch does, so a lane that only saw dead rows reports row 0
#pragma unroll
  for (int i = 0; i < R; ++i) {
    e.rs1[i * 128 + e.t] = NEG_INF;
    e.rs2[i * 128 + e.t] = NEG_INF;
    e.ri1[i * 128 + e.t] = 0;
    e.ri2[i * 128 + e.t] = 0;
  }

  Pairs<R> p;
  reset_pairs(p);
  int it = 0;
  if (PIPE && k_steps >= SLICES) {
    // tile 0's products; then tile t's products with tile t - 1's selection
    // between them, the accumulator sets taking turns; then the last fold
    float acc0[R], acc1[R];
    Tile pc = load_tile(e, 0);
    mma_tile<I8, NQ>(e, acc0, it);
    for (int tile = 1; tile < tiles; tile += 2) {
      pipe_turn<I8, NQ>(e, p, acc1, acc0, tile, it, pc);
      if (tile + 1 < tiles) pipe_turn<I8, NQ>(e, p, acc0, acc1, tile + 1, it, pc);
    }
    if ((tiles - 1) & 1) {
      fold_tile<R, 0, R>(p, acc1, pc, alpha);
    } else {
      fold_tile<R, 0, R>(p, acc0, pc, alpha);
    }
    fold_block(p, pc, e);
  } else {
    // K5, and K6 at a depth of fewer k-steps than selection slices
    float acc[R];
    for (int tile = 0; tile < tiles; ++tile) {
      const Tile c = load_tile(e, tile);  // bias and scale, loaded while the products run
      mma_tile<I8, NQ>(e, acc, it);
      fold_tile<R, 0, R>(p, acc, c, alpha);
      if (c.ri == rows_per_lane - 1) fold_block(p, c, e);
    }
  }
  write_group<R>(e, out_s + static_cast<long long>(grp) * 2 * LANE,
                 out_i + static_cast<long long>(grp) * 2 * LANE,
                 static_cast<long long>(n_groups) * 2 * LANE);
}

// q: [q_rows, d] bf16 (q_rows a multiple of NQ); corpus: [n_rows, d] bf16 or
// int8; grid n_groups * 2 * (q_rows / NQ).
template <bool I8, int NQ, bool PIPE>
int launch_group(const void* q, const void* corpus, const float* bias, const float* scale,
                 float alpha, int q_rows, int b_pad, int d, int n_rows, int blk_n, int n_blocks,
                 int gsz, float* out_s, int32_t* out_i, cudaStream_t stream) {
  if (d % KT != 0 || blk_n % LANE != 0 || blk_n / LANE > 0xFFFF || q_rows % NQ != 0 ||
      b_pad > q_rows || gsz < 1 || n_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap cmap, qmap;
  int err = make_map(&cmap, corpus,
                     I8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                     I8 ? 1 : 2, n_rows, d, HALF, KT,
                     I8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  err = make_map(&qmap, q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, q_rows, d, NQ, KT,
                 CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  auto kernel = lane_scan_group_kernel<I8, NQ, PIPE>;
  constexpr int bytes = Smem<I8, NQ>::BYTES;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int q_tiles = q_rows / NQ;
  const int n_groups = (n_blocks + gsz - 1) / gsz;
  kernel<<<n_groups * 2 * q_tiles, THREADS, bytes, stream>>>(
      cmap, qmap, bias, scale, alpha, b_pad, d, blk_n, n_blocks, gsz, q_tiles, out_s, out_i);
  return static_cast<int>(cudaGetLastError());
}

template <bool PIPE>
int dispatch(const void* q, const void* corpus, int dtype, const float* bias, const float* scale,
             float alpha, int q_rows, int b_pad, int d, int n_rows, int blk_n, int n_blocks,
             int gsz, int tile_b, float* out_s, int32_t* out_i, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 1 && dtype != 2) return static_cast<int>(cudaErrorInvalidValue);
  const bool i8 = dtype == 2;
#define LANE_GROUP(NQ)                                                                        \
  if (tile_b == NQ)                                                                            \
    return i8 ? launch_group<true, NQ, PIPE>(q, corpus, bias, scale, alpha, q_rows, b_pad, d,  \
                                             n_rows, blk_n, n_blocks, gsz, out_s, out_i, s)    \
              : launch_group<false, NQ, PIPE>(q, corpus, bias, scale, alpha, q_rows, b_pad, d, \
                                              n_rows, blk_n, n_blocks, gsz, out_s, out_i, s);
  LANE_GROUP(32)
  LANE_GROUP(64)
#undef LANE_GROUP
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace lane_group

// dtype: 1 = bfloat16, 2 = int8 (q bfloat16 for both). scale may be null.
// q: [q_rows, d] with q_rows a multiple of tile_b (32 or 64 query rows per
// CTA); rows b_pad.. are not written. One CTA per (group of gsz blocks, the
// last group may be shorter; lane half; query tile). out_s/out_i: [b_pad,
// n_groups * 256]; group g's lane l top-1 at g*256 + l, top-2 at g*256 +
// 128 + l.
extern "C" int lane_topk_group(const void* q, const void* corpus, int dtype, const float* bias,
                               const float* scale, float alpha, int q_rows, int b_pad, int d,
                               int n_rows, int blk_n, int n_blocks, int gsz, int tile_b,
                               float* out_s, int32_t* out_i, void* stream) {
  return lane_group::dispatch<false>(q, corpus, dtype, bias, scale, alpha, q_rows, b_pad, d,
                                     n_rows, blk_n, n_blocks, gsz, tile_b, out_s, out_i, stream);
}

// K5's candidates for gsz dividing n_blocks, no row scale, the selection of
// a tile overlapping the products of the next; arguments as above.
extern "C" int lane_topk_group_pipe(const void* q, const void* corpus, int dtype,
                                    const float* bias, float alpha, int q_rows, int b_pad, int d,
                                    int n_rows, int blk_n, int n_blocks, int gsz, int tile_b,
                                    float* out_s, int32_t* out_i, void* stream) {
  if (gsz < 1 || n_blocks % gsz != 0) return static_cast<int>(cudaErrorInvalidValue);
  return lane_group::dispatch<true>(q, corpus, dtype, bias, nullptr, alpha, q_rows, b_pad, d,
                                    n_rows, blk_n, n_blocks, gsz, tile_b, out_s, out_i, stream);
}
