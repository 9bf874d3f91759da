// K2 `lane_topk_emit` for bf16 and int8 corpora: every block's per-lane
// top-2 from the scan of lane_scan.cuh, 64 queries per CTA (the widest
// product whose per-pair selection state stays in registers beside its
// accumulators: 32 accumulators and 96 registers of top-2 state a thread).

#include "lane_scan.cuh"

constexpr int EMIT_NQ = 64;

// dtype: 1 = bfloat16, 2 = int8 (q bfloat16 for both). scale may be null.
// q: [q_rows, d] with q_rows a multiple of 64; rows b_pad.. are not written.
// out_s/out_i: [b_pad, n_blocks * 256]; block j's lane l top-1 at
// j*256 + l, top-2 at j*256 + 128 + l.
extern "C" int lane_topk_emit(const void* q, const void* corpus, int dtype, const float* bias,
                              const float* scale, float alpha, int q_rows, int b_pad, int d,
                              int n_rows, int blk_n, int n_blocks, int blocks_per_split,
                              int n_splits, float* out_s, int32_t* out_i, void* stream) {
  using lane_scan::launch_scan;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return launch_scan<false, EMIT_NQ, 0>(q, corpus, bias, scale, alpha, q_rows, b_pad, d,
                                            n_rows, blk_n, n_blocks, blocks_per_split, n_splits,
                                            out_s, out_i, s);
    case 2:
      return launch_scan<true, EMIT_NQ, 0>(q, corpus, bias, scale, alpha, q_rows, b_pad, d,
                                           n_rows, blk_n, n_blocks, blocks_per_split, n_splits,
                                           out_s, out_i, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
