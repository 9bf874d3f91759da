// K1 `lane_topk_acc` for bf16 and int8 corpora: the running per-lane top-T
// scan of lane_scan.cuh, one CTA per split serving every query of a batch
// of up to 32 (its design note says why).

#include "lane_scan.cuh"

// dtype: 1 = bfloat16, 2 = int8 (q bfloat16 for both). scale may be null.
// b_pad: 8, 16, 24 or 32 (the query width of the product); t_cands: 8 or
// 16. out_s/out_i: [b_pad, n_splits, W, 128] with W = 2 * blocks_per_split
// if that is at most t_cands, else t_cands.
extern "C" int lane_topk_acc(const void* q, const void* corpus, int dtype, const float* bias,
                             const float* scale, float alpha, int b_pad, int d, int n_rows,
                             int blk_n, int n_blocks, int blocks_per_split, int n_splits,
                             int t_cands, float* out_s, int32_t* out_i, void* stream) {
  using lane_scan::launch_scan;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 1 && dtype != 2) return static_cast<int>(cudaErrorInvalidValue);
  const bool i8 = dtype == 2;
#define LANE_SCAN_ACC(NQ, T)                                                                  \
  if (b_pad == NQ && t_cands == T)                                                             \
    return i8 ? launch_scan<true, NQ, T>(q, corpus, bias, scale, alpha, b_pad, b_pad, d,       \
                                         n_rows, blk_n, n_blocks, blocks_per_split, n_splits,  \
                                         out_s, out_i, s)                                      \
              : launch_scan<false, NQ, T>(q, corpus, bias, scale, alpha, b_pad, b_pad, d,      \
                                          n_rows, blk_n, n_blocks, blocks_per_split, n_splits, \
                                          out_s, out_i, s);
  LANE_SCAN_ACC(8, 8)
  LANE_SCAN_ACC(8, 16)
  LANE_SCAN_ACC(16, 8)
  LANE_SCAN_ACC(16, 16)
  LANE_SCAN_ACC(24, 8)
  LANE_SCAN_ACC(24, 16)
  LANE_SCAN_ACC(32, 8)
  LANE_SCAN_ACC(32, 16)
#undef LANE_SCAN_ACC
  return static_cast<int>(cudaErrorInvalidValue);
}
