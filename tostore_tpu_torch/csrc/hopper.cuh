// Hopper (sm_90a) building blocks shared by the port's TMA / wgmma kernels
// (lane_scan.cuh: K1, K2; ivf_probe.cu: K3, K4): mbarriers, TMA tensor
// maps and loads, bulk copies, the 128-byte-swizzle wgmma descriptor, the
// m64nNk16 bf16 wgmma instructions and the exact int8 -> bf16 widening.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Wait for the completion of the barrier's phase of this parity. A wait
// that lasts about ten seconds traps: a fault in the ring then fails the
// launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  long long start = 0;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 35)) {
      __trap();
    }
  }
}
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// orders this thread's generic-proxy shared-memory accesses before later
// async-proxy ones (TMA writes, wgmma reads) of the same buffer
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// Contiguous bytes global -> shared (both 16-byte aligned, bytes a multiple
// of 16), completing on the barrier's transaction count.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle:
// rows of 128 bytes, 8-row atoms 1024 bytes apart (SBO), leading offset 16
// bytes (unused for this layout). +2 moves it 32 bytes: the next k16 slice.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
template <int R> __device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// D[64 x N] (+)= A[64 x 16] . B[N x 16]^T, bf16 in, f32 out; both operands
// K-major in shared memory. Accumulator element i of a thread (lane l of
// warp w of the warpgroup): row 16 w + l / 4 + 8 ((i >> 1) & 1), column
// 2 (l % 4) + 8 (i >> 2) + (i & 1).
template <int N> struct Wgmma;
template <> struct Wgmma<8> {
  static __device__ __forceinline__ void mma(float (&d)[4], uint64_t da, uint64_t db,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3"
        "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(accumulate));
  }
};
template <> struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], uint64_t da, uint64_t db,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(accumulate));
  }
};
template <> struct Wgmma<24> {
  static __device__ __forceinline__ void mma(float (&d)[12], uint64_t da, uint64_t db,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11"
        "}, %12, %13, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        : "l"(da), "l"(db), "r"(accumulate));
  }
};
template <> struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t da, uint64_t db,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(accumulate));
  }
};
template <> struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
  }
};

// 8 int8 values -> 8 bf16 (exact) as one 16-byte chunk
__device__ __forceinline__ void widen8(unsigned char* dst, const unsigned char* src) {
  const uint2 raw = *reinterpret_cast<const uint2*>(src);
  const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
  __align__(16) __nv_bfloat162 w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    w[e] = __floats2bfloat162_rn(static_cast<float>(v[2 * e]), static_cast<float>(v[2 * e + 1]));
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(w);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API call; it is reached through the
// runtime's driver entry point, so the library needs no -lcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A [rows, cols] row-major tensor read in boxes of [box_rows, box_cols];
// boxes past the edge read zeros.
inline int make_map(CUtensorMap* map, const void* base, CUtensorMapDataType type, int elem,
                    long long rows, int cols, int box_rows, int box_cols,
                    CUtensorMapSwizzle swizzle) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = enc(map, type, 2, const_cast<void*>(base), dims, strides, box, estr,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace hopper
