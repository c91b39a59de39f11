// PTX wrappers for Hopper (sm_90a) kernels: mbarriers, cp.async, TMA
// tensor-map loads, bulk copies, wgmma shared-memory descriptors and the
// wgmma fence, commit and wait. Shared by K1 (flash_attention_fwd.cu), K2
// and K3 (flash_attention_bwd.cu), through flash_wgmma.cuh, K4
// (ln_matmul.cu), K5 (int4_w4a16.cu) and K6 (int4_w4a8.cu).

#pragma once

#include <cuda.h>   // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Whether the phase of `bar` with this parity has completed, without waiting.
__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Arrive on `bar` when this thread's earlier cp.async copies have landed;
// counts as one of the barrier's expected arrivals.
__device__ __forceinline__ void cp_async_arrive_noinc(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(bar) : "memory");
}

// As above, but without counting as an arrival (a zero-net change).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];" ::"r"(bar) : "memory");
}

// 16 or 4 bytes global -> shared; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// A box of a 4-D tensor map (coordinates innermost first); elements outside
// the tensor land as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` contiguous bytes global -> shared (both 16-byte aligned, bytes a
// multiple of 16), completing on `bar` as TMA does.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with the 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), LBO unused (1).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)64 << 32) |
         ((uint64_t)1 << 62);
}

// wgmma shared-memory descriptor of an MN-major tile with the 128-byte swizzle
// (a bf16 B operand stored (K, N), read with the instruction's transpose bit):
// each k row holds 64 columns in 128 bytes, 8 k rows make a 1024-byte swizzle
// atom; SBO = 1024 bytes from one 8-row group of k to the next, LBO = `lbo`
// bytes from one 64-column atom to the next along N.
__device__ __forceinline__ uint64_t mn_sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)64 << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// cuTensorMapEncodeTiled through the runtime's driver entry point (no libcuda link).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// Makes the device that holds `ptr` current on this host thread, and with it
// its primary context, before a tensor map is encoded: the encoder returns
// CUDA_ERROR_INVALID_CONTEXT on a thread with no current context, and
// autograd's device thread has none when the op's backward is the first
// work it runs (scripts/exp_tmap_context.py shows both).
inline cudaError_t bind_device_of(const void* ptr) {
  cudaPointerAttributes attr;
  const cudaError_t err = cudaPointerGetAttributes(&attr, ptr);
  return err != cudaSuccess ? err : cudaSetDevice(attr.device);
}

// A 2-D tensor map: dims and box innermost first, the row stride in bytes.
inline bool encode_2d(EncodeTiled encode, CUtensorMap* map, CUtensorMapDataType type, const void* base,
               uint64_t inner, uint64_t rows, uint64_t stride_bytes, uint32_t box_inner,
               uint32_t box_rows, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {inner, rows};
  const cuuint64_t strides[1] = {stride_bytes};
  const cuuint32_t box[2] = {box_inner, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 4-D tensor map: dims and box innermost first, the strides of dims 1-3 in
// bytes; returns the encoder's CUresult.
inline CUresult encode_4d(EncodeTiled encode, CUtensorMap* map, CUtensorMapDataType type,
                      const void* base, const uint64_t (&dims)[4],
                      const uint64_t (&stride_bytes)[3], const uint32_t (&box)[4],
                      CUtensorMapSwizzle swizzle) {
  const cuuint64_t d[4] = {dims[0], dims[1], dims[2], dims[3]};
  const cuuint64_t st[3] = {stride_bytes[0], stride_bytes[1], stride_bytes[2]};
  const cuuint32_t bx[4] = {box[0], box[1], box[2], box[3]};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, type, 4, const_cast<void*>(base), d, st, bx, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace hopper
