// The wmma tile walk of the K5 timing probe (int4_probe.cu, the walk of the
// first K5 and of the first K4): one CTA of 8 warps (2 x 4) computes a
// BM x BN tile of y = x @ W, each warp a 32 x 32 block of 2 x 2 bf16
// m16n16k16 fragments with fp32 accumulators; per step of BK the CTA stages
// a bf16 x tile and a bf16 weight tile in shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace tiles {

using namespace nvcuda;

constexpr int BM = 64;          // rows of x per CTA
constexpr int BN = 128;         // output columns per CTA
constexpr int BK = 64;          // depth per step
constexpr int NTHREADS = 256;   // 8 warps: 2 along rows x 4 along columns

constexpr int LDA = BK + 8;     // bf16 x tile row stride (144 B)
constexpr int LDB = BN + 8;     // bf16 weight tile row stride (272 B)
constexpr int LDC = BN + 4;     // fp32 / int32 output tile row stride (528 B)

constexpr int SMEM_AB = (BM * LDA + BK * LDB) * 2;
constexpr int SMEM_C = BM * LDC * 4;

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// x tile (BM x BK) of a contiguous bf16 x (T, K) into As, zeros outside.
// vec8: rows may be read as 16-byte chunks (K % 8 == 0, x 16-byte aligned).
__device__ __forceinline__ void stage_x(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* As,
                                        int T, int K, int m0, int k0, int vec8) {
  const int tid = threadIdx.x;
  if (vec8) {
    for (int c = tid; c < BM * (BK / 8); c += NTHREADS) {
      const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      const int m = m0 + r, k = k0 + kc;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m < T && k < K) v = __ldg(reinterpret_cast<const uint4*>(x + (long long)m * K + k));
      *reinterpret_cast<uint4*>(As + r * LDA + kc) = v;
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int e = tid; e < BM * BK; e += NTHREADS) {
      const int r = e / BK, kk = e % BK;
      const int m = m0 + r, k = k0 + kk;
      As[r * LDA + kk] = (m < T && k < K) ? x[(long long)m * K + k] : zero;
    }
  }
}

__device__ __forceinline__ void zero_acc(Acc (&acc)[2][2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
}

// One 16-deep product of the staged tiles at depth kk into this warp's
// (wm, wn) block of accumulators.
__device__ __forceinline__ void mma_k16(Acc (&acc)[2][2], const __nv_bfloat16* As,
                                        const __nv_bfloat16* Bs, int wm, int wn, int kk) {
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], As + (32 * wm + 16 * i) * LDA + kk, LDA);
#pragma unroll
  for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], Bs + kk * LDB + 32 * wn + 16 * j, LDB);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
}

// This warp's accumulators into the fp32 tile Cs (row stride LDC).
__device__ __forceinline__ void store_acc(Acc (&acc)[2][2], float* Cs, int wm, int wn) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (32 * wm + 16 * i) * LDC + 32 * wn + 16 * j, acc[i][j], LDC,
                              wmma::mem_row_major);
}

// The fp32 tile Cs (BM x BN) into y (T, N) fp32, with bounds.
__device__ __forceinline__ void write_tile(const float* Cs, float* __restrict__ out, int T, int N,
                                           int m0, int n0) {
  const int tid = threadIdx.x;
  const int c = tid % BN, n = n0 + c;
  for (int r = tid / BN; r < BM; r += NTHREADS / BN) {
    const int m = m0 + r;
    if (m < T && n < N) out[(long long)m * N + n] = Cs[r * LDC + c];
  }
}

}  // namespace tiles
