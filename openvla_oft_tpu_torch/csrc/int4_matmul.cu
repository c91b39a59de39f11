// K6 on Hopper: the int4 W4A8 dequant-matmul.
//
// Replaces the TPU kernels of openvla_oft_tpu/ops/int4_matmul.py:
//   K6 (W4A8):  _kernel_a8 (:432) and _kernel_stacked_a8 (:527)
// (K5, W4A16, is csrc/int4_w4a16.cu.) The stacked TPU variant reads a layer
// of an (L, K/2, N) buffer without a copy; here every operand is read
// through its row stride, so a layer view packed[l] and a column view
// packed[:, lo:hi] need no copy either, and one kernel serves both variants.
//
// Packing (ops/quant.py::quantize_weight_int4): byte (i, n) of `packed`
// (K/2, N) int8 holds weight row 2i in its low nibble and row 2i+1 in its
// high nibble, each a signed 4-bit value in [-7, 7]; scales (G, N) fp32,
// G = K / group, group a multiple of 16.
//
// K6:  y[t, n] = sx[t] * sum_g float(sum_{k in g} x8[t, k] * nibble(k, n)) * scales[g, n]
//      x8 (T, K) int8 and sx (T) fp32 from the wrapper (per-token absmax
//      / 127, round half to even). Each group's depth is an exact int32
//      product on the int8 tensor cores; the group scale multiplies that
//      partial in fp32 and the partials add in group order, with the
//      roundings of the plain version (no fused multiply-add).
//
// Design. One CTA computes a 64 x 128 tile of y with 8 warps (2 x 4), each
// a 32 x 32 block of 2 x 2 s8 m16n16k16 wmma fragments with int32
// accumulators. K6 steps one scale group at a time: it stages x8's panels
// and the group's unpacked weight panels in shared memory (the packed bytes
// read as 4-byte words where alignment allows and unpacked by all 256
// threads); after the group's products its int32 tile goes through shared
// memory to the threads, which scale it into fp32 accumulators held in
// registers. It stages its int8 tiles as 16-wide panels, so that every wmma
// pointer is 32-byte aligned.
//
// Bound. At T = 618 the LLM's linears are compute-bound on the card: a 4096
// x 12288 weight is 25 MB of int4 and 62 GFLOP, 0.0075 ms of bytes against
// 0.031 ms of int8 tensor-core time. At T = 57 bytes and operations come
// near balance. This version has no pipelining: the design of K5
// (csrc/int4_w4a16.cu) on int8 wgmma is later work.

#include "int4_tiles.cuh"

using namespace nvcuda;
using namespace tiles;

namespace {

constexpr int MAX_GROUP = 128;  // ops/quant.py INT4_GROUP: groups never exceed it

constexpr int K6_A_BYTES = BM * MAX_GROUP;      // x8 panels [k/16][row][16]
constexpr int K6_SMEM_AB = K6_A_BYTES + MAX_GROUP * BN;   // + weight panels [n/16][k][16]
constexpr int K6_SMEM = K6_SMEM_AB > SMEM_C ? K6_SMEM_AB : SMEM_C;

constexpr int ACC_PER_THREAD = BM * BN / NTHREADS;   // 32 K6 accumulators

// ---------------------------------------------------------------------------
// K6: W4A8
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NTHREADS)
int4_w4a8_kernel(const int8_t* __restrict__ x8, const float* __restrict__ sx,
                 const int8_t* __restrict__ packed, const float* __restrict__ scales,
                 float* __restrict__ out, int T, int K, int N, int group, long long ldp,
                 long long lds, int vec4) {
  __shared__ __align__(128) unsigned char smem[K6_SMEM];
  signed char* Ap = reinterpret_cast<signed char*>(smem);                // [k/16][BM][16]
  signed char* Bp = reinterpret_cast<signed char*>(smem + K6_A_BYTES);   // [n/16][group][16]
  int* Ci = reinterpret_cast<int*>(smem);

  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int c = tid % BN, n = n0 + c, r0 = tid / BN;   // this thread's accumulators:
  float acc[ACC_PER_THREAD];                          // rows r0 + 2j, column c
#pragma unroll
  for (int j = 0; j < ACC_PER_THREAD; ++j) acc[j] = 0.f;

  const int panels = group / 16;
  for (int g = 0; g < K / group; ++g) {
    const int k0 = g * group;
    // x8 panels: 16 bytes of one row per load (K % 16 == 0, rows 16-byte aligned).
    for (int e = tid; e < BM * panels; e += NTHREADS) {
      const int ks = e / BM, r = e % BM, m = m0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m < T) v = __ldg(reinterpret_cast<const uint4*>(x8 + (long long)m * K + k0 + 16 * ks));
      *reinterpret_cast<uint4*>(Ap + (ks * BM + r) * 16) = v;
    }
    // Weight panels: the group's packed rows unpacked to int8 nibbles.
    for_packed_bytes(packed, ldp, K / 2, N, k0 / 2, n0, group / 2, vec4 != 0,
                     [&](int i, int cc, int b) {
                       signed char* col = Bp + ((cc / 16) * group + 2 * i) * 16 + cc % 16;
                       col[0] = (signed char)low_nibble(b);
                       col[16] = (signed char)high_nibble(b);
                     });
    __syncthreads();
    wmma::fragment<wmma::accumulator, 16, 16, 16, int> ci[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(ci[i][j], 0);
    for (int ks = 0; ks < panels; ++ks) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], Ap + (ks * BM + 32 * wm + 16 * i) * 16, 16);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bp + ((2 * wn + j) * group + 16 * ks) * 16, 16);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(ci[i][j], a[i], b[j], ci[i][j]);
    }
    __syncthreads();   // every warp is done with the panels before Ci overwrites them
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Ci + (32 * wm + 16 * i) * LDC + 32 * wn + 16 * j, ci[i][j],
                                LDC, wmma::mem_row_major);
    __syncthreads();
    const float s = n < N ? __ldg(scales + (long long)g * lds + n) : 0.f;
#pragma unroll
    for (int j = 0; j < ACC_PER_THREAD; ++j)
      acc[j] = __fadd_rn(acc[j], __fmul_rn((float)Ci[(r0 + 2 * j) * LDC + c], s));
    __syncthreads();   // before the next group's panels overwrite Ci
  }
  if (n < N) {
#pragma unroll
    for (int j = 0; j < ACC_PER_THREAD; ++j) {
      const int m = m0 + r0 + 2 * j;
      if (m < T) out[(long long)m * N + n] = __fmul_rn(acc[j], __ldg(sx + m));
    }
  }
}

}  // namespace

extern "C" {

// Launch K6 on `stream`: x8 (T, K) int8 contiguous, sx (T) fp32, group a
// multiple of 16 and at most 128. Returns the launch's cudaError_t.
int openvla_int4_matmul_w4a8(const void* x8, const void* sx, const void* packed,
                             const void* scales, void* out, int T, int K, int N, int group,
                             long long ldp, long long lds, int vec4, void* stream) {
  if (T <= 0 || N <= 0 || K <= 0 || group <= 0 || group % 16 || group > MAX_GROUP ||
      K % group)
    return (int)cudaErrorInvalidValue;
  dim3 grid((N + BN - 1) / BN, (T + BM - 1) / BM);
  int4_w4a8_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x8), static_cast<const float*>(sx),
      static_cast<const int8_t*>(packed), static_cast<const float*>(scales),
      static_cast<float*>(out), T, K, N, group, ldp, lds, vec4);
  return (int)cudaGetLastError();
}

}  // extern "C"
