// The int4 half of the K5 timing probe's tile walk: reading the packed
// bytes of a weight tile.
//
// Packing (ops/quant.py::quantize_weight_int4): byte (i, n) of `packed`
// (K/2, N) int8 holds weight row 2i in its low nibble and row 2i+1 in its
// high nibble, each a signed 4-bit value; scales (G, N) fp32, G = K / group.

#pragma once

#include "wmma_tiles.cuh"

namespace tiles {

__device__ __forceinline__ int byte_of(int word, int j) {
  // Byte j of a little-endian word, sign-extended.
  return (int)((unsigned)word << (24 - 8 * j)) >> 24;
}
__device__ __forceinline__ int low_nibble(int b) { return (int)((unsigned)b << 28) >> 28; }
__device__ __forceinline__ int high_nibble(int b) { return b >> 4; }

// Calls f(i, c, b) for every packed byte b at (row p0 + i, column n0 + c),
// i < rows, c < BN, with b = 0 outside (K/2, N). 4-byte words when vec4.
template <typename F>
__device__ __forceinline__ void for_packed_bytes(const int8_t* packed, long long ldp, int K2,
                                                 int N, int p0, int n0, int rows, bool vec4,
                                                 F f) {
  const int tid = threadIdx.x;
  if (vec4) {
    // N % 4 == 0, so a word is wholly inside or outside the weight.
    for (int w = tid; w < rows * (BN / 4); w += NTHREADS) {
      const int i = w / (BN / 4), c = (w % (BN / 4)) * 4;
      const int p = p0 + i, n = n0 + c;
      int word = 0;
      if (p < K2 && n < N) word = __ldg(reinterpret_cast<const int*>(packed + p * ldp + n));
#pragma unroll
      for (int j = 0; j < 4; ++j) f(i, c + j, byte_of(word, j));
    }
  } else {
    for (int e = tid; e < rows * BN; e += NTHREADS) {
      const int i = e / BN, c = e % BN;
      const int p = p0 + i, n = n0 + c;
      const int b = (p < K2 && n < N) ? (int)__ldg(packed + p * ldp + n) : 0;
      f(i, c, b);
    }
  }
}

}  // namespace tiles
