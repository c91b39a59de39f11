// The OFT mask rule and tile-skip rule shared by the forward kernel (K1,
// flash_attention_fwd.cu) and the backward kernels (K2, K3,
// flash_attention_bwd.cu), so the three cannot drift apart.
//
//   allow[i, j] = valid[j] AND (j <= i  OR  (bidir[i] AND bidir[j]))
//   (without `causal` the bracket is true)
//
// A (query tile, key tile) pair is computed only when some allow[i, j] of
// the pair can be true; every skipped pair has P == 0 for all its entries.
// The backward kernels further class a live pair as interior (every entry
// allowed: no element evaluates allow()) or partial.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace oft {

constexpr int BQ = 64;                 // query rows per tile
constexpr int BK = 64;                 // key rows per tile
constexpr int NWARPS = 4;              // 16 rows per warp
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;      // finite, as in the TPU kernel

// Entry (i, j) of the mask; `valid_j`, `bid_i`, `bid_j` are the 1-D vectors.
__device__ __forceinline__ bool allow(bool causal, int i, int j, bool valid_j,
                                      bool bid_i, bool bid_j) {
  return valid_j && (!causal || j <= i || (bid_i && bid_j));
}

// Whether the pair (query rows q0..q_hi, key rows k0..) can hold an allowed
// entry. `k_any_valid`: the key tile holds a valid key; `k_any_bid`: it holds
// a key that is both valid and bidirectional; `q_bid_any`: the query tile
// holds a bidirectional row. Under `causal` a key tile wholly above the
// diagonal still counts when a bidirectional row reaches a bidirectional key
// in it: the action window attends forward.
__device__ __forceinline__ bool tile_pair_live(bool causal, int k0, int q_hi,
                                               bool q_bid_any, bool k_any_valid,
                                               bool k_any_bid) {
  return k_any_valid && (!causal || k0 <= q_hi || (q_bid_any && k_any_bid));
}

// Whether every entry of the pair (query rows q0.., key rows ..k_hi) is
// allowed, so that no element needs allow(): every key of the tile exists and
// is valid (`k_all_valid`) and, under `causal`, the last key is at or below
// the first query row. Rows past S are not the rule's business: the backward
// kernels give them P == 0 through their LSE.
__device__ __forceinline__ bool tile_pair_interior(bool causal, int k_hi, int q0,
                                                   bool k_all_valid) {
  return k_all_valid && (!causal || k_hi <= q0);
}

// Copy 64 rows of D bf16 (row stride `row_stride` elements) into a shared
// tile with row stride LD, 16 bytes per thread per step; rows >= n_valid are
// zero-filled so padding rows can never inject NaN.
template <int D, int LD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int n_valid) {
  constexpr int CHUNKS = D / 8;
  for (int idx = threadIdx.x; idx < 64 * CHUNKS; idx += NTHREADS) {
    const int r = idx / CHUNKS, c = idx % CHUNKS;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_valid)
      val = *reinterpret_cast<const uint4*>(src + r * row_stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = val;
  }
}

}  // namespace oft
