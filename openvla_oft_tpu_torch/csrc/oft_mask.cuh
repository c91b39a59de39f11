// The OFT mask rule and tile-skip rule shared by the forward kernel (K1,
// flash_attention_fwd.cu) and the backward kernels (K2, K3,
// flash_attention_bwd.cu), so the three cannot drift apart.
//
//   allow[i, j] = valid[j] AND (j <= i  OR  (bidir[i] AND bidir[j]))
//   (without `causal` the bracket is true)
//
// A (query tile, key tile) pair is computed only when some allow[i, j] of
// the pair can be true; every skipped pair has P == 0 for all its entries.
// The kernels further class a live pair as interior (every entry allowed:
// no element evaluates allow()) or partial.

#pragma once

namespace oft {

// Entry (i, j) of the mask; `valid_j`, `bid_i`, `bid_j` are the 1-D vectors.
__device__ __forceinline__ bool allow(bool causal, int i, int j, bool valid_j,
                                      bool bid_i, bool bid_j) {
  return valid_j && (!causal || j <= i || (bid_i && bid_j));
}

// allow() for the 64 keys k0 .. k0 + 63 of row i at once: bit j is
// allow(causal, i, k0 + j, valid_j, bid_i, bid_j), from the key tile's masks
// `valid` and `valid_bid` (valid and bidirectional).
__device__ __forceinline__ unsigned long long row_allowed(bool causal, int i, int k0,
                                                          unsigned long long valid,
                                                          bool bid_i,
                                                          unsigned long long valid_bid) {
  const int r = i - k0;   // the last key at or below row i
  const unsigned long long below =
      !causal || r >= 63 ? ~0ull : r < 0 ? 0ull : (2ull << r) - 1;
  return (valid & below) | (bid_i ? valid_bid : 0ull);
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
// the first query row. Rows past S are not the rule's business: K1 never
// writes them, and the backward kernels give them P == 0 through their LSE.
__device__ __forceinline__ bool tile_pair_interior(bool causal, int k_hi, int q0,
                                                   bool k_all_valid) {
  return k_all_valid && (!causal || k_hi <= q0);
}

}  // namespace oft
