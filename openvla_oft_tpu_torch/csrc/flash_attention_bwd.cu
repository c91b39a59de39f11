// K2 and K3 on Hopper: the flash-attention backward with the OFT
// block-bidirectional mask.
//
// Replace the TPU kernels openvla_oft_tpu/ops/flash_attention.py::_kernel_dq
// (K2) and ::_kernel_dkv (K3), launched by _flash_core_bwd. They compute the
// same function, not the same blocks. With the residuals of the forward (K1:
// O and LSE) and dO:
//
//   P[i, j]  = allow[i, j] ? exp(q_i . k_j * scale - LSE[i]) : 0   (fp32)
//   dP[i, j] = dO_i . v_j                                           (fp32)
//   delta[i] = sum_d dO[i, d] * O[i, d]                              (fp32)
//   dS[i, j] = P[i, j] * (dP[i, j] - delta[i]) * scale
//   dq = bf16(dS) . K,   dk = bf16(dS)^T . Q,   dv = bf16(P)^T . dO
//
// with scale = D^-1/2 and the mask rule and tile-skip rule of
// oft_mask.cuh, which K1 uses too. P and dS round to bf16 before their
// products, as the TPU kernels' astype(v.dtype) / astype(q.dtype) do; every
// product accumulates in fp32 on the tensor cores (nvcuda::wmma).
//
// Dead rows (no allowed key) carry LSE = -1e30 from K1, so exp(S - LSE)
// overflows there; P is taken by a select on `allow`, never a multiply, so
// the overflow never reaches a product.
//
// K2: one CTA per (b, h, 64-row query tile); each of 4 warps owns 16 query
// rows and keeps its dq accumulator in registers across the key tiles, which
// it walks with K1's skip rule. Scores and dP go through shared memory, where
// two lanes per row apply the mask and form dS.
//
// K3: one CTA per (b, kv head, 64-row key tile); each warp owns 16 key rows.
// It loops over the query heads of the GQA group and the query tiles, skipping
// a query tile that lies wholly before the key tile unless one of its
// bidirectional rows reaches a bidirectional key in it (the same predicate as
// K1's, read from the key tile's side). The TPU version writes dk/dv per query
// head and sums the group outside the kernel; here the group is summed inside
// the CTA in the fp32 accumulators, with one rounding to bf16 at the end. A
// key tile with no valid key, and every invalid key row, is written as zero.
//
// q, k, v and dO are read through their strides (last dim contiguous), O is
// (B,S,H,D) and LSE (B,H,S) as K1 writes them; dq is (B,S,H,D) and dk/dv
// (B,S,Hkv,D), contiguous bf16.
//
// Bound. At the LIBERO training shape (B=8, S=585, H=32, D=128) one layer's
// backward is about 3 + 4 products of 8*32*585^2*128*2 FLOP before tile
// skipping, against a few tens of MB of operands: compute-bound once it runs
// on the tensor cores. This first version keeps the score, dP and (in K3) the
// dk/dv accumulators in shared memory, which limits it to one CTA per SM;
// wgmma, TMA and register-resident tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "oft_mask.cuh"

using namespace nvcuda;

namespace {

using oft::BK;
using oft::BQ;
using oft::NTHREADS;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                                wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                                wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Every wmma pointer below stays 32-byte aligned: each region size and each
// 16-row offset is a multiple of 32 bytes.
template <int D>
struct DqLayout {
  static constexpr int LDQ = D + 8;    // bf16 Q, dO, K, V tiles
  static constexpr int LDS = BK + 4;   // fp32 S and dP tiles
  static constexpr int LDP = BK + 8;   // bf16 dS tile
  static constexpr int LDO = D + 4;    // fp32 dq staging (aliases S and dP)
  static constexpr size_t q_off = 0;
  static constexpr size_t do_off = q_off + size_t(BQ) * LDQ * 2;
  static constexpr size_t k_off = do_off + size_t(BQ) * LDQ * 2;
  static constexpr size_t v_off = k_off + size_t(BK) * LDQ * 2;
  static constexpr size_t s_off = v_off + size_t(BK) * LDQ * 2;
  static constexpr size_t dp_off = s_off + size_t(BQ) * LDS * 4;
  static constexpr size_t ds_off = dp_off + size_t(BQ) * LDS * 4;
  static constexpr size_t row_off = ds_off + size_t(BQ) * LDP * 2;
  static constexpr size_t flag_off = row_off + 2 * BQ * 4;
  static constexpr size_t bytes = flag_off + 2 * BK;
  static_assert(size_t(BQ) * LDO * 4 <= ds_off - s_off, "dq staging fits");
};

template <int D>
struct DkvLayout {
  static constexpr int LDQ = D + 8;    // bf16 K, V, Q, dO tiles
  static constexpr int LDS = BQ + 4;   // fp32 S^T and dP^T tiles (key rows)
  static constexpr int LDP = BQ + 8;   // bf16 P^T and dS^T tiles
  static constexpr int LDO = D + 4;    // fp32 dk and dv accumulators
  static constexpr size_t dk_off = 0;
  static constexpr size_t dv_off = dk_off + size_t(BK) * LDO * 4;
  static constexpr size_t k_off = dv_off + size_t(BK) * LDO * 4;
  static constexpr size_t v_off = k_off + size_t(BK) * LDQ * 2;
  static constexpr size_t q_off = v_off + size_t(BK) * LDQ * 2;
  static constexpr size_t do_off = q_off + size_t(BQ) * LDQ * 2;
  static constexpr size_t s_off = do_off + size_t(BQ) * LDQ * 2;
  static constexpr size_t dp_off = s_off + size_t(BK) * LDS * 4;
  static constexpr size_t p_off = dp_off + size_t(BK) * LDS * 4;
  static constexpr size_t ds_off = p_off + size_t(BK) * LDP * 2;
  static constexpr size_t row_off = ds_off + size_t(BK) * LDP * 2;
  static constexpr size_t flag_off = row_off + 2 * BQ * 4;
  static constexpr size_t bytes = flag_off + 3 * 64;
};

// lse[r] and delta[r] = sum_d dO[r, d] * O[r, d] for the 64 query rows of a
// tile (head h), from the dO tile in shared memory and O in device memory.
// Two threads per row; rows past S get 0 (their P is masked to 0).
template <int D, int LDQ>
__device__ __forceinline__ void load_row_stats(
    float* s_lse, float* s_delta, const __nv_bfloat16* s_do,
    const __nv_bfloat16* o, const float* lse, int b, int h, int q0, int S,
    int H) {
  const int rr = threadIdx.x >> 1, hf = threadIdx.x & 1;
  const int qi = q0 + rr;
  float acc = 0.f;
  if (qi < S) {
    const __nv_bfloat16* orow =
        o + (((long long)b * S + qi) * H + h) * D + hf * (D / 2);
    const __nv_bfloat16* drow = s_do + rr * LDQ + hf * (D / 2);
#pragma unroll 8
    for (int c = 0; c < D / 2; ++c)
      acc += __bfloat162float(orow[c]) * __bfloat162float(drow[c]);
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  if (hf == 0) {
    s_delta[rr] = acc;
    s_lse[rr] = qi < S ? lse[((long long)b * H + h) * S + qi] : 0.f;
  }
}

// ---------------------------------------------------------------- K2 (dq)
template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ o,
                    const float* __restrict__ lse,
                    const __nv_bfloat16* __restrict__ dout,
                    const uint8_t* __restrict__ key_valid,
                    const uint8_t* __restrict__ bidir,
                    __nv_bfloat16* __restrict__ dq, int S, int H, int Hkv,
                    long long q_sb, long long q_ss, long long q_sh,
                    long long k_sb, long long k_ss, long long k_sh,
                    long long v_sb, long long v_ss, long long v_sh,
                    long long d_sb, long long d_ss, long long d_sh,
                    int causal, float scale) {
  using L = DqLayout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + L::q_off);
  __nv_bfloat16* sDO = reinterpret_cast<__nv_bfloat16*>(smem + L::do_off);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + L::k_off);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + L::v_off);
  float* sS = reinterpret_cast<float*>(smem + L::s_off);
  float* sDP = reinterpret_cast<float*>(smem + L::dp_off);
  __nv_bfloat16* sDS = reinterpret_cast<__nv_bfloat16*>(smem + L::ds_off);
  float* sLse = reinterpret_cast<float*>(smem + L::row_off);
  float* sDelta = sLse + BQ;
  uint8_t* sValid = smem + L::flag_off;
  uint8_t* sBid = sValid + BK;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const uint8_t* valid_b = key_valid + (long long)b * S;
  const uint8_t* bidir_b = bidir + (long long)b * S;
  const __nv_bfloat16* k_bh = k + b * k_sb + hk * k_sh;
  const __nv_bfloat16* v_bh = v + b * v_sb + hk * v_sh;
  const int q_n = min(BQ, S - q0);

  oft::load_tile<D, L::LDQ>(sQ, q + b * q_sb + (long long)q0 * q_ss + h * q_sh,
                            q_ss, q_n);
  oft::load_tile<D, L::LDQ>(
      sDO, dout + b * d_sb + (long long)q0 * d_ss + h * d_sh, d_ss, q_n);
  __syncthreads();
  load_row_stats<D, L::LDQ>(sLse, sDelta, sDO, o, lse, b, h, q0, S, H);

  const int q_hi = min(q0 + BQ, S) - 1;
  const int q_bid_any =
      __syncthreads_or(tid < BQ && q0 + tid < S && bidir_b[q0 + tid] != 0);

  // Lanes 2r and 2r+1 of a warp own row r of its 16 (32 columns each).
  const int r = lane >> 1, half = lane & 1;
  const int row = warp * 16 + r;
  const int qi = q0 + row;
  const bool q_live = qi < S;
  const bool q_bid = q_live && bidir_b[qi] != 0;

  FragC dq_acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(dq_acc[n], 0.f);

  const int n_tiles = (S + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    const int kn = min(BK, S - k0);
    int vf = 0, bf = 0;
    if (tid < kn) {
      vf = valid_b[k0 + tid] != 0;
      bf = bidir_b[k0 + tid] != 0;
    }
    const int any_valid = __syncthreads_or(vf);
    const int any_bid = __syncthreads_or(vf && bf);
    if (!oft::tile_pair_live(causal, k0, q_hi, q_bid_any, any_valid, any_bid))
      continue;   // uniform across the CTA
    if (tid < BK) {
      sValid[tid] = (uint8_t)vf;
      sBid[tid] = (uint8_t)bf;
    }
    oft::load_tile<D, L::LDQ>(sK, k_bh + (long long)k0 * k_ss, k_ss, kn);
    oft::load_tile<D, L::LDQ>(sV, v_bh + (long long)k0 * v_ss, v_ss, kn);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 rows, fp32 accumulate.
    {
      FragC acc_s[BK / 16], acc_p[BK / 16];
#pragma unroll
      for (int n = 0; n < BK / 16; ++n) {
        wmma::fill_fragment(acc_s[n], 0.f);
        wmma::fill_fragment(acc_p[n], 0.f);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        FragA aq, ado;
        wmma::load_matrix_sync(aq, sQ + warp * 16 * L::LDQ + kk * 16, L::LDQ);
        wmma::load_matrix_sync(ado, sDO + warp * 16 * L::LDQ + kk * 16, L::LDQ);
#pragma unroll
        for (int n = 0; n < BK / 16; ++n) {
          // col_major B: B[d][key] = sK[key * LDQ + d], i.e. K transposed.
          FragBCol bk, bv;
          wmma::load_matrix_sync(bk, sK + n * 16 * L::LDQ + kk * 16, L::LDQ);
          wmma::mma_sync(acc_s[n], aq, bk, acc_s[n]);
          wmma::load_matrix_sync(bv, sV + n * 16 * L::LDQ + kk * 16, L::LDQ);
          wmma::mma_sync(acc_p[n], ado, bv, acc_p[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < BK / 16; ++n) {
        wmma::store_matrix_sync(sS + warp * 16 * L::LDS + n * 16, acc_s[n],
                                L::LDS, wmma::mem_row_major);
        wmma::store_matrix_sync(sDP + warp * 16 * L::LDS + n * 16, acc_p[n],
                                L::LDS, wmma::mem_row_major);
      }
    }
    __syncwarp();

    // dS = P * (dP - delta) * scale under the mask, rounded to bf16.
    {
      const float lse_i = sLse[row], delta_i = sDelta[row];
      const float* srow = sS + row * L::LDS + half * 32;
      const float* prow = sDP + row * L::LDS + half * 32;
      __nv_bfloat16* dsrow = sDS + row * L::LDP + half * 32;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const int jj = half * 32 + c;
        const bool ok =
            q_live && oft::allow(causal, qi, k0 + jj, sValid[jj], q_bid, sBid[jj]);
        const float p = ok ? expf(srow[c] * scale - lse_i) : 0.f;
        dsrow[c] = __float2bfloat16(p * (prow[c] - delta_i) * scale);
      }
    }
    __syncwarp();

    // dq(16 x D) += dS(16 x 64) . K(64 x D).
    {
      FragA ads[BK / 16];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wmma::load_matrix_sync(ads[kk], sDS + warp * 16 * L::LDP + kk * 16,
                               L::LDP);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          FragBRow bk;
          wmma::load_matrix_sync(bk, sK + kk * 16 * L::LDQ + n * 16, L::LDQ);
          wmma::mma_sync(dq_acc[n], ads[kk], bk, dq_acc[n]);
        }
      }
    }
    __syncthreads();   // K/V/flags are overwritten by the next tile
  }
  __syncthreads();     // the staging below aliases S and dP

  float* sStage = sS;
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(sStage + warp * 16 * L::LDO + n * 16, dq_acc[n],
                            L::LDO, wmma::mem_row_major);
  __syncwarp();
  if (q_live) {
    const float* srow = sStage + row * L::LDO + half * (D / 2);
    __nv_bfloat16* out =
        dq + (((long long)b * S + qi) * H + h) * D + half * (D / 2);
#pragma unroll 8
    for (int c = 0; c < D / 2; ++c) out[c] = __float2bfloat16(srow[c]);
  }
}

// ------------------------------------------------------------- K3 (dk, dv)
template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ o,
                     const float* __restrict__ lse,
                     const __nv_bfloat16* __restrict__ dout,
                     const uint8_t* __restrict__ key_valid,
                     const uint8_t* __restrict__ bidir,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int S, int H, int Hkv,
                     long long q_sb, long long q_ss, long long q_sh,
                     long long k_sb, long long k_ss, long long k_sh,
                     long long v_sb, long long v_ss, long long v_sh,
                     long long d_sb, long long d_ss, long long d_sh,
                     int causal, float scale) {
  using L = DkvLayout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sDK = reinterpret_cast<float*>(smem + L::dk_off);
  float* sDV = reinterpret_cast<float*>(smem + L::dv_off);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + L::k_off);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + L::v_off);
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + L::q_off);
  __nv_bfloat16* sDO = reinterpret_cast<__nv_bfloat16*>(smem + L::do_off);
  float* sS = reinterpret_cast<float*>(smem + L::s_off);
  float* sDP = reinterpret_cast<float*>(smem + L::dp_off);
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(smem + L::p_off);
  __nv_bfloat16* sDS = reinterpret_cast<__nv_bfloat16*>(smem + L::ds_off);
  float* sLse = reinterpret_cast<float*>(smem + L::row_off);
  float* sDelta = sLse + BQ;
  uint8_t* sKValid = smem + L::flag_off;
  uint8_t* sKBid = sKValid + 64;
  uint8_t* sQBid = sKBid + 64;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int rep = H / Hkv;
  const int kn = min(BK, S - k0);
  const uint8_t* valid_b = key_valid + (long long)b * S;
  const uint8_t* bidir_b = bidir + (long long)b * S;

  int vf = 0, bf = 0;
  if (tid < kn) {
    vf = valid_b[k0 + tid] != 0;
    bf = bidir_b[k0 + tid] != 0;
  }
  if (tid < BK) {
    sKValid[tid] = (uint8_t)vf;
    sKBid[tid] = (uint8_t)bf;
  }
  const int any_valid = __syncthreads_or(vf);
  const int any_bid = __syncthreads_or(vf && bf);

  // Lanes 2r and 2r+1 of a warp own key row r of its 16 (32 columns each).
  const int r = lane >> 1, half = lane & 1;
  const int krow = warp * 16 + r;
  const int kj = k0 + krow;
  const long long out_off =
      (((long long)b * S + kj) * Hkv + hk) * D + half * (D / 2);

  if (!any_valid) {   // uniform: no key of the tile is valid
    if (krow < kn) {
      for (int c = 0; c < D / 2; ++c) {
        dk[out_off + c] = __float2bfloat16(0.f);
        dv[out_off + c] = __float2bfloat16(0.f);
      }
    }
    return;
  }

  for (int i = tid; i < BK * L::LDO; i += NTHREADS) {
    sDK[i] = 0.f;
    sDV[i] = 0.f;
  }
  oft::load_tile<D, L::LDQ>(sK, k + b * k_sb + (long long)k0 * k_ss + hk * k_sh,
                            k_ss, kn);
  oft::load_tile<D, L::LDQ>(sV, v + b * v_sb + (long long)k0 * v_ss + hk * v_sh,
                            v_ss, kn);
  __syncthreads();
  const bool k_valid = sKValid[krow] != 0, k_bid = sKBid[krow] != 0;

  const int n_qtiles = (S + BQ - 1) / BQ;
  for (int g = 0; g < rep; ++g) {
    const int h = hk * rep + g;
    for (int qt = 0; qt < n_qtiles; ++qt) {
      const int q0 = qt * BQ;
      const int q_n = min(BQ, S - q0);
      const int qb = tid < q_n && bidir_b[q0 + tid] != 0;
      const int q_bid_any = __syncthreads_or(qb);
      if (!oft::tile_pair_live(causal, k0, q0 + q_n - 1, q_bid_any, any_valid,
                               any_bid))
        continue;   // uniform across the CTA
      if (tid < BQ) sQBid[tid] = (uint8_t)qb;
      oft::load_tile<D, L::LDQ>(
          sQ, q + b * q_sb + (long long)q0 * q_ss + h * q_sh, q_ss, q_n);
      oft::load_tile<D, L::LDQ>(
          sDO, dout + b * d_sb + (long long)q0 * d_ss + h * d_sh, d_ss, q_n);
      __syncthreads();
      load_row_stats<D, L::LDQ>(sLse, sDelta, sDO, o, lse, b, h, q0, S, H);

      // S^T = K Q^T and dP^T = V dO^T for this warp's 16 key rows.
      {
        FragC acc_s[BQ / 16], acc_p[BQ / 16];
#pragma unroll
        for (int n = 0; n < BQ / 16; ++n) {
          wmma::fill_fragment(acc_s[n], 0.f);
          wmma::fill_fragment(acc_p[n], 0.f);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          FragA ak, av;
          wmma::load_matrix_sync(ak, sK + warp * 16 * L::LDQ + kk * 16, L::LDQ);
          wmma::load_matrix_sync(av, sV + warp * 16 * L::LDQ + kk * 16, L::LDQ);
#pragma unroll
          for (int n = 0; n < BQ / 16; ++n) {
            FragBCol bq, bdo;   // Q^T and dO^T
            wmma::load_matrix_sync(bq, sQ + n * 16 * L::LDQ + kk * 16, L::LDQ);
            wmma::mma_sync(acc_s[n], ak, bq, acc_s[n]);
            wmma::load_matrix_sync(bdo, sDO + n * 16 * L::LDQ + kk * 16, L::LDQ);
            wmma::mma_sync(acc_p[n], av, bdo, acc_p[n]);
          }
        }
#pragma unroll
        for (int n = 0; n < BQ / 16; ++n) {
          wmma::store_matrix_sync(sS + warp * 16 * L::LDS + n * 16, acc_s[n],
                                  L::LDS, wmma::mem_row_major);
          wmma::store_matrix_sync(sDP + warp * 16 * L::LDS + n * 16, acc_p[n],
                                  L::LDS, wmma::mem_row_major);
        }
      }
      __syncthreads();   // sLse/sDelta/sQBid written by other warps

      // P^T and dS^T under the mask, rounded to bf16.
      {
        const float* srow = sS + krow * L::LDS + half * 32;
        const float* prow = sDP + krow * L::LDS + half * 32;
        __nv_bfloat16* ptrow = sP + krow * L::LDP + half * 32;
        __nv_bfloat16* dsrow = sDS + krow * L::LDP + half * 32;
#pragma unroll
        for (int c = 0; c < 32; ++c) {
          const int ii = half * 32 + c;
          const int qi = q0 + ii;
          const bool ok = qi < S && oft::allow(causal, qi, kj, k_valid,
                                               sQBid[ii] != 0, k_bid);
          const float p = ok ? expf(srow[c] * scale - sLse[ii]) : 0.f;
          ptrow[c] = __float2bfloat16(p);
          dsrow[c] = __float2bfloat16(p * (prow[c] - sDelta[ii]) * scale);
        }
      }
      __syncwarp();

      // dV(16 x D) += P^T(16 x 64) . dO(64 x D); dK += dS^T . Q.
      {
        FragA ap[BQ / 16], ads[BQ / 16];
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          wmma::load_matrix_sync(ap[kk], sP + warp * 16 * L::LDP + kk * 16,
                                 L::LDP);
          wmma::load_matrix_sync(ads[kk], sDS + warp * 16 * L::LDP + kk * 16,
                                 L::LDP);
        }
#pragma unroll
        for (int n = 0; n < D / 16; ++n) {
          float* dvp = sDV + warp * 16 * L::LDO + n * 16;
          float* dkp = sDK + warp * 16 * L::LDO + n * 16;
          FragC acc_v, acc_k;
          wmma::load_matrix_sync(acc_v, dvp, L::LDO, wmma::mem_row_major);
          wmma::load_matrix_sync(acc_k, dkp, L::LDO, wmma::mem_row_major);
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk) {
            FragBRow bdo, bq;
            wmma::load_matrix_sync(bdo, sDO + kk * 16 * L::LDQ + n * 16, L::LDQ);
            wmma::mma_sync(acc_v, ap[kk], bdo, acc_v);
            wmma::load_matrix_sync(bq, sQ + kk * 16 * L::LDQ + n * 16, L::LDQ);
            wmma::mma_sync(acc_k, ads[kk], bq, acc_k);
          }
          wmma::store_matrix_sync(dvp, acc_v, L::LDO, wmma::mem_row_major);
          wmma::store_matrix_sync(dkp, acc_k, L::LDO, wmma::mem_row_major);
        }
      }
      __syncthreads();   // Q/dO/row stats are overwritten by the next tile
    }
  }
  __syncthreads();

  if (krow < kn) {
    const float* dkrow = sDK + krow * L::LDO + half * (D / 2);
    const float* dvrow = sDV + krow * L::LDO + half * (D / 2);
#pragma unroll 8
    for (int c = 0; c < D / 2; ++c) {
      dk[out_off + c] = __float2bfloat16(k_valid ? dkrow[c] : 0.f);
      dv[out_off + c] = __float2bfloat16(k_valid ? dvrow[c] : 0.f);
    }
  }
}

struct Strides {
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, d_sb, d_ss,
      d_sh;
};

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* lse, const void* dout,
                      const void* key_valid, const void* bidir, void* dq,
                      int B, int S, int H, int Hkv, const Strides& st,
                      int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = DqLayout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_bwd_dq_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(o),
      static_cast<const float*>(lse), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const uint8_t*>(key_valid), static_cast<const uint8_t*>(bidir),
      static_cast<__nv_bfloat16*>(dq), S, H, Hkv, st.q_sb, st.q_ss, st.q_sh,
      st.k_sb, st.k_ss, st.k_sh, st.v_sb, st.v_ss, st.v_sh, st.d_sb, st.d_ss,
      st.d_sh, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* o, const void* lse, const void* dout,
                       const void* key_valid, const void* bidir, void* dk,
                       void* dv, int B, int S, int H, int Hkv,
                       const Strides& st, int causal, float scale,
                       cudaStream_t stream) {
  constexpr size_t smem = DkvLayout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BK - 1) / BK, Hkv, B);
  flash_bwd_dkv_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(o),
      static_cast<const float*>(lse), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const uint8_t*>(key_valid), static_cast<const uint8_t*>(bidir),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), S, H,
      Hkv, st.q_sb, st.q_ss, st.q_sh, st.k_sb, st.k_ss, st.k_sh, st.v_sb,
      st.v_ss, st.v_sh, st.d_sb, st.d_ss, st.d_sh, causal, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch K2 on `stream`; returns the launch's cudaError_t (0 = success).
// Strides (in elements) are (batch, seq, head) of q, k, v and dO; the wrapper
// checks shapes, dtypes, contiguity and alignment.
int openvla_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, const void* key_valid,
    const void* bidir, void* dq, int B, int S, int H, int Hkv, int D,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long d_sb, long long d_ss, long long d_sh,
    int causal, float scale, void* stream) {
  const Strides st{q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                   v_sb, v_ss, v_sh, d_sb, d_ss, d_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return (int)launch_dq<64>(q, k, v, o, lse, dout, key_valid, bidir, dq, B,
                              S, H, Hkv, st, causal, scale, s);
  if (D == 128)
    return (int)launch_dq<128>(q, k, v, o, lse, dout, key_valid, bidir, dq, B,
                               S, H, Hkv, st, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

// Launch K3 on `stream`; arguments as for K2, with dk and dv (B,S,Hkv,D).
int openvla_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, const void* key_valid,
    const void* bidir, void* dk, void* dv, int B, int S, int H, int Hkv,
    int D, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long d_sb, long long d_ss, long long d_sh,
    int causal, float scale, void* stream) {
  const Strides st{q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                   v_sb, v_ss, v_sh, d_sb, d_ss, d_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return (int)launch_dkv<64>(q, k, v, o, lse, dout, key_valid, bidir, dk, dv,
                               B, S, H, Hkv, st, causal, scale, s);
  if (D == 128)
    return (int)launch_dkv<128>(q, k, v, o, lse, dout, key_valid, bidir, dk,
                                dv, B, S, H, Hkv, st, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
