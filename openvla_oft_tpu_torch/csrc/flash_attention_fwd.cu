// K1 on Hopper: flash-attention forward with the OFT block-bidirectional mask.
//
// Replaces the TPU kernel openvla_oft_tpu/ops/flash_attention.py::_kernel
// (launched by _fwd_pallas). Same function, not the same block structure:
//
//   allow[i, j] = (j <= i  AND  valid[j])  OR  (bidir[i] AND bidir[j] AND valid[j])
//   (without `causal` the first term is just valid[j])
//   O[i]  = sum_j softmax_j(q_i . k_j * D^-1/2 over allowed j) v_j   (0 if no j allowed)
//   LSE[i] = m_i + log(max(l_i, 1e-30)),  m_i = -1e30 for a row with no allowed key
//
// q (B,S,H,D), k/v (B,S,Hkv,D) bf16, read through their strides (the last
// dim must be contiguous), so slices of the fused wqkv projection need no
// copy; GQA maps query head h to kv head h / (H/Hkv). O is (B,S,H,D) bf16,
// LSE (B,H,S) fp32. Scores and softmax are fp32; probabilities are rounded to
// bf16 before the P.V product, as the TPU kernel's p.astype(v.dtype) does.
//
// Design. The TPU kernel keeps the whole key range of one (batch, head) in
// VMEM and takes one softmax pass. At S=1168, D=128 K and V alone are 598 KB,
// far above the 227 KB of shared memory a block may use, so this kernel
// streams 64-row key tiles with an online softmax (running max, sum and
// accumulator in fp32). One CTA owns one (b, h, 64-row query tile); each of
// its 4 warps owns 16 query rows. Both products run on the tensor cores
// through nvcuda::wmma (bf16 in, fp32 accumulate). The score tile and the
// output accumulator live in shared memory, where two lanes per row apply the
// mask, the online-softmax update and the rescale.
//
// Tile skipping (oft_mask.cuh, shared with K2/K3). Under `causal`, a key
// tile wholly above the diagonal is skipped only when no bidirectional query
// row of the query tile can reach a bidirectional key in it: the action
// window's rows attend FORWARD into the window, so a plain causal skip would
// drop them. Tiles with no valid key are skipped too (they contribute nothing).
//
// Bound. At the LIBERO prefill (S=618, H=32, D=128) one layer is about
// 6.3 GFLOP against about 10 MB of q/k/v/o, so the op is compute-bound once
// it runs on the tensor cores. This first version leaves for later: wgmma
// and TMA, a ring of K/V tiles with cp.async overlap, keeping the score and
// output tiles in registers (mma.sync fragment layouts) instead of shared
// memory, and warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "oft_mask.cuh"

using namespace nvcuda;

namespace {

using oft::BK;
using oft::BQ;
using oft::NEG_INF;
using oft::NTHREADS;

template <int D>
struct Layout {
  // Row strides are padded to spread shared-memory banks; every wmma pointer
  // stays 32-byte aligned (16-row offsets are multiples of 32 bytes).
  static constexpr int LDQ = D + 8;    // bf16 Q/K/V tiles
  static constexpr int LDS = BK + 4;   // fp32 score tile
  static constexpr int LDP = BK + 8;   // bf16 probability tile
  static constexpr int LDO = D + 4;    // fp32 output accumulator
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + size_t(BQ) * LDQ * 2;
  static constexpr size_t v_off = k_off + size_t(BK) * LDQ * 2;
  static constexpr size_t s_off = v_off + size_t(BK) * LDQ * 2;
  static constexpr size_t p_off = s_off + size_t(BQ) * LDS * 4;
  static constexpr size_t o_off = p_off + size_t(BQ) * LDP * 2;
  static constexpr size_t flag_off = o_off + size_t(BQ) * LDO * 4;
  static constexpr size_t bytes = flag_off + 2 * BK;
};

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const uint8_t* __restrict__ key_valid,
                 const uint8_t* __restrict__ bidir,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int S, int H, int Hkv,
                 long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh,
                 int causal, float scale) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + L::q_off);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + L::k_off);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + L::v_off);
  float* sS = reinterpret_cast<float*>(smem + L::s_off);
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(smem + L::p_off);
  float* sO = reinterpret_cast<float*>(smem + L::o_off);
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

  oft::load_tile<D, L::LDQ>(sQ, q + b * q_sb + (long long)q0 * q_ss + h * q_sh,
                            q_ss, min(BQ, S - q0));
  for (int i = tid; i < BQ * L::LDO; i += NTHREADS) sO[i] = 0.f;

  const int q_hi = min(q0 + BQ, S) - 1;
  const int q_bid_any =
      __syncthreads_or(tid < BQ && q0 + tid < S && bidir_b[q0 + tid] != 0);

  // Lanes 2r and 2r+1 of a warp own row r of its 16 (32 score columns each);
  // both keep the row's running max m and sum l.
  const int r = lane >> 1, half = lane & 1;
  const int row = warp * 16 + r;
  const int qi = q0 + row;
  const bool q_live = qi < S;
  const bool q_bid = q_live && bidir_b[qi] != 0;
  float m = NEG_INF, l = 0.f;

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

    // Scores of this warp's 16 rows: (16 x D) . (D x 64), fp32 accumulate.
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
#pragma unroll
      for (int n = 0; n < BK / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::load_matrix_sync(a, sQ + warp * 16 * L::LDQ + kk * 16, L::LDQ);
#pragma unroll
        for (int n = 0; n < BK / 16; ++n) {
          // col_major B: B[d][key] = sK[key * LDQ + d], i.e. K transposed.
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> bk;
          wmma::load_matrix_sync(bk, sK + n * 16 * L::LDQ + kk * 16, L::LDQ);
          wmma::mma_sync(acc[n], a, bk, acc[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < BK / 16; ++n)
        wmma::store_matrix_sync(sS + warp * 16 * L::LDS + n * 16, acc[n],
                                L::LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // Mask, online-softmax update, bf16 probabilities, rescale of O.
    {
      const float* srow = sS + row * L::LDS + half * 32;
      float sv[32];
      unsigned allow_bits = 0u;
      float tile_max = NEG_INF;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const int jj = half * 32 + c;
        const int j = k0 + jj;
        const bool allow =
            q_live && oft::allow(causal, qi, j, sValid[jj], q_bid, sBid[jj]);
        sv[c] = srow[c] * scale;
        if (allow) {
          allow_bits |= 1u << c;
          tile_max = fmaxf(tile_max, sv[c]);
        }
      }
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
      const float m_new = fmaxf(m, tile_max);
      const float alpha = expf(m - m_new);
      float sum = 0.f;
      __nv_bfloat16* prow = sP + row * L::LDP + half * 32;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const float p = (allow_bits >> c) & 1u ? expf(sv[c] - m_new) : 0.f;
        sum += p;
        prow[c] = __float2bfloat16(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      l = alpha * l + sum;
      m = m_new;
      float* orow = sO + row * L::LDO + half * (D / 2);
#pragma unroll 8
      for (int c = 0; c < D / 2; ++c) orow[c] *= alpha;
    }
    __syncwarp();

    // O(16 x D) += P(16 x 64) . V(64 x D).
    {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> pa[BK / 16];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wmma::load_matrix_sync(pa[kk], sP + warp * 16 * L::LDP + kk * 16,
                               L::LDP);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        float* optr = sO + warp * 16 * L::LDO + n * 16;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::load_matrix_sync(acc, optr, L::LDO, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> bv;
          wmma::load_matrix_sync(bv, sV + kk * 16 * L::LDQ + n * 16, L::LDQ);
          wmma::mma_sync(acc, pa[kk], bv, acc);
        }
        wmma::store_matrix_sync(optr, acc, L::LDO, wmma::mem_row_major);
      }
    }
    __syncthreads();   // K/V/flags are overwritten by the next tile
  }
  __syncthreads();

  if (q_live) {
    const float denom = fmaxf(l, 1e-30f);
    const float* orow = sO + row * L::LDO + half * (D / 2);
    __nv_bfloat16* out = o + (((long long)b * S + qi) * H + h) * D + half * (D / 2);
#pragma unroll 8
    for (int c = 0; c < D / 2; ++c) out[c] = __float2bfloat16(orow[c] / denom);
    if (half == 0) lse[((long long)b * H + h) * S + qi] = m + logf(denom);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* key_valid, const void* bidir, void* o, void* lse,
                   int B, int S, int H, int Hkv,
                   long long q_sb, long long q_ss, long long q_sh,
                   long long k_sb, long long k_ss, long long k_sh,
                   long long v_sb, long long v_ss, long long v_sh,
                   int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(key_valid),
      static_cast<const uint8_t*>(bidir), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), S, H, Hkv, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
      v_sb, v_ss, v_sh, causal, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch K1 on `stream`; returns the launch's cudaError_t (0 = success).
// Strides are in elements; the wrapper checks shapes, dtypes and alignment.
int openvla_flash_attention_fwd(const void* q, const void* k, const void* v,
                                const void* key_valid, const void* bidir,
                                void* o, void* lse, int B, int S, int H,
                                int Hkv, int D,
                                long long q_sb, long long q_ss, long long q_sh,
                                long long k_sb, long long k_ss, long long k_sh,
                                long long v_sb, long long v_ss, long long v_sh,
                                int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return (int)launch<64>(q, k, v, key_valid, bidir, o, lse, B, S, H, Hkv,
                           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                           causal, scale, st);
  if (D == 128)
    return (int)launch<128>(q, k, v, key_valid, bidir, o, lse, B, S, H, Hkv,
                            q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                            v_sh, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

const char* openvla_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
