// K4 on Hopper: fused LayerNorm standardization + matmul + bias + activation.
//
// Replaces the TPU kernel openvla_oft_tpu/ops/vit_fused.py::_kernel (:47),
// called by `ln_matmul` (:67):
//
//   y[i, j] = act( standardize(x[i, :]) @ w[:, j] + b[j] )
//
// standardize is LayerNorm without its affine (folded into w and b by
// models/vit.py::fuse_vit_inference_weights): row mean and E[x^2] in fp32,
// var = E[x^2] - mean^2, eps 1e-6, (x - mean) * 1/sqrt(var + eps) rounded to
// bf16 before the product. The product accumulates in fp32 on the bf16
// tensor cores; the epilogue adds the bias and applies the activation in
// fp32 (none; gelu with erff; gelu_tanh in the exp form 1 - 2/(e^{2z}+1);
// quick_gelu x * sigmoid(1.702 x)) and rounds once to bf16. The plain
// version is ops/vit_fused.py::ln_matmul_ref.
//
// x (M, D) bf16 contiguous, w (D, N) bf16 read through its row stride (a
// layer or column view of a stacked kernel), b (N) bf16 or null, y (M, N)
// bf16. The ViT shapes are ragged: M = 783, 768 (ALOHA), 522, 512 (LIBERO);
// N = 4304 (SigLIP fc1) is no multiple of the 128-wide column tile; every
// edge is guarded, and D need not be a multiple of the depth step.
//
// Design. One CTA computes a 64 x 128 tile of y with 8 warps (2 x 4), each a
// 32 x 32 block of 2 x 2 wmma bf16 m16n16k16 fragments with fp32
// accumulators. First each warp computes the statistics of 8 of the CTA's
// 64 rows (one warp per row, a shuffle reduction). Then the CTA walks D in
// 64-deep steps: it loads the x tile, standardizes it with the row
// statistics and rounds it to bf16 into shared memory, loads the w tile, and
// runs the products. The epilogue goes through shared memory (over the
// staging tiles) to the bias, the activation and the bounded store.
//
// Bound. At the ViT shapes the kernel is bound by operations, not bytes: a
// DINOv2 fc1 at M = 783 is 6.6 GFLOP against 16.4 MB (6.6 us at 989
// TFLOP/s, 4.9 us at 3.35 TB/s). As in the TPU grid, x is re-read and
// re-standardized for every column block (24-34 times per launch); keeping
// the standardized rows once per row block, wgmma and TMA with a ring of
// staged tiles are later work.

#include "wmma_tiles.cuh"

using namespace tiles;

namespace {

constexpr int NWARPS = NTHREADS / 32;
constexpr int SMEM = SMEM_AB > SMEM_C ? SMEM_AB : SMEM_C;

enum Act { ACT_NONE = 0, ACT_GELU = 1, ACT_GELU_TANH = 2, ACT_QUICK_GELU = 3 };

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case ACT_GELU:
      return v * 0.5f * (1.f + erff(v / 1.4142135623730951f));
    case ACT_GELU_TANH: {
      const float z = 0.7978845608028654f * (v + 0.044715f * v * v * v);
      return 0.5f * v * (1.f + (1.f - 2.f / (expf(2.f * z) + 1.f)));
    }
    case ACT_QUICK_GELU:
      return v * (1.f / (1.f + expf(-1.702f * v)));
    default:
      return v;
  }
}

__global__ void __launch_bounds__(NTHREADS)
ln_matmul_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                 const __nv_bfloat16* __restrict__ b, __nv_bfloat16* __restrict__ out, int M,
                 int D, int N, long long ldw, int act, float eps, int vec8, int wvec8) {
  __shared__ __align__(128) unsigned char smem[SMEM];
  __shared__ float s_mean[BM], s_rstd[BM];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + BM * LDA;
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  // Row statistics in fp32: one warp per row.
  for (int r = warp; r < BM; r += NWARPS) {
    const int m = m0 + r;
    float s = 0.f, ss = 0.f;
    if (m < M) {
      const __nv_bfloat16* row = x + (long long)m * D;
      if (vec8) {
        for (int k = 8 * lane; k < D; k += 8 * 32) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + k));
          const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float f = __bfloat162float(e[j]);
            s += f;
            ss += f * f;
          }
        }
      } else {
        for (int k = lane; k < D; k += 32) {
          const float f = __bfloat162float(row[k]);
          s += f;
          ss += f * f;
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o /= 2) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    }
    if (lane == 0) {
      const float mean = s / (float)D;
      const float var = ss / (float)D - mean * mean;
      s_mean[r] = mean;
      s_rstd[r] = 1.f / sqrtf(var + eps);
    }
  }
  __syncthreads();

  Acc acc[2][2];
  zero_acc(acc);

  for (int k0 = 0; k0 < D; k0 += BK) {
    // x tile (BM x BK), standardized and rounded to bf16; zeros outside (M, D).
    if (vec8) {
      for (int c = tid; c < BM * (BK / 8); c += NTHREADS) {
        const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
        const int m = m0 + r, k = k0 + kc;
        uint4 o = make_uint4(0u, 0u, 0u, 0u);
        if (m < M && k < D) {   // D % 8 == 0: the chunk is wholly inside
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(x + (long long)m * D + k));
          const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
          __nv_bfloat16* oe = reinterpret_cast<__nv_bfloat16*>(&o);
          const float mean = s_mean[r], rstd = s_rstd[r];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            oe[j] = __float2bfloat16_rn((__bfloat162float(e[j]) - mean) * rstd);
        }
        *reinterpret_cast<uint4*>(As + r * LDA + kc) = o;
      }
    } else {
      for (int e = tid; e < BM * BK; e += NTHREADS) {
        const int r = e / BK, kk = e % BK;
        const int m = m0 + r, k = k0 + kk;
        As[r * LDA + kk] =
            (m < M && k < D)
                ? __float2bfloat16_rn((__bfloat162float(x[(long long)m * D + k]) - s_mean[r]) *
                                      s_rstd[r])
                : zero;
      }
    }
    // w tile (BK x BN) through w's row stride; zeros outside (D, N).
    if (wvec8) {
      for (int c = tid; c < BK * (BN / 8); c += NTHREADS) {
        const int i = c / (BN / 8), nc = (c % (BN / 8)) * 8;
        const int k = k0 + i, n = n0 + nc;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);   // N % 8 == 0: wholly inside or outside
        if (k < D && n < N) v = __ldg(reinterpret_cast<const uint4*>(w + k * ldw + n));
        *reinterpret_cast<uint4*>(Bs + i * LDB + nc) = v;
      }
    } else {
      for (int e = tid; e < BK * BN; e += NTHREADS) {
        const int i = e / BN, c = e % BN;
        const int k = k0 + i, n = n0 + c;
        Bs[i * LDB + c] = (k < D && n < N) ? w[k * ldw + n] : zero;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) mma_k16(acc, As, Bs, wm, wn, kk);
    __syncthreads();
  }

  // Epilogue: fragments -> shared (over the staging tiles) -> bias,
  // activation, one rounding, bounded store.
  store_acc(acc, Cs, wm, wn);
  __syncthreads();
  const int c = tid % BN, n = n0 + c;
  if (n >= N) return;
  const float bias = b != nullptr ? __bfloat162float(b[n]) : 0.f;
  for (int r = tid / BN; r < BM; r += NTHREADS / BN) {
    const int m = m0 + r;
    if (m < M) out[(long long)m * N + n] = __float2bfloat16_rn(activate(Cs[r * LDC + c] + bias, act));
  }
}

}  // namespace

extern "C" {

// Launch K4 on `stream`; returns the launch's cudaError_t (0 = success).
// ldw: row stride of w in elements (its columns are contiguous). act: 0
// none, 1 gelu, 2 gelu_tanh, 3 quick_gelu. vec8: x rows may be read as
// 16-byte chunks; wvec8: w rows too. The wrapper checks dtypes and shapes.
int openvla_ln_matmul(const void* x, const void* w, const void* b, void* out, int M, int D,
                      int N, long long ldw, int act, float eps, int vec8, int wvec8,
                      void* stream) {
  if (M <= 0 || N <= 0 || D <= 0 || act < ACT_NONE || act > ACT_QUICK_GELU ||
      (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  ln_matmul_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(out), M, D, N, ldw, act,
      eps, vec8, wvec8);
  return (int)cudaGetLastError();
}

}  // extern "C"
