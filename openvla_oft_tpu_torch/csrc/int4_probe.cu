// The K5 timing probe on Hopper: the wmma tile walk of the first K5 with its
// dequant step varied.
//
// Replaces the TPU kernel vla_scripts/exp_int4_probe.py::_kernel_probe (:53),
// called by `_probe_call` (:103). It splits that walk's time into its parts
// by taking one part away at a time; the plain versions are in
// ops/int4_probe.py. K5 itself is now the wgmma kernel of int4_w4a16.cu,
// which the probe script times as its "fused" column. One kernel, templated
// on the mode:
//   no-scale   (0): y = sum_k x[t, k] * nibble(k, n)            (no scale;
//                   WRONG NUMBERS by design: the scale multiply's cost)
//   no-unpack  (1): y = sum_i (x[t, 2i] + x[t, 2i+1]) * byte(i, n)
//                   (the raw byte as a number; WRONG NUMBERS by design: the
//                   nibble unpack's cost)
//   group-dots (2): y = sum_g (sum_{k in g} x[t, k] * nibble(k, n)) * scales[g, n]
//                   (a correct W4A16: the group scale multiplies the fp32
//                   partial of each group instead of every weight element)
// x (T, K) bf16 contiguous, packed (K/2, N) int8 and scales (G, N) fp32 read
// through their row strides, y (T, N) fp32. Byte i gives weight rows 2i and
// 2i+1, as in K5: the TPU wrapper's split of x into even and odd halves exists
// only because Mosaic cannot relayout, and is not carried over.
//
// Design. no-scale and no-unpack are the walk with the weight tile built from the
// unscaled nibbles or from the raw bytes. group-dots also stages unscaled
// nibbles; after each group's last 16-deep product every warp stores its
// 32 x 32 block of partials to its own region of shared memory, and each
// lane scales its column of them into 32 fp32 accumulators held in
// registers (in group order, no fused multiply-add); the accumulators go to
// y at the end. Its groups must be multiples of 16 deep.
//
// Bound. As K5: operations at T = 618, near balance at the probe's T = 112
// (a 4096 x 12288 weight is 25 MB of int4 and 11 GFLOP at T = 112: 7.5 us of
// bytes, 11.4 us of bf16 tensor-core time).

#include "int4_tiles.cuh"

using namespace tiles;

namespace {

enum Mode { NO_SCALE = 0, NO_UNPACK = 1, GROUP_DOTS = 2 };

constexpr int SMEM_PLAIN = SMEM_AB > SMEM_C ? SMEM_AB : SMEM_C;
constexpr int SMEM_GROUP = SMEM_AB + SMEM_C;   // partials beside the staging tiles
constexpr int LANE_ROWS = 32;                  // group-dots rows per lane

template <int MODE>
__global__ void __launch_bounds__(NTHREADS)
int4_probe_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ packed,
                  const float* __restrict__ scales, float* __restrict__ out, int T, int K, int N,
                  int group, long long ldp, long long lds, int vec8, int vec4) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + BM * LDA;
  // no-scale, no-unpack: the epilogue tile over the staging tiles, as in K5;
  // group-dots: the partials beside them.
  float* Cs = reinterpret_cast<float*>(smem + (MODE == GROUP_DOTS ? SMEM_AB : 0));

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int n_lane = n0 + 32 * wn + lane;   // group-dots: this lane's column

  Acc acc[2][2];
  zero_acc(acc);
  float sum[LANE_ROWS];
#pragma unroll
  for (int r = 0; r < LANE_ROWS; ++r) sum[r] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    stage_x(x, As, T, K, m0, k0, vec8);
    for_packed_bytes(packed, ldp, K / 2, N, k0 / 2, n0, BK / 2, vec4 != 0,
                     [&](int i, int c, int b) {
                       float lo, hi;
                       if (MODE == NO_UNPACK) {
                         lo = hi = (float)b;
                       } else {
                         lo = (float)low_nibble(b);
                         hi = (float)high_nibble(b);
                       }
                       Bs[(2 * i) * LDB + c] = __float2bfloat16_rn(lo);
                       Bs[(2 * i + 1) * LDB + c] = __float2bfloat16_rn(hi);
                     });
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      mma_k16(acc, As, Bs, wm, wn, kk);
      const int k_end = k0 + kk + 16;
      if (MODE == GROUP_DOTS && k_end <= K && k_end % group == 0) {
        // The group ends here: its partials, scaled, into the accumulators.
        store_acc(acc, Cs, wm, wn);
        __syncwarp();
        const float s =
            n_lane < N ? __ldg(scales + (long long)(k_end / group - 1) * lds + n_lane) : 0.f;
        const float* part = Cs + (32 * wm) * LDC + 32 * wn + lane;
#pragma unroll
        for (int r = 0; r < LANE_ROWS; ++r)
          sum[r] = __fadd_rn(sum[r], __fmul_rn(part[r * LDC], s));
        __syncwarp();
        zero_acc(acc);
      }
    }
    __syncthreads();
  }

  if (MODE == GROUP_DOTS) {
    if (n_lane < N) {
#pragma unroll
      for (int r = 0; r < LANE_ROWS; ++r) {
        const int m = m0 + 32 * wm + r;
        if (m < T) out[(long long)m * N + n_lane] = sum[r];
      }
    }
  } else {
    store_acc(acc, Cs, wm, wn);
    __syncthreads();
    write_tile(Cs, out, T, N, m0, n0);
  }
}

template <int MODE>
int launch(const void* x, const void* packed, const void* scales, void* out, int T, int K, int N,
           int group, long long ldp, long long lds, int vec8, int vec4, cudaStream_t stream) {
  const int smem = MODE == GROUP_DOTS ? SMEM_GROUP : SMEM_PLAIN;
  cudaError_t err = cudaFuncSetAttribute(int4_probe_kernel<MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + BN - 1) / BN, (T + BM - 1) / BM);
  int4_probe_kernel<MODE><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(packed),
      static_cast<const float*>(scales), static_cast<float*>(out), T, K, N, group, ldp, lds, vec8,
      vec4);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the probe in `mode` (0 no-scale, 1 no-unpack, 2 group-dots) on
// `stream`; returns the launch's cudaError_t (0 = success). Operands as K5's
// (openvla_int4_matmul_w4a16); group-dots takes groups that are multiples
// of 16.
int openvla_int4_probe(const void* x, const void* packed, const void* scales, void* out, int T,
                       int K, int N, int group, long long ldp, long long lds, int mode, int vec8,
                       int vec4, void* stream) {
  if (T <= 0 || N <= 0 || K <= 0 || K % 2 || group <= 0 || group % 2 || K % group ||
      (mode == GROUP_DOTS && group % 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case NO_SCALE:
      return launch<NO_SCALE>(x, packed, scales, out, T, K, N, group, ldp, lds, vec8, vec4, s);
    case NO_UNPACK:
      return launch<NO_UNPACK>(x, packed, scales, out, T, K, N, group, ldp, lds, vec8, vec4, s);
    case GROUP_DOTS:
      return launch<GROUP_DOTS>(x, packed, scales, out, T, K, N, group, ldp, lds, vec8, vec4, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
