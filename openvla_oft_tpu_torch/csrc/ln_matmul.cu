// K4 on Hopper: fused LayerNorm standardization + matmul + bias + activation.
//
// Replaces the TPU kernel openvla_oft_tpu/ops/vit_fused.py::_kernel (:47),
// called by `ln_matmul` (:67):
//
//   y[i, j] = act( bf16((x[i, :] - mean_i) * rsqrt(E[x^2]_i - mean_i^2 + eps)) @ w[:, j] + b[j] )
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
// x (M, D) bf16 with row stride ldx, w (D, N) bf16 with row stride ldw (a
// layer or column view of a stacked kernel needs no copy), b (N) bf16 or
// null, y (M, N) bf16 contiguous. Both strides are multiples of 16 bytes and
// both bases 16-byte aligned (the TMA copies need it; the wrapper pads a
// copy of any operand that is not). The ViT shapes are ragged: M = 783, 768
// (ALOHA), 522, 512 (LIBERO); N = 4304 (SigLIP fc1) is no multiple of any
// column tile; TMA fills rows and columns past M, D and N with zeros, and
// the stores are bounded.
//
// Bound. At the ViT shapes the kernel is bound by operations, not bytes: a
// DINOv2 fc1 at M = 783 is 6.6 GFLOP against 16.4 MB (6.6 us at 989
// TFLOP/s, 4.9 us at 3.35 TB/s). What holds it back on the card is measured
// by scripts/exp_k4_parts.py (PERF.md): the ring of copies through L2 sets
// its floor.
//
// Design. A CTA computes a BM x BN tile of y: BM 64 or 128 rows (one consumer
// warpgroup per 64), BN 128, 192 or 256 columns; the plan
// ops/vit_fused.py::_k4_plan picks the tile per launch, one compiled
// instance each. Beside the consumers, a loading warpgroup (setmaxnreg gives
// its registers to the consumers):
//  - Its first thread keeps a ring of STAGES stages of 64 k filled by TMA:
//    x's BM rows raw (one 128-byte row each, K-major, 128-byte swizzle) and
//    w's 64 k x BN columns as BN / 64 boxes of 64 k rows x 64 columns
//    (MN-major, 128-byte swizzle), read through w's row stride. It issues a
//    stage as soon as the consumers release its slot.
//  - The row statistics are computed once per CTA, in its prologue, by every
//    warp (four rows at a time, fp32 sums of 16-byte loads) while the first
//    stages land, with the bias of the CTA's columns.
//  - Each consumer thread holds the statistics of its two fragment rows. Per
//    stage it reads its A fragments of raw x with ldmatrix (the swizzle gives
//    the chunk of each k16 step), standardizes them in registers, (x - mean)
//    * rstd rounded to bf16 (zeros past D: standardizing TMA's zero fill
//    would give -mean * rstd), and issues wgmma m64nBNk16 with A from those
//    registers and B = w from shared memory (MN-major, mn_sw128_desc, read
//    with the transpose bit). A stage's A is prepared while the previous
//    stage's wgmmas run (two register sets), and each element of x is
//    standardized once per CTA.
//    Why registers: K5's register-A wgmma did not overlap its dequant
//    (PERF.md), which argues for standardizing in place in shared memory and
//    a wgmma with both operands there. Here the register work is 4
//    operations per element, and the in-place variants pay a proxy fence
//    and a barrier per stage: on the card they measured slower (the parts
//    script's smem-std and loader-std variants, PERF.md).
//  - The epilogue adds the bias and applies the activation in fp32 on the
//    accumulator fragments (erf by the TPU kernel's own A&S 7.1.26, branch
//    free), rounds once and stores bf16 pairs, rows and columns bounded.
//  mbarriers: full (TMA landed), empty (consumers done); ready (standardized)
//  in the loader-std variant only.
//
// Built with -DK4_PARTS, the file also holds the variants that
// scripts/exp_k4_parts.py times at one tile (the `Part` flags).

#include <cuda_bf16.h>

#include "hopper_ptx.cuh"

namespace {

using namespace hopper;

constexpr int BK = 64;                 // depth per stage: a 128-byte bf16 row
constexpr int W_BOX = 64 * 128;        // one box of w: 64 k rows x 64 columns (bytes)
constexpr int SMEM_LIMIT = 227 * 1024;
constexpr int MAX_STAGES = 6;
constexpr int STD_WARPS = 3;           // the loading warpgroup's warps 1-3

enum Act { ACT_NONE = 0, ACT_GELU = 1, ACT_GELU_TANH = 2, ACT_QUICK_GELU = 3 };

// What an instance does. K4 is SHIPPED; the other combinations are the parts
// script's variants (-DK4_PARTS).
enum Part {
  ROW_STATS = 1,     // the statistics in each CTA's prologue
  STATS_PASS = 2,    // the statistics from a separate pass, read from a workspace
  STANDARDIZE = 4,   // x standardized: in the consumers' A fragments, or as below
  PRODUCTS = 8,      // the wgmmas
  SMEM_STD = 16,     // the consumers standardize their rows in shared memory (SS wgmma)
  LOADER_STD = 32,   // the loading warpgroup's warps 1-3 do that, a barrier per stage
  STATS_2ROWS = 64   // the prologue's warps take 2 rows at a time, not 4
};
constexpr int SHIPPED = ROW_STATS | STANDARDIZE | PRODUCTS;

template <int BM, int BN>
struct Cfg {
  static_assert(BM == 64 || BM == 128, "BM is 64 or 128");
  static_assert(BN == 128 || BN == 192 || BN == 256, "BN is 128, 192 or 256");
  static constexpr int CONSUMERS = BM / 64 * 128;    // a warpgroup per 64 rows
  static constexpr int NTHREADS = CONSUMERS + 128;   // + the loading warpgroup
  static constexpr int X_BYTES = BM * 128;
  static constexpr int W_BYTES = BN / 64 * W_BOX;
  static constexpr int STAGE = X_BYTES + W_BYTES;
  static constexpr int FIT = (SMEM_LIMIT - 2048 - BM * 8) / STAGE;
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr int SMEM = 1024 + STAGES * STAGE + 3 * STAGES * 8;
  static_assert(STAGES >= 3, "ring of at least 3 stages");
};

struct Params {
  const __nv_bfloat16* x;   // (M, D), row stride ldx: the prologue's statistics
  const __nv_bfloat16* b;   // (N) or null
  const float2* stats;      // (M) {mean, rstd} from the statistics pass (STATS_PASS)
  __nv_bfloat16* out;       // (M, N)
  int M, D, N, row_blocks, act;
  long long ldx;
  float eps;
};

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xFFFF0000u); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The two bf16 of a word standardized, each rounded to bf16.
__device__ __forceinline__ uint32_t standardize2(uint32_t v, float mean, float rstd) {
  return pack_bf16((bf16_lo(v) - mean) * rstd, (bf16_hi(v) - mean) * rstd);
}

// Standardizes 16-byte chunk c of a stage's x tile in place: the chunk's
// tile row is c / 8 (`row`: its row in the CTA's block, for the statistics);
// TMA's 128-byte swizzle put its 8 columns at 8 ((c ^ (c / 8)) % 8) of the
// stage. Columns past D are written as zeros: TMA's zero fill, standardized,
// would be -mean * rstd.
__device__ __forceinline__ void standardize_chunk(uint4* tile, int c, int row, int k0,
                                                  const float2* stats, int D) {
  const int k = k0 + 8 * ((c ^ (c >> 3)) & 7);
  const float2 st = stats[row];
  uint4 v = tile[c];
  if (k + 8 <= D) {
    v.x = standardize2(v.x, st.x, st.y);
    v.y = standardize2(v.y, st.x, st.y);
    v.z = standardize2(v.z, st.x, st.y);
    v.w = standardize2(v.w, st.x, st.y);
  } else {
    uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      u[j] = pack_bf16(k + 2 * j < D ? (bf16_lo(u[j]) - st.x) * st.y : 0.f,
                       k + 2 * j + 1 < D ? (bf16_hi(u[j]) - st.x) * st.y : 0.f);
    v = make_uint4(u[0], u[1], u[2], u[3]);
  }
  tile[c] = v;
}

// Adds the bf16 values of a 16-byte chunk at columns k .. k + 7 to the row's
// fp32 sums, skipping columns past D (the padding of a row whose stride the
// wrapper rounded up).
__device__ __forceinline__ void add_chunk(const uint4& v, int k, int D, float& s, float& ss) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float lo = k + 2 * j < D ? bf16_lo(u[j]) : 0.f;
    const float hi = k + 2 * j + 1 < D ? bf16_hi(u[j]) : 0.f;
    s += lo + hi;
    ss += lo * lo + hi * hi;
  }
}

__device__ __forceinline__ float2 finish_stats(float s, float ss, int D, float eps) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  const float mean = s / (float)D;
  const float var = ss / (float)D - mean * mean;
  return make_float2(mean, 1.f / sqrtf(var + eps));
}

// {mean, 1 / sqrt(var + eps)} of R rows (16-byte aligned; a null row is
// skipped) by one warp: fp32 sums, var = E[x^2] - mean^2. R rows at once keep
// R times the loads in flight.
template <int R>
__device__ __forceinline__ void row_stats(const __nv_bfloat16* const (&rows)[R], int D,
                                          float eps, int lane, float2 (&st)[R]) {
  float s[R], ss[R];
#pragma unroll
  for (int r = 0; r < R; ++r) s[r] = ss[r] = 0.f;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll 2
  for (int k = 8 * lane; k < D; k += 256) {
    uint4 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      v[r] = rows[r] != nullptr ? __ldg(reinterpret_cast<const uint4*>(rows[r] + k)) : zero;
#pragma unroll
    for (int r = 0; r < R; ++r) add_chunk(v[r], k, D, s[r], ss[r]);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) st[r] = finish_stats(s[r], ss[r], D, eps);
}

// erf by Abramowitz-Stegun 7.1.26, |error| < 1.5e-7 (the TPU kernel's own
// _erf), branch-free: erff's branches diverge within a warp, and this
// epilogue has no other work to hide them behind.
__device__ __forceinline__ float erf_as(float x) {
  const float ax = fabsf(x);
  const float t = __fdividef(1.f, fmaf(0.3275911f, ax, 1.f));
  const float poly =
      t * fmaf(t, fmaf(t, fmaf(t, fmaf(t, 1.061405429f, -1.453152027f), 1.421413741f),
                       -0.284496736f),
               0.254829592f);
  return copysignf(1.f - poly * __expf(-ax * ax), x);
}

// The activations in fp32 (fast exp and reciprocal: their errors are far
// below the one bf16 rounding that follows).
template <int ACT>
__device__ __forceinline__ float activate(float v) {
  if (ACT == ACT_GELU) return v * 0.5f * (1.f + erf_as(v * 0.7071067811865476f));
  if (ACT == ACT_GELU_TANH) {
    const float z = 0.7978845608028654f * (v + 0.044715f * v * v * v);
    return 0.5f * v * (1.f + (1.f - __fdividef(2.f, __expf(2.f * z) + 1.f)));
  }
  if (ACT == ACT_QUICK_GELU) return v * __fdividef(1.f, 1.f + __expf(-1.702f * v));
  return v;
}

// D (64 x N, fp32) += A (64 x 16, bf16, K-major in shared memory) * B (16 x N,
// bf16, MN-major in shared memory, the transpose bit set): one wgmma
// m64nNk16 per call (the parts script's shared-memory variants).
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate);

#ifdef K4_PARTS
template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t desc_a,
                                            uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<192>(float (&d)[96], uint64_t desc_a,
                                            uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 1;\n}"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<256>(float (&d)[128], uint64_t desc_a,
                                            uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}
#endif  // K4_PARTS

// D (64 x N, fp32) += A (64 x 16, bf16, registers) * B (16 x N, bf16,
// MN-major in shared memory, the transpose bit set).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<192>(float (&d)[96], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}


// Keeps a[] in its registers up to this point: an in-flight wgmma may still
// read them, so nothing else may be allocated there before its wait.
__device__ __forceinline__ void hold(uint32_t (&a)[4]) {
  asm volatile("" : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3])::"memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The consumer thread's fragment of y: bias (from shared memory), activation,
// one rounding, bf16 pairs. Accumulator v of an m64nBN fragment sits in row
// m + 8 ((v >> 1) & 1), column n + 8 (v >> 2) + (v & 1); c0 = n - n0. All
// activations first, then the stores: independent chains the compiler can
// interleave.
template <int BN, int ACT>
__device__ __forceinline__ void store_tile(float (&acc)[BN / 2], const float* bias,
                                           const Params& p, int m, int n, int c0) {
#pragma unroll
  for (int v = 0; v < BN / 2; ++v)
    acc[v] = activate<ACT>(acc[v] + bias[c0 + 8 * (v >> 2) + (v & 1)]);
  const bool pairs = (p.N & 1) == 0;   // then every (row, even column) pair is 4-byte aligned
#pragma unroll
  for (int c = 0; c < BN / 8; ++c) {
    const int col = n + 8 * c;
    if (col >= p.N) continue;
    const bool two = col + 1 < p.N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m + 8 * h;
      if (row >= p.M) continue;
      const float y0 = acc[4 * c + 2 * h], y1 = acc[4 * c + 2 * h + 1];
      __nv_bfloat16* dst = p.out + (long long)row * p.N + col;
      if (two && pairs) {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(y0, y1);
      } else {
        dst[0] = __float2bfloat16_rn(y0);
        if (two) dst[1] = __float2bfloat16_rn(y1);
      }
    }
  }
}

// --- the kernel ----------------------------------------------------------------

template <int BM, int BN, int V>
__global__ void __launch_bounds__(Cfg<BM, BN>::NTHREADS, 1)
ln_matmul_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap wmap, const Params p) {
  using C = Cfg<BM, BN>;
  constexpr int STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* xs = smem;                                   // [STAGES][BM rows][128 B]
  uint8_t* ws = xs + STAGES * C::X_BYTES;               // [STAGES][BN / 64][64 k][128 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(ws + STAGES * C::W_BYTES);
  uint64_t* ready = full + STAGES;
  uint64_t* empty = ready + STAGES;
  __shared__ float2 s_stats[BM];                        // {mean, rstd} of the CTA's rows
  __shared__ float s_bias[BN];                          // the CTA's columns' bias, fp32

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = (blockIdx.x % p.row_blocks) * BM, n0 = (blockIdx.x / p.row_blocks) * BN;
  const int nkb = (p.D + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(full + s), 1);                 // expect_tx by the producer
      mbar_init(smem_u32(ready + s), STD_WARPS);        // one per standardizing warp
      mbar_init(smem_u32(empty + s), C::CONSUMERS / 32);   // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Stage kb's copies: x's BM rows x 64 k, and w's 64 k x BN columns.
  auto issue = [&](int kb) {
    const int s = kb % STAGES;
    const uint32_t bar = smem_u32(full + s);
    mbar_expect_tx(bar, C::STAGE);
    tma_load_2d(smem_u32(xs + s * C::X_BYTES), &xmap, bar, kb * BK, m0);
#pragma unroll
    for (int i = 0; i < BN / 64; ++i)
      tma_load_2d(smem_u32(ws + s * C::W_BYTES + i * W_BOX), &wmap, bar, n0 + 64 * i, kb * BK);
  };
  const bool producer = tid == C::CONSUMERS;   // the loading warpgroup's first thread
  if (producer) {
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&xmap)) : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&wmap)) : "memory");
    for (int kb = 0; kb < nkb && kb < STAGES; ++kb) issue(kb);   // the slots start free
  }

  // The statistics of the CTA's rows, once, while the first stages land:
  // every warp, R rows at a time; and the bias of the CTA's columns.
  if (V & ROW_STATS) {
    constexpr int NW = C::NTHREADS / 32, R = V & STATS_2ROWS ? 2 : 4;
    for (int r0 = warp; r0 < BM; r0 += R * NW) {
      const __nv_bfloat16* rows[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = r0 + i * NW;
        rows[i] = r < BM && m0 + r < p.M ? p.x + (long long)(m0 + r) * p.ldx : nullptr;
      }
      float2 st[R];
      row_stats<R>(rows, p.D, p.eps, lane, st);
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < R; ++i)
          if (r0 + i * NW < BM)
            s_stats[r0 + i * NW] = rows[i] != nullptr ? st[i] : make_float2(0.f, 1.f);
      }
    }
  } else {
    for (int r = tid; r < BM; r += C::NTHREADS)
      s_stats[r] = (V & STATS_PASS) && m0 + r < p.M ? p.stats[m0 + r] : make_float2(0.f, 1.f);
  }
  for (int c = tid; c < BN; c += C::NTHREADS)
    s_bias[c] = p.b != nullptr && n0 + c < p.N ? __bfloat162float(p.b[n0 + c]) : 0.f;
  __syncthreads();

  // setmaxnreg, with two consumer warpgroups: they take exactly what the
  // loading warpgroup gives up of the 168 registers a thread of a 384-thread
  // block starts with (a larger request would wait forever). The loading
  // warpgroup needs registers only where it standardizes (LOADER_STD).
  constexpr int CREGS = V & LOADER_STD ? 216 : 232, LREGS = 168 - 2 * (CREGS - 168);
  static_assert(C::CONSUMERS == 128 || 256 * CREGS + 128 * LREGS == 384 * 168,
                "register split");
  if (tid >= C::CONSUMERS) {
    // ---- the loading warpgroup: its first thread copies ----
    if constexpr (C::CONSUMERS == 256)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(LREGS));
    const int lw = warp - C::CONSUMERS / 32;
    if (lw == 0) {
      if (!producer) return;
      // Each later stage as soon as the consumers have released its slot.
      for (int kb = STAGES; kb < nkb; ++kb) {
        mbar_wait(smem_u32(empty + kb % STAGES), ((kb / STAGES) & 1) ^ 1);
        issue(kb);
      }
      return;
    }
    if (!(V & LOADER_STD)) return;
    // LOADER_STD: warps 1-3 standardize each stage, then arrive on `ready`.
    const int st_tid = tid - C::CONSUMERS - 32;   // 0 .. 95
    for (int kb = 0; kb < nkb; ++kb) {
      const int s = kb % STAGES;
      mbar_wait(smem_u32(full + s), (kb / STAGES) & 1);
      if (V & STANDARDIZE) {
        uint4* tile = reinterpret_cast<uint4*>(xs + s * C::X_BYTES);
#pragma unroll 4
        for (int c = st_tid; c < BM * 8; c += 32 * STD_WARPS)
          standardize_chunk(tile, c, c >> 3, kb * BK, s_stats, p.D);
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");   // for wgmma's reads
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(ready + s));
    }
    return;
  }

  // ---- consumer warpgroups: 64 rows each ----
  if constexpr (C::CONSUMERS == 256)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CREGS));
  const int wg = warp / 4;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const uint32_t b_base = smem_u32(ws);
  // Stage kb's slot back to the producer.
  auto release = [&](int kb) {
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(empty + kb % STAGES));
  };
  if constexpr ((V & (SMEM_STD | LOADER_STD)) == 0) {
    // A from registers: each lane's ldmatrix reads raw x from the stage (row
    // lr of the warpgroup's 64, the 16-byte chunk 2j + lane / 16 of k16 step
    // j, found through the swizzle), and the thread standardizes its fragment:
    // registers 0 and 2 hold its row r_lo, 1 and 3 its row r_lo + 8, each two
    // columns, 2 (lane % 4) + {0, 1} (+ 8 for registers 2 and 3).
    const int r_lo = 16 * (warp % 4) + lane / 4;
    const float2 st_lo = s_stats[64 * wg + r_lo], st_hi = s_stats[64 * wg + r_lo + 8];
    const int lr = 16 * (warp % 4) + (lane & 7) + 8 * ((lane >> 3) & 1);
    const uint32_t a_row = smem_u32(xs) + (64 * wg + lr) * 128;
    uint32_t a[2][BK / 16][4] = {};
    auto load_a = [&](int kb, uint32_t (&f)[BK / 16][4]) {
      if (!(V & (STANDARDIZE | PRODUCTS))) return;   // the ring alone
      const uint32_t base = a_row + (kb % STAGES) * C::X_BYTES;
      const int k0 = kb * BK + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        ldmatrix_x4(base + ((((2 * j + (lane >> 4)) ^ lr) & 7) << 4), f[j]);
        if (!(V & STANDARDIZE)) continue;   // raw x; TMA's zeros past D
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 st = i & 1 ? st_hi : st_lo;
          const int k = k0 + 16 * j + 8 * (i >> 1);
          f[j][i] = kb * BK + BK <= p.D
                        ? standardize2(f[j][i], st.x, st.y)
                        : pack_bf16(k < p.D ? (bf16_lo(f[j][i]) - st.x) * st.y : 0.f,
                                    k + 1 < p.D ? (bf16_hi(f[j][i]) - st.x) * st.y : 0.f);
        }
      }
    };
    mbar_wait(smem_u32(full), 0);
    load_a(0, a[0]);
    // Stage kb, whose A is a[P]: its wgmmas as one group; once the previous
    // stage's group is done, that stage is released and the next stage's A
    // goes into a[P ^ 1]. P is kb % 2, a constant in each copy.
    for (int kb0 = 0; kb0 < nkb; kb0 += 2) {
#pragma unroll
      for (int P = 0; P < 2; ++P) {
        const int kb = kb0 + P;
        if (kb >= nkb) break;
        const int s = kb % STAGES;
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < BK / 16; ++j)
          if (V & PRODUCTS)
            wgmma_rs<BN>(acc, a[P][j],
                         mn_sw128_desc(b_base + s * C::W_BYTES + 2048 * j, W_BOX));
        wgmma_commit();
        wgmma_wait<1>();
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) hold(a[P ^ 1][j]);
        if (kb > 0) release(kb - 1);
        if (kb + 1 < nkb) {
          mbar_wait(smem_u32(full + (kb + 1) % STAGES), ((kb + 1) / STAGES) & 1);
          load_a(kb + 1, a[P ^ 1]);
        }
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      hold(a[0][j]);
      hold(a[1][j]);
    }
  } else {
    // SMEM_STD: each warpgroup standardizes its own 64 rows in place (while
    // its wgmmas of stage kb - 1 run), makes them visible to the async proxy
    // and waits for its 4 warps; then stage kb's wgmmas; once stage kb - 1's
    // are done, that stage's slot goes back to the producer.
    const int ct = tid % 128;
    uint4* const tiles = reinterpret_cast<uint4*>(xs) + wg * 64 * 8;
    const uint32_t a_base = smem_u32(xs) + wg * 64 * 128;
    for (int kb = 0; kb < nkb; ++kb) {
      const int s = kb % STAGES;
      if (V & LOADER_STD)
        mbar_wait(smem_u32(ready + s), (kb / STAGES) & 1);
      else
        mbar_wait(smem_u32(full + s), (kb / STAGES) & 1);
      if ((V & STANDARDIZE) && (V & SMEM_STD)) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = ct + 128 * i;   // chunk c of the warpgroup's 64 rows: row c / 8
          standardize_chunk(tiles + s * (C::X_BYTES / 16), c, 64 * wg + (c >> 3), kb * BK,
                            s_stats, p.D);
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");   // for wgmma's reads
        asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");     // all 64 rows are in
      }
      if (V & PRODUCTS) {
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < BK / 16; ++j)
          wgmma_ss<BN>(acc, sw128_desc(a_base + s * C::X_BYTES + 32 * j),
                       mn_sw128_desc(b_base + s * C::W_BYTES + 2048 * j, W_BOX), 1);
        wgmma_commit();
        wgmma_wait<1>();   // stage kb - 1's wgmmas are done
      }
      if (kb > 0) release(kb - 1);
    }
    wgmma_wait<0>();
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");

  const int m = m0 + 64 * wg + 16 * (warp % 4) + lane / 4, c0 = 2 * (lane % 4);
  switch (p.act) {
    case ACT_GELU: store_tile<BN, ACT_GELU>(acc, s_bias, p, m, n0 + c0, c0); break;
    case ACT_GELU_TANH: store_tile<BN, ACT_GELU_TANH>(acc, s_bias, p, m, n0 + c0, c0); break;
    case ACT_QUICK_GELU: store_tile<BN, ACT_QUICK_GELU>(acc, s_bias, p, m, n0 + c0, c0); break;
    default: store_tile<BN, ACT_NONE>(acc, s_bias, p, m, n0 + c0, c0);
  }
}

template <int BM, int BN, int V>
int launch(const void* x, const void* w, long long ldw, const Params& p, cudaStream_t stream) {
  using C = Cfg<BM, BN>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  // x (M, D): boxes of 64 k x BM rows. w (D, N): boxes of 64 columns x 64 k.
  CUtensorMap xmap, wmap;
  if (!encode_2d(encode, &xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, p.D, p.M,
                 (uint64_t)p.ldx * 2, BK, BM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_2d(encode, &wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w, p.N, p.D, (uint64_t)ldw * 2,
                 64, BK, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(ln_matmul_kernel<BM, BN, V>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int grid = p.row_blocks * ((p.N + BN - 1) / BN);
  ln_matmul_kernel<BM, BN, V><<<grid, C::NTHREADS, C::SMEM, stream>>>(xmap, wmap, p);
  return (int)cudaGetLastError();
}

// The checks and parameters shared by the entries; false if K4 cannot take them.
bool make_params(Params& p, const void* x, const void* w, const void* b, void* out, int M, int D,
                 int N, long long ldx, long long ldw, int act, float eps, int bm) {
  if (M <= 0 || N <= 0 || D <= 0 || act < ACT_NONE || act > ACT_QUICK_GELU || ldx < D ||
      ldw < N || ldx % 8 || ldw % 8 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return false;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.b = static_cast<const __nv_bfloat16*>(b);
  p.stats = nullptr;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.M = M;
  p.D = D;
  p.N = N;
  p.row_blocks = (M + bm - 1) / bm;
  p.act = act;
  p.ldx = ldx;
  p.eps = eps;
  return true;
}

#ifdef K4_PARTS
// The statistics pass of the STATS_PASS variant: one warp per row.
__global__ void __launch_bounds__(256)
ln_stats_kernel(const __nv_bfloat16* x, float2* stats, int M, int D, long long ldx, float eps) {
  const int r = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (r >= M) return;
  const __nv_bfloat16* const row[1] = {x + (long long)r * ldx};
  float2 st[1];
  row_stats<1>(row, D, eps, lane, st);
  if (lane == 0) stats[r] = st[0];
}
#endif

}  // namespace

extern "C" {

// Launch K4 on `stream`; returns the launch's cudaError_t (0 = success).
// ldx, ldw: row strides of x and w in elements, multiples of 8, both bases
// 16-byte aligned (their columns are contiguous). act: 0 none, 1 gelu, 2
// gelu_tanh, 3 quick_gelu. bm, bn: the tile of ops/vit_fused.py::_k4_plan.
int openvla_ln_matmul(const void* x, const void* w, const void* b, void* out, int M, int D,
                      int N, long long ldx, long long ldw, int act, float eps, int bm, int bn,
                      void* stream) {
  Params p;
  if (!make_params(p, x, w, b, out, M, D, N, ldx, ldw, act, eps, bm))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bm * 1000 + bn) {
    case 128256: return launch<128, 256, SHIPPED>(x, w, ldw, p, st);
    case 128192: return launch<128, 192, SHIPPED>(x, w, ldw, p, st);
    case 128128: return launch<128, 128, SHIPPED>(x, w, ldw, p, st);
    case 64128: return launch<64, 128, SHIPPED>(x, w, ldw, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

#ifdef K4_PARTS
// A variant of K4 at the 128 x 256 tile: `parts` is a combination of Part
// (SHIPPED is K4). With STATS_PASS, `stats` holds M float2 and the
// statistics pass runs first.
int openvla_ln_matmul_parts(const void* x, const void* w, const void* b, void* out, void* stats,
                            int M, int D, int N, long long ldx, long long ldw, int act, float eps,
                            int parts, void* stream) {
  Params p;
  if (!make_params(p, x, w, b, out, M, D, N, ldx, ldw, act, eps, 128))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (parts & STATS_PASS) {
    if (stats == nullptr) return (int)cudaErrorInvalidValue;
    p.stats = static_cast<const float2*>(stats);
    ln_stats_kernel<<<(M + 7) / 8, 256, 0, st>>>(p.x, static_cast<float2*>(stats), M, D, ldx,
                                                 eps);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  switch (parts) {
#define K4_VARIANT(v) \
  case (v): return launch<128, 256, (v)>(x, w, ldw, p, st);
    K4_VARIANT(SHIPPED)
    K4_VARIANT(STATS_PASS | STANDARDIZE | PRODUCTS)
    K4_VARIANT(STANDARDIZE | PRODUCTS)
    K4_VARIANT(ROW_STATS | PRODUCTS)
    K4_VARIANT(ROW_STATS | STANDARDIZE)
    K4_VARIANT(0)
    K4_VARIANT(SHIPPED | SMEM_STD)
    K4_VARIANT(SHIPPED | LOADER_STD)
    K4_VARIANT(SHIPPED | STATS_2ROWS)
#undef K4_VARIANT
    default: return (int)cudaErrorInvalidValue;
  }
}
#endif

}  // extern "C"
