// K5's machine: the int4 W4A16 wgmma kernel, with its dequant step as a
// template policy. Included by int4_w4a16.cu (K5 itself, the SCALED policy)
// and by int4_probe.cu (the K5 timing probe: the same kernel with the
// NO_SCALE, NO_UNPACK or GROUP_DOTS policy). The design, the operands and
// the bound are described at the top of int4_w4a16.cu.

#pragma once

#include <cuda_bf16.h>

#include "hopper_ptx.cuh"

namespace {

using namespace hopper;

constexpr int BN = 128;              // output columns per CTA (2 warpgroups x 64)
constexpr int BK = 64;               // depth per stage: one 128-byte bf16 x row
constexpr int CONSUMERS = 256;       // 2 consumer warpgroups
constexpr int NTHREADS = CONSUMERS + 128;  // + a producer warpgroup (one warp works)
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;   // setmaxnreg: 128 x 40 + 256 x 232
constexpr int P_BYTES = (BK / 2) * BN;   // packed stage: 32 rows of 128 bytes, swizzled
constexpr int S_ROWS = BK / 16;      // scale rows per stage (groups >= 16)
constexpr int S_BYTES = S_ROWS * BN * 4;
constexpr int CLD = BN + 4;          // epilogue tile row stride (floats)
constexpr int SMEM_LIMIT = 227 * 1024;

template <int TT>
struct Cfg {
  static_assert(TT % 64 == 0 && TT <= 256, "T_TILE is 64, 128, 192 or 256");
  static constexpr int X_BYTES = TT * 128;             // multiple of 1024 (swizzle atom)
  static constexpr int STAGE = X_BYTES + P_BYTES + S_BYTES;
  static constexpr int FIT = (SMEM_LIMIT - 2048) / STAGE;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8;
  static_assert(STAGES >= 3, "ring of at least 3 stages");
  static_assert(TT * CLD * 4 <= STAGES * STAGE, "epilogue tile fits over the ring");
};

// Byte (r, c) of a packed stage: 128-byte rows whose 16-byte chunks are
// permuted as TMA's 128-byte swizzle does (chunk ^ row % 8), so that the
// consumers' reads of 4 rows at one column hit 4 different bank groups.
__device__ __forceinline__ int pk_off(int r, int c) {
  return r * BN + ((((c >> 4) ^ r) & 7) << 4) + (c & 15);
}

// D (64 x N, fp32) = scale_d * D + A (64 x 16, bf16, registers) * B (16 x N,
// bf16, smem): one wgmma m64nNk16 per call, for the tiles of x's rows that K5
// compiles (scale_d 0 starts a new sum).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d = 1);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b,
                                          int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b,
                                          int scale_d) {
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
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<192>(float (&d)[96], const uint32_t (&a)[4], uint64_t desc_b,
                                          int scale_d) {
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
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 0;\n}"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128], const uint32_t (&a)[4], uint64_t desc_b,
                                          int scale_d) {
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
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// Keeps a[] in its registers up to this point: an in-flight wgmma may still
// read them, so nothing else may be allocated there before its wait.
__device__ __forceinline__ void hold(uint32_t (&a)[4]) {
  asm volatile("" : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3])::"memory");
}

// The dequant step, the kernel's template policy: how a consumer turns the
// packed bytes of a stage into wgmma's A registers, and where the group
// scale goes. K5 is SCALED. The K5 timing probe varies this one step and
// keeps the rest of the machine (ring, wgmmas, split-K, epilogue):
//   NO_SCALE    the nibbles without their scale (WRONG NUMBERS by design)
//   NO_UNPACK   the byte as a signed number for both k of its pair, no
//               scale (WRONG NUMBERS by design)
//   GROUP_DOTS  the nibbles without their scale; each group's products go
//               to a partial accumulator, which is scaled and added to the
//               sum at the group's end (a correct W4A16, rounded otherwise)
// The values of the probe's modes are the `mode` of its C entry.
enum Mode { NO_SCALE = 0, NO_UNPACK = 1, GROUP_DOTS = 2, SCALED = 3 };

template <int MODE>
struct Dequant {
  static constexpr bool SCALES = MODE == SCALED || MODE == GROUP_DOTS;   // reads scale rows
  static constexpr bool FOLD = MODE == GROUP_DOTS;   // the scale on each group's partial
  // FOLD keeps a second accumulator set (the partial) beside the sum: TT / 2
  // registers more, so tiles of at most 128 rows under the consumers' 232.
  static constexpr int MAX_TT = FOLD ? 128 : 256;

  // One packed byte -> bf16x2 (low nibble = even k in the low half). A
  // nibble becomes an fp32 exactly by 2^23 + (nibble ^ 8) - (2^23 + 8);
  // SCALED multiplies it by its scale in fp32 and rounds to bf16.
  static __device__ __forceinline__ uint32_t pair(uint32_t b, float s) {
    __nv_bfloat162 v;
    if constexpr (MODE == NO_UNPACK) {
      // 2^23 + ((int8_t)b + 128) - (2^23 + 128): the byte sign-extended,
      // exact in bf16.
      const float w = __fsub_rn(__uint_as_float((b ^ 0x80u) | 0x4B000000u), 8388736.0f);
      v = __floats2bfloat162_rn(w, w);
    } else {
      const float magic = 8388616.0f;   // 2^23 + 8
      const float lo = __fsub_rn(__uint_as_float((b & 0xFu) ^ 0x4B000008u), magic);
      const float hi = __fsub_rn(__uint_as_float(((b >> 4) & 0xFu) ^ 0x4B000008u), magic);
      if constexpr (MODE == SCALED) {
        v = __floats2bfloat162_rn(__fmul_rn(lo, s), __fmul_rn(hi, s));
      } else {
        v = __floats2bfloat162_rn(lo, hi);
      }
    }
    return *reinterpret_cast<uint32_t*>(&v);
  }

  // A of the 4 k16 steps of a packed stage for one thread: 16 bytes of the
  // stage, all loaded before any is converted. pb points at the stage plus
  // the thread's byte of its first row pair: packed row 8j + l%4 (+4) sits
  // at 1024 j (+ off4) from it, since the swizzle of a row depends only on
  // its row % 8, and column + 8 is 8 bytes on in the same 16-byte chunk.
  // srow points at the stage's first scale row, at the thread's column: a
  // new group starts when `left` (k16 steps left in the group) is 0, and its
  // two scales are then loaded once, from the stage's next scale row. FOLD
  // also gives, per step j, its group's two scales (fs[j]) and whether the
  // step starts or ends its group (bit j of starts, ends).
  static __device__ __forceinline__ void stage(uint32_t (&r)[BK / 16][4], const uint8_t* pb,
                                               int off4, const float* srow, int gsteps,
                                               int& left, float& s_lo, float& s_hi,
                                               float (&fs)[BK / 16][2], int& starts,
                                               int& ends) {
    uint32_t b[BK / 16][4];
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      b[j][0] = pb[1024 * j];              // (n, k pair)
      b[j][1] = pb[1024 * j + 8];          // (n + 8, k pair)
      b[j][2] = pb[1024 * j + off4];       // (n, k pair + 8)
      b[j][3] = pb[1024 * j + off4 + 8];   // (n + 8, k pair + 8)
    }
    if constexpr (FOLD) starts = ends = 0;
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      if constexpr (SCALES) {
        if (left == 0) {   // a new group: its two scales, once
          s_lo = srow[0];
          s_hi = srow[8];
          srow += BN;
          left = gsteps;
          if constexpr (FOLD) starts |= 1 << j;
        }
        --left;
        if constexpr (FOLD) {
          if (left == 0) ends |= 1 << j;
          fs[j][0] = s_lo;
          fs[j][1] = s_hi;
        }
      }
      r[j][0] = pair(b[j][0], s_lo);
      r[j][1] = pair(b[j][1], s_hi);
      r[j][2] = pair(b[j][2], s_lo);
      r[j][3] = pair(b[j][3], s_hi);
    }
  }
};

// FOLD at the end of a group: wait for its products, then add the partial
// times the group's scales to the sum, in group order and without a fused
// multiply-add (the TPU probe's acc + part * scales[g]). Accumulator v of a
// m64nN fragment is output column 16w + l/4 + 8 (v/2 % 2): its scale is
// s[0] or s[1].
template <int TT>
__device__ __forceinline__ void fold(float (&sum)[TT / 2], float (&part)[TT / 2],
                                     const float (&s)[2]) {
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int v = 0; v < TT / 2; ++v) asm volatile("" : "+f"(part[v])::"memory");
#pragma unroll
  for (int v = 0; v < TT / 2; ++v)
    sum[v] = __fadd_rn(sum[v], __fmul_rn(part[v], s[(v >> 1) & 1]));
  wgmma_fence();
}

struct Params {
  const int8_t* packed;
  const float* scales;
  float* out;
  float* work;        // (splits, T, N) partials when splits > 1
  int* counters;      // one per output tile when splits > 1, zeroed by the wrapper
  int T, K, N, group, splits, chunks, ntiles;
  long long ldp, lds;
  int tma_w;          // packed and scales by TMA too (16-byte bases and strides)
  int pvec, svec;     // else packed: 16, 4 or 1 bytes per copy; scales: 16 or 4
};

// --- the kernel ----------------------------------------------------------------

template <int TT, class D>
__global__ void __launch_bounds__(NTHREADS, 1)
int4_w4a16_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap pmap,
                        const __grid_constant__ CUtensorMap smap, const Params p) {
  static_assert(TT <= D::MAX_TT, "the dequant policy's tiles");
  using C = Cfg<TT>;
  constexpr int STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* xs = smem;                                     // [STAGES][TT rows][128 B]
  uint8_t* ps = xs + STAGES * C::X_BYTES;                 // [STAGES][32][128 B], swizzled
  float* ss = reinterpret_cast<float*>(ps + STAGES * P_BYTES);   // [STAGES][S_ROWS][BN]
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(ss) + STAGES * S_BYTES);   // full[STAGES], empty[STAGES]
  __shared__ int last_flag;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // blockIdx.x = chunk + chunks * (tile + ntiles * split): the CTAs that share a
  // weight tile are neighbours in launch order, so its bytes come from L2.
  const int chunk = blockIdx.x % p.chunks;
  const int tile = (blockIdx.x / p.chunks) % p.ntiles;
  const int split = blockIdx.x / (p.chunks * p.ntiles);
  const int t0 = chunk * TT, n0 = tile * BN;
  const int k_len = p.K / p.splits, k_begin = split * k_len;
  const int nkb = (k_len + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(bars + s), 1 + 32);            // expect_tx + 32 producer lanes
      mbar_init(smem_u32(bars + STAGES + s), CONSUMERS / 32);   // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {
    // ---- producer warpgroup: its registers go to the consumers; one warp works ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (warp != CONSUMERS / 32) return;
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&xmap))
                   : "memory");
      if (p.tma_w) {
        asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&pmap))
                     : "memory");
        asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&smap))
                     : "memory");
      }
    }
    const int K2 = p.K / 2, p_end = (k_begin + k_len) / 2;
    for (int kb = 0; kb < nkb; ++kb) {
      const int s = kb % STAGES;
      mbar_wait(smem_u32(bars + STAGES + s), ((kb / STAGES) & 1) ^ 1);
      const uint32_t full = smem_u32(bars + s);
      const int k0 = k_begin + kb * BK;
      const int g0 = (k0 + p.group - 1) / p.group;   // the first group starting in the stage
      uint8_t* pdst = ps + s * P_BYTES;
      float* sdst = ss + s * (S_BYTES / 4);
      if (p.tma_w) {   // x, the packed rows k0/2 .. +31 and the 4 scale rows from g0
        if (lane == 0) {
          mbar_expect_tx(full, C::X_BYTES + P_BYTES + S_BYTES);
          tma_load_2d(smem_u32(xs + s * C::X_BYTES), &xmap, full, k0, t0);
          tma_load_2d(smem_u32(pdst), &pmap, full, n0, k0 / 2);
          tma_load_2d(smem_u32(sdst), &smap, full, n0, g0);
        }
        mbar_arrive(full);
        continue;
      }
      if (lane == 0) {
        mbar_expect_tx(full, C::X_BYTES);
        tma_load_2d(smem_u32(xs + s * C::X_BYTES), &xmap, full, k0, t0);
      }
      // Scales: the rows of the groups that start in this stage (at most 4).
      const int srows = (k0 + BK - 1) / p.group - g0 + 1;   // may be 0
      const int G = p.K / p.group;
      if (p.svec == 16) {
        for (int e = lane; e < srows * (BN / 4); e += 32) {
          const int r = e / (BN / 4), c = (e % (BN / 4)) * 4;
          const bool ok = g0 + r < G && n0 + c < p.N;
          cp_async16(smem_u32(sdst + r * BN + c),
                     ok ? p.scales + (g0 + r) * p.lds + n0 + c : p.scales, ok ? 16 : 0);
        }
      } else {
        for (int e = lane; e < srows * BN; e += 32) {
          const int r = e / BN, c = e % BN;
          const bool ok = g0 + r < G && n0 + c < p.N;
          cp_async4(smem_u32(sdst + r * BN + c),
                    ok ? p.scales + (g0 + r) * p.lds + n0 + c : p.scales, ok ? 4 : 0);
        }
      }
      // Packed bytes: rows k0/2 .. k0/2 + 31 of this split, columns n0 .. n0 + 127.
      const int r0 = k0 / 2;
      const int r_end = p_end < K2 ? p_end : K2;
      if (p.pvec == 16) {
        for (int e = lane; e < (BK / 2) * (BN / 16); e += 32) {
          const int r = e / (BN / 16), c = (e % (BN / 16)) * 16;
          const bool ok = r0 + r < r_end && n0 + c < p.N;
          cp_async16(smem_u32(pdst + pk_off(r, c)),
                     ok ? p.packed + (r0 + r) * p.ldp + n0 + c : p.packed, ok ? 16 : 0);
        }
        cp_async_arrive_noinc(full);
      } else if (p.pvec == 4) {
        for (int e = lane; e < (BK / 2) * (BN / 4); e += 32) {
          const int r = e / (BN / 4), c = (e % (BN / 4)) * 4;
          const bool ok = r0 + r < r_end && n0 + c < p.N;
          cp_async4(smem_u32(pdst + pk_off(r, c)),
                    ok ? p.packed + (r0 + r) * p.ldp + n0 + c : p.packed, ok ? 4 : 0);
        }
        cp_async_arrive_noinc(full);
      } else {
        for (int e = lane; e < (BK / 2) * BN; e += 32) {
          const int r = e / BN, c = e % BN;
          const bool ok = r0 + r < r_end && n0 + c < p.N;
          pdst[pk_off(r, c)] = ok ? (uint8_t)__ldg(p.packed + (r0 + r) * p.ldp + n0 + c) : 0;
        }
        cp_async_arrive(full);   // the scales' copies still gate the phase
        mbar_arrive(full);       // releases the byte stores above
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  const int wg = warp / 4, w = warp % 4;
  const int col = 64 * wg + 16 * w + lane / 4;   // this thread's A rows: n0 + col, +8
  const int tig = lane % 4;

  // The m64nTTk16 accumulators (see the epilogue for their layout); under
  // FOLD the current group's partial, and `sum` the scaled partials.
  float acc[TT / 2];
  float sum[D::FOLD ? TT / 2 : 1];
#pragma unroll
  for (int i = 0; i < TT / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (D::FOLD ? TT / 2 : 1); ++i) sum[i] = 0.f;
  // A of the 4 k16 steps of a stage, for two stages: the wgmmas of one run
  // while the consumers dequantize the next.
  uint32_t a[2][BK / 16][4];
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) a[b][j][i] = 0u;
  float s_lo = 0.f, s_hi = 0.f;
  int left = 0;                       // k16 steps left in the current group
  float fs[BK / 16][2];               // FOLD: each step's group scales, and the
  int starts = 0, ends = 0;           // steps that start or end a group
  const int gsteps = p.group / 16;
  // The thread's bytes in a packed stage: rows l%4 and l%4 + 4 of each 8.
  const int off0 = pk_off(tig, col), off4 = pk_off(tig + 4, col) - off0;

  mbar_wait(smem_u32(bars), 0);
  D::stage(a[0], ps + off0, off4, ss + col, gsteps, left, s_lo, s_hi, fs, starts, ends);
  // Stage kb, whose A is a[P]: its 4 k16 steps' wgmmas as one group; then,
  // once the previous stage's group is done, that stage is released and the
  // next stage's A goes into a[P ^ 1]. P is kb % 2, a constant in each copy.
  for (int kb0 = 0; kb0 < nkb; kb0 += 2) {
#pragma unroll
    for (int P = 0; P < 2; ++P) {
      const int kb = kb0 + P;
      if (kb >= nkb) break;
      const int s = kb % STAGES;
      const uint32_t xbase = smem_u32(xs + s * C::X_BYTES);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        if constexpr (D::FOLD) {
          wgmma_rs<TT>(acc, a[P][j], sw128_desc(xbase + j * 32), ((starts >> j) & 1) ^ 1);
          if ((ends >> j) & 1) fold<TT>(sum, acc, fs[j]);
        } else {
          wgmma_rs<TT>(acc, a[P][j], sw128_desc(xbase + j * 32));
        }
      }
      wgmma_commit();
      wgmma_wait<1>();
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) hold(a[P ^ 1][j]);
      if (kb > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(smem_u32(bars + STAGES + (kb - 1) % STAGES));
      }
      if (kb + 1 < nkb) {
        const int sn = (kb + 1) % STAGES;
        mbar_wait(smem_u32(bars + sn), ((kb + 1) / STAGES) & 1);
        D::stage(a[P ^ 1], ps + sn * P_BYTES + off0, off4, ss + sn * (S_BYTES / 4) + col,
                 gsteps, left, s_lo, s_hi, fs, starts, ends);
      }
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < BK / 16; ++j) {
    hold(a[0][j]);
    hold(a[1][j]);
  }
#pragma unroll
  for (int i = 0; i < TT / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");

  // ---- epilogue: D^T through shared memory (over the ring) as y rows ----
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");   // the ring is idle
  float* cs = reinterpret_cast<float*>(smem);                     // [TT][CLD]
#pragma unroll
  for (int v = 0; v < TT / 2; ++v) {
    // Accumulator v of a m64nN fragment: row 16w + l/4 + 8 (v/2 % 2), column
    // 8 (v/4) + 2 (l%4) + v%2.
    const int n = col + 8 * ((v >> 1) & 1);
    const int t = 8 * (v >> 2) + 2 * tig + (v & 1);
    if constexpr (D::FOLD) {
      cs[t * CLD + n] = sum[v];
    } else {
      cs[t * CLD + n] = acc[v];
    }
  }
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");

  const int rows = p.T - t0 < TT ? p.T - t0 : TT;
  if (p.splits == 1) {
    for (int e = tid; e < rows * BN; e += CONSUMERS) {
      const int t = e / BN, c = e % BN;
      if (n0 + c < p.N) p.out[(long long)(t0 + t) * p.N + n0 + c] = cs[t * CLD + c];
    }
    return;
  }
  // Split-K: this split's partial, then the last CTA of the tile adds all in order.
  const long long plane = (long long)p.T * p.N;
  float* part = p.work + split * plane;
  for (int e = tid; e < rows * BN; e += CONSUMERS) {
    const int t = e / BN, c = e % BN;
    if (n0 + c < p.N) part[(long long)(t0 + t) * p.N + n0 + c] = cs[t * CLD + c];
  }
  __threadfence();
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
  if (tid == 0) {
    const int prev = atomicAdd(p.counters + tile * p.chunks + chunk, 1);
    last_flag = prev == p.splits - 1;
  }
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
  if (!last_flag) return;
  __threadfence();
  // Each element sums the splits' partials in split order; the loads of 4
  // splits are in flight at once, and 4 columns at a time where rows are
  // 16-byte aligned (N % 4 == 0).
  if (p.N % 4 == 0) {
    for (int e = tid; e < rows * (BN / 4); e += CONSUMERS) {
      const int t = e / (BN / 4), c = (e % (BN / 4)) * 4;
      if (n0 + c >= p.N) continue;
      const float4* src = reinterpret_cast<const float4*>(p.work + (long long)(t0 + t) * p.N + n0 + c);
      const long long step = plane / 4;
      float4 sum = __ldcg(src);
      int sp = 1;
      for (; sp + 4 <= p.splits; sp += 4) {
        float4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) v[u] = __ldcg(src + (sp + u) * step);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          sum.x = __fadd_rn(sum.x, v[u].x);
          sum.y = __fadd_rn(sum.y, v[u].y);
          sum.z = __fadd_rn(sum.z, v[u].z);
          sum.w = __fadd_rn(sum.w, v[u].w);
        }
      }
      for (; sp < p.splits; ++sp) {
        const float4 v = __ldcg(src + sp * step);
        sum.x = __fadd_rn(sum.x, v.x);
        sum.y = __fadd_rn(sum.y, v.y);
        sum.z = __fadd_rn(sum.z, v.z);
        sum.w = __fadd_rn(sum.w, v.w);
      }
      *reinterpret_cast<float4*>(p.out + (long long)(t0 + t) * p.N + n0 + c) = sum;
    }
    return;
  }
  for (int e = tid; e < rows * BN; e += CONSUMERS) {
    const int t = e / BN, c = e % BN;
    if (n0 + c >= p.N) continue;
    const long long off = (long long)(t0 + t) * p.N + n0 + c;
    float sum = __ldcg(p.work + off);
    int sp = 1;
    for (; sp + 4 <= p.splits; sp += 4) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = __ldcg(p.work + (sp + u) * plane + off);
#pragma unroll
      for (int u = 0; u < 4; ++u) sum = __fadd_rn(sum, v[u]);
    }
    for (; sp < p.splits; ++sp) sum = __fadd_rn(sum, __ldcg(p.work + sp * plane + off));
    p.out[off] = sum;
  }
}

template <int TT, class D>
int launch(const void* x, const Params& p, int grid, cudaStream_t stream) {
  using C = Cfg<TT>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  // x (T, K) bf16: boxes of 64 k x TT rows. packed (K/2, N) bytes: boxes of
  // 128 columns x 32 rows, swizzled as the consumers read them. scales
  // (G, N) fp32: boxes of 128 columns x 4 rows.
  CUtensorMap xmap, pmap, smap;
  if (!encode_2d(encode, &xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, p.K, p.T, (uint64_t)p.K * 2,
                 BK, TT, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  pmap = smap = xmap;   // unused unless p.tma_w
  if (p.tma_w &&
      !(encode_2d(encode, &pmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, p.packed, p.N, p.K / 2,
                  (uint64_t)p.ldp, BN, BK / 2, CU_TENSOR_MAP_SWIZZLE_128B) &&
        encode_2d(encode, &smap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, p.scales, p.N,
                  p.K / p.group, (uint64_t)p.lds * 4, BN, S_ROWS, CU_TENSOR_MAP_SWIZZLE_NONE)))
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(int4_w4a16_wgmma_kernel<TT, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  int4_w4a16_wgmma_kernel<TT, D><<<grid, NTHREADS, C::SMEM, stream>>>(xmap, pmap, smap, p);
  return (int)cudaGetLastError();
}

// The machine with dequant policy D on `stream`; returns the launch's
// cudaError_t. Operands and plan as openvla_int4_matmul_w4a16 (int4_w4a16.cu)
// documents them; t_tile at most D::MAX_TT.
template <class D>
int launch_k5(const void* x, const void* packed, const void* scales, void* out, void* work,
              void* counters, int T, int K, int N, int group, long long ldp, long long lds,
              int t_tile, int splits, void* stream) {
  if (T <= 0 || N <= 0 || K <= 0 || group <= 0 || group % 16 || K % group || splits <= 0 ||
      (K / group) % splits || (splits > 1 && ((K / splits) % BK || !work || !counters)) ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.packed = static_cast<const int8_t*>(packed);
  p.scales = static_cast<const float*>(scales);
  p.out = static_cast<float*>(out);
  p.work = static_cast<float*>(work);
  p.counters = static_cast<int*>(counters);
  p.T = T;
  p.K = K;
  p.N = N;
  p.group = group;
  p.splits = splits;
  p.chunks = (T + t_tile - 1) / t_tile;
  p.ntiles = (N + BN - 1) / BN;
  p.ldp = ldp;
  p.lds = lds;
  const uintptr_t pa = reinterpret_cast<uintptr_t>(packed), sa = reinterpret_cast<uintptr_t>(scales);
  p.tma_w = pa % 16 == 0 && ldp % 16 == 0 && sa % 16 == 0 && lds % 4 == 0;
  p.pvec = (pa % 16 == 0 && ldp % 16 == 0 && N % 16 == 0) ? 16
           : (pa % 4 == 0 && ldp % 4 == 0 && N % 4 == 0)  ? 4
                                                          : 1;
  p.svec = (sa % 16 == 0 && lds % 4 == 0 && N % 4 == 0) ? 16 : 4;
  const int grid = p.chunks * p.ntiles * splits;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (t_tile) {
    case 64: return launch<64, D>(x, p, grid, st);
    case 128: return launch<128, D>(x, p, grid, st);
    default: break;
  }
  if constexpr (D::MAX_TT == 256) {
    switch (t_tile) {
      case 192: return launch<192, D>(x, p, grid, st);
      case 256: return launch<256, D>(x, p, grid, st);
      default: break;
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
