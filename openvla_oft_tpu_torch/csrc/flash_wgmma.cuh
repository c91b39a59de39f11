// The pieces of the flash-attention kernels on Hopper that K1
// (flash_attention_fwd.cu) and K2/K3 (flash_attention_bwd.cu) share: the
// ring's stage headers and barriers, the flag masks of a 64-row tile, the
// bf16 wgmma forms they issue (SS m64n64k16 for scores; RS with an MN-major
// B for the products), the descriptors of a ring tile, the conversion of an
// accumulator into A fragments, the register fences, and the tensor maps of
// the operands read through their strides.
//
// Every operand tile is 64 rows of D bf16 as D / 64 boxes of 64 rows x 128
// bytes with the 128-byte swizzle, read by a 4-D tensor map (D, heads, S, B):
// rows past S arrive as zeros. The same tile serves wgmma as a K-major
// operand (D contiguous) and, through the transpose bit, as an MN-major B
// (rows along the product's depth).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper_ptx.cuh"

namespace flash {

using namespace hopper;

constexpr int TILE_ROWS = 64;             // rows of a ring tile and of a wgmma's M
constexpr int BOX = 64 * 128;             // one TMA box: 64 rows x 64 bf16 columns
constexpr int SMEM_LIMIT = 227 * 1024;
constexpr float LOG2E = 1.4426950408889634f;

// A stage's header, written by the loading warp before it arms the stage.
// r0: the tile's first row (-1: the walk has ended); h: K3's query head;
// m0, m1: the key masks of K1 and K2 (valid; valid and bidirectional), K3's
// query mask (bidirectional) in m0.
struct __align__(16) Header {
  int r0, h, pad0, pad1;
  unsigned long long m0, m1;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Bit i: row r0 + i exists (< S) and its flag is set (a warp's ballot).
__device__ __forceinline__ unsigned long long row_mask(const uint8_t* flags, int r0, int S,
                                                       int lane) {
  const bool a = r0 + lane < S && flags[r0 + lane] != 0;
  const bool b = r0 + 32 + lane < S && flags[r0 + 32 + lane] != 0;
  const unsigned lo = __ballot_sync(0xffffffffu, a), hi = __ballot_sync(0xffffffffu, b);
  return (unsigned long long)hi << 32 | lo;
}

// The masks of a 64-key tile: valid, and valid and bidirectional.
struct Keys {
  unsigned long long valid, bid;
};
__device__ __forceinline__ Keys key_masks(const uint8_t* valid_b, const uint8_t* bidir_b, int k0,
                                          int S, int lane) {
  const unsigned long long v = row_mask(valid_b, k0, S, lane);
  return {v, v & row_mask(bidir_b, k0, S, lane)};
}

__device__ __forceinline__ bool bit(unsigned long long m, int i) { return (m >> i) & 1ull; }

// 2^x: one MUFU.EX2 (ex2.approx.ftz, relative error about 2^-22; P rounds
// to bf16 before any product).
__device__ __forceinline__ float exp2_(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// D (64 x N, fp32) += A (64 x 16) * B (16 x N): both K-major bf16 in shared
// memory; `accumulate` 0 overwrites D.
template <int N>
__device__ __forceinline__ void wgmma_kk(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate);
// D (64 x N, fp32) += A (64 x 16, bf16 registers) * B (16 x N, bf16, MN-major
// in shared memory, the transpose bit set).
template <int N>
__device__ __forceinline__ void wgmma_rs_t(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t desc_b);


template <>
__device__ __forceinline__ void wgmma_kk<64>(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                            int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs_t<64>(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_t<128>(float (&d)[64], const uint32_t (&a)[4],
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

// Loads rows r0 .. r0 + 63 of head `head` of batch row b: D / 64 boxes.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int head, int r0, int b) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c) tma_load_4d(dst + c * BOX, map, bar, 64 * c, head, r0, b);
}

// Descriptors of k16 step kk of a 64-row tile at `tile`: K-major (the step's
// 16 columns of every row), and MN-major (rows 16 kk .. 16 kk + 15 as the
// depth, the D columns as N; LBO = the next 64-column box).
__device__ __forceinline__ uint64_t kdesc(uint32_t tile, int kk) {
  return sw128_desc(tile + (kk >> 2) * BOX + 32 * (kk & 3));
}
__device__ __forceinline__ uint64_t mndesc(uint32_t tile, int kk) {
  return mn_sw128_desc(tile + 2048 * kk, BOX);
}

// A 64 x 64 accumulator as the bf16 A fragments of the next product's four
// k16 steps: registers 8 kk .. 8 kk + 7 hold columns 16 kk .. 16 kk + 15 of
// the thread's two rows in the order of the A fragment.
__device__ __forceinline__ void to_frags(const float (&x)[32], uint32_t (&f)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) f[kk][i] = pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

// Register fences after a wgmma wait: the compiler sees a wgmma's results
// when it is issued, so without these it may read an accumulator, or reuse
// an A fragment's registers, before the wait that makes that safe.
template <int N>
__device__ __forceinline__ void settle(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}
__device__ __forceinline__ void hold(uint32_t (&f)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(f[kk][i])::"memory");
}

// The ring of a kernel whose shared-memory carve `Sm` has the barrier arrays
// full, empty (STAGES each) and res_full, and the headers hdr.
template <int STAGES, int CONSUMERS, class Sm>
__device__ __forceinline__ void init_barriers(const Sm& sm) {
  for (int s = 0; s < STAGES; ++s) {
    mbar_init(smem_u32(sm.full + s), 1);                   // the loading warp's arrive
    mbar_init(smem_u32(sm.empty + s), CONSUMERS / 32);     // one per consumer warp
  }
  mbar_init(smem_u32(sm.res_full), 1);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Stage `it` of the walk: its slot, once the consumers have released it.
template <int STAGES, class Sm>
__device__ __forceinline__ int next_slot(const Sm& sm, int it) {
  const int s = it % STAGES;
  if (it >= STAGES) mbar_wait(smem_u32(sm.empty + s), ((it / STAGES) & 1) ^ 1);
  return s;
}

// The loading warp's last stage: a header with r0 = -1 and no copies.
template <int STAGES, class Sm>
__device__ __forceinline__ void end_walk(const Sm& sm, int it, int lane) {
  const int s = next_slot<STAGES>(sm, it);
  if (lane == 0) {
    sm.hdr[s].r0 = -1;
    mbar_arrive(smem_u32(sm.full + s));
  }
}

template <class... Maps>
__device__ __forceinline__ void prefetch_maps(const Maps*... maps) {
  const CUtensorMap* all[] = {maps...};
  for (const CUtensorMap* m : all)
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(m)) : "memory");
}

// A consumer warp gives stage s back to the loading warp.
template <class Sm>
__device__ __forceinline__ void release(const Sm& sm, int s, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(smem_u32(sm.empty + s));
}

// The tensor map of a (B, S, heads, D) operand read through its strides (in
// elements: batch, seq, head) as (D, heads, S, B), boxes of 64 columns x 1
// head x 64 rows, the 128-byte swizzle. A dimension of extent 1 gets a
// nominal stride (its stride is never used).
inline CUresult encode_operand(EncodeTiled encode, CUtensorMap* map, const void* ptr, int D,
                               int heads, int S, int B, long long sb, long long ss,
                               long long sh) {
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)heads, (uint64_t)S, (uint64_t)B};
  const long long strides[3] = {sh, ss, sb};
  uint64_t bytes[3];
  uint64_t span = (uint64_t)D * 2;
  for (int j = 0; j < 3; ++j) {
    bytes[j] = dims[j + 1] == 1 ? span : (uint64_t)strides[j] * 2;
    span = bytes[j] * dims[j + 1];
  }
  const uint32_t box[4] = {64, 1, TILE_ROWS, 1};
  return encode_4d(encode, map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, dims, bytes, box,
                   CU_TENSOR_MAP_SWIZZLE_128B);
}

inline bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace flash
