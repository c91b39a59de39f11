// K6 on Hopper: the int4 W4A8 dequant-matmul, with int8 wgmma.
//
// Replaces the TPU kernels of openvla_oft_tpu/ops/int4_matmul.py:
//   _kernel_a8 (:432, int4_matmul_fused_a8) and _kernel_stacked_a8 (:527,
//   int4_matmul_fused_stacked_a8). Every operand is read through its row
//   stride, so a layer view packed[l] or a column view packed[:, lo:hi]
//   needs no copy and one kernel serves both TPU variants.
//
//   y[t, n] = sx[t] * sum_g float(sum_{k in g} x8[t, k] * nibble(k, n)) * scales[g, n]
//
// x8 (T, K) int8 contiguous and sx (T) fp32 come from the wrapper (per-token
// absmax / 127, round half to even: ops/int4_matmul.py::quantize_act_rows);
// packed (K/2, N) int8, byte (i, n) holding weight row 2i in its low nibble
// and row 2i+1 in its high nibble, each a signed 4-bit value
// (ops/quant.py::quantize_weight_int4); scales (G, N) fp32, G = K / group,
// group a multiple of 16 and at most 128; y (T, N) fp32. Each group's
// product is an exact int32 sum on the int8 tensor cores; its scale
// multiplies it in fp32 and the groups add in order, with the plain
// version's roundings (a multiply, then an add; no fused multiply-add).
//
// Bound. At T = 618 the LLM's linears are compute-bound on the card (wqkv:
// 62 GOP, 0.031 ms at the int8 tensor-core peak, against 0.0075 ms for its
// 25 MB of int4); at T = 57 bytes and operations come near balance. Beside
// the products, every group's int32 partial costs each consumer thread
// about 4 ALU operations per output value (convert, scale, add): at group
// 128 that is as many SM issue slots as the wgmmas take tensor-core time,
// so the design keeps the two running at once.
//
// Design (swap-AB). The CTA computes the transposed tile y^T (128 output
// columns n x T_TILE rows t) as D = A * B with wgmma m64nT_TILEk32.s32.s8.s8:
//  - B (32 k x T_TILE rows) is x8's tile, K-major in shared memory with the
//    128-byte swizzle: one 128-byte row of x8 (128 k) per row t, by TMA.
//  - A (64 columns n x 32 k per consumer warpgroup) is the unpacked weight.
//    An 8-bit wgmma operand must be K-major, and packed is N-major, so an
//    unpacking warpgroup transposes it: each stage's 64 packed rows x 128
//    columns become a 128 n x 128 k int8 tile, K-major with the 128-byte
//    swizzle, read by the consumers' descriptors (A from shared memory, so
//    that the wgmmas run while the consumers scale the previous group). A
//    thread reads a packed word (4 columns of one row), sign-extends its
//    low and high nibbles as bytes without a borrow between them, and
//    byte-permutes 16 k of 4 columns into 4 rows of A; the rows it writes
//    are staggered by lane, so that the 16-byte stores of 8 lanes fall in
//    8 different bank groups.
//  - Groups that are not a multiple of 32 deep (16, 48, 80, 112) would put
//    a k32 step across a group boundary. For them (HALF) every 16 k is a
//    k32 step of its own: A holds the 16 k in its half of the step and
//    zeros in the other half (written once), so the step reads B's whole
//    32 k and counts only its own 16. Twice the products, for those
//    weights only.
//  - Two int32 accumulator sets: group g's wgmmas (scale-d 0 on its first
//    step, which zeroes the set) are in flight while the consumers turn
//    group g-1's set into fp32 (exact: |partial| <= 127 * 7 * 128 < 2^22,
//    by adding 1.5 * 2^23 as an integer and subtracting it as a float),
//    multiply by the group scales of their two rows n (held in registers)
//    and add into the fp32 accumulators. Groups are counted in k32 steps:
//    no division in the loop.
//  - One warp of the unpacking warpgroup also keeps the ring of STAGES
//    stages of 128 k filled, STAGES - 2 ahead of the unpacking: x8 by TMA;
//    the packed bytes (swizzled as TMA's 128-byte swizzle does, so that
//    reading a row is free of bank conflicts) and the scales by TMA too
//    where their base and row stride are 16-byte aligned, else by cp.async
//    in 16- or 4-byte chunks where address, stride and width allow, else by
//    byte loads. mbarriers: full (data landed), afull (A unpacked), empty
//    (both consumer warpgroups done with the stage). setmaxnreg gives the
//    unpacking warpgroup's spare registers to the consumers.
//  - Split-K at small T: when the grid is under one wave, `splits` CTAs
//    share an output tile, each over K / splits (whole groups, a multiple
//    of 128). Each writes its fp32 partial to a workspace; the last to
//    arrive (an atomic counter that the wrapper zeroes) adds the partials
//    in split order. Two calls give bitwise-equal y.
//  - Epilogue: the accumulators go through shared memory as y rows, times
//    sx[t] once at the end (after the split reduction), so the global
//    writes are row-coalesced; rows past T and columns past N are masked.
// The plan (T_TILE, splits) comes from ops/int4_matmul.py::_k6_plan.

#include "hopper_ptx.cuh"

namespace {

using namespace hopper;

constexpr int BN = 128;              // output columns per CTA (2 warpgroups x 64)
constexpr int BK = 128;              // depth per stage: one 128-byte x8 row
constexpr int MAX_GROUP = BK;        // a stage holds a group start: the ring cannot stall
constexpr int CONSUMERS = 256;       // 2 consumer warpgroups
constexpr int NTHREADS = CONSUMERS + 128;   // + the unpacking warpgroup (its warp 0 copies)
constexpr int P_BYTES = (BK / 2) * BN;      // packed stage: 64 rows of 128 bytes, swizzled
constexpr int S_ROWS = BK / 16;      // scale rows per stage (groups >= 16)
constexpr int S_BYTES = S_ROWS * BN * 4;
constexpr int A_TILE = BN * 128;     // one 128 n x 128-byte K-major tile of A
constexpr int CLD = BN + 4;          // epilogue tile row stride (floats)
constexpr int SMEM_LIMIT = 227 * 1024;
constexpr uint32_t F2I_MAGIC = 0x4B400000u;   // 1.5 * 2^23 as fp32 bits
constexpr float F2I_BIAS = 12582912.0f;      // 1.5 * 2^23

template <int TT, bool HALF>
struct Cfg {
  static_assert(TT == 64 || TT == 96, "T_TILE is 64 or 96");
  static constexpr int X_BYTES = TT * 128;            // multiple of 1024 (swizzle atom)
  static constexpr int STEPS = HALF ? 8 : 4;          // k32 steps per stage
  static constexpr int A_BYTES = HALF ? 2 * A_TILE : A_TILE;
  static constexpr int STAGE = X_BYTES + A_BYTES + P_BYTES + S_BYTES;
  static constexpr int FIT = (SMEM_LIMIT - 2048) / STAGE;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int SMEM = 1024 + STAGES * STAGE + 3 * STAGES * 8;
  // setmaxnreg: the consumers take exactly what the unpackers give up of
  // the 168 registers a thread of a 384-thread block starts with (a larger
  // request would wait for registers that never come free). The consumers
  // hold 3 x TT / 2 accumulators: at TT = 128 that is 192 and spills.
  static constexpr int CREGS = TT == 96 ? 208 : 184;
  static constexpr int UREGS = 168 - 2 * (CREGS - 168);
  static_assert(STAGES >= 3, "ring of at least 3 stages");
  static_assert(TT * CLD * 4 <= STAGES * STAGE, "epilogue tile fits over the ring");
  static_assert(CONSUMERS * CREGS + 128 * UREGS == NTHREADS * 168, "register split");
};

// Byte (r, c) of a 128-byte-row tile with TMA's 128-byte swizzle: 16-byte
// chunk c / 16 of row r sits at chunk (c / 16) ^ (r % 8).
__device__ __forceinline__ int sw_off(int r, int c) {
  return r * 128 + ((((c >> 4) ^ r) & 7) << 4) + (c & 15);
}

// A packed word (4 columns of one packed row) -> its low and high nibbles as
// 4 signed bytes each. Per byte, with f = nibble ^ 8 in [0, 15]:
// ((f | 0x80) - 8) ^ 0x80 = f - 8 mod 256, and no byte borrows from the next.
__device__ __forceinline__ void unpack_word(uint32_t r, uint32_t& lo, uint32_t& hi) {
  const uint32_t f = r ^ 0x88888888u;
  lo = (((f & 0x0F0F0F0Fu) | 0x80808080u) - 0x08080808u) ^ 0x80808080u;
  hi = ((((f >> 4) & 0x0F0F0F0Fu) | 0x80808080u) - 0x08080808u) ^ 0x80808080u;
}

// Column j of 4 packed rows r[0..3] (byte j of each word) as one word, for
// j = 0..3: a 4 x 4 byte transpose in 8 byte permutes.
__device__ __forceinline__ void transpose4(const uint32_t (&r)[4], uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140), t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140), t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

// D (64 x N, int32) = (accumulate ? D : 0) + A (64 x 32, s8, smem) * B (32 x N, s8, smem):
// one wgmma m64nNk32 per call, for the tiles of x8's rows that K6 compiles.
template <int N>
__device__ __forceinline__ void wgmma_s8(int32_t (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate);

template <>
__device__ __forceinline__ void wgmma_s8<64>(int32_t (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_s8<96>(int32_t (&d)[48], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p;\n}"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// Keeps an accumulator set in its registers up to this point: an in-flight
// wgmma writes it, and reads of a finished set must follow its wait.
template <int N>
__device__ __forceinline__ void fence_regs(int32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// acc += float(d) * the scale of the value's row (s_lo: n, s_hi: n + 8),
// rounded after the multiply and after the add, as the plain version is.
template <int N>
__device__ __forceinline__ void scale_group(float (&acc)[N], const int32_t (&d)[N], float s_lo,
                                            float s_hi) {
#pragma unroll
  for (int v = 0; v < N; ++v) {
    const float f = __fsub_rn(__uint_as_float(static_cast<uint32_t>(d[v]) + F2I_MAGIC), F2I_BIAS);
    acc[v] = __fadd_rn(acc[v], __fmul_rn(f, ((v >> 1) & 1) ? s_hi : s_lo));
  }
}

struct Params {
  const int8_t* packed;
  const float* scales;
  const float* sx;
  float* out;
  float* work;        // (splits, T, N) partials when splits > 1
  int* counters;      // one per output tile when splits > 1, zeroed by the wrapper
  int T, K, N, group, splits, chunks, ntiles;
  long long ldp, lds;
  int tma_w;          // packed and scales by TMA too (16-byte bases and strides)
  int pvec, svec;     // else packed: 16, 4 or 1 bytes per copy; scales: 16 or 4
  int srows;          // scale rows a stage can need: ceil(128 / group)
};

// --- the kernel ----------------------------------------------------------------

template <int TT, bool HALF>
__global__ void __launch_bounds__(NTHREADS, 1)
int4_w4a8_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap pmap,
                       const __grid_constant__ CUtensorMap smap, const Params p) {
  using C = Cfg<TT, HALF>;
  constexpr int STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* xs = smem;                                     // [STAGES][TT rows][128 B]
  uint8_t* as = xs + STAGES * C::X_BYTES;                 // [STAGES][1 or 2][128 n][128 B]
  uint8_t* ps = as + STAGES * C::A_BYTES;                 // [STAGES][64][128 B], swizzled
  float* ss = reinterpret_cast<float*>(ps + STAGES * P_BYTES);   // [STAGES][S_ROWS][BN]
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(ss) + STAGES * S_BYTES);   // full, afull, empty [STAGES] each
  uint64_t* afull = bars + STAGES;
  uint64_t* empty = bars + 2 * STAGES;
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
      mbar_init(smem_u32(bars + s), 1 + 32);              // expect_tx + 32 copying lanes
      mbar_init(smem_u32(afull + s), 4);                  // one per unpacking warp
      mbar_init(smem_u32(empty + s), CONSUMERS / 32);     // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {
    // ---- unpacking warpgroup; its warp 0 also keeps the ring filled ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(C::UREGS));
    const int uw = warp - CONSUMERS / 32;
    if (HALF) {   // the zero halves of A's k32 steps, once (the unpacking never writes them)
      for (int e = tid - CONSUMERS; e < STAGES * C::A_BYTES / 16; e += 128)
        reinterpret_cast<uint4*>(as)[e] = make_uint4(0u, 0u, 0u, 0u);
      asm volatile("bar.sync 2, 128;" ::: "memory");
    }
    if (uw == 0 && lane == 0) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&xmap))
                   : "memory");
      if (p.tma_w) {
        asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&pmap))
                     : "memory");
        asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&smap))
                     : "memory");
      }
    }
    const int K2 = p.K / 2, p_end = (k_begin + k_len) / 2, G = p.K / p.group;
    // Stage kb's copies, by the 32 lanes of warp 0, once the consumers are
    // done with the slot's previous stage.
    auto issue = [&](int kb) {
      const int s = kb % STAGES;
      mbar_wait(smem_u32(empty + s), ((kb / STAGES) & 1) ^ 1);
      const uint32_t full = smem_u32(bars + s);
      const int k0 = k_begin + kb * BK;
      const int g0 = (k0 + p.group - 1) / p.group;   // the first group starting in the stage
      uint8_t* pdst = ps + s * P_BYTES;
      float* sdst = ss + s * (S_BYTES / 4);
      if (p.tma_w) {   // x8, the packed rows k0/2 .. +63 and p.srows scale rows from g0
        if (lane == 0) {
          mbar_expect_tx(full, C::X_BYTES + P_BYTES + p.srows * BN * 4);
          tma_load_2d(smem_u32(xs + s * C::X_BYTES), &xmap, full, k0, t0);
          tma_load_2d(smem_u32(pdst), &pmap, full, n0, k0 / 2);
          tma_load_2d(smem_u32(sdst), &smap, full, n0, g0);
        }
        mbar_arrive(full);
        return;
      }
      if (lane == 0) {
        mbar_expect_tx(full, C::X_BYTES);
        tma_load_2d(smem_u32(xs + s * C::X_BYTES), &xmap, full, k0, t0);
      }
      // Scales: the rows of the groups that start in this stage (at most 8).
      const int srows = (k0 + BK - 1) / p.group - g0 + 1;
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
      // Packed bytes: rows k0/2 .. k0/2 + 63 of this split, columns n0 .. n0 + 127.
      const int r0 = k0 / 2;
      const int r_end = p_end < K2 ? p_end : K2;
      if (p.pvec == 16) {
        for (int e = lane; e < (BK / 2) * (BN / 16); e += 32) {
          const int r = e / (BN / 16), c = (e % (BN / 16)) * 16;
          const bool ok = r0 + r < r_end && n0 + c < p.N;
          cp_async16(smem_u32(pdst + sw_off(r, c)),
                     ok ? p.packed + (r0 + r) * p.ldp + n0 + c : p.packed, ok ? 16 : 0);
        }
        cp_async_arrive_noinc(full);
      } else if (p.pvec == 4) {
        for (int e = lane; e < (BK / 2) * (BN / 4); e += 32) {
          const int r = e / (BN / 4), c = (e % (BN / 4)) * 4;
          const bool ok = r0 + r < r_end && n0 + c < p.N;
          cp_async4(smem_u32(pdst + sw_off(r, c)),
                    ok ? p.packed + (r0 + r) * p.ldp + n0 + c : p.packed, ok ? 4 : 0);
        }
        cp_async_arrive_noinc(full);
      } else {
        for (int e = lane; e < (BK / 2) * BN; e += 32) {
          const int r = e / BN, c = e % BN;
          const bool ok = r0 + r < r_end && n0 + c < p.N;
          pdst[sw_off(r, c)] = ok ? (uint8_t)__ldg(p.packed + (r0 + r) * p.ldp + n0 + c) : 0;
        }
        cp_async_arrive(full);   // the scales' copies still gate the phase
        mbar_arrive(full);       // releases the byte stores above
      }
    };
    // Lane l takes columns 4l .. 4l + 3 of each 16-k chunk, in an order
    // rotated by rot = (l / 2) % 4, so that 8 lanes store 8 different rows % 8.
    const int rot = (lane >> 1) & 3;
    const uint32_t rot_sel = (0x32103210u >> (4 * rot)) & 0xFFFFu;   // byte i <- byte i + rot
    int next = 0;   // warp 0: the next stage to copy
    for (int kb = 0; kb < nkb; ++kb) {
      if (uw == 0) {
        // Copy stage kb if it is not yet on its way, then every later stage
        // whose slot is already free: the unpacking never waits for a slot.
        while (next < nkb && next < kb + STAGES) {
          if (next > kb) {
            int free = 0;
            if (lane == 0)
              free = mbar_test(smem_u32(empty + next % STAGES), ((next / STAGES) & 1) ^ 1);
            if (!__shfl_sync(0xffffffffu, free, 0)) break;
          }
          issue(next++);
        }
      }
      const int s = kb % STAGES;
      mbar_wait(smem_u32(bars + s), (kb / STAGES) & 1);
      const uint8_t* pst = ps + s * P_BYTES;
      uint8_t* ast = as + s * C::A_BYTES;
      // Warp uw takes the 16-k chunks uw and uw + 4.
#pragma unroll
      for (int it = 0; it < 2; ++it) {
        const int c = uw + 4 * it;                 // packed rows 8c .. 8c + 7
        uint32_t r[2][4], col[2][4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          r[i / 4][i % 4] = __byte_perm(
              *reinterpret_cast<const uint32_t*>(pst + sw_off(8 * c + i, 4 * lane)), 0, rot_sel);
        transpose4(r[0], col[0]);                  // col[h][j]: rows 4h .. 4h + 3 of column j
        transpose4(r[1], col[1]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t v[4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {            // k 8h .. 8h + 7: packed rows 4h .. 4h + 3
            uint32_t lo, hi;
            unpack_word(col[h][j], lo, hi);
            v[2 * h] = __byte_perm(lo, hi, 0x5140);       // rows 4h, 4h + 1
            v[2 * h + 1] = __byte_perm(lo, hi, 0x7362);   // rows 4h + 2, 4h + 3
          }
          const int n = 4 * lane + ((j + rot) & 3);
          // HALF: chunk c is k32 step c, in its half c % 2 of the step's 32 bytes.
          const int off = HALF ? (c >> 2) * A_TILE + sw_off(n, 32 * (c & 3) + 16 * (c & 1))
                               : sw_off(n, 16 * c);
          *reinterpret_cast<uint4*>(ast + off) = make_uint4(v[0], v[1], v[2], v[3]);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");   // for wgmma's reads
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(afull + s));
    }
    return;
  }

  // ---- consumer warpgroups ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(C::CREGS));
  const int wg = warp / 4, w = warp % 4;
  const int col = 64 * wg + 16 * w + lane / 4;   // this thread's D rows: n0 + col, +8
  const int tig = lane % 4;

  int32_t d0[TT / 2], d1[TT / 2];   // two int32 sets: groups alternate between them
  float acc[TT / 2];                // the fp32 sum over the groups
#pragma unroll
  for (int i = 0; i < TT / 2; ++i) {
    d0[i] = d1[i] = 0;
    acc[i] = 0.f;
  }
  float s_lo[2] = {0.f, 0.f}, s_hi[2] = {0.f, 0.f};   // each set's group scales
  const int gsteps = p.group / (HALF ? 16 : 32);       // k32 steps per group
  const int ngroups = k_len / p.group;
  const uint32_t a_base = smem_u32(as) + wg * (A_TILE / 2);   // this warpgroup's 64 rows n
  const uint32_t x_base = smem_u32(xs);
  int kb = 0, j = 0, released = 0;   // stage, k32 step in it, stages handed back
  const float* srow = ss + col;      // the next group's scale row
  mbar_wait(smem_u32(afull), 0);
  // Group g into set P = g % 2 (a constant in each copy): its steps' wgmmas,
  // then, once group g - 1's are done, the stages before g's first are
  // released and g - 1's set is scaled into acc while g's run.
  for (int g0 = 0; g0 < ngroups; g0 += 2) {
#pragma unroll
    for (int P = 0; P < 2; ++P) {
      const int g = g0 + P;
      if (g >= ngroups) break;
      int32_t(&d)[TT / 2] = P ? d1 : d0;
      int32_t(&prev)[TT / 2] = P ? d0 : d1;
      if (j == C::STEPS) {
        j = 0;
        ++kb;
        mbar_wait(smem_u32(afull + kb % STAGES), (kb / STAGES) & 1);
        srow = ss + (kb % STAGES) * (S_BYTES / 4) + col;
      }
      const int kb_first = kb;
      s_lo[P] = srow[0];
      s_hi[P] = srow[8];
      srow += BN;
      wgmma_fence();
      for (int st = 0; st < gsteps; ++st) {
        if (j == C::STEPS) {
          j = 0;
          ++kb;
          mbar_wait(smem_u32(afull + kb % STAGES), (kb / STAGES) & 1);
          srow = ss + (kb % STAGES) * (S_BYTES / 4) + col;
        }
        const int s = kb % STAGES;
        const uint32_t a_off = HALF ? (j >> 2) * A_TILE + 32 * (j & 3) : 32 * j;
        const uint32_t b_off = 32 * (HALF ? j >> 1 : j);
        wgmma_s8<TT>(d, sw128_desc(a_base + s * C::A_BYTES + a_off),
                     sw128_desc(x_base + s * C::X_BYTES + b_off), st);
        ++j;
      }
      wgmma_commit();
      // (No register fence on d here: an instruction that defines the
      // accumulators of an in-flight wgmma makes ptxas serialize the wgmmas.)
      wgmma_wait<1>();   // group g - 1's wgmmas are done
      if (released < kb_first) {
        __syncwarp();
        for (; released < kb_first; ++released)
          if (lane == 0) mbar_arrive(smem_u32(empty + released % STAGES));
      }
      if (g > 0) {
        fence_regs(prev);
        scale_group(acc, prev, s_lo[P ^ 1], s_hi[P ^ 1]);
      }
    }
  }
  wgmma_wait<0>();
  fence_regs(d0);
  fence_regs(d1);
  if ((ngroups - 1) & 1)
    scale_group(acc, d1, s_lo[1], s_hi[1]);
  else
    scale_group(acc, d0, s_lo[0], s_hi[0]);

  // ---- epilogue: D^T through shared memory (over the ring) as y rows ----
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");   // the ring is idle
  float* cs = reinterpret_cast<float*>(smem);                     // [TT][CLD]
#pragma unroll
  for (int v = 0; v < TT / 2; ++v) {
    // Accumulator v of a m64nN fragment: row 16w + l/4 + 8 (v/2 % 2), column
    // 8 (v/4) + 2 (l%4) + v%2.
    const int n = col + 8 * ((v >> 1) & 1);
    const int t = 8 * (v >> 2) + 2 * tig + (v & 1);
    cs[t * CLD + n] = acc[v];
  }
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");

  const int rows = p.T - t0 < TT ? p.T - t0 : TT;
  if (p.splits == 1) {
    for (int e = tid; e < rows * BN; e += CONSUMERS) {
      const int t = e / BN, c = e % BN;
      if (n0 + c < p.N)
        p.out[(long long)(t0 + t) * p.N + n0 + c] = __fmul_rn(cs[t * CLD + c], __ldg(p.sx + t0 + t));
    }
    return;
  }
  // Split-K: this split's partial, then the last CTA of the tile adds all in
  // order and applies sx.
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
  // Each element sums the splits' partials in split order, 4 splits' loads in flight.
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
    p.out[off] = __fmul_rn(sum, __ldg(p.sx + t0 + t));
  }
}

template <int TT, bool HALF>
int launch(const void* x8, const Params& p, int grid, cudaStream_t stream) {
  using C = Cfg<TT, HALF>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  // x8 (T, K) bytes: boxes of 128 k x TT rows. packed (K/2, N) bytes: boxes
  // of 128 columns x 64 rows, swizzled as the unpacking reads them. scales
  // (G, N) fp32: boxes of 128 columns x the rows of the groups a stage starts.
  CUtensorMap xmap, pmap, smap;
  if (!encode_2d(encode, &xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, x8, p.K, p.T, (uint64_t)p.K, BK,
                 TT, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  pmap = smap = xmap;   // unused unless p.tma_w
  if (p.tma_w &&
      !(encode_2d(encode, &pmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, p.packed, p.N, p.K / 2,
                  (uint64_t)p.ldp, BN, BK / 2, CU_TENSOR_MAP_SWIZZLE_128B) &&
        encode_2d(encode, &smap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, p.scales, p.N,
                  p.K / p.group, (uint64_t)p.lds * 4, BN, p.srows, CU_TENSOR_MAP_SWIZZLE_NONE)))
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(int4_w4a8_wgmma_kernel<TT, HALF>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  int4_w4a8_wgmma_kernel<TT, HALF><<<grid, NTHREADS, C::SMEM, stream>>>(xmap, pmap, smap, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch K6 on `stream`; returns the launch's cudaError_t (0 = success).
// x8 (T, K) int8 contiguous and 16-byte aligned, sx (T) fp32; ldp, lds: row
// strides of packed and scales in elements (their columns are contiguous);
// t_tile and splits: the plan of ops/int4_matmul.py::_k6_plan. With splits
// > 1, `work` holds splits * T * N floats and `counters` ceil(N/128) *
// ceil(T/t_tile) zeroed ints. Groups must be multiples of 16 and at most
// 128, and K / splits a multiple of 128 when splits > 1.
int openvla_int4_matmul_w4a8(const void* x8, const void* sx, const void* packed,
                             const void* scales, void* out, void* work, void* counters, int T,
                             int K, int N, int group, long long ldp, long long lds, int t_tile,
                             int splits, void* stream) {
  if (T <= 0 || N <= 0 || K <= 0 || group <= 0 || group % 16 || group > MAX_GROUP ||
      K % group || splits <= 0 || (K / group) % splits ||
      (splits > 1 && ((K / splits) % BK || !work || !counters)) ||
      reinterpret_cast<uintptr_t>(x8) % 16)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.packed = static_cast<const int8_t*>(packed);
  p.scales = static_cast<const float*>(scales);
  p.sx = static_cast<const float*>(sx);
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
  p.srows = (BK + group - 1) / group;
  const int grid = p.chunks * p.ntiles * splits;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool half = group % 32 != 0;
  switch (t_tile) {
    case 64: return half ? launch<64, true>(x8, p, grid, st) : launch<64, false>(x8, p, grid, st);
    case 96: return half ? launch<96, true>(x8, p, grid, st) : launch<96, false>(x8, p, grid, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
