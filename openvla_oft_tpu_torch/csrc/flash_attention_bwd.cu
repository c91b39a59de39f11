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
// with scale = D^-1/2 and the mask rule, tile-skip rule and interior rule of
// oft_mask.cuh, which K1 shares. P and dS round to bf16 before
// their products, as the TPU kernels' astype(v.dtype) / astype(q.dtype) do;
// every product accumulates in fp32 on the tensor cores (wgmma).
//
// Dead rows (no allowed key) carry LSE = -1e30 from K1, so exp(S - LSE)
// overflows there; P is taken by a select on `allow`, never a multiply, so
// the overflow never reaches a product. A dead row is never in an interior
// pair (that pair would allow it a key). Rows past S carry LSE = +1e30 in the
// stats rows below, so their P is exp(-huge) = 0 without a select.
//
// Bound. At the LIBERO training shape (B=8, S=585, H=32, D=128) one layer's
// backward is 3 (K2) + 4 (K3) products of 2*64*64*128 FLOP per live 64x64
// tile pair and head against a few tens of MB of operands: compute-bound.
//
// Design (both kernels). A CTA of three warpgroups: two consumer warpgroups
// of 64 rows each, whose accumulators stay in registers, and a loading
// warpgroup whose first warp keeps a ring of STAGES stages filled by TMA
// (setmaxnreg moves its registers to the consumers); the tiles, tensor maps,
// wgmma forms and ring helpers are flash_wgmma.cuh's, shared with K1. Per
// 64 x 64 pair a consumer
// issues two SS wgmmas for the scores and dP, turns them into P (one
// ex2.approx per entry) and dS in registers from the accumulator layout
// (interior pairs without allow()), converts them in place into bf16 A
// fragments (the accumulator's layout is the A fragment's, as in
// FlashAttention-3) and issues the RS wgmmas of its products. Nothing of
// S, dP, P or dS goes to shared memory. The loading warp walks the tiles
// with the skip rule and writes each stage's header (its row offset, head,
// flag masks); an empty header ends the walk.
//
// K2 (dq): one CTA per (b, h, 128 query rows), longest rows first. Q and dO
// stay resident; K and V come through the ring as 64-row key tiles. The
// consumers first compute delta for the CTA's rows from dO and O (two threads
// per row) and, when asked, write (LSE, delta) as the stats rows (B, H,
// s_pad) that K3 reads; rows past S get (+1e30, 0).
//
// K3 (dk, dv): one CTA per (b, kv head, 128 key rows). K and V stay resident;
// Q and dO come through the ring as 64-row query tiles of every head of the
// GQA group, each with its 64 stats rows (one bulk copy). The group is summed
// in the fp32 accumulators, with one rounding to bf16 at the end. A key tile
// with no valid key, and every invalid key row, is written as zero.
// flash_bwd_stats_kernel writes the stats rows when K3 is called alone.
//
// Deterministic: every sum runs in a fixed order, no atomics.
//
// Built with -DBWD_PARTS, the file also holds the variants that
// scripts/exp_bwd_parts.py times (the `Part` flags): without delta, P and
// dS or the wgmmas.
//
// q, k, v and dO are read through their strides (last dim contiguous, other
// strides multiples of 8 elements, 16-byte aligned bases), O is (B,S,H,D)
// and LSE (B,H,S) as K1 writes them; dq is (B,S,H,D) and dk/dv (B,S,Hkv,D),
// contiguous bf16.

#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_wgmma.cuh"
#include "oft_mask.cuh"

namespace {

using namespace flash;

constexpr int ROWS = 64;                  // a warpgroup's rows (wgmma M); a ring tile's rows
constexpr int CTA_ROWS = 2 * ROWS;        // K2's query rows, K3's key rows per CTA
constexpr int CONSUMERS = 256;            // two consumer warpgroups
constexpr int NTHREADS = CONSUMERS + 128; // + the loading warpgroup
constexpr int STAGES = 4;
static_assert(ROWS == 64 && CTA_ROWS == 128 && STAGES == 4,
              "the plan of ops/flash_attention.py::_bwd_plan (BWD_TILE, BWD_ROWS, BWD_STAGES)");
// setmaxnreg: the consumers take exactly what the loading warpgroup gives up
// of the 168 registers a thread of a 384-thread block starts with (a larger
// request would wait for registers that never come free).
constexpr int CREGS = 232, LREGS = 168 - 2 * (CREGS - 168);
static_assert(CONSUMERS * CREGS + 128 * LREGS == NTHREADS * 168, "register split");
constexpr float PAD_LSE = 1e30f;          // stats of rows past S: P = 0

// What an instance does. The library's kernels are SHIPPED; the other
// combinations are the variants that scripts/exp_bwd_parts.py times (built
// with -DBWD_PARTS).
enum Part {
  SCORES = 1,     // P and dS from the scores; without: the raw accumulators
  PRODUCTS = 2,   // the wgmmas
  DELTA = 4       // K2: delta from dO and O in the prologue; without: delta = 0
};
constexpr int SHIPPED = SCORES | PRODUCTS | DELTA;

template <int D>
struct Layout {
  static_assert(D == 64 || D == 128, "D is 64 or 128");
  static constexpr int TILE = ROWS * D * 2;          // a 64-row tile: D / 64 boxes
  static constexpr int RES = 2 * CTA_ROWS * D * 2;   // two resident 128-row tiles
  static constexpr int STAGE = 2 * TILE;             // two 64-row tiles per stage
  static constexpr int STATS = ROWS * 8;             // K3: a query tile's (LSE, delta)
  // [resident tiles][ring][stats rows][headers][full, empty, resident
  // barriers]: every tile starts on a 1024-byte swizzle atom.
  static constexpr int STATS_OFF = RES + STAGES * STAGE;
  static constexpr int HDR_OFF = STATS_OFF + STAGES * STATS;
  static constexpr int BAR_OFF = HDR_OFF + STAGES * 32;
  static constexpr int SMEM = 1024 + BAR_OFF + (2 * STAGES + 1) * 8;
  static_assert(SMEM + CTA_ROWS * 8 <= SMEM_LIMIT, "shared memory");
};

struct Params {
  const __nv_bfloat16* o;      // K2 and the stats pass: (B,S,H,D) contiguous
  const float* lse;            // (B,H,S)
  const __nv_bfloat16* dout;   // read through d_sb, d_ss, d_sh by the delta pass
  long long d_sb, d_ss, d_sh;
  const uint8_t* key_valid;    // (B,S)
  const uint8_t* bidir;        // (B,S)
  float2* stats;               // (B,H,s_pad) (LSE, delta): K2 writes (if set), K3 reads
  __nv_bfloat16* out0;         // dq | dk
  __nv_bfloat16* out1;         // -  | dv
  int S, H, Hkv, s_pad, causal;
  float scale;
};

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xFFFF0000u); }

// (LSE, delta) of query row `row` of head h, delta = sum_d dO * O in fp32:
// lanes 2r and 2r + 1 take one half of D each. Rows past S get (+1e30, 0).
template <int D, bool WITH_DELTA = true>
__device__ __forceinline__ float2 row_stats(const Params& p, int b, int h, int row, int half) {
  float acc = 0.f;
  if (WITH_DELTA && row < p.S) {
    const uint4* o4 = reinterpret_cast<const uint4*>(
        p.o + (((long long)b * p.S + row) * p.H + h) * D + half * (D / 2));
    const uint4* d4 = reinterpret_cast<const uint4*>(p.dout + b * p.d_sb + row * p.d_ss +
                                                     h * p.d_sh + half * (D / 2));
#pragma unroll
    for (int i = 0; i < D / 16; ++i) {
      const uint4 x = o4[i], y = d4[i];
      const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc += bf16_lo(xs[j]) * bf16_lo(ys[j]) + bf16_hi(xs[j]) * bf16_hi(ys[j]);
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  return row < p.S ? make_float2(p.lse[((long long)b * p.H + h) * p.S + row], acc)
                   : make_float2(PAD_LSE, 0.f);
}

struct Smem {
  uint8_t *res0, *res1, *ring, *stats;
  Header* hdr;
  uint64_t *full, *empty, *res_full;
};

template <int D>
__device__ __forceinline__ Smem carve(uint8_t* raw) {
  using L = Layout<D>;
  uint8_t* s = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                          ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(s + L::BAR_OFF);
  return {s, s + L::RES / 2, s + L::RES, s + L::STATS_OFF,
          reinterpret_cast<Header*>(s + L::HDR_OFF), bars, bars + STAGES, bars + 2 * STAGES};
}

// ---------------------------------------------------------------- K2 (dq)
template <int D, int V>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap dmap, const Params p) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  const Smem sm = carve<D>(smem_raw);      // res0: Q, res1: dO; a stage: K, V
  __shared__ float2 s_stats[CTA_ROWS];     // (LSE, delta) of the CTA's rows

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int S = p.S;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * CTA_ROWS;   // the longest rows first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (p.H / p.Hkv);
  const uint8_t* valid_b = p.key_valid + (long long)b * S;
  const uint8_t* bidir_b = p.bidir + (long long)b * S;

  if (tid == 0) init_barriers<STAGES, CONSUMERS>(sm);
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- the loading warpgroup: its first warp walks the key tiles ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(LREGS));
    if (warp != CONSUMERS / 32) return;
    unsigned long long qb[2];   // each query half's bidirectional rows
    int q_hi[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      qb[hf] = row_mask(bidir_b, q0 + ROWS * hf, S, lane);
      q_hi[hf] = min(q0 + ROWS * hf + ROWS, S) - 1;
    }
    if (lane == 0) {
      prefetch_maps(&qmap, &kmap, &vmap, &dmap);
      const uint32_t bar = smem_u32(sm.res_full);
      mbar_expect_tx(bar, L::RES);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        load_tile<D>(smem_u32(sm.res0 + hf * L::TILE), &qmap, bar, h, q0 + ROWS * hf, b);
        load_tile<D>(smem_u32(sm.res1 + hf * L::TILE), &dmap, bar, h, q0 + ROWS * hf, b);
      }
    }
    int it = 0;
    for (int k0 = 0; k0 < S; k0 += ROWS) {
      const Keys km = key_masks(valid_b, bidir_b, k0, S, lane);
      bool live = false;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        live |= q0 + ROWS * hf < S &&
                oft::tile_pair_live(p.causal, k0, q_hi[hf], qb[hf] != 0, km.valid != 0,
                                    km.bid != 0);
      if (!live) continue;   // uniform across the warp
      const int s = next_slot<STAGES>(sm, it++);
      if (lane == 0) {
        sm.hdr[s] = Header{k0, 0, 0, 0, km.valid, km.bid};
        const uint32_t bar = smem_u32(sm.full + s), dst = smem_u32(sm.ring + s * L::STAGE);
        mbar_expect_tx(bar, L::STAGE);
        load_tile<D>(dst, &kmap, bar, hk, k0, b);
        load_tile<D>(dst + L::TILE, &vmap, bar, hk, k0, b);
      }
    }
    end_walk<STAGES>(sm, it, lane);
    return;
  }

  // ---- two consumer warpgroups: 64 query rows each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CREGS));
  {
    // delta once per query row: two threads per row of the CTA's 128.
    const int r = tid >> 1;
    const float2 st = row_stats<D, (V & DELTA) != 0>(p, b, h, q0 + r, tid & 1);
    if (!(tid & 1)) {
      s_stats[r] = st;
      if (p.stats != nullptr)   // s_pad covers every CTA's rows (the entry's check)
        p.stats[((long long)b * p.H + h) * p.s_pad + q0 + r] = st;
    }
  }
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");

  const int wg = warp / 4, w = warp % 4, c = lane % 4;
  const int q0w = q0 + ROWS * wg, lr = 16 * w + lane / 4;   // rows lr and lr + 8 of 64
  const int qi0 = q0w + lr, qi1 = qi0 + 8;
  const float2 st0 = s_stats[ROWS * wg + lr], st1 = s_stats[ROWS * wg + lr + 8];
  const unsigned long long qbm = row_mask(bidir_b, q0w, S, lane);
  const bool bid0 = bit(qbm, lr), bid1 = bit(qbm, lr + 8);
  const bool has_rows = q0w < S;
  const int q_hi = min(q0w + ROWS, S) - 1;
  const float scale = p.scale, sl2 = scale * LOG2E;
  const float nl0 = -st0.x * LOG2E, nl1 = -st1.x * LOG2E;
  const uint32_t qa = smem_u32(sm.res0 + wg * L::TILE), da = smem_u32(sm.res1 + wg * L::TILE);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  mbar_wait(smem_u32(sm.res_full), 0);
  for (int it = 0;; ++it) {
    const int s = it % STAGES;
    mbar_wait(smem_u32(sm.full + s), (it / STAGES) & 1);
    const Header hd = sm.hdr[s];
    if (hd.r0 < 0) break;
    const int k0 = hd.r0;
    if (has_rows && oft::tile_pair_live(p.causal, k0, q_hi, qbm != 0, hd.m0 != 0, hd.m1 != 0)) {
      const bool interior =
          oft::tile_pair_interior(p.causal, k0 + ROWS - 1, q0w, hd.m0 == ~0ull);
      const uint32_t ka = smem_u32(sm.ring + s * L::STAGE), va = ka + L::TILE;
      float sc[32], dp[32];
      if constexpr ((V & PRODUCTS) != 0) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) wgmma_kk<64>(sc, kdesc(qa, kk), kdesc(ka, kk), kk);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) wgmma_kk<64>(dp, kdesc(da, kk), kdesc(va, kk), kk);
        wgmma_commit();
        wgmma_wait<1>();   // S done
      }
      settle(sc);
      if constexpr ((V & SCORES) != 0) {
        // P in place while dP runs. Accumulator v holds row lr + 8 ((v >> 1)
        // & 1) and key column 8 (v >> 2) + 2c + (v & 1) of the tile.
#pragma unroll
        for (int v = 0; v < 32; ++v) {
          const int col = 8 * (v >> 2) + 2 * c + (v & 1);
          const bool hi = (v >> 1) & 1;
          float pv = exp2_(fmaf(sc[v], sl2, hi ? nl1 : nl0));
          if (!interior && !oft::allow(p.causal, hi ? qi1 : qi0, k0 + col, bit(hd.m0, col),
                                       hi ? bid1 : bid0, bit(hd.m1, col)))
            pv = 0.f;   // a select: dead rows' exp overflows
          sc[v] = pv;
        }
      }
      if constexpr ((V & PRODUCTS) != 0) wgmma_wait<0>();
      settle(dp);
      if constexpr ((V & SCORES) != 0) {
#pragma unroll
        for (int v = 0; v < 32; ++v)
          dp[v] = sc[v] * (dp[v] - ((v >> 1) & 1 ? st1.y : st0.y)) * scale;
      }
      uint32_t f[4][4];
      to_frags(dp, f);
      if constexpr ((V & PRODUCTS) != 0) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs_t<D>(acc, f[kk], mndesc(ka, kk));
        wgmma_commit();
        wgmma_wait<0>();
      }
      hold(f);
    }
    release(sm, s, lane);
  }

  settle(acc);
  // dq: bf16 pairs of the thread's two rows; rows past S are not written.
#pragma unroll
  for (int v = 0; v < D / 2; v += 2) {
    const int col = 8 * (v >> 2) + 2 * c, row = (v >> 1) & 1 ? qi1 : qi0;
    if (row < S)
      *reinterpret_cast<__nv_bfloat162*>(p.out0 + (((long long)b * S + row) * p.H + h) * D +
                                         col) = __floats2bfloat162_rn(acc[v], acc[v + 1]);
  }
}

// ------------------------------------------------------------- K3 (dk, dv)
template <int D, int V>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap dmap, const Params p) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  const Smem sm = carve<D>(smem_raw);      // res0: K, res1: V; a stage: Q, dO (+ stats rows)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int S = p.S;
  const int k0 = blockIdx.x * CTA_ROWS, hk = blockIdx.y, b = blockIdx.z;
  const int rep = p.H / p.Hkv;
  const uint8_t* valid_b = p.key_valid + (long long)b * S;
  const uint8_t* bidir_b = p.bidir + (long long)b * S;

  if (tid == 0) init_barriers<STAGES, CONSUMERS>(sm);
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- the loading warpgroup: its first warp walks the query tiles ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(LREGS));
    if (warp != CONSUMERS / 32) return;
    Keys kh[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) kh[hf] = key_masks(valid_b, bidir_b, k0 + ROWS * hf, S, lane);
    if ((kh[0].valid | kh[1].valid) == 0) return;   // no valid key: the consumers write zeros
    if (lane == 0) {
      prefetch_maps(&qmap, &kmap, &vmap, &dmap);
      const uint32_t bar = smem_u32(sm.res_full);
      mbar_expect_tx(bar, L::RES);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        load_tile<D>(smem_u32(sm.res0 + hf * L::TILE), &kmap, bar, hk, k0 + ROWS * hf, b);
        load_tile<D>(smem_u32(sm.res1 + hf * L::TILE), &vmap, bar, hk, k0 + ROWS * hf, b);
      }
    }
    int it = 0;
    for (int q0 = 0; q0 < S; q0 += ROWS) {
      const unsigned long long qb = row_mask(bidir_b, q0, S, lane);
      const int q_hi = min(q0 + ROWS, S) - 1;
      bool live = false;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        live |= oft::tile_pair_live(p.causal, k0 + ROWS * hf, q_hi, qb != 0,
                                    kh[hf].valid != 0, kh[hf].bid != 0);
      if (!live) continue;   // uniform across the warp
      for (int g = 0; g < rep; ++g) {   // the heads of the GQA group
        const int h = hk * rep + g;
        const int s = next_slot<STAGES>(sm, it++);
        if (lane == 0) {
          sm.hdr[s] = Header{q0, h, 0, 0, qb, 0ull};
          const uint32_t bar = smem_u32(sm.full + s), dst = smem_u32(sm.ring + s * L::STAGE);
          mbar_expect_tx(bar, L::STAGE + L::STATS);
          load_tile<D>(dst, &qmap, bar, h, q0, b);
          load_tile<D>(dst + L::TILE, &dmap, bar, h, q0, b);
          bulk_load(smem_u32(sm.stats + s * L::STATS),
                    p.stats + ((long long)b * p.H + h) * p.s_pad + q0, L::STATS, bar);
        }
      }
    }
    end_walk<STAGES>(sm, it, lane);
    return;
  }

  // ---- two consumer warpgroups: 64 key rows each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CREGS));
  const int wg = warp / 4, w = warp % 4, c = lane % 4;
  const Keys k_lo = key_masks(valid_b, bidir_b, k0, S, lane);
  const Keys k_up = key_masks(valid_b, bidir_b, k0 + ROWS, S, lane);
  const Keys km = wg ? k_up : k_lo;
  const int kw = k0 + ROWS * wg, lr = 16 * w + lane / 4;    // key rows lr and lr + 8 of 64
  const int kr0 = kw + lr, kr1 = kr0 + 8;
  const bool kv0 = bit(km.valid, lr), kv1 = bit(km.valid, lr + 8);
  const bool kb0 = bit(km.bid, lr), kb1 = bit(km.bid, lr + 8);
  const float scale = p.scale, sl2 = scale * LOG2E;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  if ((k_lo.valid | k_up.valid) != 0) {
    const uint32_t ka = smem_u32(sm.res0 + wg * L::TILE), va = smem_u32(sm.res1 + wg * L::TILE);
    mbar_wait(smem_u32(sm.res_full), 0);
    for (int it = 0;; ++it) {
      const int s = it % STAGES;
      mbar_wait(smem_u32(sm.full + s), (it / STAGES) & 1);
      const Header hd = sm.hdr[s];
      if (hd.r0 < 0) break;
      const int q0 = hd.r0;
      if (oft::tile_pair_live(p.causal, kw, min(q0 + ROWS, S) - 1, hd.m0 != 0, km.valid != 0,
                              km.bid != 0)) {
        const bool interior =
            oft::tile_pair_interior(p.causal, kw + ROWS - 1, q0, km.valid == ~0ull);
        const uint32_t qa = smem_u32(sm.ring + s * L::STAGE), da = qa + L::TILE;
        // (LSE, delta) of query columns 8j + 2c and 8j + 2c + 1 at [4j + c].
        const float4* st = reinterpret_cast<const float4*>(sm.stats + s * L::STATS);
        float sc[32], dp[32];
        if constexpr ((V & PRODUCTS) != 0) {
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            wgmma_kk<64>(sc, kdesc(ka, kk), kdesc(qa, kk), kk);
          wgmma_commit();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            wgmma_kk<64>(dp, kdesc(va, kk), kdesc(da, kk), kk);
          wgmma_commit();
          wgmma_wait<1>();   // S^T done
        }
        settle(sc);
        if constexpr ((V & SCORES) != 0) {
          // P^T in place while dP^T runs. Accumulator v = 4j + 2hi + e holds
          // key row lr + 8 hi and query column 8j + 2c + e of the tile.
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float4 t = st[4 * j + c];
#pragma unroll
            for (int hi = 0; hi < 2; ++hi)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int v = 4 * j + 2 * hi + e, col = 8 * j + 2 * c + e;
                float pv = exp2_(fmaf(sc[v], sl2, -(e ? t.z : t.x) * LOG2E));
                if (!interior && !oft::allow(p.causal, q0 + col, hi ? kr1 : kr0,
                                             hi ? kv1 : kv0, bit(hd.m0, col), hi ? kb1 : kb0))
                  pv = 0.f;   // a select: dead rows' exp overflows
                sc[v] = pv;
              }
          }
        }
        if constexpr ((V & PRODUCTS) != 0) wgmma_wait<0>();
        settle(dp);
        if constexpr ((V & SCORES) != 0) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float4 t = st[4 * j + c];
#pragma unroll
            for (int v = 4 * j; v < 4 * j + 4; ++v)
              dp[v] = sc[v] * (dp[v] - (v & 1 ? t.w : t.y)) * scale;
          }
        }
        uint32_t pf[4][4], df[4][4];
        to_frags(sc, pf);
        to_frags(dp, df);
        if constexpr ((V & PRODUCTS) != 0) {
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) wgmma_rs_t<D>(dv, pf[kk], mndesc(da, kk));
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) wgmma_rs_t<D>(dk, df[kk], mndesc(qa, kk));
          wgmma_commit();
          wgmma_wait<0>();
        }
        hold(pf);
        hold(df);
      }
      release(sm, s, lane);
    }
  }

  settle(dk);
  settle(dv);
  // dk, dv: bf16 pairs of the thread's two key rows, zero for invalid keys;
  // rows past S are not written.
#pragma unroll
  for (int v = 0; v < D / 2; v += 2) {
    const int col = 8 * (v >> 2) + 2 * c;
    const bool hi = (v >> 1) & 1;
    const int row = hi ? kr1 : kr0;
    if (row >= S) continue;
    const bool ok = hi ? kv1 : kv0;
    const long long off = (((long long)b * S + row) * p.Hkv + hk) * D + col;
    *reinterpret_cast<__nv_bfloat162*>(p.out0 + off) =
        __floats2bfloat162_rn(ok ? dk[v] : 0.f, ok ? dk[v + 1] : 0.f);
    *reinterpret_cast<__nv_bfloat162*>(p.out1 + off) =
        __floats2bfloat162_rn(ok ? dv[v] : 0.f, ok ? dv[v + 1] : 0.f);
  }
}

// ---------------------------------------------- the stats rows for K3 alone
// (LSE, delta) of every row of (B, H, s_pad), two threads per row: what K2
// writes on the way, for a K3 called without K2.
template <int D>
__global__ void __launch_bounds__(128) flash_bwd_stats_kernel(const Params p) {
  const int row = blockIdx.x * ROWS + threadIdx.x / 2, h = blockIdx.y, b = blockIdx.z;
  const float2 st = row_stats<D>(p, b, h, row, threadIdx.x & 1);
  if (!(threadIdx.x & 1)) p.stats[((long long)b * p.H + h) * p.s_pad + row] = st;
}

// ------------------------------------------------------------------- host
struct Strides {
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, d_sb, d_ss, d_sh;
};

// The tensor maps of q, k, v and dO (flash_wgmma.cuh::encode_operand).
template <int D>
CUresult encode_maps(CUtensorMap (&maps)[4], const void* q, const void* k, const void* v,
                     const void* dout, int B, int S, int H, int Hkv, const Strides& st) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return CUDA_ERROR_NOT_FOUND;
  const void* ptr[4] = {q, k, v, dout};
  const int heads[4] = {H, Hkv, Hkv, H};
  const long long strides[4][3] = {{st.q_sb, st.q_ss, st.q_sh}, {st.k_sb, st.k_ss, st.k_sh},
                                   {st.v_sb, st.v_ss, st.v_sh}, {st.d_sb, st.d_ss, st.d_sh}};
  for (int i = 0; i < 4; ++i) {
    const CUresult res = encode_operand(encode, &maps[i], ptr[i], D, heads[i], S, B,
                                        strides[i][0], strides[i][1], strides[i][2]);
    if (res != CUDA_SUCCESS) return res;
  }
  return CUDA_SUCCESS;
}

template <int D, bool DQ, int V = SHIPPED>
int launch(const void* q, const void* k, const void* v, const void* dout, const Params& p,
           int B, const Strides& st, cudaStream_t stream) {
  using L = Layout<D>;
  const cudaError_t bound = bind_device_of(q);
  if (bound != cudaSuccess) return (int)bound;
  CUtensorMap m[4];
  const CUresult encoded = encode_maps<D>(m, q, k, v, dout, B, p.S, p.H, p.Hkv, st);
  if (encoded != CUDA_SUCCESS) return -(int)encoded;   // the encoder's CUresult, negated
  auto kernel = DQ ? flash_bwd_dq_kernel<D, V> : flash_bwd_dkv_kernel<D, V>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((p.S + CTA_ROWS - 1) / CTA_ROWS, DQ ? p.H : p.Hkv, B);
  kernel<<<grid, NTHREADS, L::SMEM, stream>>>(m[0], m[1], m[2], m[3], p);
  return (int)cudaGetLastError();
}

// The checks shared by the entries: sizes, the stats rows' padding, alignment.
bool valid_call(int B, int S, int H, int Hkv, int D, int s_pad, const Strides& st) {
  const long long all[12] = {st.q_sb, st.q_ss, st.q_sh, st.k_sb, st.k_ss, st.k_sh,
                             st.v_sb, st.v_ss, st.v_sh, st.d_sb, st.d_ss, st.d_sh};
  for (long long x : all)
    if (x % 8) return false;
  return B > 0 && S > 0 && Hkv > 0 && H % Hkv == 0 && (D == 64 || D == 128) &&
         s_pad >= S && s_pad % CTA_ROWS == 0;
}

}  // namespace

extern "C" {

// Launch K2 on `stream`; returns the launch's cudaError_t (0 = success), or
// minus the CUresult of the tensor-map encoder where it refused an operand.
// Strides (in elements) are (batch, seq, head) of q, k, v and dO. `stats`
// (B, H, s_pad) float2, or null: where set, K2 writes (LSE, delta) of every
// query row there for K3. The wrapper checks shapes and dtypes.
int openvla_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* o, const void* lse,
    const void* dout, const void* key_valid, const void* bidir, void* dq, void* stats, int B,
    int S, int H, int Hkv, int D, int s_pad, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long d_sb, long long d_ss, long long d_sh, int causal,
    float scale, void* stream) {
  const Strides st{q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, d_sb, d_ss, d_sh};
  if (!valid_call(B, S, H, Hkv, D, s_pad, st) || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(dout) || !aligned16(o))
    return (int)cudaErrorInvalidValue;
  const Params p{static_cast<const __nv_bfloat16*>(o), static_cast<const float*>(lse),
                 static_cast<const __nv_bfloat16*>(dout), d_sb, d_ss, d_sh,
                 static_cast<const uint8_t*>(key_valid), static_cast<const uint8_t*>(bidir),
                 static_cast<float2*>(stats), static_cast<__nv_bfloat16*>(dq), nullptr,
                 S, H, Hkv, s_pad, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch<64, true>(q, k, v, dout, p, B, st, s)
                 : launch<128, true>(q, k, v, dout, p, B, st, s);
}

// Launch K3 on `stream`; arguments as for K2, with `stats` (B, H, s_pad)
// float2 as K2 or the stats pass wrote them (K3 reads no O and no LSE), and
// dk and dv (B,S,Hkv,D).
int openvla_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* stats, const void* dout,
    const void* key_valid, const void* bidir, void* dk, void* dv, int B, int S, int H, int Hkv,
    int D, int s_pad, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long d_sb, long long d_ss, long long d_sh, int causal, float scale,
    void* stream) {
  const Strides st{q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, d_sb, d_ss, d_sh};
  if (!valid_call(B, S, H, Hkv, D, s_pad, st) || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(dout) || !aligned16(stats))
    return (int)cudaErrorInvalidValue;
  const Params p{nullptr, nullptr, static_cast<const __nv_bfloat16*>(dout), d_sb, d_ss, d_sh,
                 static_cast<const uint8_t*>(key_valid), static_cast<const uint8_t*>(bidir),
                 const_cast<float2*>(static_cast<const float2*>(stats)),
                 static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
                 S, H, Hkv, s_pad, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch<64, false>(q, k, v, dout, p, B, st, s)
                 : launch<128, false>(q, k, v, dout, p, B, st, s);
}

// Launch the stats pass: (LSE, delta) of every row into `stats` (B, H, s_pad)
// float2, from O (B,S,H,D) contiguous, LSE (B,H,S) and dO through its strides.
int openvla_flash_attention_bwd_stats(const void* o, const void* lse, const void* dout,
                                      void* stats, int B, int S, int H, int D, int s_pad,
                                      long long d_sb, long long d_ss, long long d_sh,
                                      void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || (D != 64 && D != 128) || s_pad < S ||
      s_pad % CTA_ROWS || d_sb % 8 || d_ss % 8 || d_sh % 8 || !aligned16(o) || !aligned16(dout))
    return (int)cudaErrorInvalidValue;
  const Params p{static_cast<const __nv_bfloat16*>(o), static_cast<const float*>(lse),
                 static_cast<const __nv_bfloat16*>(dout), d_sb, d_ss, d_sh, nullptr, nullptr,
                 static_cast<float2*>(stats), nullptr, nullptr, S, H, 1, s_pad, 0, 0.f};
  const dim3 grid(s_pad / ROWS, H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    flash_bwd_stats_kernel<64><<<grid, 128, 0, s>>>(p);
  else
    flash_bwd_stats_kernel<128><<<grid, 128, 0, s>>>(p);
  return (int)cudaGetLastError();
}

#ifdef BWD_PARTS
// A variant of K2 (kernel 0: o, lse, stats written, out0 = dq) or K3
// (kernel 1: stats read, out0 = dk, out1 = dv) at D = 128: `parts` is a
// combination of Part (SHIPPED is the library's kernel); the other
// arguments as for the entries above.
int openvla_flash_attention_bwd_parts(
    int kernel, int parts, const void* q, const void* k, const void* v, const void* o,
    const void* lse, void* stats, const void* dout, const void* key_valid, const void* bidir,
    void* out0, void* out1, int B, int S, int H, int Hkv, int s_pad, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long d_sb, long long d_ss,
    long long d_sh, int causal, float scale, void* stream) {
  const Strides st{q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, d_sb, d_ss, d_sh};
  if (!valid_call(B, S, H, Hkv, 128, s_pad, st) || stats == nullptr)
    return (int)cudaErrorInvalidValue;
  const Params p{static_cast<const __nv_bfloat16*>(o), static_cast<const float*>(lse),
                 static_cast<const __nv_bfloat16*>(dout), d_sb, d_ss, d_sh,
                 static_cast<const uint8_t*>(key_valid), static_cast<const uint8_t*>(bidir),
                 static_cast<float2*>(stats), static_cast<__nv_bfloat16*>(out0),
                 static_cast<__nv_bfloat16*>(out1), S, H, Hkv, s_pad, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kernel * 100 + parts) {
#define BWD_VARIANT(kern, flags) \
  case kern * 100 + (flags): return launch<128, kern == 0, (flags)>(q, k, v, dout, p, B, st, s);
    BWD_VARIANT(0, SHIPPED)
    BWD_VARIANT(0, SHIPPED & ~DELTA)
    BWD_VARIANT(0, SHIPPED & ~SCORES)
    BWD_VARIANT(0, SHIPPED & ~PRODUCTS)
    BWD_VARIANT(0, 0)
    BWD_VARIANT(1, SHIPPED)
    BWD_VARIANT(1, SHIPPED & ~SCORES)
    BWD_VARIANT(1, SHIPPED & ~PRODUCTS)
    BWD_VARIANT(1, 0)
#undef BWD_VARIANT
    default: return (int)cudaErrorInvalidValue;
  }
}
#endif

}  // extern "C"
