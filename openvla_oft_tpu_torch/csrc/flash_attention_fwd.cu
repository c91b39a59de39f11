// K1 on Hopper: flash-attention forward with the OFT block-bidirectional mask.
//
// Replaces the TPU kernel openvla_oft_tpu/ops/flash_attention.py::_kernel
// (launched by _fwd_pallas). Same function, not the same block structure:
//
//   allow[i, j] = valid[j] AND (j <= i  OR  (bidir[i] AND bidir[j]))
//   (without `causal` the bracket is true)
//   O[i]  = sum_j softmax_j(q_i . k_j * D^-1/2 over allowed j) v_j   (0 if no j allowed)
//   LSE[i] = m_i + log(max(l_i, 1e-30)),  m_i = -1e30 for a row with no allowed key
//
// q (B,S,H,D), k/v (B,S,Hkv,D) bf16, read through their strides (last dim
// contiguous, other strides multiples of 8 elements, 16-byte aligned bases),
// so slices of the fused wqkv projection need no copy; GQA maps query head h
// to kv head h / (H/Hkv). O is (B,S,H,D) bf16 contiguous (K2 reads it so),
// LSE (B,H,S) fp32. Scores and softmax are fp32; probabilities are rounded
// to bf16 before the P.V product, as the TPU kernel's p.astype(v.dtype) does.
//
// Bound. Per live 64 x 64 tile pair and head, two products of 2*64*64*D
// FLOP (QK^T, PV) against q, k, v read once and O written once: at the
// LIBERO prefill (B=1, S=618) the bytes bound it (about 6 us), at the
// training batch (B=8, S=585) and the ALOHA length the operations do.
//
// Design (the machine of K2 in flash_attention_bwd.cu, with one product
// fewer per pair and an online softmax). One CTA per (b, h, 128 query rows),
// the longest rows first; two consumer warpgroups of 64 query rows each keep
// their Q tile resident in shared memory and their scores, softmax state
// (running max and sum) and O accumulator in registers. A loading warpgroup
// gives its registers to the consumers (setmaxnreg); its first warp walks the
// key tiles with the skip rule of oft_mask.cuh and keeps a ring of STAGES
// (K, V) 64-row tiles filled by TMA through 4-D tensor maps (rows past S
// arrive as zeros), each stage with a header of its key offset and flag
// masks; an empty header ends the walk. The flag masks of every tile are
// read once, by all warps before the roles split, while Q's copy lands, so
// the walk never waits on a global load. Per live pair a consumer warpgroup
//   - issues S = Q.K^T as SS wgmma m64n64k16 (both K-major),
//   - takes the row max over the accumulator layout (each row is spread over
//     4 lanes: two shuffles), in the log2 domain (scores times scale.log2e),
//   - rescales its O accumulator by alpha = 2^(m_old - m_new) in registers,
//   - forms P = 2^(s - m_new) with one ex2.approx per entry; entries the
//     mask refuses are set to -1e30 before the max, from one 64-bit mask
//     per row (oft_mask.cuh::row_allowed; partial pairs only: interior
//     pairs, oft_mask.cuh::tile_pair_interior, evaluate no mask),
//   - packs P in place into bf16 A fragments and issues O += P.V as RS wgmma
//     with the V tile as an MN-major B (the transpose bit).
// Nothing of S, P or O goes to shared memory. The row sums stay per thread
// (a quad's partial sums share their row's alpha) until the epilogue, which
// sums each quad, multiplies O by one reciprocal per row (64 IEEE divisions
// per thread were a large share of the fixed cost per CTA) and writes bf16 O
// and fp32 LSE for rows < S.
//
// A row with no allowed key keeps m = -1e30 * log2e (finite): its P is
// 2^(-1e30 - 0) = 0 exactly, so O = 0 exactly, and its LSE is
// m * ln2 + log(1e-30), about -1e30, as the plain version gives.
//
// Deterministic: the order of every sum is fixed, no atomics.
//
// Built with -DFWD_PARTS, the file also holds the variants that
// scripts/exp_fwd_parts.py times (the `Part` flags): without the softmax, or
// the wgmmas.

#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_wgmma.cuh"
#include "oft_mask.cuh"

namespace {

using namespace flash;

constexpr int ROWS = 64;                  // a consumer warpgroup's query rows; a ring tile's key rows
constexpr int CTA_ROWS = 2 * ROWS;        // query rows per CTA
constexpr int CONSUMERS = 256;            // two consumer warpgroups
constexpr int NTHREADS = CONSUMERS + 128; // + the loading warpgroup
constexpr int STAGES = 4;
static_assert(ROWS == 64 && CTA_ROWS == 128 && STAGES == 4,
              "the plan of ops/flash_attention.py::_fwd_plan (FWD_TILE, FWD_ROWS, FWD_STAGES)");
// setmaxnreg: the consumers take exactly what the loading warpgroup gives up
// of the 168 registers a thread of a 384-thread block starts with.
constexpr int CREGS = 232, LREGS = 168 - 2 * (CREGS - 168);
static_assert(CONSUMERS * CREGS + 128 * LREGS == NTHREADS * 168, "register split");
constexpr float MASKED = -1e30f;          // a refused entry's score (raw), as in the TPU kernel
constexpr float NO_MAX = -1e30f * LOG2E;  // the running max (log2 domain) of a row with no key yet
constexpr float LN2 = 0.6931471805599453f;

// What an instance does. The library's kernel is SHIPPED; the other
// combinations are the variants that scripts/exp_fwd_parts.py times (built
// with -DFWD_PARTS).
enum Part {
  SOFTMAX = 1,    // mask, max, rescale, exp2, sums; without: the raw scores go to P.V
  PRODUCTS = 2    // the wgmmas
};
constexpr int SHIPPED = SOFTMAX | PRODUCTS;

template <int D>
struct Layout {
  static_assert(D == 64 || D == 128, "D is 64 or 128");
  static constexpr int TILE = ROWS * D * 2;          // a 64-row tile: D / 64 boxes
  static constexpr int RES = CTA_ROWS * D * 2;       // the CTA's Q: two 64-row tiles
  static constexpr int STAGE = 2 * TILE;             // K and V of one key tile
  // [Q][ring][headers][full, empty, resident barriers][the flags of every
  // 64-row tile, 16 bytes each, sized at launch]: every tile starts on a
  // 1024-byte swizzle atom.
  static constexpr int HDR_OFF = RES + STAGES * STAGE;
  static constexpr int BAR_OFF = HDR_OFF + STAGES * 32;
  static constexpr int FLAGS_OFF = BAR_OFF + (2 * STAGES + 1) * 8 + 8;
  static constexpr int SMEM = 1024 + FLAGS_OFF;      // + 16 bytes per tile
};

struct Params {
  const uint8_t* key_valid;    // (B,S)
  const uint8_t* bidir;        // (B,S)
  __nv_bfloat16* o;            // (B,S,H,D)
  float* lse;                  // (B,H,S)
  int S, H, Hkv, causal;
  float scale;
};

struct Smem {
  uint8_t *res0, *ring;
  Header* hdr;
  uint64_t *full, *empty, *res_full;
  ulonglong2* flags;   // tile t: rows t * 64 .. (bit i: row exists and is) valid, bidirectional
};

template <int D>
__device__ __forceinline__ Smem carve(uint8_t* raw) {
  using L = Layout<D>;
  uint8_t* s = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                          ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(s + L::BAR_OFF);
  return {s, s + L::RES, reinterpret_cast<Header*>(s + L::HDR_OFF), bars, bars + STAGES,
          bars + 2 * STAGES, reinterpret_cast<ulonglong2*>(s + L::FLAGS_OFF)};
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D, int V>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, const Params p) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  const Smem sm = carve<D>(smem_raw);      // res0: Q; a stage: K, V

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int S = p.S;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * CTA_ROWS;   // the longest rows first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (p.H / p.Hkv);
  const uint8_t* valid_b = p.key_valid + (long long)b * S;
  const uint8_t* bidir_b = p.bidir + (long long)b * S;

  const int n_tiles = (S + ROWS - 1) / ROWS;
  if (tid == 0) {
    init_barriers<STAGES, CONSUMERS>(sm);
    prefetch_maps(&qmap, &kmap, &vmap);
    const uint32_t bar = smem_u32(sm.res_full);
    mbar_expect_tx(bar, L::RES);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      load_tile<D>(smem_u32(sm.res0 + hf * L::TILE), &qmap, bar, h, q0 + ROWS * hf, b);
  }
  // The flag masks of every 64-row tile, a tile per warp at a time, while
  // Q is copied: the walk and the consumers then read them from shared
  // memory instead of waiting on a global load per tile.
  for (int t = warp; t < n_tiles; t += NTHREADS / 32) {
    const unsigned long long v = row_mask(valid_b, t * ROWS, S, lane);
    const unsigned long long bd = row_mask(bidir_b, t * ROWS, S, lane);
    if (lane == 0) sm.flags[t] = make_ulonglong2(v, bd);
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- the loading warpgroup: its first warp walks the key tiles ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(LREGS));
    if (warp != CONSUMERS / 32) return;
    unsigned long long qb[2];   // each query half's bidirectional rows
    int q_hi[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int t = q0 / ROWS + hf;
      qb[hf] = t < n_tiles ? sm.flags[t].y : 0ull;
      q_hi[hf] = min(q0 + ROWS * hf + ROWS, S) - 1;
    }
    int it = 0;
    for (int k0 = 0; k0 < S; k0 += ROWS) {
      const ulonglong2 f = sm.flags[k0 / ROWS];
      const Keys km{f.x, f.x & f.y};
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
  const int wg = warp / 4, w = warp % 4, c = lane % 4;
  const int q0w = q0 + ROWS * wg, lr = 16 * w + lane / 4;   // rows lr and lr + 8 of 64
  const int qi0 = q0w + lr, qi1 = qi0 + 8;
  const bool has_rows = q0w < S;
  const unsigned long long qbm = has_rows ? sm.flags[q0w / ROWS].y : 0ull;
  const bool bid0 = bit(qbm, lr), bid1 = bit(qbm, lr + 8);
  const int q_hi = min(q0w + ROWS, S) - 1;
  const float sl2 = p.scale * LOG2E;
  const uint32_t qa = smem_u32(sm.res0 + wg * L::TILE);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  // Each of the thread's two rows: the running max (log2 domain, over the
  // whole row) and this thread's share of the running sum.
  float m[2] = {NO_MAX, NO_MAX}, l[2] = {0.f, 0.f};
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
      float sc[32];
      if constexpr ((V & PRODUCTS) != 0) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) wgmma_kk<64>(sc, kdesc(qa, kk), kdesc(ka, kk), kk);
        wgmma_commit();
        wgmma_wait<0>();
      } else {
#pragma unroll
        for (int v = 0; v < 32; ++v) sc[v] = 0.f;
      }
      settle(sc);
      if constexpr ((V & SOFTMAX) != 0) {
        // Accumulator v holds row lr + 8 ((v >> 1) & 1) and key column
        // 8 (v >> 2) + 2c + (v & 1) of the tile.
        if (!interior) {
          // The row's allowed keys, shifted so that bit 8j + e is column
          // 8j + 2c + e.
          const unsigned long long ok[2] = {
              oft::row_allowed(p.causal, qi0, k0, hd.m0, bid0, hd.m1) >> (2 * c),
              oft::row_allowed(p.causal, qi1, k0, hd.m0, bid1, hd.m1) >> (2 * c)};
#pragma unroll
          for (int v = 0; v < 32; ++v)
            if (!bit(ok[(v >> 1) & 1], 8 * (v >> 2) + (v & 1))) sc[v] = MASKED;
        }
        float mx[2] = {MASKED, MASKED};
#pragma unroll
        for (int v = 0; v < 32; ++v) mx[(v >> 1) & 1] = fmaxf(mx[(v >> 1) & 1], sc[v]);
        float alpha[2], mu[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float t = quad_max(mx[r]);
          const float m_new = fmaxf(m[r], t == MASKED ? NO_MAX : t * sl2);
          alpha[r] = exp2_(m[r] - m_new);
          m[r] = m_new;
          mu[r] = m_new == NO_MAX ? 0.f : m_new;   // a row with no key yet: P = 2^-huge = 0
        }
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int v = 0; v < 32; ++v) {
          const int hi = (v >> 1) & 1;
          sc[v] = exp2_(fmaf(sc[v], sl2, -mu[hi]));
          sum[hi] += sc[v];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + sum[r];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      }
      uint32_t f[4][4];
      to_frags(sc, f);
      if constexpr ((V & PRODUCTS) != 0) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs_t<D>(acc, f[kk], mndesc(va, kk));
        wgmma_commit();
        wgmma_wait<0>();
      }
      hold(f);
    }
    release(sm, s, lane);
  }

  settle(acc);
  // O: bf16 pairs of the thread's two rows, times one reciprocal per row;
  // rows past S are not written.
  float den[2], inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    den[r] = fmaxf(quad_sum(l[r]), 1e-30f);
    inv[r] = 1.f / den[r];
  }
#pragma unroll
  for (int v = 0; v < D / 2; v += 2) {
    const int col = 8 * (v >> 2) + 2 * c, hi = (v >> 1) & 1, row = hi ? qi1 : qi0;
    if (row < S)
      *reinterpret_cast<__nv_bfloat162*>(p.o + (((long long)b * S + row) * p.H + h) * D + col) =
          __floats2bfloat162_rn(acc[v] * inv[hi], acc[v + 1] * inv[hi]);
  }
  if (c == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? qi1 : qi0;
      if (row < S) p.lse[((long long)b * p.H + h) * S + row] = m[r] * LN2 + logf(den[r]);
    }
  }
}

// ------------------------------------------------------------------- host
template <int D, int V = SHIPPED>
int launch(const void* q, const void* k, const void* v, const Params& p, int B,
           const long long (&st)[9], cudaStream_t stream) {
  using L = Layout<D>;
  const cudaError_t bound = bind_device_of(q);
  if (bound != cudaSuccess) return (int)bound;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -(int)CUDA_ERROR_NOT_FOUND;
  CUtensorMap m[3];
  const void* ptr[3] = {q, k, v};
  const int heads[3] = {p.H, p.Hkv, p.Hkv};
  for (int i = 0; i < 3; ++i) {
    const CUresult res = encode_operand(encode, &m[i], ptr[i], D, heads[i], p.S, B,
                                        st[3 * i], st[3 * i + 1], st[3 * i + 2]);
    if (res != CUDA_SUCCESS) return -(int)res;   // the encoder's CUresult, negated
  }
  const int smem = L::SMEM + 16 * ((p.S + ROWS - 1) / ROWS);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D, V>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((p.S + CTA_ROWS - 1) / CTA_ROWS, p.H, B);
  flash_fwd_kernel<D, V><<<grid, NTHREADS, smem, stream>>>(m[0], m[1], m[2], p);
  return (int)cudaGetLastError();
}

bool valid_call(const void* q, const void* k, const void* v, int B, int S, int H, int Hkv,
                const long long (&st)[9]) {
  for (long long x : st)
    if (x % 8) return false;
  return B > 0 && S > 0 && Hkv > 0 && H % Hkv == 0 && aligned16(q) && aligned16(k) &&
         aligned16(v);
}

}  // namespace

extern "C" {

// Launch K1 on `stream`; returns the launch's cudaError_t (0 = success), or
// minus the CUresult of the tensor-map encoder where it refused an operand.
// Strides are in elements (batch, seq, head) of q, k and v; O (B,S,H,D) and
// LSE (B,H,S) are contiguous. The wrapper checks shapes and dtypes.
int openvla_flash_attention_fwd(const void* q, const void* k, const void* v,
                                const void* key_valid, const void* bidir,
                                void* o, void* lse, int B, int S, int H,
                                int Hkv, int D,
                                long long q_sb, long long q_ss, long long q_sh,
                                long long k_sb, long long k_ss, long long k_sh,
                                long long v_sb, long long v_ss, long long v_sh,
                                int causal, float scale, void* stream) {
  const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  if (!valid_call(q, k, v, B, S, H, Hkv, st) || (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  const Params p{static_cast<const uint8_t*>(key_valid), static_cast<const uint8_t*>(bidir),
                 static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), S, H, Hkv, causal,
                 scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch<64>(q, k, v, p, B, st, s) : launch<128>(q, k, v, p, B, st, s);
}

#ifdef FWD_PARTS
// A variant of K1 at D = 128: `parts` is a combination of Part (SHIPPED is
// the library's kernel); the other arguments as for the entry above.
int openvla_flash_attention_fwd_parts(int parts, const void* q, const void* k, const void* v,
                                      const void* key_valid, const void* bidir, void* o,
                                      void* lse, int B, int S, int H, int Hkv,
                                      long long q_sb, long long q_ss, long long q_sh,
                                      long long k_sb, long long k_ss, long long k_sh,
                                      long long v_sb, long long v_ss, long long v_sh,
                                      int causal, float scale, void* stream) {
  const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  if (!valid_call(q, k, v, B, S, H, Hkv, st)) return (int)cudaErrorInvalidValue;
  const Params p{static_cast<const uint8_t*>(key_valid), static_cast<const uint8_t*>(bidir),
                 static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), S, H, Hkv, causal,
                 scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (parts) {
#define FWD_VARIANT(flags) \
  case (flags): return launch<128, (flags)>(q, k, v, p, B, st, s);
    FWD_VARIANT(SHIPPED)
    FWD_VARIANT(SHIPPED & ~SOFTMAX)
    FWD_VARIANT(SHIPPED & ~PRODUCTS)
    FWD_VARIANT(0)
#undef FWD_VARIANT
    default: return (int)cudaErrorInvalidValue;
  }
}
#endif

const char* openvla_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
