// K5 on Hopper: the int4 W4A16 dequant-matmul, with wgmma.
//
// Replaces the TPU kernels of openvla_oft_tpu/ops/int4_matmul.py:
//   _kernel (:43, int4_matmul_fused) and _kernel_stacked (:199,
//   int4_matmul_fused_stacked). Every operand is read through its row
//   stride, so a layer view packed[l] or a column view packed[:, lo:hi]
//   needs no copy and one kernel serves both TPU variants.
//
//   y[t, n] = sum_k bf16(x[t, k]) * bf16(nibble(k, n) * scales[k / group, n])
//
// x (T, K) bf16 contiguous (the wrapper rounds fp32 x to bf16, as the TPU
// kernel does); packed (K/2, N) int8, byte (i, n) holding weight row 2i in
// its low nibble and row 2i+1 in its high nibble, each a signed 4-bit value
// (ops/quant.py::quantize_weight_int4); scales (G, N) fp32, G = K / group,
// group a multiple of 16; y (T, N) fp32. A nibble times its group scale is
// one fp32 multiply rounded to bf16: the same weight as the plain version's
// dequantized bf16 weight, so only the fp32 summation order differs.
//
// Bound. At T = 618 the LLM's linears are compute-bound on the card (wqkv:
// 62 GFLOP, 0.063 ms at the bf16 tensor-core peak, against 0.0075 ms for
// its 25 MB of int4); at T = 57 bytes and operations come near balance.
//
// Design (swap-AB). The CTA computes the transposed tile y^T (128 output
// columns n x T_TILE rows t) as D = A * B with wgmma m64nT_TILEk16:
//  - A (64 columns n x 16 k, one per consumer warpgroup) is the dequantized
//    weight, built in registers. In the register layout of a 16-bit A
//    fragment, lane l of warp w holds rows n = 16w + l/4 (+8) at the k pairs
//    2(l%4) + {0, 1} (+8). A pair (k even, k odd) of one column is exactly
//    one packed byte, so each A register (bf16x2) is one byte: 4 shared-
//    memory bytes per thread and k16 step. The weight tile is dequantized
//    once per CTA for all T_TILE rows, so at T <= T_TILE once in the grid.
//  - B (16 k x T_TILE rows t) is x's tile, K-major in shared memory with the
//    128-byte swizzle, read by a wgmma descriptor.
//  - Each thread keeps the scales of its two columns in registers and loads
//    them once per group. The nibble becomes an fp32 exactly by a bit trick
//    (no int-to-float conversion): 2^23 + (nibble ^ 8) - (2^23 + 8). A
//    thread's 16 bytes of a stage are at fixed offsets from one address, and
//    groups are counted in k16 steps: no division in the loop.
//  - The consumers dequantize a whole stage (4 k16 steps) at a time into one
//    of two register sets, and issue its 4 wgmmas as one group, so that the
//    next stage's dequant follows the issue of this stage's products.
//  - A producer warpgroup (one working warp; its registers go to the
//    consumers by setmaxnreg) keeps a ring of STAGES stages of 64 k in
//    flight, synchronised by mbarriers (full: data landed; empty: both
//    warpgroups are done with it). x comes by TMA (cp.async.bulk.tensor with
//    SWIZZLE_128B, the layout the descriptor reads); the packed bytes (32
//    rows x 128 columns, swizzled so that the consumers' reads are free of
//    bank conflicts) and the scales by TMA too where their base and row
//    stride are 16-byte aligned, else by cp.async in 16- or 4-byte chunks
//    where address, stride and width allow, else by byte loads. The choice
//    is made per launch from the pointers and strides.
//  - Split-K at small T: when the grid is under one wave, `splits` CTAs
//    share an output tile, each over K / splits (whole groups, a multiple of
//    64). Each writes its fp32 partial to a workspace; the last to arrive
//    (an atomic counter that the wrapper zeroes) adds the partials in split
//    order and writes y. Two calls give bitwise-equal y.
//  - Epilogue: the accumulators go through shared memory as y rows, so the
//    global writes are row-coalesced; rows past T and columns past N are
//    masked.
// What holds it back (measured on the card, scripts/exp_k5_overlap.py): a
// wgmma that reads A from registers does not overlap the consumers' own
// dequant arithmetic, while the same work with A read from shared memory
// does; and the x tile of every 128-column CTA comes again through L2.
// The plan (T_TILE, splits) comes from ops/int4_matmul.py::_k5_plan.
//
// The kernel is in int4_w4a16.cuh, templated on its dequant step (the
// policy Dequant<MODE>): K5 is Dequant<SCALED>, and the K5 timing probe
// (int4_probe.cu) runs the same kernel with the other policies.

#include "int4_w4a16.cuh"

extern "C" {

// Launch K5 on `stream`; returns the launch's cudaError_t (0 = success).
// x (T, K) bf16 contiguous and 16-byte aligned; ldp, lds: row strides of
// packed and scales in elements (their columns are contiguous); t_tile and
// splits: the plan of ops/int4_matmul.py::_k5_plan. With splits > 1, `work`
// holds splits * T * N floats and `counters` ceil(N/128) * ceil(T/t_tile)
// zeroed ints. Groups must be multiples of 16, and K / splits a multiple of
// 64 when splits > 1.
int openvla_int4_matmul_w4a16(const void* x, const void* packed, const void* scales, void* out,
                              void* work, void* counters, int T, int K, int N, int group,
                              long long ldp, long long lds, int t_tile, int splits,
                              void* stream) {
  return launch_k5<Dequant<SCALED>>(x, packed, scales, out, work, counters, T, K, N, group, ldp,
                                    lds, t_tile, splits, stream);
}

}  // extern "C"
