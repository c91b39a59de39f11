// The K5 timing probe on Hopper: K5's kernel with its dequant step varied.
//
// Replaces the TPU kernel vla_scripts/exp_int4_probe.py::_kernel_probe (:53),
// called by `_probe_call` (:103). It splits K5's time into its parts by
// taking one part of the dequant away at a time; the plain versions are in
// ops/int4_probe.py. The kernel is K5's own (int4_w4a16.cuh: the TMA ring,
// the register-A wgmma, split-K and the epilogue) with another dequant
// policy, so the differences between its modes and K5 are the costs of the
// parts of the kernel that the serving path runs:
//   no-scale   (Dequant<NO_SCALE>):  y = sum_k x[t, k] * nibble(k, n)
//                  (WRONG NUMBERS by design: K5 - no-scale is the scale
//                  multiply and the scales' reads)
//   no-unpack  (Dequant<NO_UNPACK>): y = sum_i (x[t, 2i] + x[t, 2i+1]) * byte(i, n)
//                  (the signed byte as a number, no scale; WRONG NUMBERS by
//                  design: no-scale - no-unpack is the nibble unpack)
//   group-dots (Dequant<GROUP_DOTS>): y = sum_g (sum_{k in g} x[t, k] * nibble(k, n))
//                  * scales[g, n]  (a correct W4A16: the group scale
//                  multiplies the fp32 partial of each group, in registers,
//                  instead of every weight element)
// Operands, plan and workspace as K5's (openvla_int4_matmul_w4a16). Byte i
// gives weight rows 2i and 2i+1, as in K5: the TPU wrapper's split of x into
// even and odd halves exists only because Mosaic cannot relayout, and is not
// carried over.
//
// group-dots keeps the group's partial as a second accumulator set, so its
// tiles hold at most 128 rows of x (ops/int4_probe.py::_probe_plan); the
// first wgmma of a group starts the partial (scale-d 0), and at the group's
// end the consumers wait for it and add partial * scale to the sum in group
// order. A split of K holds whole groups, so each split folds its own and the
// last CTA to arrive adds the splits' partials, as K5 does.
//
// Bound. As K5: near balance at the probe's T = 112 (a 4096 x 12288 weight is
// 25 MB of int4 and 11 GFLOP at T = 112: 7.5 us of bytes, 11.4 us of bf16
// tensor-core time).

#include "int4_w4a16.cuh"

extern "C" {

// Launch the probe in `mode` (0 no-scale, 1 no-unpack, 2 group-dots) on
// `stream`; returns the launch's cudaError_t (0 = success). Every other
// argument as K5's openvla_int4_matmul_w4a16; group-dots takes t_tile 64 or
// 128.
int openvla_int4_probe(const void* x, const void* packed, const void* scales, void* out,
                       void* work, void* counters, int T, int K, int N, int group,
                       long long ldp, long long lds, int t_tile, int splits, int mode,
                       void* stream) {
  switch (mode) {
    case NO_SCALE:
      return launch_k5<Dequant<NO_SCALE>>(x, packed, scales, out, work, counters, T, K, N,
                                          group, ldp, lds, t_tile, splits, stream);
    case NO_UNPACK:
      return launch_k5<Dequant<NO_UNPACK>>(x, packed, scales, out, work, counters, T, K, N,
                                           group, ldp, lds, t_tile, splits, stream);
    case GROUP_DOTS:
      return launch_k5<Dequant<GROUP_DOTS>>(x, packed, scales, out, work, counters, T, K, N,
                                            group, ldp, lds, t_tile, splits, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
