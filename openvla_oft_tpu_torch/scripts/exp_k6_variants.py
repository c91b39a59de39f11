"""Where K6's A operand comes from, and what holds K6 back: its time in variants.

K6 (`csrc/int4_w4a8.cu`) runs per 128-deep stage: the ring of copies (x8's
tile, the packed bytes, the scales), the unpacking warpgroup's transpose of
the packed bytes into a K-major int8 tile in shared memory (the wgmma A
operand, "SS": both operands from shared memory), the int8 wgmmas, and the
consumers' per-group scaling of the int32 partials into fp32. This script
builds variants of K6's own source, each a text substitution that the
script checks applies, and times them at the 7B's int4 shapes with the plan
that K6 takes (`ops/int4_matmul.py::_k6_plan`):

  k6            K6 as shipped (SS)
  rs            A from registers, as K5 does it: the consumers unpack each
                k32 step's A fragment from the packed bytes themselves (two
                shared-memory bytes per register) and issue the register form
                of the wgmma; the unpacking warpgroup does no work. A correct
                W4A8, checked like k6 (groups of 128 only)
  no-unpack     the unpacking warpgroup does no work (A is whatever the tile
                holds: WRONG NUMBERS by design): the ring, the wgmmas and the
                scaling
  no-scale      each group's int32 set is not scaled into fp32 (WRONG
                NUMBERS by design): the ring, the unpacking and the wgmmas

K6 is also timed with its other compiled t_tile at the plan's split
("k6 t_tile N"). Times are medians of CUDA-event timings around the kernel's launch alone
(x8 and sx quantized once beforehand), with the L2 flushed before each call,
beside `torch._int_mm` on the unpacked int8 weight (no scales).

    python -m openvla_oft_tpu_torch.scripts.exp_k6_variants [--iters 20]

It needs a CUDA card and nvcc: it times the card's kernels.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from openvla_oft_tpu_torch import _build
from openvla_oft_tpu_torch.ops import int4_matmul as M
from openvla_oft_tpu_torch.ops.quant import _unpack_int4, quantize_weight_int4
from openvla_oft_tpu_torch.utils.timing import cuda_time_ms, l2_flush_buffer

SHAPES = [("wqkv", 4096, 12288), ("gate_up", 4096, 22016), ("wo", 4096, 4096),
          ("down", 11008, 4096)]
ROWS = (618, 57)
SOURCE = _build.CSRC_DIR / "int4_w4a8.cu"
OUT_DIR = _build.BUILD_DIR / "exp_k6_variants"
CHECKED = ("k6", "rs")            # the variants that compute W4A8

_ANCHOR = "// Keeps an accumulator set in its registers up to this point"
_DECL = "  float acc[TT / 2];                // the fp32 sum over the groups\n"
_STEPS = "      for (int st = 0; st < gsteps; ++st) {\n"
_MMA = ("        wgmma_s8<TT>(d, sw128_desc(a_base + s * C::A_BYTES + a_off),\n"
        "                     sw128_desc(x_base + s * C::X_BYTES + b_off), st);\n")
_WAIT1 = "      wgmma_wait<1>();   // group g - 1's wgmmas are done\n"
_WAIT0 = "  wgmma_wait<0>();\n"
_UNPACK = "      for (int it = 0; it < 2; ++it) {\n"
_SCALE = "        scale_group(acc, prev, s_lo[P ^ 1], s_hi[P ^ 1]);\n"

# The register form of the int8 wgmma, the fragment build and the register hold.
_RS_HELPERS = r'''
template <int N>
__device__ __forceinline__ void wgmma_s8_rs(int32_t (&d)[N / 2], const uint32_t (&a)[4],
                                            uint64_t desc_b, int accumulate);
{specs}
// A fragment register from packed bytes b (rows 2i) and b1 (2i + 1) of one
// column: k 4i .. 4i + 3 as signed bytes.
__device__ __forceinline__ uint32_t frag_word(uint32_t b, uint32_t b1) {{
  uint32_t lo, hi;
  unpack_word(b | (b1 << 8), lo, hi);
  return __byte_perm(lo, hi, 0x5140);
}}

__device__ __forceinline__ void hold4(uint32_t (&a)[4][4]) {{
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[s][i])::"memory");
}}

'''
# Step st of the group: A rows n = col, col + 8 at k 32j + 4 tig (+16), from
# the packed stage's rows 16j + 2 tig (+1) and 16j + 8 + 2 tig (+1).
_RS_MMA = r'''        {
          const uint8_t* pst = ps + s * P_BYTES;
          const int r = 16 * j + 2 * tig;
          ra[P][st][0] = frag_word(pst[sw_off(r, col)], pst[sw_off(r + 1, col)]);
          ra[P][st][1] = frag_word(pst[sw_off(r, col + 8)], pst[sw_off(r + 1, col + 8)]);
          ra[P][st][2] = frag_word(pst[sw_off(r + 8, col)], pst[sw_off(r + 9, col)]);
          ra[P][st][3] = frag_word(pst[sw_off(r + 8, col + 8)], pst[sw_off(r + 9, col + 8)]);
          wgmma_fence();   // the registers were just written
          wgmma_s8_rs<TT>(d, ra[P][st], sw128_desc(x_base + s * C::X_BYTES + b_off), st);
        }
'''


def _rs_spec(n: int) -> str:
    """wgmma m64nNk32.s32.s8.s8 with A from registers."""
    nr = n // 2
    regs = ", ".join(f"%{i}" for i in range(nr))
    outs = ", ".join(f'"+r"(d[{i}])' for i in range(nr))
    return (f"template <> __device__ __forceinline__ void wgmma_s8_rs<{n}>(int32_t (&d)[{nr}], "
            f"const uint32_t (&a)[4], uint64_t desc_b, int accumulate) {{\n"
            f"  asm volatile(\"{{\\n .reg .pred p;\\n setp.ne.b32 p, %{nr + 5}, 0;\\n "
            f"wgmma.mma_async.sync.aligned.m64n{n}k32.s32.s8.s8 {{{regs}}}, "
            f"{{%{nr}, %{nr + 1}, %{nr + 2}, %{nr + 3}}}, %{nr + 4}, p;\\n}}\"\n"
            f"    : {outs}\n"
            f"    : \"r\"(a[0]), \"r\"(a[1]), \"r\"(a[2]), \"r\"(a[3]), \"l\"(desc_b), "
            f"\"r\"(accumulate));\n}}\n")


def _replace(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"K6's source no longer holds {old.strip()!r} once: update "
                           "exp_k6_variants' substitutions")
    return text.replace(old, new)


def variant_sources() -> dict:
    """name -> CUDA source of every timed variant."""
    src = SOURCE.read_text()
    rs = _replace(src, _ANCHOR, _RS_HELPERS.format(
        specs="".join(_rs_spec(n) for n in M.K6_T_TILES)) + _ANCHOR)
    rs = _replace(rs, _DECL, _DECL + "  uint32_t ra[2][4][4];             // A of a group's 4 steps, per set\n")
    rs = _replace(rs, _STEPS, "#pragma unroll\n      for (int st = 0; st < 4; ++st) {   // groups of 128\n")
    rs = _replace(rs, _MMA, _RS_MMA)
    rs = _replace(rs, _WAIT1, _WAIT1 + "      hold4(ra[P ^ 1]);\n")
    rs = _replace(rs, _WAIT0, _WAIT0 + "  hold4(ra[0]);\n  hold4(ra[1]);\n")
    rs = _replace(rs, _UNPACK, "      for (int it = 0; it < 0; ++it) {\n")
    return {
        "k6": src,
        "rs": rs,
        "no-unpack": _replace(src, _UNPACK, "      for (int it = 0; it < 0; ++it) {\n"),
        "no-scale": _replace(src, _SCALE, "        acc[0] += (float)prev[0];\n"),
    }


def build_variants() -> dict:
    """name -> (the variant's entry point, its ptxas lines), each built with
    nvcc into its own library."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _build._find_nvcc()
    jobs = {}
    for name, text in variant_sources().items():
        cu = OUT_DIR / f"{name}.cu"
        cu.write_text(text)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-shared", "-o",
               str(OUT_DIR / f"{name}.so"), str(cu)]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
    fns = {}
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, proc in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{out}")
        fn = ctypes.CDLL(str(OUT_DIR / f"{name}.so")).openvla_int4_matmul_w4a8
        fn.argtypes = [p] * 7 + [i] * 4 + [i64, i64, i, i, p]
        fn.restype = ctypes.c_int
        fns[name] = (fn, [ln.strip() for ln in out.splitlines() if "Used" in ln or "spill" in ln])
    return fns


def main(argv=None) -> dict:
    """Prints one line per shape and returns {"ms": {"wqkv T=618": {variant:
    ms, "torch._int_mm": ms}}, "plan": {...}, "rel_err": {...}, "ptxas": {...}}."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=20,
                        help="timed calls per variant (the median is kept)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("exp_k6_variants times the card's kernels and needs a CUDA device")
    dev = torch.device("cuda")
    fns = build_variants()
    for name, (_, ptxas) in fns.items():
        print(f"[ptxas] {name}: " + " | ".join(ptxas), flush=True)
    flush = l2_flush_buffer(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    result = {"ms": {}, "plan": {}, "rel_err": {}, "ptxas": {n: v[1] for n, v in fns.items()}}
    for rows in ROWS:
        for name, k_dim, n in SHAPES:
            label = f"{name} T={rows}"
            x = torch.randn((rows, k_dim), generator=gen, device=dev).bfloat16()
            q4 = quantize_weight_int4(torch.randn((k_dim, n), generator=gen, device=dev) * 0.02)
            packed, scales = q4["kernel_q4"], q4["scale_w4"]
            group = k_dim // scales.shape[0]
            x8, sx = M.quantize_act_rows(x)
            t_tile, splits, grid = M._k6_plan(rows, k_dim, n, group)
            out = torch.empty((rows, n), dtype=torch.float32, device=dev)
            work = torch.empty((splits, rows, n), dtype=torch.float32, device=dev)
            counters = torch.zeros(-(-n // M.K6_BN) * -(-rows // min(M.K6_T_TILES)),
                                   dtype=torch.int32, device=dev)
            stream = torch.cuda.current_stream(dev).cuda_stream

            def launch(fn, tile=t_tile):
                if splits > 1:
                    counters.zero_()
                err = fn(x8.data_ptr(), sx.data_ptr(), packed.data_ptr(), scales.data_ptr(),
                         out.data_ptr(), work.data_ptr(), counters.data_ptr(), rows, k_dim, n,
                         group, packed.stride(0), scales.stride(0), tile, splits, stream)
                _build.check_launch(err, "exp_k6_variants")

            ref = M.int4_matmul_a8_ref(x, packed, scales)
            times, errs = {}, {}
            for vname, (fn, _) in fns.items():
                launch(fn)
                torch.cuda.synchronize()
                if vname in CHECKED:
                    errs[vname] = ((out - ref).abs().max() / ref.abs().max()).item()
                times[vname] = cuda_time_ms(lambda: launch(fn), iters=args.iters, flush=flush)
            for tile in M.K6_T_TILES:
                if tile != t_tile:
                    times[f"k6 t_tile {tile}"] = cuda_time_ms(lambda: launch(fns["k6"][0], tile),
                                                              iters=args.iters, flush=flush)
            w8 = _unpack_int4(packed)
            if rows > 16:   # the faster of a row-major and a column-major weight
                times["torch._int_mm"] = min(
                    cuda_time_ms(lambda: torch._int_mm(x8, w), iters=args.iters, flush=flush)
                    for w in (w8, w8.t().contiguous().t()))
            result["ms"][label] = times
            result["plan"][label] = (t_tile, splits, grid)
            result["rel_err"][label] = errs
            print(f"{label}: plan (t_tile {t_tile}, splits {splits}, {grid} CTAs); "
                  + ", ".join(f"{v} {t:.4f}" for v, t in times.items())
                  + " ms; rel err " + ", ".join(f"{v} {e:.2e}" for v, e in errs.items())
                  + f" (median of {args.iters}, CUDA events, L2 flushed)", flush=True)
            if any(not e <= 1e-4 for e in errs.values()):
                raise AssertionError(f"a W4A8 variant disagrees with int4_matmul_a8_ref at {label}")
            del x, q4, packed, scales, x8, sx, out, work, counters, w8, ref
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
