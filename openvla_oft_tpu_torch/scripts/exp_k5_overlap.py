"""What holds K5 back: its time with one part of its work taken away at a time.

K5 (`csrc/int4_w4a16.cu`) runs three things per 64-deep stage: the ring of
asynchronous copies that brings x's tile, the packed bytes and the scales
(the "pipe"), the consumers' dequant arithmetic into wgmma's register A
operand, and the wgmmas. This script builds variants of K5's own source (its
kernel header `csrc/int4_w4a16.cuh` inlined), each a text substitution that
the script checks applies, and times them at the 7B's int4 shapes with the
plan that K5 takes (`ops/int4_matmul.py::_k5_plan`):

  k5          K5 as shipped
  no-dequant  A is a constant (no shared-memory reads of the packed bytes, no
              dequant arithmetic): the pipe and the wgmmas
  no-mma      no wgmma (the dequantized registers are kept alive): the pipe
              and the dequant
  pipe        neither: the ring of copies and the barriers alone
  ss          the dequant runs as in K5, but each wgmma reads A from shared
              memory (x's tile stands in for the weight: WRONG NUMBERS by
              design) instead of from the registers the dequant wrote

Every variant but k5 gives wrong numbers by design; only k5 is checked
against `int4_matmul_ref`. Times are medians of CUDA-event timings, with the
L2 flushed before each call, beside `torch.matmul` on the dequantized bf16
weight.

    python -m openvla_oft_tpu_torch.scripts.exp_k5_overlap [--iters 20]

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
from openvla_oft_tpu_torch.ops.quant import dequantize_int4, quantize_weight_int4
from openvla_oft_tpu_torch.utils.timing import cuda_time_ms, l2_flush_buffer

SHAPES = [("wqkv", 4096, 12288), ("gate_up", 4096, 22016), ("wo", 4096, 4096),
          ("down", 11008, 4096)]
ROWS = (618, 57)
SOURCE = _build.CSRC_DIR / "int4_w4a16.cu"
HEADER = _build.CSRC_DIR / "int4_w4a16.cuh"   # K5's kernel, shared with the probe
OUT_DIR = _build.BUILD_DIR / "exp_k5_overlap"

_WGMMA = "wgmma_rs<TT>(acc, a[P][j], sw128_desc(xbase + j * 32));"
_DEQUANT = "    uint32_t b[BK / 16][4];\n"
_CONST_A = ("  if (gsteps >= 0) {\n    for (int j = 0; j < BK / 16; ++j)\n"
            "      for (int i = 0; i < 4; ++i) r[j][i] = 0x3F803F80u;\n    return;\n  }\n")
_NO_MMA = "{ hold(a[P][j]); acc[0] += __uint_as_float(a[P][j][0] ^ a[P][j][3]); }"
_HOLD_DECL = "// Keeps a[] in its registers up to this point"


def _ss_wgmma(n: int) -> str:
    """wgmma m64nNk16 with A and B both read from shared memory."""
    nr = n // 2
    regs = ", ".join(f"%{i}" for i in range(nr))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(nr))
    return (f"template <> __device__ __forceinline__ void wgmma_ss<{n}>(float (&d)[{nr}], "
            f"uint64_t da, uint64_t db) {{\n  asm volatile(\"{{\\n .reg .pred p;\\n setp.ne.b32 "
            f"p, %{nr + 2}, 0;\\n wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
            f"{{{regs}}}, %{nr}, %{nr + 1}, p, 1, 1, 0, 0;\\n}}\"\n    : {outs}\n"
            f"    : \"l\"(da), \"l\"(db), \"r\"(1));\n}}\n")


def _replace(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"K5's source no longer holds {old.strip()!r} once: update "
                           "the parts script's substitutions")
    return text.replace(old, new)


def k5_source() -> str:
    """K5's translation unit with its kernel's header inlined: one text that
    holds the whole machine, for the substitutions."""
    header = HEADER.read_text().replace("#pragma once\n", "")
    return _replace(SOURCE.read_text(), '#include "int4_w4a16.cuh"\n', header)


def variant_sources() -> dict:
    """name -> CUDA source of every timed variant."""
    src = k5_source()
    no_dequant = _replace(src, _DEQUANT, _CONST_A + _DEQUANT)
    ss_decl = ("template <int N>\n__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], "
               "uint64_t da, uint64_t db);\n" + "".join(_ss_wgmma(n) for n in M.K5_T_TILES))
    ss = _replace(src, _HOLD_DECL, ss_decl + "\n" + _HOLD_DECL)
    return {
        "k5": src,
        "no-dequant": no_dequant,
        "no-mma": _replace(src, _WGMMA, _NO_MMA),
        "pipe": _replace(no_dequant, _WGMMA, _NO_MMA),
        "ss": _replace(ss, _WGMMA, "{ wgmma_ss<TT>(acc, sw128_desc(xbase + j * 32), "
                                   "sw128_desc(xbase + j * 32)); hold(a[P][j]); }"),
    }


def build_variants() -> dict:
    """name -> the variant's entry point, each built with nvcc into its own library."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _build._find_nvcc()
    jobs = {}
    for name, text in variant_sources().items():
        cu = OUT_DIR / f"{name}.cu"
        cu.write_text(text)
        cmd = [nvcc, *_build.NVCC_FLAGS[:-1], "-I", str(_build.CSRC_DIR), "-shared", "-o",
               str(OUT_DIR / f"{name}.so"), str(cu)]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
    fns = {}
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, proc in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{out}")
        fn = ctypes.CDLL(str(OUT_DIR / f"{name}.so")).openvla_int4_matmul_w4a16
        fn.argtypes = [p] * 6 + [i] * 4 + [i64, i64, i, i, p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main(argv=None) -> dict:
    """Prints one line per shape and returns {"ms": {"wqkv T=618": {variant:
    ms, "torch.matmul": ms}}, "plan": {...}, "k5_rel_err": {...}}."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=20,
                        help="timed calls per variant (the median is kept)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("exp_k5_overlap times the card's kernels and needs a CUDA device")
    dev = torch.device("cuda")
    fns = build_variants()
    flush = l2_flush_buffer(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    result = {"ms": {}, "plan": {}, "k5_rel_err": {}}
    for rows in ROWS:
        for name, k_dim, n in SHAPES:
            label = f"{name} T={rows}"
            x = torch.randn((rows, k_dim), generator=gen, device=dev).bfloat16()
            q4 = quantize_weight_int4(torch.randn((k_dim, n), generator=gen, device=dev) * 0.02)
            packed, scales = q4["kernel_q4"], q4["scale_w4"]
            group = k_dim // scales.shape[0]
            t_tile, splits, grid = M._k5_plan(rows, k_dim, n, group)
            out = torch.empty((rows, n), dtype=torch.float32, device=dev)
            work = torch.empty((splits, rows, n), dtype=torch.float32, device=dev)
            counters = torch.zeros(-(-n // M.K5_BN) * -(-rows // t_tile), dtype=torch.int32,
                                   device=dev)
            stream = torch.cuda.current_stream(dev).cuda_stream

            def launch(fn):
                if splits > 1:
                    counters.zero_()
                err = fn(x.data_ptr(), packed.data_ptr(), scales.data_ptr(), out.data_ptr(),
                         work.data_ptr(), counters.data_ptr(), rows, k_dim, n, group,
                         packed.stride(0), scales.stride(0), t_tile, splits, stream)
                _build.check_launch(err, "exp_k5_overlap")

            times = {}
            for vname, fn in fns.items():
                launch(fn)
                torch.cuda.synchronize()
                if vname == "k5":
                    ref = M.int4_matmul_ref(x, packed, scales)
                    result["k5_rel_err"][label] = ((out - ref).abs().max()
                                                   / ref.abs().max()).item()
                times[vname] = cuda_time_ms(lambda: launch(fn), iters=args.iters, flush=flush)
            w16 = dequantize_int4(packed, scales, torch.bfloat16)
            times["torch.matmul"] = cuda_time_ms(lambda: torch.matmul(x, w16), iters=args.iters,
                                                 flush=flush)
            result["ms"][label] = times
            result["plan"][label] = (t_tile, splits, grid)
            print(f"{label}: plan (t_tile {t_tile}, splits {splits}, {grid} CTAs); "
                  + ", ".join(f"{v} {t:.4f}" for v, t in times.items())
                  + f" ms; K5 rel err {result['k5_rel_err'][label]:.2e} (median of "
                  f"{args.iters}, CUDA events, L2 flushed)", flush=True)
            del x, q4, packed, scales, out, work, counters, w16
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
