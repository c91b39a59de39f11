"""K5 against another build of its source, and what the probe's group-dots
fold costs: the parts run of the K5 timing probe.

K5 (`csrc/int4_w4a16.cu`) and the probe (`csrc/int4_probe.cu`) run one kernel,
`csrc/int4_w4a16.cuh`, with different dequant policies. This script answers
two questions about it, in one process:

1. Does K5 stay as it was? With `--parent DIR` (the `csrc/` of another build,
   for example the parent commit unpacked by `git archive`), K5's source in
   DIR and K5's source here are each compiled alone into a library of their
   own, and called with the same plan (`ops/int4_matmul.py::_k5_plan`) on the
   same seeded inputs at the 7B's int4 shapes (wqkv, gate_up, down, and wo as
   layer 1 of a stacked (2, K/2, N) weight) and T = 57, 112 and 618. Their
   outputs must be bitwise equal; their device times are taken in the order
   DIR, here, here, DIR, and the ratio is here / DIR.
2. What does group-dots' fold cost? At T = 112 and the probe's three shapes,
   beside no-scale (the same dequant, no fold) and group-dots as shipped:
     no-fold  group-dots with the fold's multiply and add taken away (the
              wait for each group's partial kept; WRONG NUMBERS by design)
   so group-dots - no-fold is the fold's arithmetic, and no-fold - no-scale
   the wait at each group's end and the scales' reads; each with the
   probe's plan and with tiles of 64 rows, the only tiles where a ping-pong
   of two partial sets (no wait) fits. Then the ping-pong itself at 64-row
   tiles (a substitution of the consumers' loop, for groups of 128):
     ping-pong  group g folded while group g + 1's first products run

Times are device times (torch.profiler, the mean of `--iters` calls, the L2
flushed before each; `utils/timing.py::device_ms`). Libraries go to
`_build/exp_probe_parts/`.

    python -m openvla_oft_tpu_torch.scripts.exp_probe_parts [--parent DIR] [--iters 10]

It needs a CUDA card and nvcc: it times the card's kernels. It raises where
K5's two builds disagree.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from openvla_oft_tpu_torch import _build
from openvla_oft_tpu_torch.ops import int4_matmul as M
from openvla_oft_tpu_torch.ops.int4_probe import MODES, _probe_plan
from openvla_oft_tpu_torch.ops.quant import quantize_weight_int4
from openvla_oft_tpu_torch.scripts.exp_k5_overlap import _replace
from openvla_oft_tpu_torch.utils.timing import device_ms, l2_flush_buffer

# (name, K, N, how the weight is handed over)
K5_SHAPES = [("wqkv", 4096, 12288, "whole"), ("gate_up", 4096, 22016, "whole"),
             ("down", 11008, 4096, "whole"), ("wo layer view", 4096, 4096, "layer")]
K5_ROWS = (57, 112, 618)
PROBE_T = 112
PROBE_SHAPES = [("qkv", 4096, 12288), ("gate_up", 4096, 22016), ("down", 11008, 4096)]
OUT_DIR = _build.BUILD_DIR / "exp_probe_parts"

_FOLD = "    sum[v] = __fadd_rn(sum[v], __fmul_rn(part[v], s[(v >> 1) & 1]));\n"
_NO_FOLD = "    sum[v] = part[v];\n"
# The consumers' stage loop, from its first line to the fence after its last wait.
_LOOP_FIRST = "  for (int kb0 = 0; kb0 < nkb; kb0 += 2) {\n"
_LOOP_LAST = '  for (int i = 0; i < TT / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");\n'
# The ping-pong variant of group-dots' loop, for groups of two stages (128
# deep): even groups accumulate in acc, odd ones in pp, so group g is folded
# after group g + 1's first stage is issued and the wait<1> that follows has
# retired g's last stage: no wait<0>. The loop runs 4 stages per pass, so
# each stage's set is known when it compiles. Three accumulator sets: tiles
# of 64 rows only.
_PING_PONG = r"""  if constexpr (D::FOLD) {
    float pp[TT / 2];
    float s_even[2] = {0.f, 0.f}, s_odd[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < TT / 2; ++i) pp[i] = 0.f;
    auto fold_retired = [&](float (&part)[TT / 2], const float (&sc)[2]) {
#pragma unroll
      for (int v = 0; v < TT / 2; ++v) asm volatile("" : "+f"(part[v])::"memory");
#pragma unroll
      for (int v = 0; v < TT / 2; ++v)
        sum[v] = __fadd_rn(sum[v], __fmul_rn(part[v], sc[(v >> 1) & 1]));
    };
    for (int kb0 = 0; kb0 < nkb; kb0 += 4) {
#pragma unroll
      for (int P = 0; P < 4; ++P) {
        const int kb = kb0 + P;
        if (kb >= nkb) break;
        const int s = kb % STAGES;
        const uint32_t xbase = smem_u32(xs + s * C::X_BYTES);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
          if (P < 2) {
            wgmma_rs<TT>(acc, a[P & 1][j], sw128_desc(xbase + j * 32), P + j == 0 ? 0 : 1);
          } else {
            wgmma_rs<TT>(pp, a[P & 1][j], sw128_desc(xbase + j * 32), P + j == 2 ? 0 : 1);
          }
        }
        wgmma_commit();
        wgmma_wait<1>();
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) hold(a[(P & 1) ^ 1][j]);
        if (P == 1) { s_even[0] = fs[0][0]; s_even[1] = fs[0][1]; }
        if (P == 3) { s_odd[0] = fs[0][0]; s_odd[1] = fs[0][1]; }
        // The previous group's last stage is retired: fold it.
        if (P == 2) fold_retired(acc, s_even);
        if (P == 0 && kb > 0) fold_retired(pp, s_odd);
        if (kb > 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(smem_u32(bars + STAGES + (kb - 1) % STAGES));
        }
        if (kb + 1 < nkb) {
          const int sn = (kb + 1) % STAGES;
          mbar_wait(smem_u32(bars + sn), ((kb + 1) / STAGES) & 1);
          D::stage(a[(P & 1) ^ 1], ps + sn * P_BYTES + off0, off4,
                   ss + sn * (S_BYTES / 4) + col, gsteps, left, s_lo, s_hi, fs, starts, ends);
        }
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      hold(a[0][j]);
      hold(a[1][j]);
    }
    // The last group (stages nkb - 2, nkb - 1) is still to fold.
    const bool odd = ((nkb - 1) >> 1) & 1;
#pragma unroll
    for (int v = 0; v < TT / 2; ++v) {
      asm volatile("" : "+f"(acc[v]), "+f"(pp[v])::"memory");
      const float s_v = (v >> 1) & 1 ? (odd ? s_odd[1] : s_even[1]) : (odd ? s_odd[0] : s_even[0]);
      sum[v] = __fadd_rn(sum[v], __fmul_rn(odd ? pp[v] : acc[v], s_v));
    }
  } else {
"""


def _flat(cu: Path) -> str:
    """A translation unit of csrc/ with the kernel header inlined."""
    header = (cu.parent / "int4_w4a16.cuh").read_text().replace("#pragma once\n", "")
    return _replace(cu.read_text(), '#include "int4_w4a16.cuh"\n', header)


def build(sources: dict) -> dict:
    """{name: (source path, include dir)} -> {name: CDLL}, one nvcc each, all at once."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _build._find_nvcc()
    jobs = {}
    for name, (src, include) in sources.items():
        cmd = [nvcc, *_build.NVCC_FLAGS[:-1], "-I", str(include), "-shared", "-o",
               str(OUT_DIR / f"{name}.so"), str(src)]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
    libs = {}
    for name, proc in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        libs[name] = ctypes.CDLL(str(OUT_DIR / f"{name}.so"))
    return libs


def _entry(lib, name: str, probe: bool):
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = getattr(lib, name)
    fn.argtypes = [p] * 6 + [i] * 4 + [i64, i64, i, i] + ([i] if probe else []) + [p]
    fn.restype = ctypes.c_int
    return fn


class Call:
    """One launch of K5's machine through a C entry on fixed operands: the
    plan's workspace and counters are made once, the counters zeroed before
    each launch."""

    def __init__(self, x, packed, scales, plan):
        self.x, self.packed, self.scales = x, packed, scales
        self.t, self.k = x.shape
        self.n = packed.shape[1]
        self.group = self.k // scales.shape[0]
        self.plan = plan(self.t, self.k, self.n, self.group)
        t_tile, splits, _ = self.plan
        dev = x.device
        self.work = torch.empty((splits, self.t, self.n), dtype=torch.float32, device=dev)
        self.counters = torch.zeros(-(-self.n // M.K5_BN) * -(-self.t // t_tile),
                                    dtype=torch.int32, device=dev)

    def __call__(self, fn, *extra) -> torch.Tensor:
        t_tile, splits, _ = self.plan
        out = torch.empty((self.t, self.n), dtype=torch.float32, device=self.x.device)
        if splits > 1:
            self.counters.zero_()
        stream = torch.cuda.current_stream(self.x.device).cuda_stream
        err = fn(self.x.data_ptr(), self.packed.data_ptr(), self.scales.data_ptr(),
                 out.data_ptr(), self.work.data_ptr(), self.counters.data_ptr(), self.t, self.k,
                 self.n, self.group, self.packed.stride(0), self.scales.stride(0), t_tile,
                 splits, *extra, stream)
        _build.check_launch(err, "exp_probe_parts")
        return out


def _weight(gen, k, n, how, dev):
    if how == "layer":
        q = quantize_weight_int4(torch.randn((2, k, n), generator=gen, device=dev) * 0.02)
        return q["kernel_q4"][1], q["scale_w4"][1]
    q = quantize_weight_int4(torch.randn((k, n), generator=gen, device=dev) * 0.02)
    return q["kernel_q4"], q["scale_w4"]


def k5_against_parent(parent, here, iters: int, flush) -> dict:
    """K5 of both builds at every K5_SHAPES x K5_ROWS case: bitwise equality
    and device times (parent, here, here, parent)."""
    dev = torch.device("cuda")
    result = {}
    for rows in K5_ROWS:
        for name, k, n, how in K5_SHAPES:
            label = f"{name} T={rows}"
            gen = torch.Generator(device=dev).manual_seed(rows + k + n)
            x = torch.randn((rows, k), generator=gen, device=dev).bfloat16()
            packed, scales = _weight(gen, k, n, how, dev)
            call = Call(x, packed, scales, M._k5_plan)
            y_parent, y_here = call(parent), call(here)
            torch.cuda.synchronize()
            same = torch.equal(y_parent, y_here)
            times = [device_ms(lambda fn=fn: call(fn), flush, iters)[0]
                     for fn in (parent, here, here, parent)]
            p_ms, h_ms = (times[0] + times[3]) / 2, (times[1] + times[2]) / 2
            result[label] = {"bitwise_equal": same, "parent_ms": p_ms, "ms": h_ms,
                             "ratio": h_ms / p_ms, "plan": call.plan,
                             "order_ms": times}
            print(f"[k5 parent] {label}: plan {call.plan}; bitwise equal {same}; device ms "
                  f"parent {times[0]:.4f}, here {times[1]:.4f}, here {times[2]:.4f}, parent "
                  f"{times[3]:.4f}: here / parent {h_ms / p_ms:.4f}", flush=True)
            if not same:
                raise AssertionError(f"K5 of this build and of the parent's differ at {label}")
            del x, packed, scales, call, y_parent, y_here
    return result


def fold_parts(probe, no_fold, ping_pong, iters: int, flush) -> dict:
    """no-scale, group-dots and no-fold at T = PROBE_T and the probe's shapes,
    with the probe's plan and with tiles of 64 rows, and the ping-pong
    variant with tiles of 64 rows (checked against the plain group-dots
    first). The ping-pong folds group g while group g + 1's first products
    run instead of waiting for them; it fits only 64-row tiles (three
    accumulator sets). At best it takes away the whole wait, so 64-row
    group-dots less the 64-row wait bounds it from below."""
    from openvla_oft_tpu_torch.ops.int4_probe import int4_probe_ref

    dev = torch.device("cuda")
    result = {}
    for name, k, n in PROBE_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(k + n)
        x = torch.randn((PROBE_T, k), generator=gen, device=dev).bfloat16()
        packed, scales = _weight(gen, k, n, "whole", dev)
        for tiles in ("plan", "t_tile 64"):
            variants = [("no-scale", probe, "no-scale"), ("group-dots", probe, "group-dots"),
                        ("no-fold", no_fold, "group-dots")]
            if tiles != "plan":
                variants.append(("ping-pong", ping_pong, "group-dots"))
            times = {}
            for label, fn, mode in variants:
                plan = ((lambda *a, mode=mode: _probe_plan(*a, mode)) if tiles == "plan"
                        else (lambda *a: M._k5_plan(*a, (64,))))
                call = Call(x, packed, scales, plan)
                if label == "ping-pong":
                    got = call(fn, MODES.index(mode))
                    ref = int4_probe_ref(x, packed, scales, "group-dots")
                    rel = ((got - ref).abs().max() / ref.abs().max()).item()
                    print(f"[fold] ping-pong {name}: rel error {rel:.2e} against the plain "
                          f"group-dots", flush=True)
                    if not rel <= 1e-3:
                        raise AssertionError(f"the ping-pong variant is wrong at {name}")
                times[label] = device_ms(lambda: call(fn, MODES.index(mode)), flush, iters)[0]
            times["fold"] = times["group-dots"] - times["no-fold"]
            times["wait"] = times["no-fold"] - times["no-scale"]
            if tiles != "plan":
                times["ping-pong at least"] = times["group-dots"] - times["wait"]
            result[f"{name} {tiles}"] = dict(times, plan=call.plan)
            print(f"[fold] {name} T={PROBE_T} {tiles} {call.plan}: "
                  + ", ".join(f"{v} {t:.4f}" for v, t in times.items())
                  + " ms (device time; fold = group-dots - no-fold, wait = no-fold - no-scale)",
                  flush=True)
        del x, packed, scales
    return result


def main(argv=None) -> dict:
    """Prints one line per case; returns {"k5": {case: {...}} (with --parent),
    "fold": {shape: {variant: ms}}}."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="the csrc/ directory of the build to hold K5 against")
    parser.add_argument("--iters", type=int, default=10,
                        help="calls per profiler window (device_ms)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("exp_probe_parts times the card's kernels and needs a CUDA device")
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    probe_src = _flat(_build.CSRC_DIR / "int4_probe.cu")
    no_fold, ping_pong = OUT_DIR / "no_fold.cu", OUT_DIR / "ping_pong.cu"
    no_fold.write_text(_replace(probe_src, _FOLD, _NO_FOLD))
    loop = probe_src[probe_src.index(_LOOP_FIRST):probe_src.index(_LOOP_LAST) + len(_LOOP_LAST)]
    ping_pong.write_text(_replace(probe_src, loop, _PING_PONG + loop + "  }\n"))
    sources = {"k5": (_build.CSRC_DIR / "int4_w4a16.cu", _build.CSRC_DIR),
               "probe": (_build.CSRC_DIR / "int4_probe.cu", _build.CSRC_DIR),
               "no_fold": (no_fold, _build.CSRC_DIR), "ping_pong": (ping_pong, _build.CSRC_DIR)}
    if args.parent is not None:
        sources["parent_k5"] = (args.parent / "int4_w4a16.cu", args.parent)
    libs = build(sources)
    flush = l2_flush_buffer(torch.device("cuda"))
    result = {}
    if args.parent is not None:
        result["k5"] = k5_against_parent(
            _entry(libs["parent_k5"], "openvla_int4_matmul_w4a16", False),
            _entry(libs["k5"], "openvla_int4_matmul_w4a16", False), args.iters, flush)
    result["fold"] = fold_parts(*(_entry(libs[v], "openvla_int4_probe", True)
                                  for v in ("probe", "no_fold", "ping_pong")),
                                args.iters, flush)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
