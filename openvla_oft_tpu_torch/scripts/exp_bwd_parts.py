"""What holds K2 and K3 back: their time with one part of their work taken
away, and their time against the number of live tile pairs.

K2 and K3 (`csrc/flash_attention_bwd.cu`) run, per (query tile, key tile)
pair, two score wgmmas (S and dP), the elementwise work that turns them into
P and dS, and the product wgmmas (K2: dQ; K3: dV and dK), fed by the loading
warp's ring; K2 computes delta in its prologue. Built with `-DBWD_PARTS`,
the same source holds compile-time instances without one part or another
(the `Part` flags) at D = 128. This script builds that library into
`_build/exp_bwd_parts/` and times, at the training shape (B = 8, S = 585,
H = 32, D = 128, the training batch's right pads and windows):

  shipped     the kernel as shipped
  no-delta    K2 without delta's loads in its prologue (delta = 0)
  no-scores   no P, dS: the score accumulators go to the products raw
  no-mma      no wgmma (P and dS on registers no product wrote)
  ring        the walk, the ring, the prologue and the epilogue alone

shipped is checked against `flash_attention_bwd_ref`. Then the shipped
kernels through their wrappers under three masks of the same shape:
the training mask, full attention (every pair live and interior) and one
valid 64-key tile per row (a pair or two per CTA): the time against the live
pairs gives a cost per pair and a fixed cost. Times are device times
(torch.profiler, the mean of `--iters` calls, the L2 flushed before each).

    python -m openvla_oft_tpu_torch.scripts.exp_bwd_parts [--iters 10]

It needs a CUDA card and nvcc: it times the card's kernels.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import numpy as np
import torch

from openvla_oft_tpu_torch import _build
from openvla_oft_tpu_torch.ops import flash_attention as fa
from openvla_oft_tpu_torch.utils.timing import device_ms, l2_flush_buffer

SHAPE = (8, 585, 32, 32, 128)        # B, S, H, Hkv, D: the 7B's training batch
# The `Part` flags of csrc/flash_attention_bwd.cu and the variants built from them.
SCORES, PRODUCTS, DELTA = 1, 2, 4
SHIPPED = SCORES | PRODUCTS | DELTA
_COMMON = {"shipped": SHIPPED, "no-scores": SHIPPED & ~SCORES,
           "no-mma": SHIPPED & ~PRODUCTS, "ring": 0}
VARIANTS = {"K2": {**_COMMON, "no-delta": SHIPPED & ~DELTA}, "K3": _COMMON}
CHECKED = ("shipped",)
OUT_DIR = _build.BUILD_DIR / "exp_bwd_parts"


def build_parts():
    """The parts library's entry `openvla_flash_attention_bwd_parts`."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    lib = OUT_DIR / "libbwd_parts.so"
    cmd = [_build._find_nvcc(), *_build.NVCC_FLAGS, "-DBWD_PARTS", "-shared", "-o", str(lib),
           str(_build.CSRC_DIR / "flash_attention_bwd.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (OUT_DIR / "build.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on K2/K3's parts:\n{proc.stdout}{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry function" in line or "spill" in line or "Used" in line:
            print("[ptxas]", line.strip()[:200], flush=True)
    fn = ctypes.CDLL(str(lib)).openvla_flash_attention_bwd_parts
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [i, i] + [p] * 11 + [i] * 5 + [i64] * 12 + [i, ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn


def operands(mask: str, seed: int = 0) -> tuple:
    """(q, k, v, O, LSE, dO, causal, key_valid, bidir) at SHAPE, q/k/v as
    views of one fused projection. mask: "training" (per-row right pads and
    a 57-slot window, causal), "full" (every key, not causal) or "one-tile"
    (keys 0..63 only, causal)."""
    b, s, h, hkv, d = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, s, (h + 2 * hkv) * d), generator=gen, device="cuda").bfloat16()
    q = qkv[..., :h * d].view(b, s, h, d)
    k = qkv[..., h * d:(h + hkv) * d].view(b, s, hkv, d)
    v = qkv[..., (h + hkv) * d:].view(b, s, hkv, d)
    do = torch.randn((b, s, h, d), generator=gen, device="cuda").bfloat16()
    key_valid = torch.zeros((b, s), dtype=torch.bool, device="cuda")
    bidir = torch.zeros((b, s), dtype=torch.bool, device="cuda")
    causal = mask != "full"
    for i in range(b):
        if mask == "training":
            key_valid[i, :s - 5 * i] = True
            bidir[i, s - 5 * i - 57:s - 5 * i] = True
        elif mask == "full":
            key_valid[i] = True
        else:
            key_valid[i, :64] = True
    o, lse = fa.flash_attention_fwd(q, k, v, causal, key_valid, bidir)
    return q, k, v, o, lse, do, causal, key_valid, bidir


def variant_times(fn, iters: int, flush) -> dict:
    """{kernel: {variant: ms}} at SHAPE under the training mask, and each
    checked variant's error."""
    q, k, v, o, lse, do, causal, key_valid, bidir = operands("training")
    b, s, h, hkv, d = SHAPE
    masks = fa._mask_u8(b, s, key_valid, bidir, q.device)
    q, k, v, do = fa._bwd_operands(q, k, v, o, lse, do)
    plan = fa._plan_of(q, k)
    stats = fa._stats_rows(q, plan)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    refs = fa.flash_attention_bwd_ref(q, k, v, o, lse, do, causal, key_valid, bidir)

    def run(kernel: int, parts: int) -> None:
        out = (dq, dq) if kernel == 0 else (dk, dv)
        err = fn(kernel, parts, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), stats.data_ptr(), do.data_ptr(), masks[0].data_ptr(),
                 masks[1].data_ptr(), out[0].data_ptr(), out[1].data_ptr(), b, s, h, hkv,
                 plan["s_pad"], *fa._strides(q, k, v, do), int(causal),
                 ctypes.c_float(d ** -0.5), torch.cuda.current_stream().cuda_stream)
        _build.check_launch(err, "exp_bwd_parts")

    result = {"ms": {}, "rel_err": {}}
    run(0, SHIPPED)   # the stats rows that K3's variants read
    for kernel, variants in VARIANTS.items():
        index = 0 if kernel == "K2" else 1
        for name, parts in variants.items():
            run(index, parts)
            torch.cuda.synchronize()
            if name in CHECKED:
                outs = (dq,) if index == 0 else (dk, dv)
                wants = refs[:1] if index == 0 else refs[1:]
                result["rel_err"][f"{kernel} {name}"] = max(
                    ((g.float() - r.float()).abs().max() / r.float().abs().max()).item()
                    for g, r in zip(outs, wants))
            result["ms"][f"{kernel} {name}"] = device_ms(lambda: run(index, parts), flush,
                                                         iters)[0]
        run(0, SHIPPED)   # K3's variants after K2's no-delta read true stats rows
    return result


def pair_sweep(iters: int, flush) -> dict:
    """The shipped K2 and K3 (through the op's path: K2 writes the stats
    rows, K3 reads them) under three masks: {mask: {"pairs": n, "K2": ms,
    "K3": ms}}, and the least-squares cost per live pair and fixed cost."""
    rows = {}
    for mask in ("training", "full", "one-tile"):
        q, k, v, o, lse, do, causal, key_valid, bidir = operands(mask)
        b, s = q.shape[:2]
        masks = fa._mask_u8(b, s, key_valid, bidir, q.device)
        q, k, v, do = fa._bwd_operands(q, k, v, o, lse, do)
        plan = fa._plan_of(q, k)
        stats = fa._stats_rows(q, plan)
        fa._launch_dq(q, k, v, o, lse, do, causal, *masks, plan, stats)
        rows[mask] = {
            "pairs": fa._live_pairs(causal, key_valid, bidir),
            "K2": device_ms(lambda: fa._launch_dq(q, k, v, o, lse, do, causal, *masks, plan,
                                                  stats), flush, iters)[0],
            "K3": device_ms(lambda: fa._launch_dkv(q, k, v, do, causal, *masks, plan, stats),
                            flush, iters)[0]}
    pairs = np.array([r["pairs"] for r in rows.values()], dtype=float) * SHAPE[2]
    fit = {}
    for kernel in ("K2", "K3"):
        ms = np.array([r[kernel] for r in rows.values()])
        slope, fixed = np.polyfit(pairs, ms, 1)
        fit[kernel] = {"us_per_pair_head": slope * 1e3, "fixed_ms": fixed}
    return {"masks": rows, "fit": fit}


def main(argv=None) -> dict:
    """Prints the variants' times and the pair sweep and returns {"variants":
    {"ms": {...}, "rel_err": {...}}, "pairs": {...}}."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=10,
                        help="timed calls per variant (their mean device time is kept)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("exp_bwd_parts times the card's kernels and needs a CUDA device")
    flush = l2_flush_buffer("cuda")
    variants = variant_times(build_parts(), args.iters, flush)
    print(f"K2/K3 parts at B, S, H, Hkv, D = {SHAPE}: "
          + ", ".join(f"{v} {t:.4f}" for v, t in variants["ms"].items())
          + " ms; rel err " + ", ".join(f"{v} {e:.2e}" for v, e in variants["rel_err"].items())
          + f" (device time, mean of {args.iters}, L2 flushed)", flush=True)
    pairs = pair_sweep(args.iters, flush)
    for mask, row in pairs["masks"].items():
        print(f"mask {mask}: {row['pairs']} live pairs per head; K2 {row['K2']:.4f} ms, "
              f"K3 {row['K3']:.4f} ms", flush=True)
    for kernel, fit in pairs["fit"].items():
        print(f"{kernel}: {fit['us_per_pair_head']:.5f} us per live pair and head, fixed "
              f"{fit['fixed_ms']:.4f} ms", flush=True)
    result = {"variants": variants, "pairs": pairs}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
