"""What holds K1 back: its time with one part of its work taken away, and
its time against the number of live tile pairs.

K1 (`csrc/flash_attention_fwd.cu`) runs, per (query tile, key tile) pair, a
score wgmma (S = Q.K^T), the online softmax in registers (mask, row max,
rescale of O, exp2, row sums) and the product wgmma (O += P.V), fed by the
loading warp's ring. Built with `-DFWD_PARTS`, the same source holds
compile-time instances without one part or another (the `Part` flags) at
D = 128. This script builds that library into `_build/exp_fwd_parts/` and
times, at the LIBERO prefill (B = 1, S = 618), the ALOHA length (B = 1,
S = 1168) and the training batch (B = 8, S = 585, per-row right pads and
windows), all at H = 32, D = 128:

  shipped     the kernel as shipped
  no-softmax  no mask, max, rescale or exp2: the raw scores go to P.V
  no-mma      no wgmma (the softmax on scores no product wrote)
  ring        the walk, the ring, the prologue and the epilogue alone

shipped is checked against `flash_attention_ref`. Then the shipped kernel
through its wrapper under three masks of the training shape: the training
mask, full attention (every pair live and interior) and one valid 64-key
tile per row: the time against the live pairs gives a cost per pair and
head and a fixed cost. Times are device times (torch.profiler,
the mean of `--iters` calls, the L2 flushed before each).

    python -m openvla_oft_tpu_torch.scripts.exp_fwd_parts [--iters 10]

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

H, D = 32, 128
# name -> (B, S, [(first valid key, last valid + 1, window start, len)] per row)
SHAPES = {
    "libero_prefill": (1, 618, [(24, 618, 561, 57)]),
    "aloha_length": (1, 1168, [(24, 1168, 817, 351)]),
    "training": (8, 585, [(0, 585 - 5 * i, 585 - 5 * i - 57, 57) for i in range(8)]),
}
# The `Part` flags of csrc/flash_attention_fwd.cu and the variants built from them.
SOFTMAX, PRODUCTS = 1, 2
SHIPPED = SOFTMAX | PRODUCTS
VARIANTS = {"shipped": SHIPPED, "no-softmax": SHIPPED & ~SOFTMAX,
            "no-mma": SHIPPED & ~PRODUCTS, "ring": 0}
MASKS = ("training", "full", "one-tile")
OUT_DIR = _build.BUILD_DIR / "exp_fwd_parts"


def build_parts():
    """The parts library's entry `openvla_flash_attention_fwd_parts`."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    lib = OUT_DIR / "libfwd_parts.so"
    cmd = [_build._find_nvcc(), *_build.NVCC_FLAGS, "-DFWD_PARTS", "-shared", "-o", str(lib),
           str(_build.CSRC_DIR / "flash_attention_fwd.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (OUT_DIR / "build.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on K1's parts:\n{proc.stdout}{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry function" in line or "spill" in line or "Used" in line:
            print("[ptxas]", line.strip()[:200], flush=True)
    fn = ctypes.CDLL(str(lib)).openvla_flash_attention_fwd_parts
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [i] + [p] * 7 + [i] * 4 + [i64] * 9 + [i, ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn


def operands(b: int, s: int, rows, causal: bool = True, seed: int = 0) -> tuple:
    """(q, k, v, causal, key_valid, bidir) at (b, s, H, D), q/k/v as views of
    one fused projection, the masks from `rows` (one tuple per batch row,
    the last repeated)."""
    gen = torch.Generator(device="cuda").manual_seed(seed + s)
    qkv = torch.randn((b, s, 3 * H * D), generator=gen, device="cuda").bfloat16()
    q, k, v = (qkv[..., i * H * D:(i + 1) * H * D].view(b, s, H, D) for i in range(3))
    key_valid = torch.zeros((b, s), dtype=torch.bool, device="cuda")
    bidir = torch.zeros((b, s), dtype=torch.bool, device="cuda")
    for i in range(b):
        lo, hi, w0, wl = rows[min(i, len(rows) - 1)]
        key_valid[i, lo:hi] = True
        bidir[i, w0:w0 + wl] = True
    return q, k, v, causal, key_valid, bidir


def mask_operands(mask: str) -> tuple:
    """The training shape's operands under `mask`: "training" (per-row right
    pads and a 57-slot window, causal), "full" (every key, not causal) or
    "one-tile" (keys 0..63 only, causal)."""
    b, s, rows = SHAPES["training"]
    if mask == "full":
        return operands(b, s, [(0, s, 0, 0)], causal=False)
    if mask == "one-tile":
        rows = [(0, 64, 0, 0)]
    return operands(b, s, rows)


def variant_times(fn, iters: int, flush) -> dict:
    """{shape: {variant: ms}} and each shape's shipped error (max |dO|)."""
    result = {"ms": {}, "max_abs_err": {}}
    for name, (b, s, rows) in SHAPES.items():
        q, k, v, causal, key_valid, bidir = operands(b, s, rows)
        masks = fa._mask_u8(b, s, key_valid, bidir, q.device)
        o = torch.empty((b, s, H, D), dtype=q.dtype, device=q.device)
        lse = torch.empty((b, H, s), dtype=torch.float32, device=q.device)

        def run(parts: int) -> None:
            err = fn(parts, q.data_ptr(), k.data_ptr(), v.data_ptr(), masks[0].data_ptr(),
                     masks[1].data_ptr(), o.data_ptr(), lse.data_ptr(), b, s, H, H,
                     *fa._strides(q, k, v), int(causal), ctypes.c_float(D ** -0.5),
                     torch.cuda.current_stream().cuda_stream)
            _build.check_launch(err, "exp_fwd_parts")

        result["ms"][name] = {}
        for variant, parts in VARIANTS.items():
            run(parts)
            torch.cuda.synchronize()
            if variant == "shipped":
                o_ref, _ = fa.flash_attention_ref(q, k, v, causal, key_valid, bidir)
                result["max_abs_err"][name] = (o.float() - o_ref.float()).abs().max().item()
            result["ms"][name][variant] = device_ms(lambda: run(parts), flush, iters)[0]
    return result


def pair_sweep(iters: int, flush) -> dict:
    """The shipped K1 through its wrapper under MASKS: {mask: {"pairs": n,
    "ms": t}}, and the least-squares cost per live pair and head and fixed
    cost."""
    rows = {}
    for mask in MASKS:
        q, k, v, causal, key_valid, bidir = mask_operands(mask)
        masks = fa._mask_u8(q.shape[0], q.shape[1], key_valid, bidir, q.device)
        rows[mask] = {"pairs": fa._live_pairs(causal, key_valid, bidir),
                      "ms": device_ms(lambda: fa._launch(q, k, v, causal, *masks), flush,
                                      iters)[0]}
    pairs = np.array([r["pairs"] for r in rows.values()], dtype=float) * H
    slope, fixed = np.polyfit(pairs, np.array([r["ms"] for r in rows.values()]), 1)
    return {"masks": rows, "fit": {"us_per_pair_head": slope * 1e3, "fixed_ms": fixed}}


def main(argv=None) -> dict:
    """Prints the variants' times and the pair sweep and returns {"variants":
    {"ms": {...}, "max_abs_err": {...}}, "pairs": {...}}."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=10,
                        help="timed calls per variant (their mean device time is kept)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("exp_fwd_parts times the card's kernels and needs a CUDA device")
    flush = l2_flush_buffer("cuda")
    variants = variant_times(build_parts(), args.iters, flush)
    for name, ms in variants["ms"].items():
        print(f"K1 parts at {name} (B, S = {SHAPES[name][:2]}, H = {H}, D = {D}): "
              + ", ".join(f"{v} {t:.4f}" for v, t in ms.items())
              + f" ms; shipped max|dO| {variants['max_abs_err'][name]:.2e} (device time, mean of "
              f"{args.iters}, L2 flushed)", flush=True)
    pairs = pair_sweep(args.iters, flush)
    for mask, row in pairs["masks"].items():
        print(f"mask {mask}: {row['pairs']} live pairs per head; K1 {row['ms']:.4f} ms",
              flush=True)
    fit = pairs["fit"]
    print(f"K1: {fit['us_per_pair_head']:.5f} us per live pair and head, fixed "
          f"{fit['fixed_ms']:.4f} ms", flush=True)
    result = {"variants": variants, "pairs": pairs}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
