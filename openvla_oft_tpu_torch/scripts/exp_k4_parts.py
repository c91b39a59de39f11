"""What holds K4 back: its time with one part of its work taken away at a
time, and its time on every compiled tile at the ViT shapes.

K4 (`csrc/ln_matmul.cu`) runs four things: the row statistics in each CTA's
prologue, the ring of TMA copies that brings x's and w's tiles, the
consumers' standardizing of their A fragments in registers, and their
wgmmas. Built with `-DK4_PARTS`, the same source holds compile-time
instances without one part or another, or with a part done another way (the
`Part` flags), at the 128 x 256 tile that `ops/vit_fused.py::_k4_plan` gives
DINOv2's fc1 at ALOHA (M = 783, D = 1024, N = 4096, gelu). This script
builds that library into `_build/exp_k4_parts/` and times, there:

  k4          K4 as shipped (statistics in the prologue)
  stats-pass  the statistics from a separate pass (one warp per row) into a
              workspace, which the CTAs read: both kernels timed together
  no-stats    no statistics (mean 0, rstd 1: y = act(x @ w + b))
  no-std      statistics, but no standardizing (y = act(x @ w + b))
  no-mma      statistics and standardizing, no wgmma (y = act(b))
  ring        the ring of copies and the barriers alone (y = act(b)); and
              once more without the activation (ring-no-act: y = b)
  smem-std    the consumers standardize their rows in place in shared
              memory (a proxy fence and a warpgroup barrier per stage), then
              run wgmmas with both operands in shared memory
  loader-std  the same standardizing on 3 warps of the loading warpgroup,
              which hand each stage to the consumers through a barrier
  stats-2rows the prologue's warps read 2 rows at a time, not 4

k4, stats-pass, smem-std, loader-std and stats-2rows are checked against
`ln_matmul_ref`, no-stats and no-std against act(x @ w + b) in fp32;
no-mma and the ring give act(b) by design. Then the tile sweep: K4 through
its wrapper on each of `K4_TILES` at the 8 ViT shapes, beside the plan's
choice and `torch.matmul` on the product. Times are device times
(torch.profiler, the mean of `--iters` calls, the L2 flushed before each;
CUDA events where a profiler window records nothing).

    python -m openvla_oft_tpu_torch.scripts.exp_k4_parts [--iters 10]

It needs a CUDA card and nvcc: it times the card's kernels.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from openvla_oft_tpu_torch import _build
from openvla_oft_tpu_torch.ops import vit_fused as VF
from openvla_oft_tpu_torch.utils.timing import device_ms, l2_flush_buffer

SHAPE = ("DINOv2 fc1 ALOHA", 783, 1024, 4096, "gelu")
# (name, M, D, N, act): the ViTs' launches at ALOHA (3 images) and LIBERO (2).
VIT_SHAPES = [
    (f"{vit} {proj} {deploy}", m, d, n, act)
    for deploy, rows in (("ALOHA", (783, 768)), ("LIBERO", (522, 512)))
    for vit, m, d, projs in (("DINOv2", rows[0], 1024, ((3072, None), (4096, "gelu"))),
                             ("SigLIP", rows[1], 1152, ((3456, None), (4304, "gelu_tanh"))))
    for proj, (n, act) in zip(("qkv", "fc1"), projs)]
# The `Part` flags of csrc/ln_matmul.cu and the variants built from them.
ROW_STATS, STATS_PASS, STANDARDIZE, PRODUCTS, SMEM_STD, LOADER_STD, STATS_2ROWS = (
    1, 2, 4, 8, 16, 32, 64)
K4 = ROW_STATS | STANDARDIZE | PRODUCTS
VARIANTS = {"k4": K4,
            "stats-pass": STATS_PASS | STANDARDIZE | PRODUCTS,
            "no-stats": STANDARDIZE | PRODUCTS,
            "no-std": ROW_STATS | PRODUCTS,
            "no-mma": ROW_STATS | STANDARDIZE,
            "ring": 0,
            "smem-std": K4 | SMEM_STD,
            "loader-std": K4 | LOADER_STD,
            "stats-2rows": K4 | STATS_2ROWS}
# Variants checked against ln_matmul_ref, and against act(x @ w + b).
STANDARDIZED = ("k4", "stats-pass", "smem-std", "loader-std", "stats-2rows")
RAW = ("no-stats", "no-std")
PARTS_TILE = (128, 256)
OUT_DIR = _build.BUILD_DIR / "exp_k4_parts"


def build_parts():
    """The parts library's entry `openvla_ln_matmul_parts`, built with nvcc."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    lib = OUT_DIR / "libk4_parts.so"
    cmd = [_build._find_nvcc(), *_build.NVCC_FLAGS, "-DK4_PARTS", "-shared", "-o", str(lib),
           str(_build.CSRC_DIR / "ln_matmul.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (OUT_DIR / "build.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on K4's parts:\n{proc.stdout}{proc.stderr}")
    fn = ctypes.CDLL(str(lib)).openvla_ln_matmul_parts
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p] * 5 + [i] * 3 + [i64, i64, i, ctypes.c_float, i, p]
    fn.restype = ctypes.c_int
    return fn


def operands(m: int, d: int, n: int, seed: int = 0, large_mean: bool = False) -> tuple:
    """x, w, b in bf16 on the card, as the gpu tests draw them. large_mean:
    rows with mean / std about 20, and every 97th row a high-norm token with
    three channels at +-100, as DINOv2's residual stream has them."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if large_mean:
        x = torch.randn((m, d), generator=gen, device="cuda") + 20.0
        rows = torch.arange(5, m, 97, device="cuda")
        for ch, v in ((3, 100.0), (250, -100.0), (700, 100.0)):
            x[rows, ch] = v
        x = x.bfloat16()
    else:
        x = (torch.randn((m, d), generator=gen, device="cuda") * 1.5 + 0.3).bfloat16()
    w = (torch.randn((d, n), generator=gen, device="cuda") * d ** -0.5).bfloat16()
    b = (torch.randn((n,), generator=gen, device="cuda") * 0.1).bfloat16()
    return x, w, b


def run_parts(fn, x, w, b, act, parts: int, out, stats) -> None:
    m, d = x.shape
    n = w.shape[1]
    err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), stats.data_ptr(), m, d,
             n, x.stride(0), w.stride(0), VF.ACTS.index(act), VF.EPS, parts,
             torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "exp_k4_parts")


def _rel(got, ref) -> float:
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def variant_times(fn, iters: int, flush) -> dict:
    """{variant: ms} at SHAPE, and each checked variant's error."""
    name, m, d, n, act = SHAPE
    if VF._k4_plan(m, d, n)[:2] != PARTS_TILE:
        raise RuntimeError(f"_k4_plan no longer gives {name} the {PARTS_TILE} tile: "
                           "update exp_k4_parts' PARTS_TILE and the -DK4_PARTS entry")
    x, w, b = operands(m, d, n)
    out = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
    stats = torch.empty((m, 2), dtype=torch.float32, device="cuda")
    ref = VF.ln_matmul_ref(x, w, b, act)
    raw = VF._activate(x.float() @ w.float() + b.float(), act)
    result = {"ms": {}, "rel_err": {}}
    for vname, parts in VARIANTS.items():
        run_parts(fn, x, w, b, act, parts, out, stats)
        torch.cuda.synchronize()
        if vname in STANDARDIZED:
            result["rel_err"][vname] = _rel(out, ref)
        elif vname in RAW:
            result["rel_err"][vname] = _rel(out, raw)
        result["ms"][vname] = device_ms(
            lambda: run_parts(fn, x, w, b, act, parts, out, stats), flush, iters)[0]
    # The ring again without the activation: what GELU costs the epilogue.
    result["ms"]["ring-no-act"] = device_ms(
        lambda: run_parts(fn, x, w, b, None, VARIANTS["ring"], out, stats), flush, iters)[0]
    result["ms"]["ln_matmul"] = device_ms(lambda: VF.ln_matmul(x, w, b, act), flush, iters)[0]
    result["ms"]["torch.matmul"] = device_ms(lambda: torch.matmul(x, w), flush, iters)[0]
    return result


def tile_sweep(iters: int, flush) -> dict:
    """{shape: {"plan": (BM, BN, CTAs), "ms": {"BMxBN": ms, "torch.matmul": ms}}}."""
    sweep = {}
    for name, m, d, n, act in VIT_SHAPES:
        x, w, b = operands(m, d, n, seed=m + d + n)
        ref = VF.ln_matmul_ref(x, w, b, act)
        times = {}
        for tile in VF.K4_TILES:
            y = VF._launch(x, w, b, act, VF.EPS, tile=tile)
            torch.cuda.synchronize()
            if _rel(y, ref) > 1e-2:
                raise AssertionError(f"K4's {tile} tile disagrees with ln_matmul_ref at {name}")
            times[f"{tile[0]}x{tile[1]}"] = device_ms(
                lambda: VF._launch(x, w, b, act, VF.EPS, tile=tile), flush, iters)[0]
        times["torch.matmul"] = device_ms(lambda: torch.matmul(x, w), flush, iters)[0]
        sweep[name] = {"plan": VF._k4_plan(m, d, n), "ms": times}
    return sweep


def main(argv=None) -> dict:
    """Prints the variants' and the tiles' times and returns {"variants":
    {"ms": {...}, "rel_err": {...}}, "tiles": {...}}."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=10,
                        help="timed calls per variant (their mean device time is kept)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("exp_k4_parts times the card's kernels and needs a CUDA device")
    flush = l2_flush_buffer("cuda")
    variants = variant_times(build_parts(), args.iters, flush)
    name, m, d, n, act = SHAPE
    print(f"{name} (M={m} D={d} N={n} {act}, tile {PARTS_TILE}): "
          + ", ".join(f"{v} {t:.4f}" for v, t in variants["ms"].items())
          + " ms; rel err " + ", ".join(f"{v} {e:.2e}" for v, e in variants["rel_err"].items())
          + f" (device time, mean of {args.iters}, L2 flushed)", flush=True)
    tiles = tile_sweep(args.iters, flush)
    for shape, row in tiles.items():
        print(f"{shape}: plan {row['plan']}; " + ", ".join(f"{k} {t:.4f}"
                                                          for k, t in row["ms"].items())
              + " ms", flush=True)
    result = {"variants": variants, "tiles": tiles}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
