"""Where K5's time goes at a decode-like row count: the K5 timing probe.

Port of `vla_scripts/exp_int4_probe.py`. At T = 112 rows and the 7B's int4
shapes it times K5 beside K5's own kernel with one part of its dequant step
taken away (`ops/int4_probe.py`, kernel `csrc/int4_probe.cu` on
`csrc/int4_w4a16.cuh`), beside K6 and beside `torch.matmul` on the
dequantized bf16 weight:

  fused         K5 as shipped (`ops/int4_matmul.py::int4_matmul_fused`)
  no-scale      K5 without the group-scale multiply (WRONG NUMBERS by design:
                isolates the scale multiply)
  no-unpack     K5 on the raw signed bytes, no unpack and no scale (WRONG
                NUMBERS by design: isolates the nibble unpack)
  group-dots    K5 with each scale on its group's fp32 partial instead of on
                every weight element (a correct W4A16 alternative)
  a8-fused      K6 (`ops/int4_matmul.py::int4_matmul_fused_a8`)
  torch.matmul  on the dequantized bf16 weight: the library's product
  int8-dyn      the W8A8 linear with per-token activations
                (`ops/quant.py::int8_linear`: the activation quantize, the
                library's `torch._int_mm` on the int8 weight of the same
                matrix, the epilogue), as the JAX probe's int8-dyn row

and, per shape, the split of K5's time: K5 - no-scale (the scale multiply),
K5 - no-unpack (the unpack and the scale), no-unpack - torch.matmul (the
machine's own cost over the library's product). Then the group-dots
correctness line against fused (and against the plain W4A16,
`int4_matmul_ref`), and K5 on layer 7 of a synthetic (32, K/2, N) stack, the
layer view the serving loop hands it. Times are device times
(torch.profiler, the mean of `--iters` calls, the L2 flushed before each;
`utils/timing.py::device_ms`); the floor is the packed weight's bytes at
the H100's 3.35 TB/s.

    python -m openvla_oft_tpu_torch.scripts.exp_int4_probe [--iters 10]

It needs a CUDA card: a timing probe of the card's kernels has no CPU form.
"""

from __future__ import annotations

import argparse

import torch

from openvla_oft_tpu_torch.ops import int4_matmul as M
from openvla_oft_tpu_torch.ops.int4_probe import int4_probe
from openvla_oft_tpu_torch.ops.quant import (dequantize_int4, int8_linear, quantize_weight,
                                             quantize_weight_int4)
from openvla_oft_tpu_torch.utils.timing import device_ms, l2_flush_buffer

T = 112
SHAPES = [("qkv", 4096, 12288), ("gate_up", 4096, 22016), ("down", 11008, 4096)]
PEAK_BYTES = 3.35e12        # H100 SXM HBM3 (NVIDIA's data sheet)
STACK_LAYERS, STACK_LAYER = 32, 7


def variants() -> dict:
    """name -> fn(x, packed, scales) of every timed variant."""
    out = {"fused": M.int4_matmul_fused}
    for mode in ("no-scale", "no-unpack", "group-dots"):
        out[mode] = lambda x, p, s, mode=mode: int4_probe(x, p, s, mode)
    out["a8-fused"] = M.int4_matmul_fused_a8
    return out


def _rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    return ((got - ref).abs().max() / (ref.abs().max() + 1e-9)).item()


def main(argv=None) -> dict:
    """Runs the probe and prints its lines; returns {"ms": {shape: {variant:
    ms}}, "how": {shape: {variant: how the time was taken}}, "split": {shape:
    {difference: ms}}, "floor_ms": {shape: ms}, "totals": {variant: ms},
    "group_dots_vs_fused", "group_dots_vs_ref", "stacked_ms": {shape: ms}}."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=10,
                        help="calls per profiler window (device_ms)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("the int4 probe times the card's kernels and needs a CUDA device")
    print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = l2_flush_buffer(dev)
    result = {"ms": {}, "how": {}, "split": {}, "floor_ms": {}, "totals": {}, "stacked_ms": {}}
    for name, k_dim, n in SHAPES:
        w = torch.randn((k_dim, n), generator=gen, device=dev) * 0.02
        q4, q8 = quantize_weight_int4(w), quantize_weight(w)
        del w
        x = torch.randn((T, k_dim), generator=gen, device=dev).bfloat16()
        w16 = dequantize_int4(q4["kernel_q4"], q4["scale_w4"], torch.bfloat16)
        floor = k_dim * n / 2 / PEAK_BYTES * 1e3
        result["floor_ms"][name] = floor
        print(f"== {name} ({k_dim}x{n}) T={T}  int4 byte floor {floor:.4f} ms ==", flush=True)
        times = result["ms"][name] = {}
        hows = result["how"][name] = {}
        fns = dict(variants(), **{"torch.matmul": lambda x, p, s: torch.matmul(x, w16),
                                  "int8-dyn": lambda x, p, s: int8_linear(q8, x)})
        for vname, fn in fns.items():
            ms, how = device_ms(lambda: fn(x, q4["kernel_q4"], q4["scale_w4"]), flush,
                                iters=args.iters)
            times[vname], hows[vname] = ms, how
            result["totals"][vname] = result["totals"].get(vname, 0.0) + ms
            print(f"{name}/{vname}: {ms:.4f} ms ({how}, mean of {args.iters} calls, L2 "
                  f"flushed)", flush=True)
        split = result["split"][name] = {
            "K5 - no-scale": times["fused"] - times["no-scale"],
            "K5 - no-unpack": times["fused"] - times["no-unpack"],
            "no-unpack - torch.matmul": times["no-unpack"] - times["torch.matmul"]}
        print(f"{name}/split: " + ", ".join(f"{d} {v:.4f}" for d, v in split.items()) + " ms",
              flush=True)
        del q4, q8, x, w16

    # Correctness spot check of group-dots (the JAX probe's shape).
    k_dim, n = 512, 256
    q4 = quantize_weight_int4(torch.randn((k_dim, n), generator=gen, device=dev) * 0.02)
    x = torch.randn((T, k_dim), generator=gen, device=dev).bfloat16()
    got = int4_probe(x, q4["kernel_q4"], q4["scale_w4"], "group-dots")
    fused = M.int4_matmul_fused(x, q4["kernel_q4"], q4["scale_w4"])
    ref = M.int4_matmul_ref(x, q4["kernel_q4"], q4["scale_w4"])
    result["group_dots_vs_fused"] = _rel_err(got, fused)
    result["group_dots_vs_ref"] = _rel_err(got, ref)
    print(f"group-dots correctness vs fused: rel-max-err {result['group_dots_vs_fused']:.2e}; "
          f"vs int4_matmul_ref: {result['group_dots_vs_ref']:.2e}", flush=True)

    # K5 on one layer of a synthetic stack: random bytes and scales (the
    # kernel's time sees only bytes; quantizing a real stack is not needed).
    print(f"== stacked (L={STACK_LAYERS}, the serving loop's layer view) per layer ==",
          flush=True)
    for name, k_dim, n in SHAPES:
        kq = torch.randint(-128, 128, (STACK_LAYERS, k_dim // 2, n), generator=gen, device=dev,
                           dtype=torch.int8)
        sw = torch.rand((STACK_LAYERS, k_dim // 128, n), generator=gen, device=dev) * 0.01
        x = torch.randn((T, k_dim), generator=gen, device=dev).bfloat16()
        ms, _ = device_ms(lambda: M.int4_matmul_fused(x, kq[STACK_LAYER], sw[STACK_LAYER]),
                          flush, iters=args.iters)
        result["stacked_ms"][name] = ms
        print(f"{name}/stacked (layer {STACK_LAYER}): {ms:.4f} ms", flush=True)
        del kq, sw
    print("\nper-layer totals (ms):",
          {k: round(v, 4) for k, v in result["totals"].items()}, flush=True)
    return result


if __name__ == "__main__":
    main()
