"""Diffusion-head chunk latency on one card: prefix-KV against full prefill.

Port of `vla_scripts/bench_diffusion.py`. The reference's
`_run_diffusion_prediction` (modeling_prismatic.py:793-877) reruns a full
Llama prefill per DDIM step; the port's default loop computes the static
[BOS][patches][proprio] prefix K/V once and runs each step over the
[t][prompt][actions][STOP] suffix rows (`models/prismatic.py::
DiffusionPrefix`); `--old` runs the full prefill per step.

    python -m openvla_oft_tpu_torch.scripts.bench_diffusion [--old | --split-kv]
        [--steps N] [--quant {int8,int4,int4a8}] [--static]
        [--platform {libero,aloha}] [--film {on,off}] [--k K] [--device cuda]

`--split-kv` runs the suffix attention as two online-softmax blocks
(`ops/attention.py::attention_split_kv`) instead of the dense path on the
concatenated keys. The model is the deploy CLI's flagship
(`serving/deploy.py::flagship_policy`: DINOv2 + SigLIP, Llama-2-7B, seeded
random bf16 weights drawn on the device, fused and quantized by
`serving_params`): `--quant int8` is `load_in_8bit`
(the LLM, the ViTs and the projector W8A8), `int4` is `load_in_4bit`, which
packs the LLM only (the JAX bench packs the ViTs and the projector to int4
as well), `int4a8` the same weights served W4A8. `--static` attaches
placeholder static activation scales to the int8 LLM (timing-equivalent to
calibrated ones). The noise predictor and the noisy-action projector stay
bf16. Each call is `OpenVLAPolicy.predict_action` on zero pixels and a
fixed instruction; the first call (kernel builds, allocator growth) and
one warm call go untimed, then K calls are timed by the host clock, each
ending in `torch.cuda.synchronize()`; on the card the peak of
`torch.cuda.max_memory_allocated` over the timed calls goes to stderr. It
runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def build_policy(args):
    from openvla_oft_tpu_torch.ops.quant_calibrate import attach_placeholder_act_scales
    from openvla_oft_tpu_torch.serving.deploy import flagship_policy

    policy = flagship_policy(torch.device(args.device), seed=args.seed, platform=args.platform,
                             head="diffusion", num_diffusion_steps=args.steps,
                             load_in_4bit=args.quant in ("int4", "int4a8"),
                             int4_a8=args.quant == "int4a8", load_in_8bit=args.quant == "int8",
                             use_film=None if args.film is None else args.film == "on")
    policy.diffusion_prefix_kv = not args.old
    policy.split_kv = args.split_kv
    if args.static:
        policy.params["llm"] = attach_placeholder_act_scales(policy.params["llm"])
    return policy


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", action="store_true",
                    help="a full prefill per step instead of the prefix K/V")
    ap.add_argument("--split-kv", action="store_true",
                    help="the suffix attention as two online-softmax blocks instead of "
                         "the concatenated prefix and suffix K/V")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--quant", default=None, choices=["int8", "int4", "int4a8"])
    ap.add_argument("--static", action="store_true",
                    help="static int8 activation scales (placeholder values, "
                         "timing-equivalent to calibrated ones); needs --quant int8")
    ap.add_argument("--platform", default="libero", choices=["libero", "aloha"])
    ap.add_argument("--film", default=None, choices=["on", "off"],
                    help="FiLM in the ViTs; default on for aloha, off for libero")
    ap.add_argument("--k", type=int, default=8, help="timed calls")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.static and args.quant != "int8":
        ap.error("--static needs --quant int8")
    if args.split_kv and args.old:
        ap.error("--split-kv needs the prefix K/V (not --old)")
    return args


def main(argv=None) -> dict:
    args = parse(argv)
    policy = build_policy(args)
    cfg = policy.cfg
    size = cfg.vision_configs[0].image_size
    pixels = np.zeros((cfg.num_images_in_input, len(cfg.vision_configs), size, size, 3),
                      np.float32)
    proprio = np.zeros(policy.platform.proprio_dim, np.float32)

    def run():
        actions = policy.predict_action(pixels, "put the bowl on the plate", proprio=proprio)
        if policy.device.type == "cuda":
            torch.cuda.synchronize()
        return actions

    t0 = time.perf_counter()
    run()
    print(f"# first call: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    run()
    if policy.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(args.k):
        actions = run()
    per_call = (time.perf_counter() - t0) / args.k
    peak = torch.cuda.max_memory_allocated() if policy.device.type == "cuda" else None
    mode = ("full-prefill" if args.old else "prefix-kv") \
        + ("+split-kv" if args.split_kv else "") \
        + (f"+{args.quant}" if args.quant else "") \
        + ("+static" if args.static else "") \
        + ("+film" if cfg.use_film else "")
    print(f"diffusion[{mode}] steps={args.steps}: {per_call * 1e3:.1f} ms/chunk "
          f"({per_call / args.steps * 1e3:.2f} ms/step)")
    if peak is not None:
        print(f"# torch.cuda.max_memory_allocated over the timed calls: "
              f"{peak / 2**30:.3f} GiB", file=sys.stderr)
    return {"mode": mode, "ms_per_chunk": per_call * 1e3, "actions": actions,
            "peak_bytes": peak}


if __name__ == "__main__":
    main()
