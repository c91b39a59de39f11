"""Autoregressive discrete-decode latency on one card, beside the OFT
parallel decode of the same tokens.

Port of `vla_scripts/bench_ar.py`. Base OpenVLA (reference
`prismatic/models/vlas/openvla.py:36-103`) decodes one greedy action token
at a time; OFT decodes a whole chunk in one prefill with parallel decoding
(the OFT paper, arXiv 2502.19645, reports about 26x on an A100). Rows:
  - base-OpenVLA 1 action: 1 image, a 48-token prompt bucket with 24 real
    tokens (S = 48 + 256 = 304), greedy decode of 7 tokens
    (`models/prismatic.py::predict_action_autoregressive`);
  - the chunked-AR strawman: the same prefill, 56 tokens (what an 8 x 7
    chunk would cost without parallel decoding);
  - the OFT parallel decode of the same 56 discrete tokens, from the same
    param tree, served by an `OpenVLAPolicy(head="discrete")` at 2 images
    through `predict_action` (the tree does not depend on the image count);
    the AR-56 / parallel ratio is printed after it.

    python -m openvla_oft_tpu_torch.scripts.bench_ar [--quant {int8,int4,int4a8}]
        [--k K] [--device cuda]

The model is the deploy CLI's flagship with the discrete head
(`serving/deploy.py::flagship_policy(head="discrete", num_images=1)`:
DINOv2 + SigLIP, Llama-2-7B with its lm_head, seeded random bf16 weights
drawn on the device, fused and quantized by `serving_params`): `--quant
int8` is `load_in_8bit` (the LLM, the ViTs and the projector W8A8), `int4`
is `load_in_4bit` (the LLM only, as the JAX bench does), `int4a8` the same
weights served W4A8. The lm_head stays bf16 in every mode. Each row's first
call (kernel builds, allocator growth) and one warm call go untimed, then K
calls are timed by the host clock, each ending in
`torch.cuda.synchronize()`. On the card the peak of
`torch.cuda.max_memory_allocated` over the timed calls is printed last. It
runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

BUCKET, REAL_TOKENS = 48, 24
ROWS = (("base-openvla 1 action (7 tokens)", 7),
        ("chunked-AR strawman 8x7 (56 tokens)", 56))
PARALLEL_LABEL = "OFT parallel decode 8x7 (56 tokens, 2 images)"


def build_policy(args):
    from openvla_oft_tpu_torch.serving.deploy import flagship_policy

    return flagship_policy(torch.device(args.device), seed=args.seed, head="discrete",
                           num_images=1, load_in_4bit=args.quant in ("int4", "int4a8"),
                           int4_a8=args.quant == "int4a8", load_in_8bit=args.quant == "int8")


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quant", default=None, choices=["int8", "int4", "int4a8"])
    ap.add_argument("--k", type=int, default=8, help="timed calls per row")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def prompt(device) -> tuple:
    """The JAX bench's prompt: 24 real tokens ([BOS] 100 x 22 [29871])
    left-padded into a 48-token bucket. (ids, mask) (1, 48)."""
    ids = torch.zeros((1, BUCKET), dtype=torch.long, device=device)
    ids[0, -REAL_TOKENS:] = torch.tensor([1] + [100] * (REAL_TOKENS - 2) + [29871])
    mask = torch.zeros((1, BUCKET), dtype=torch.long, device=device)
    mask[0, -REAL_TOKENS:] = 1
    return ids, mask


def time_calls(fn, k: int, device) -> float:
    """ms per call over k timed calls after two untimed ones (host clock,
    each ending in torch.cuda.synchronize on the card)."""
    def run():
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
        return out

    run()
    run()
    t0 = time.perf_counter()
    for _ in range(k):
        run()
    return (time.perf_counter() - t0) / k * 1e3


def main(argv=None) -> dict:
    from openvla_oft_tpu_torch.models.prismatic import predict_action_autoregressive
    from openvla_oft_tpu_torch.ops.quant import int4_a8
    from openvla_oft_tpu_torch.policy import OpenVLAPolicy

    args = parse(argv)
    policy = build_policy(args)
    cfg, platform, params, dev = policy.cfg, policy.platform, policy.params, policy.device
    tag = args.quant or "bf16"
    size = cfg.vision_configs[0].image_size
    ids, mask = prompt(dev)
    pixels = torch.zeros((1, 1, len(cfg.vision_configs), size, size, 3), device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    rows, tokens = {}, {}
    for label, n_new in ROWS:
        def decode(n=n_new):
            with torch.inference_mode(), int4_a8(policy.int4_a8):
                return predict_action_autoregressive(params, cfg, platform, ids, mask, pixels,
                                                     num_new_tokens=n)

        ms = time_calls(decode, args.k, dev)
        tokens[n_new] = decode().cpu().numpy()
        rows[label] = ms
        print(f"{label}[{tag}]: {ms:.1f} ms ({ms / n_new:.2f} ms/token)", flush=True)

    parallel = OpenVLAPolicy(cfg=dataclasses.replace(cfg, num_images_in_input=2),
                             platform=platform, params=params, head="discrete",
                             prompt_bucket=BUCKET, int4_a8=policy.int4_a8)
    frames = np.zeros((2, len(cfg.vision_configs), size, size, 3), np.float32)
    proprio = np.zeros(platform.proprio_dim, np.float32)
    ms = time_calls(lambda: parallel.predict_action(frames, "put the bowl on the plate",
                                                    proprio=proprio), args.k, dev)
    rows[PARALLEL_LABEL] = ms
    n_chunk = platform.chunk_len
    ratio = rows[ROWS[1][0]] / ms
    print(f"{PARALLEL_LABEL}[{tag}]: {ms:.1f} ms ({ms / n_chunk:.2f} ms/token)", flush=True)
    print(f"AR 56 tokens / parallel decode: {ratio:.1f}x [{tag}]", flush=True)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
    if peak is not None:
        print(f"# torch.cuda.max_memory_allocated over the rows: {peak / 2**30:.3f} GiB",
              file=sys.stderr)
    return {"ms": rows, "ratio": ratio, "tokens": tokens, "peak_bytes": peak, "tag": tag}


if __name__ == "__main__":
    main()
