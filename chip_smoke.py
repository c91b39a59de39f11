#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: `python3 chip_smoke.py`.

Drives the port's serving path once, at the full width of the flagship model
(DINOv2 + SigLIP -> projector -> Llama-2-7B, 2 images, LIBERO, bf16, seeded
random weights made on the card), through the entry points a user calls:
an HTTP /act server built by `openvla_oft_tpu_torch.serving.deploy`.

Phases, each of which raises on failure (exit code != 0, no result line):
  1. environment: the card, torch/CUDA versions, TF32 off;
  2. build: the hand-written kernels from `openvla_oft_tpu_torch/csrc`;
  3. kernel check: K1 against its plain version at the path's shapes, timed;
  4. serving: 3 /act requests, K1 launched 31 times per request;
  5. path parity: the K1 path against the dense path on the same inputs.
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

import json
import socket
import subprocess
import sys
import time

import numpy as np
import torch

# Tolerances of the kernel check: bf16 outputs of an fp32-accumulated
# attention against fp32 math on the same bf16 inputs.
MAX_ABS_O, MEAN_ABS_O, MAX_ABS_LSE = 2e-2, 2e-3, 1e-2
PARITY_COSINE = 0.99


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median of `iters` CUDA-event timings of fn() after `warmup` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def kernel_check(card: str) -> dict:
    """K1 against flash_attention_ref at the serving path's shapes."""
    from openvla_oft_tpu_torch.ops import flash_attention as fa
    from openvla_oft_tpu_torch.ops.attention import attention

    dev = torch.device("cuda")
    # (name, B, S, H, Hkv, D, left pads, window (start, len))
    cases = [
        ("libero_prefill", 1, 618, 32, 32, 128, 24, (561, 57)),
        ("aloha_length", 1, 1168, 32, 32, 128, 24, (817, 351)),
        ("gqa", 1, 618, 32, 8, 128, 24, (561, 57)),
        ("dead_rows", 1, 618, 32, 32, 128, 150, (561, 57)),
    ]
    results = {}
    for name, b, s, h, hkv, d, pads, (w0, wl) in cases:
        gen = torch.Generator(device=dev).manual_seed(s + hkv)
        # q/k/v as views of one fused projection output, as the Llama path has them.
        qkv = torch.randn((b, s, (h + 2 * hkv) * d), generator=gen, device=dev).bfloat16()
        q = qkv[..., :h * d].view(b, s, h, d)
        k = qkv[..., h * d:(h + hkv) * d].view(b, s, hkv, d)
        v = qkv[..., (h + hkv) * d:].view(b, s, hkv, d)
        key_valid = torch.ones((b, s), dtype=torch.bool, device=dev)
        key_valid[:, :pads] = False
        bidir = torch.zeros((b, s), dtype=torch.bool, device=dev)
        bidir[:, w0:w0 + wl] = True
        o, lse = fa.flash_attention_fwd(q, k, v, True, key_valid, bidir)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.flash_attention_ref(q, k, v, True, key_valid, bidir)
        live = key_valid[0]
        err = (o.float() - o_ref.float())[:, live].abs()
        max_err, mean_err = err.max().item(), err.mean().item()
        lse_err = (lse - lse_ref)[..., live].abs().max().item()
        dead_zero = bool(torch.all(o[:, ~live] == 0).item())
        ms = cuda_time_ms(lambda: fa.flash_attention_fwd(q, k, v, True, key_valid, bidir))
        plain_ms = cuda_time_ms(lambda: fa.flash_attention_ref(q, k, v, True, key_valid,
                                                               bidir))
        dense_ms = cuda_time_ms(lambda: attention(q, k, v, is_causal=True, use_flash=False,
                                                  key_valid=key_valid, bidir_mask=bidir))
        log(f"[kernel] K1 {name}: B={b} S={s} H={h} Hkv={hkv} D={d} pads={pads} "
            f"window=({w0},{wl}) max|dO|={max_err:.3e} mean|dO|={mean_err:.3e} "
            f"max|dLSE|={lse_err:.3e} dead_rows_zero={dead_zero} | kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, dense path {dense_ms:.4f} ms "
            f"(median of 20, CUDA events; {card})")
        if not (max_err <= MAX_ABS_O and mean_err <= MEAN_ABS_O
                and lse_err <= MAX_ABS_LSE and dead_zero):
            raise AssertionError(f"K1 disagrees with its plain version at {name}")
        results[name] = {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}
    return results


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def serve(policy, card: str, rng) -> tuple:
    """3 /act requests through the HTTP server; returns (observations, answers,
    launches in the run)."""
    from openvla_oft_tpu_torch.ops.flash_attention import flash_attention
    from openvla_oft_tpu_torch.serving.deploy import build_server, get_action_from_server

    platform = policy.platform
    n_layers = policy.cfg.llm.num_layers
    server = build_server(policy)
    port = free_port()
    server.run("127.0.0.1", port, background=True)
    observations, answers = [], []
    try:
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        for i in range(3):
            obs = {"full_image": rng.integers(0, 256, (256, 256, 3), dtype=np.uint8),
                   "wrist_image": rng.integers(0, 256, (256, 256, 3), dtype=np.uint8),
                   "state": rng.standard_normal(platform.proprio_dim).astype(np.float32),
                   "instruction": "put the bowl on the plate"}
            before = flash_attention.launches
            t0 = time.perf_counter()
            action = get_action_from_server(obs, f"http://127.0.0.1:{port}/act")
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            per_request = flash_attention.launches - before
            if not isinstance(action, np.ndarray):
                raise AssertionError(f"/act answered {action!r}")
            log(f"[serve] request {i}: /act -> {action.shape} {action.dtype} finite="
                f"{bool(np.isfinite(action).all())}, K1 launches {per_request}, "
                f"latency {dt * 1e3:.2f} ms (host wall clock around the HTTP round trip, "
                f"ends in torch.cuda.synchronize; {card})")
            if action.shape != (platform.num_actions_chunk, platform.action_dim) \
                    or not np.isfinite(action).all():
                raise AssertionError("bad action chunk")
            if per_request != n_layers - 1:
                raise AssertionError(f"K1 ran {per_request} times in one request, "
                                     f"expected {n_layers - 1}")
            observations.append(obs)
            answers.append(action)
        launches = flash_attention.launches
    finally:
        server.shutdown()
    log(f"[serve] torch.cuda.max_memory_allocated during serving: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB ({card})")
    return observations, answers, launches


def path_parity(policy, obs, served) -> None:
    """serve_action_chunk / predict_action_hidden through K1 and through the
    dense oracle on the same inputs, both on the card."""
    from openvla_oft_tpu_torch.models.prismatic import predict_action_hidden, prepare_prompt_ids
    from openvla_oft_tpu_torch.policy import serve_action_chunk
    from openvla_oft_tpu_torch.processing.image_processing import device_preprocess

    dev = policy.device
    cfg, platform = policy.cfg, policy.platform
    frames = torch.tensor(np.stack([obs["full_image"], obs["wrist_image"]]),
                          device=dev)[None]
    ids, mask = prepare_prompt_ids(policy.tokenizer, obs["instruction"],
                                   policy.prompt_bucket)
    ids = torch.as_tensor(ids, device=dev)[None]
    mask = torch.as_tensor(mask, device=dev)[None]
    proprio = torch.tensor(obs["state"], device=dev)[None]
    d = platform.action_dim
    common = dict(action_low=torch.full((d,), -1.0, device=dev),
                  action_high=torch.full((d,), 1.0, device=dev),
                  action_mask=torch.tensor([True] * (d - 1) + [False], device=dev),
                  proprio_low=torch.full((platform.proprio_dim,), -1.0, device=dev),
                  proprio_high=torch.full((platform.proprio_dim,), 1.0, device=dev),
                  resize_size=cfg.vision_configs[0].image_size)
    with torch.inference_mode():
        pixels = device_preprocess(cfg, frames[0], common["resize_size"])[None]
        hidden, actions = {}, {}
        for use_flash in (True, False):
            hidden[use_flash] = predict_action_hidden(
                policy.params, cfg, platform, ids, mask, pixels,
                proprio=proprio.clamp(-1, 1), use_flash=use_flash).actions_hidden.float()
            actions[use_flash] = serve_action_chunk(
                policy.params, cfg, platform, frames, ids, mask, proprio,
                use_flash=use_flash, **common)[0].cpu().numpy()
    cos = torch.nn.functional.cosine_similarity(hidden[True].flatten(),
                                                hidden[False].flatten(), dim=0).item()
    d_act = float(np.abs(actions[True] - actions[False]).max())
    d_served = float(np.abs(actions[True] - served).max())
    log(f"[parity] actions_hidden cosine(K1 path, dense path) = {cos:.6f}; "
        f"max|d actions| K1 vs dense = {d_act:.4e}; served /act vs direct K1 call "
        f"max|d| = {d_served:.4e}")
    if not cos >= PARITY_COSINE:
        raise AssertionError(f"K1 path and dense path disagree: cosine {cos}")
    if not np.isfinite(actions[False]).all() or d_served > 1e-3:
        raise AssertionError("served answer differs from the direct call")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this smoke run needs one.",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False
    from openvla_oft_tpu_torch import _build
    from openvla_oft_tpu_torch.serving.deploy import flagship_policy

    card = card_line()
    log(card)
    log(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}, "
        f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    lib_path = _build.build()
    log(f"[build] {lib_path.relative_to(_build.PKG_DIR.parent)} ready in "
        f"{time.perf_counter() - t0:.1f} s")
    log((lib_path.parent / "build.log").read_text().strip())

    checks = kernel_check(card)

    t0 = time.perf_counter()
    policy = flagship_policy("cuda", seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(policy.params))
    log(f"[init] flagship params on the card: {n_params / 1e9:.3f} B, "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB, built in "
        f"{time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)
    observations, answers, launches = serve(policy, card, rng)
    path_parity(policy, observations[0], answers[0])

    libero = checks["libero_prefill"]
    kernels = [{"name": "flash_attention_fwd", "route": "cuda",
                "source": "openvla_oft_tpu_torch/csrc/flash_attention_fwd.cu",
                "replaces": "openvla_oft_tpu/ops/flash_attention.py:50",
                "launches": launches,
                "max_abs_err": max(c["max_abs_err"] for c in checks.values()),
                "ms": libero["ms"], "plain_ms": libero["plain_ms"]}]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
