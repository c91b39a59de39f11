#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: `python3 chip_smoke.py`.

Drives the port's serving path and its training path once each, at the full
width of the flagship model (DINOv2 + SigLIP -> projector -> Llama-2-7B,
2 images, LIBERO, seeded random weights made on the card), through the entry
points a user calls: an HTTP /act server built by
`openvla_oft_tpu_torch.serving.deploy`, and the fine-tuning CLI
`openvla_oft_tpu_torch.training.finetune` (LoRA r=32, L1 objective, B=8).

Phases, each of which raises on failure (exit code != 0, no result line):
  1. environment: the card, torch/CUDA versions, TF32 off;
  2. build: the hand-written kernels from `openvla_oft_tpu_torch/csrc`;
  3. kernel check: K1 (and `flash_attention_allheads`, which is K1) against
     its plain version at the serving path's shapes, timed;
  4. serving: 3 /act requests, K1 launched 31 times per request;
  5. path parity: the K1 path against the dense path on the same inputs;
  6. backward kernel check: K2 (dq) and K3 (dk, dv) against their plain
     version at the training shape (B=8, per-row pads and windows), the
     ALOHA length, GQA and dead rows, timed;
  7. training: 3 steps of the fine-tuning CLI at B=8 (remat "all": K1 64,
     K2 32 and K3 32 launches per step), loss, grad norm, step time, peak
     memory;
  8. step profile: the CLI's train_step on its final state and first batch,
     3 steps timed, then one traced with torch.profiler (device activity
     only): device time by kernel class and the idle share;
  9. training-path parity: one loss and backward through K1/K2/K3 against
     the dense path on the same 7B weights and batch.
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

import gc
import json
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Tolerances of the kernel check: bf16 outputs of an fp32-accumulated
# attention against fp32 math on the same bf16 inputs.
MAX_ABS_O, MEAN_ABS_O, MAX_ABS_LSE = 2e-2, 2e-3, 1e-2
PARITY_COSINE = 0.99
# K2/K3 against fp32 math on the same bf16 inputs: max|Δ| / max|ref| and cosine.
BWD_REL, BWD_COSINE = 2e-2, 0.999
# The fine-tuning CLI's flags: the oft-libero-spatial recipe's (recipes.py:24-33)
# with its per-GPU batch ("8 GPUs x batch 8") and 3 steps.
TRAIN_FLAGS = ["--vla_path", "random:7b", "--data_root_dir", "dummy",
               "--dataset_name", "libero_spatial_no_noops", "--robot_platform", "libero",
               "--use_l1_regression", "True", "--use_proprio", "True",
               "--num_images_in_input", "2", "--lora_rank", "32", "--batch_size", "8",
               "--learning_rate", "5e-4", "--num_steps_before_decay", "100000",
               "--max_steps", "3", "--merge_lora_during_training", "False",
               "--wandb_log_freq", "1", "--device", "cuda"]
TRAIN_LOSS_REL, TRAIN_GRAD_COSINE = 1e-2, 0.99


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
        if name == "libero_prefill":
            # flash_attention_allheads (the TPU's all-heads-per-block variant)
            # is K1 reading (B, S, H, D) through its strides.
            o_all = fa.flash_attention_allheads(q, k, v, is_causal=True,
                                                key_valid=key_valid, bidir_mask=bidir)
            torch.cuda.synchronize()
            all_err = (o_all.float() - o_ref.float())[:, live].abs().max().item()
            log(f"[kernel] flash_attention_allheads (K1) {name}: max|dO|={all_err:.3e}")
            if not all_err <= MAX_ABS_O:
                raise AssertionError("flash_attention_allheads disagrees with its plain version")
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
        reset_launch_counts()
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


def launch_counts() -> dict:
    from openvla_oft_tpu_torch.ops import flash_attention as fa

    return {"K1": fa.flash_attention.launches, "K2": fa.flash_attention_dq.launches,
            "K3": fa.flash_attention_dkv.launches}


def reset_launch_counts() -> None:
    from openvla_oft_tpu_torch.ops import flash_attention as fa

    fa.flash_attention.launches = 0
    fa.flash_attention_dq.launches = 0
    fa.flash_attention_dkv.launches = 0


def training_setup():
    """The fine-tuning CLI's flags parsed, its model config, platform,
    TrainConfig and first batch (numpy), all as the CLI builds them."""
    from openvla_oft_tpu_torch.training import finetune as FT

    cfg = FT.parse_config(TRAIN_FLAGS)
    return (FT.model_config(cfg), FT.platform_of(cfg), FT.train_config(cfg),
            FT.first_batch(cfg))


def live_tile_pairs(key_valid: np.ndarray, bidir: np.ndarray, tile: int = 64) -> int:
    """(query tile, key tile) pairs that K2 and K3 compute, over the batch:
    the skip rule of csrc/oft_mask.cuh (causal)."""
    b, s = key_valid.shape
    pairs = 0
    for bi in range(b):
        for q0 in range(0, s, tile):
            q_hi = min(q0 + tile, s) - 1
            q_bid = bidir[bi, q0:q_hi + 1].any()
            for k0 in range(0, s, tile):
                valid = key_valid[bi, k0:k0 + tile]
                k_bid = (valid & bidir[bi, k0:k0 + tile]).any()
                pairs += bool(valid.any() and (k0 <= q_hi or (q_bid and k_bid)))
    return pairs


def _rel_cos(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    g, r = got.double().flatten(), ref.double().flatten()
    rel = ((g - r).abs().max() / r.abs().max()).item()
    cos = torch.nn.functional.cosine_similarity(g, r, dim=0).item()
    return (g - r).abs().max().item(), rel, cos


def backward_check(card: str, s_train: int) -> dict:
    """K2 and K3 against flash_attention_bwd_ref, timed with CUDA events."""
    from openvla_oft_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    s = s_train
    # Right pads and a 57-slot window (56 actions + STOP) that differ per row,
    # as in a training batch whose prompts differ in length.
    train_rows = [(0, s - 5 * i, s - 5 * i - 57, 57) for i in range(8)]
    # (name, B, S, H, Hkv, D, [(first valid key, last valid + 1, window start, len)])
    cases = [
        ("training", 8, s, 32, 32, 128, train_rows),
        ("aloha_length", 1, 1168, 32, 32, 128, [(0, 1168, 817, 351)]),
        ("gqa", 2, s, 32, 8, 128, train_rows[::4]),
        ("dead_rows", 1, s, 32, 32, 128, [(150, s, s - 57, 57)]),
    ]
    results = {}
    for name, b, s_len, h, hkv, d, rows in cases:
        gen = torch.Generator(device=dev).manual_seed(s_len + hkv + b)
        qkv = torch.randn((b, s_len, (h + 2 * hkv) * d), generator=gen, device=dev).bfloat16()
        q = qkv[..., :h * d].view(b, s_len, h, d)
        k = qkv[..., h * d:(h + hkv) * d].view(b, s_len, hkv, d)
        v = qkv[..., (h + hkv) * d:].view(b, s_len, hkv, d)
        do = torch.randn((b, s_len, h, d), generator=gen, device=dev).bfloat16()
        key_valid = torch.zeros((b, s_len), dtype=torch.bool, device=dev)
        bidir = torch.zeros((b, s_len), dtype=torch.bool, device=dev)
        for i, (lo, hi, w0, wl) in enumerate(rows):
            key_valid[i, lo:hi] = True
            bidir[i, w0:w0 + wl] = True
        o, lse = fa.flash_attention_fwd(q, k, v, True, key_valid, bidir)
        args = (q, k, v, o, lse, do, True, key_valid, bidir)
        dq = fa.flash_attention_dq(*args)
        dk, dv = fa.flash_attention_dkv(*args)
        torch.cuda.synchronize()
        refs = fa.flash_attention_bwd_ref(*args)
        errs = {n: _rel_cos(g, r) for n, g, r in zip(("dq", "dk", "dv"), (dq, dk, dv), refs)}
        dead = ~fa._allow(q, True, key_valid, bidir)[:, 0].any(-1)
        zeros = bool(torch.all(dq[dead] == 0) and torch.all(dk[~key_valid] == 0)
                     and torch.all(dv[~key_valid] == 0))
        finite = all(bool(torch.isfinite(t).all()) for t in (dq, dk, dv))
        ms_dq = cuda_time_ms(lambda: fa.flash_attention_dq(*args))
        ms_dkv = cuda_time_ms(lambda: fa.flash_attention_dkv(*args))
        plain_dq = cuda_time_ms(lambda: fa.flash_attention_dq_ref(*args))
        plain_dkv = cuda_time_ms(lambda: fa.flash_attention_dkv_ref(*args))
        pairs = live_tile_pairs(key_valid.cpu().numpy(), bidir.cpu().numpy())
        mm = 2 * 64 * 64 * d * h * pairs          # one 64x64xD product per live pair and head
        tf_dq, tf_dkv = 3 * mm / ms_dq / 1e9, 4 * mm / ms_dkv / 1e9
        log(f"[bwd] {name}: B={b} S={s_len} H={h} Hkv={hkv} D={d} rows={rows[:2]}"
            f"{'...' if len(rows) > 2 else ''} | " + " ".join(
                f"{n} max|d|={e[0]:.3e} rel={e[1]:.3e} cos={e[2]:.6f}" for n, e in errs.items())
            + f" | dead rows and invalid keys exactly 0: {zeros}, finite: {finite}")
        log(f"[bwd] {name}: K2 {ms_dq:.4f} ms ({tf_dq:.1f} TFLOP/s), plain dq {plain_dq:.4f} ms;"
            f" K3 {ms_dkv:.4f} ms ({tf_dkv:.1f} TFLOP/s), plain dk/dv {plain_dkv:.4f} ms "
            f"({pairs} live 64x64 tile pairs per head; median of 20, CUDA events; {card})")
        if not (zeros and finite and all(e[1] <= BWD_REL and e[2] >= BWD_COSINE
                                         for e in errs.values())):
            raise AssertionError(f"K2/K3 disagree with their plain version at {name}")
        results[name] = {"dq_err": errs["dq"][0], "dkv_err": max(errs["dk"][0], errs["dv"][0]),
                         "ms_dq": ms_dq, "ms_dkv": ms_dkv, "plain_dq": plain_dq,
                         "plain_dkv": plain_dkv}
        del q, k, v, qkv, do, o, lse, dq, dk, dv, refs, args
    torch.cuda.empty_cache()
    return results


def train(card: str, n_layers: int):
    """3 steps of the fine-tuning CLI (in process); returns (state, launches)."""
    from openvla_oft_tpu_torch.bridge import tree_leaves
    from openvla_oft_tpu_torch.training import finetune as FT

    run_root = tempfile.mkdtemp(prefix="chip_smoke_runs_")
    expect = {"K1": 2 * n_layers, "K2": n_layers, "K3": n_layers}   # remat "all"
    seen = {"prev": {k: 0 for k in expect}}

    def on_step(step, metrics, state):
        counts = launch_counts()
        per_step = {k: counts[k] - seen["prev"][k] for k in counts}
        seen["prev"], seen["state"] = counts, state
        log(f"[train] step {step}: loss={metrics['loss']:.6f} grad_norm={metrics['grad_norm']:.6f}"
            f" curr_action_l1={metrics['curr_action_l1_loss']:.6f} step_time="
            f"{metrics['step_time']:.4f} s (host clock, ends in torch.cuda.synchronize) "
            f"launches {per_step} ({card})")
        if not (np.isfinite(metrics["loss"]) and np.isfinite(metrics["grad_norm"])
                and metrics["grad_norm"] > 0):
            raise AssertionError(f"bad training step {step}: {metrics}")
        if per_step != expect:
            raise AssertionError(f"step {step} launched {per_step}, expected {expect}")
        if step == 0:
            seen["first"] = [t.detach().clone() for t in tree_leaves(state.trainables)]

    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        reset_launch_counts()
        out = FT.main(TRAIN_FLAGS + ["--run_root_dir", run_root], on_step=on_step)
        launches = launch_counts()
        log(f"[train] finetune: {out['final_step']} steps in {time.perf_counter() - t0:.1f} s "
            f"(weights drawn on the card, checkpoint written); launches {launches}; "
            f"torch.cuda.max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB"
            f" ({card})")
        state = seen["state"]
        if out["final_step"] != 3 or out["ckpt"] is None:
            raise AssertionError(f"the training run ended at {out}")
        if launches != {k: 3 * n for k, n in expect.items()}:
            raise AssertionError(f"training launched {launches}")
        leaves = tree_leaves(state.trainables)
        start = 0
        for group, tree in state.trainables.items():
            stop = start + len(tree_leaves(tree))
            moved = max((a.detach() - b).abs().max().item()
                        for a, b in zip(leaves[start:stop], seen["first"][start:stop]))
            log(f"[train] {group}: max |change| between step 0 and step 2 = {moved:.3e}")
            if not moved > 0:
                raise AssertionError(f"trainables {group} did not change")
            start = stop
        del seen["first"]
        return state, launches
    finally:
        shutil.rmtree(run_root, ignore_errors=True)


def kernel_class(name: str) -> str:
    n = name.lower()
    for cls, keys in (("K1", ("flash_fwd",)), ("K2", ("flash_bwd_dq",)),
                      ("K3", ("flash_bwd_dkv",)),
                      ("fp32 GEMM", ("sgemm", "f32f32", "simt")),
                      ("bf16 GEMM", ("gemm", "cutlass", "xmma", "nvjet", "sm90")),
                      ("AdamW", ("multi_tensor", "adam")),
                      ("reduction", ("reduce", "norm")),
                      ("copy and cat", ("copy", "cat", "memcpy", "memset")),
                      ("elementwise", ("elementwise", "vectorized", "unrolled"))):
        if any(k in n for k in keys):
            return cls
    return "other"


def profile_step(state, card: str) -> dict:
    """The CLI's train_step on its final state and first batch: 3 steps
    timed without the profiler, then one traced with torch.profiler (device
    activity only). The idle share of the traced step is 1 - (union of kernel
    intervals) / (its wall time); tracing slows the host, so that is an upper
    bound. Kernel durations do not depend on the host, so 1 - (device time) /
    (median untraced step) estimates the idle share of an untraced step."""
    from torch.profiler import ProfilerActivity, profile

    from openvla_oft_tpu_torch.training.train_step import train_step

    model_cfg, platform, tcfg, batch = training_setup()
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}

    def step() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(state, batch, model_cfg, platform, tcfg)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    untraced = [step() for _ in range(3)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall = step()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise AssertionError("torch.profiler recorded no device activity")
    busy, end = 0.0, float("-inf")
    for s, e in sorted((k.time_range.start, k.time_range.end) for k in kernels):
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    busy /= 1e3                                         # us -> ms
    by_class = {}
    for k in kernels:
        cls = kernel_class(k.name)
        ms, n = by_class.get(cls, (0.0, 0))
        by_class[cls] = (ms + (k.time_range.end - k.time_range.start) / 1e3, n + 1)
    log(f"[profile] train_step at B=8: untraced {', '.join(f'{t:.1f}' for t in untraced)} ms;"
        f" traced {wall:.1f} ms with {len(kernels)} kernels and {busy:.1f} ms of device time"
        f" (union of kernel intervals); idle share of the traced step "
        f"{1 - busy / wall:.3f}; estimate for the untraced steps "
        f"{1 - busy / float(np.median(untraced)):.3f} (host clock, ends in "
        f"torch.cuda.synchronize; {card})")
    for cls, (ms, n) in sorted(by_class.items(), key=lambda kv: -kv[1][0]):
        log(f"[profile]   {cls}: {ms:.1f} ms, {n} kernels")
    return {"untraced_ms": untraced, "traced_ms": wall, "busy_ms": busy}


def training_parity(state, card: str) -> None:
    """One loss and backward through K1/K2/K3 and through the dense path on
    the same 7B weights and batch, LoRA B drawn with std 1e-3."""
    from openvla_oft_tpu_torch.bridge import tree_leaves
    from openvla_oft_tpu_torch.training import train_step as TT

    dev = state.base_params["llm"]["embed"]["embedding"].device
    cfg, platform, tcfg, batch = training_setup()
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    gen = torch.Generator(device=dev).manual_seed(7)

    def lora_b(tree):
        for key, node in tree.items():
            if key == "b":
                yield node
            elif isinstance(node, dict):
                yield from lora_b(node)

    with torch.no_grad():
        for b in lora_b(state.trainables["lora"]):
            b.normal_(0.0, 1e-3, generator=gen)
    leaves = tree_leaves(state.trainables)
    loss, grads = {}, {}
    for use_flash in (True, False):
        before = launch_counts()
        l, _ = TT.loss_and_metrics(state.trainables, state.base_params, batch, cfg,
                                   platform, tcfg, use_flash=use_flash)
        g = torch.autograd.grad(l, leaves)
        loss[use_flash] = l.item()
        grads[use_flash] = g
        used = {k: v - before[k] for k, v in launch_counts().items()}
        log(f"[train-parity] use_flash={use_flash}: loss={loss[use_flash]:.6f} launches {used}")
    rel = abs(loss[True] - loss[False]) / abs(loss[False])
    log(f"[train-parity] loss K1/K2/K3 path {loss[True]:.6f}, dense path {loss[False]:.6f}, "
        f"relative difference {rel:.3e} ({card})")
    ok = np.isfinite(loss[True]) and rel <= TRAIN_LOSS_REL
    start = 0
    for group, tree in state.trainables.items():
        stop = start + len(tree_leaves(tree))
        flat = [torch.cat([x.float().flatten() for x in grads[f][start:stop]])
                for f in (True, False)]
        cos = torch.nn.functional.cosine_similarity(flat[0], flat[1], dim=0).item()
        log(f"[train-parity] {group}: gradient cosine(K1/K2/K3 path, dense path) = {cos:.6f}")
        ok = ok and cos >= TRAIN_GRAD_COSINE
        start = stop
    if not ok:
        raise AssertionError("the training path through K1/K2/K3 disagrees with the dense path")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this smoke run needs one.",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False
    from openvla_oft_tpu_torch import _build
    from openvla_oft_tpu_torch.bridge import tree_leaves
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
    n_params = sum(t.numel() for t in tree_leaves(policy.params))
    log(f"[init] flagship params on the card: {n_params / 1e9:.3f} B, "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB, built in "
        f"{time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)
    observations, answers, serve_launches = serve(policy, card, rng)
    path_parity(policy, observations[0], answers[0])
    n_layers = policy.cfg.llm.num_layers
    del policy
    gc.collect()
    torch.cuda.empty_cache()

    cfg, _, _, batch = training_setup()
    s_train = (batch["input_ids"].shape[1] + 1                      # + proprio token
               + cfg.num_images_in_input * cfg.vision_configs[0].num_patches)
    log(f"[bwd] training layout: S = {s_train} (text bucket + "
        f"{cfg.num_images_in_input} x {cfg.vision_configs[0].num_patches} patches + proprio)")
    bwd = backward_check(card, s_train)
    state, train_launches = train(card, n_layers)
    profile_step(state, card)
    training_parity(state, card)

    libero, tr = checks["libero_prefill"], bwd["training"]
    src = "openvla_oft_tpu_torch/csrc/"
    kernels = [{"name": "flash_attention_fwd", "route": "cuda",
                "source": src + "flash_attention_fwd.cu",
                "replaces": "openvla_oft_tpu/ops/flash_attention.py:50",
                "launches": serve_launches + train_launches["K1"],
                "max_abs_err": max(c["max_abs_err"] for c in checks.values()),
                "ms": libero["ms"], "plain_ms": libero["plain_ms"]},
               {"name": "flash_attention_dq", "route": "cuda",
                "source": src + "flash_attention_bwd.cu",
                "replaces": "openvla_oft_tpu/ops/flash_attention.py:181",
                "launches": train_launches["K2"],
                "max_abs_err": max(c["dq_err"] for c in bwd.values()),
                "ms": tr["ms_dq"], "plain_ms": tr["plain_dq"]},
               {"name": "flash_attention_dkv", "route": "cuda",
                "source": src + "flash_attention_bwd.cu",
                "replaces": "openvla_oft_tpu/ops/flash_attention.py:207",
                "launches": train_launches["K3"],
                "max_abs_err": max(c["dkv_err"] for c in bwd.values()),
                "ms": tr["ms_dkv"], "plain_ms": tr["plain_dkv"]}]
    log(f"[launches] serving run: K1 {serve_launches}; training run: {train_launches}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
