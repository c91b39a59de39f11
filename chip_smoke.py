#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: `python3 chip_smoke.py`.

Drives the port's serving paths (LIBERO bf16, ALOHA bf16 with FiLM and the
ViTs through K4, LIBERO int4, LIBERO int8, the LIBERO diffusion head in bf16
and int4, the discrete head and base OpenVLA's autoregressive decode in
bf16, int4 and int8), the K5 timing probe and the training path,
at the full width of the flagship model (DINOv2 + SigLIP -> projector ->
Llama-2-7B, seeded random weights made on the card), through the entry
points a user calls: an HTTP /act server built by
`openvla_oft_tpu_torch.serving.deploy` (`flagship_policy`, with
`platform="aloha"` and `vit_fused`, `load_in_4bit`, `load_in_8bit` or
`load_vision_in_8bit`, and `head="diffusion"` or `head="discrete"` through
the staged `OpenVLAPolicy.predict_action`), `predict_action_autoregressive`
and its bench script `openvla_oft_tpu_torch.scripts.bench_ar`, the probe script
`openvla_oft_tpu_torch.scripts.exp_int4_probe`, and the fine-tuning CLI
`openvla_oft_tpu_torch.training.finetune` (LoRA r=32, L1 objective, B=8).

Phases, each of which raises on failure (exit code != 0, no result line):
  1. environment: the card, torch/CUDA versions, TF32 off;
  2. build: the hand-written kernels from `openvla_oft_tpu_torch/csrc`; K1's
     to K6's registers, spills and shared memory from ptxas, and their
     wgmma instructions counted in the library's SASS (HGMMA for the bf16
     kernels, IGMMA for K6's int8; an instance with none is a failure);
  3. kernel check: K1 (and `flash_attention_allheads`, which is K1) against
     its plain version at the serving path's shapes (the diffusion prefix,
     S = 514 causal with no window, and the AR prefill, S = 304 causal with
     24 left pads, among them) and the training batch
     (per-row pads and windows), with its plan and two bitwise-equal calls,
     device times (torch.profiler, L2 flushed) beside SDPA with the boolean
     OFT mask and the bound, CUDA events beside them; K4 (`ln_matmul`)
     against its plain version at the 8 ViT serving shapes and on large-mean
     rows, with its plan, device times (torch.profiler) beside `torch.matmul`
     on the product alone and the bound, CUDA-event times beside the
     unfused sequence; two K4 calls bitwise equal;
  3a. K4's parts: the script `openvla_oft_tpu_torch.scripts.exp_k4_parts`
     (K4 without its statistics, its standardizing or its wgmmas, the
     statistics from a separate pass, the ring alone; every compiled tile at
     the 8 ViT shapes);
  3b. K1's parts: the script `openvla_oft_tpu_torch.scripts.exp_fwd_parts`
     (K1 without its softmax or its wgmmas, the ring alone, at S = 618, 1168
     and the training batch; the sweep over masks: cost per live pair and
     fixed cost);
  3c. use_flash="auto" where K1 does not take the call (run right after
     phase 3): one request of a policy at the stock TINY_LLAMA (head_dim 16)
     goes through the dense path (no K1 launch) and answers as
     use_flash=False;
  4. serving: 3 /act requests, K1 launched 31 times per request, the server
     built without its warm-up (the first request is the cold one); one
     request through FastAPI's /act (ActionServer.run) against the stdlib
     server's answer;
  5. path parity: the K1 path against the dense path on the same inputs;
     one request traced with torch.profiler with vit_fused on (K4 98
     launches) and one with it off (device time by kernel class);
  5a. ALOHA serving: `flagship_policy(platform="aloha", vit_fused=True)`
     (3 cameras, FiLM, 25 x 14 chunk, S = 1168): 3 /act requests with K1 31
     and K4 98 launches each, then 3 with vit_fused off (K4 0); the K4 path
     against the unfused path and the K1 path against the dense path; one
     request traced each way;
  6. int4 kernel check: K5 (W4A16) and K6 (W4A8) against their plain
     versions at the 7B's int4 shapes (T = 618, 514, 304, 57 and 1), a column
     view, a layer view and group 16, timed beside the library call
     (`torch.matmul`, `torch._int_mm`) and the bound, device times from
     torch.profiler, with each kernel's plan (t_tile, splits, CTAs), rate and
     share of the bound; two K5 calls and two K6 calls bitwise equal at wo
     T = 57 (split over K) and wqkv T = 618; K5 and the dequant path at
     T = 618 and 2048 (the dispatch rule);
  7. int4 serving: the policy rebuilt with `load_in_4bit`, 3 /act requests
     W4A16 (130 K5 launches each), then 3 W4A8 (130 K6 launches each); one
     request of each traced (the K5 and K6 share of the device time, and
     K5's and K6's time per request);
  8. int4 path parity: K5 and K6 against their plain versions through
     `predict_action_hidden` on the same int4 weights; int4 against bf16;
  8a. the K5 probe: the probe script's `main` (T = 112, the 7B's shapes;
     K5, its kernel with the three probe dequant policies, K6 and
     `torch.matmul` on the dequantized weight, by device time, and the split
     of K5's time, and the int8-dyn row: `int8_linear` on the int8 weight),
     each mode against its plain version at each shape, with the bound;
     group-dots' plain version timed at qkv;
  8b. int8 serving: one int8_linear at wqkv T = 618 and its q column view
     at T = 57, dynamic and static, traced (kernels per linear, the GEMM,
     which must be one kernel of the `int8 GEMM` class, against the
     quantize and the epilogue); the policy rebuilt
     with `load_in_8bit` (the LLM, the ViTs and the projector int8; build
     time, memory and its peak), 3 /act requests (K1 31, K4/K5/K6 0, 329
     int8 products each: 130 in the LLM, 196 in the ViTs, 3 in the
     projector), one traced (device time by class, the int8 share, kernels,
     idle share); actions_hidden through torch._int_mm against the float64
     product (max|d| <= 1e-6 of max|ref|), the K1 path against the dense
     path, int8 against bf16 (logged); static activation scales from 2
     random_observations (`attach_static_act_scales`), 3 requests and a
     traced one, static against dynamic (logged); `load_vision_in_8bit`, 3
     requests (199 int8 products each) and a traced one;
  8c. diffusion serving: `flagship_policy(head="diffusion")` (LIBERO, 50
     DDIM steps, the [BOS][patches][proprio] prefix K/V computed once, each
     step a 105-row suffix forward against 514 + 105 keys): build memory, 3
     `predict_action` requests on pixels from `device_preprocess` (K1 32
     each, the prefix prefill; K4/K5/K6 0), one traced (device time by
     class, idle share), wall and device time per chunk and per step; on
     the card the prefix K/V through K1 against the dense path, one suffix
     step against `predict_action_hidden`, the loop at 5 steps prefix-KV
     against full prefill and split-KV against concatenation (cosine >=
     0.99 each); then rebuilt with `load_in_4bit`: 2 requests (K5 128 +
     50 x 32 x 4 = 6,528 each), one traced, the prefix (T = 514) and one
     step (T = 105) through K5 against K5's plain version (cosine >= 0.99);
  8d. discrete decoding: `flagship_policy(head="discrete")` (LIBERO): 3
     `predict_action` requests (K1 31 each; K4/K5/K6 0), the action-row
     logits through K1 against dense (cosine >= 0.99, argmax agreement
     logged), the lm_head product (`torch.mm(..., out_dtype=float32)`)
     against the fp32 product of the same bf16 values (max|d| <= 1e-4 of
     max|ref|); base OpenVLA on the same tree at 1 image (bucket 48, 24
     real tokens, S = 304): `predict_action_autoregressive`, 3 requests of 7
     tokens and 2 of 56 (K1 32 each, the prefill), the cached decode against
     a no-cache forward over the same tokens (dense both, cosine >= 0.999),
     the prefill through K1 against dense (cosine >= 0.99), one request
     traced (device time by class, kernels a token, idle share); rebuilt
     with `load_in_4bit`: 2 requests of 7 tokens (K5 128 + 6 x 128 = 896
     each), one traced, one decode step through K5 against its plain version
     (cosine >= 0.99); with `load_in_8bit`: one request (1,095 int8
     products, one padded row per product in each step); `bench_ar` in bf16
     and with `--quant int4` (its 7-token, 56-token and parallel rows);
  9. backward kernel check: K2 (dq) and K3 (dk, dv) against their plain
     version at the training shape (B=8, per-row pads and windows), the
     ALOHA length, GQA and dead rows, two calls of each bitwise equal, with
     their plan; device times (torch.profiler, L2 flushed) beside SDPA's
     backward kernels alone and the bound, CUDA events beside them; the
     stats rows K2 writes against the stats pass and the plain LSE, delta;
 10. training: 3 steps of the fine-tuning CLI at B=8 (remat "all": K1 64,
     K2 32 and K3 32 launches per step), loss, grad norm, step time, peak
     memory, no stats pass (K3 reads K2's stats rows);
 11. step profile: the CLI's train_step on its final state and first batch,
     3 steps timed, then one traced with torch.profiler (device activity
     only): device time by kernel class, K1's and K2 + K3's shares, the idle
     share;
 12. training-path parity: one loss and backward through K1/K2/K3 against
     the dense path on the same 7B weights and batch.
Every serving phase but the first builds its server with the deploy CLI's
warm-up (one synthetic predict before it binds) and logs the warm-up's time
and the first request after it. The line before the last is a JSON object
with one entry per kernel; the last line is {"ok": true, "device": {...}}.
"""

import gc
import json
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from openvla_oft_tpu_torch.utils.timing import (cuda_time_ms, device_ms, l2_flush_buffer,
                                                profiled)

# Tolerances of the kernel check: bf16 outputs of an fp32-accumulated
# attention against fp32 math on the same bf16 inputs.
MAX_ABS_O, MEAN_ABS_O, MAX_ABS_LSE = 2e-2, 2e-3, 1e-2
PARITY_COSINE = 0.99
# The int8 path through torch._int_mm against its float64 product: both are
# exact int32 sums, so only a nondeterministic float op elsewhere could differ.
INT8_REL = 1e-6
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
# K5 and K6 against their plain versions, max|d| / max|ref|: K5 sums the same
# bf16 products in another order; K6's group products are exact int32 sums,
# so only the fp32 sum over the groups can differ.
INT4_K5_REL, INT4_K6_REL = 1e-3, 1e-4
# (name, K, N) of the 7B's int4 linears (wqkv and gate_up fused for serving).
INT4_SHAPES = [("wqkv", 4096, 12288), ("wo", 4096, 4096), ("gate_up", 4096, 22016),
               ("down", 11008, 4096)]
# K4 and the probe against their plain versions: max|d| / max|ref| (K4 one
# bf16 rounding, the sums in another order; the probe fp32 sums of the same
# bf16 products), and K4's cosine.
K4_REL, K4_COSINE, PROBE_REL = 1e-2, 0.9999, 1e-3
# (name, M, D, N, act): the ViTs' LN + matmul launches at ALOHA (3 images) and
# LIBERO (2): DINOv2 rows 3 x 261 and 2 x 261, SigLIP 3 x 256 and 2 x 256;
# qkv without activation, fc1 with the backbone's GELU.
K4_SHAPES = [
    (f"{vit} {proj} {deploy}", m, d, n, act)
    for deploy, rows in (("ALOHA", (783, 768)), ("LIBERO", (522, 512)))
    for vit, m, d, projs in (("DINOv2", rows[0], 1024, ((3072, None), (4096, "gelu"))),
                             ("SigLIP", rows[1], 1152, ((3456, None), (4304, "gelu_tanh"))))
    for proj, (n, act) in zip(("qkv", "fc1"), projs)]
K4_EXTRA = [("DINOv2 qkv ALOHA, quick_gelu", 783, 1024, 3072, "quick_gelu"),
            ("ragged M=37 N=200", 37, 1024, 200, "gelu"),
            ("DINOv2 fc1 ALOHA, large-mean rows", 783, 1024, 4096, "gelu")]
# K4_EXTRA cases drawn with rows of mean / std about 20 and high-norm tokens.
K4_LARGE_MEAN = ("DINOv2 fc1 ALOHA, large-mean rows",)
# H100 SXM (NVIDIA's data sheet): dense bf16 and int8 tensor-core peaks, HBM3 rate.
PEAK_BF16, PEAK_INT8, PEAK_BYTES = 989e12, 1979e12, 3.35e12


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(ops: float, n_bytes: int, peak: float) -> tuple:
    """(ms, "operations" or "bytes"): the least time the card could take, the
    larger of ops / peak and bytes / HBM rate."""
    t_ops, t_bytes = ops / peak * 1e3, n_bytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sdpa_args(q, k, v, key_valid, bidir):
    """The operands of torch's scaled_dot_product_attention for the same
    attention: (B, H, S, D) views and the boolean OFT mask (B, 1, S, S)."""
    from openvla_oft_tpu_torch.ops import flash_attention as fa

    return ([t.transpose(1, 2) for t in (q, k, v)],
            dict(attn_mask=fa._allow(q, True, key_valid, bidir),
                 enable_gqa=q.shape[2] != k.shape[2]))


def allowed_entries(q, key_valid, bidir) -> int:
    """The (query, key) entries that the OFT rule allows, summed over the
    batch: per head, the entries whose products a flash kernel needs. Its
    64x64 tiles also compute the refused entries of partial pairs; a bound
    does not count that work."""
    from openvla_oft_tpu_torch.ops import flash_attention as fa

    return int(fa._allow(q, True, key_valid, bidir).sum())


# The wgmma kernels' instances (mangled-name pattern -> label) and the wgmma
# form their SASS must hold: bf16 wgmma is HGMMA, int8 wgmma IGMMA.
WGMMA_KERNELS = {"K1": (r"flash_fwd_kernelILi(\d+)E", "HGMMA", "D={}"),
                 "K2": (r"flash_bwd_dq_kernelILi(\d+)E", "HGMMA", "D={}"),
                 "K3": (r"flash_bwd_dkv_kernelILi(\d+)E", "HGMMA", "D={}"),
                 "K4": (r"ln_matmul_kernelILi(\d+)ELi(\d+)E", "HGMMA", "BM={} BN={}"),
                 "K5": (r"int4_w4a16_wgmma_kernelILi(\d+)E\w*?DequantILi3E", "HGMMA",
                        "T_TILE={}"),
                 "probe": (r"int4_w4a16_wgmma_kernelILi(\d+)E\w*?DequantILi([012])E", "HGMMA",
                           "T_TILE={} mode={}"),
                 "K6": (r"int4_w4a8_wgmma_kernelILi(\d+)ELb([01])E", "IGMMA",
                        "T_TILE={} HALF={}")}


def wgmma_build_report(lib_path) -> dict:
    """K1's to K6's instances in ptxas' report (registers,
    spills, shared memory, any note that it serialized the wgmmas) and their
    wgmma instructions in the built library's SASS (HGMMA for the bf16 ones,
    IGMMA for K6's int8). An instance with none is not the wgmma design:
    that raises. Returns {kernel: {instance: count}}."""
    def instance(line):
        for name, (pattern, _, label) in WGMMA_KERNELS.items():
            m = re.search(pattern, line)
            if m:
                return name, label.format(*m.groups())
        return None

    stats, current = {}, None
    for line in (lib_path.parent / "build.log").read_text().splitlines():
        if "Compiling entry function" in line:
            current = instance(line)
        elif current and ("spill" in line or "Used" in line or "wgmma" in line):
            stats[current] = (stats.get(current, "") + " " + line.split(":")[-1].strip()).strip()
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=600, check=True).stdout
    counts, current = {name: {} for name in WGMMA_KERNELS}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = instance(line)
            if current:
                counts[current[0]][current[1]] = 0
        elif current and WGMMA_KERNELS[current[0]][1] in line:
            counts[current[0]][current[1]] += 1
    for name, inst in sorted(set(stats) | {(k, i) for k, v in counts.items() for i in v}):
        log(f"[build] {name} {inst}: ptxas {stats.get((name, inst), 'not reported')}; "
            f"{counts[name].get(inst, 0)} {WGMMA_KERNELS[name][1]} instructions in its SASS")
    for name, found in counts.items():
        if not found or min(found.values()) == 0:
            raise AssertionError(f"{name} does not reach wgmma: "
                                 f"{WGMMA_KERNELS[name][1]} counts {found}")
    return counts


def kernel_check(card: str, s_train: int) -> dict:
    """K1 against flash_attention_ref at the serving path's shapes and the
    training batch (per-row pads and windows), with its plan and two
    bitwise-equal calls; timed by device time (torch.profiler, L2 flushed)
    beside SDPA with the boolean OFT mask (the library yardstick) and the
    bound (FLOPs over the allowed entries; K1's own bytes), with CUDA
    events around the calls beside them."""
    from openvla_oft_tpu_torch.ops import flash_attention as fa
    from openvla_oft_tpu_torch.ops.attention import attention

    sdpa = torch.nn.functional.scaled_dot_product_attention

    dev = torch.device("cuda")
    s = s_train
    train_rows = [(0, s - 5 * i, s - 5 * i - 57, 57) for i in range(8)]   # as phase 9
    # (name, B, S, H, Hkv, D, [(first valid key, last valid + 1, window start, len)])
    cases = [
        ("libero_prefill", 1, 618, 32, 32, 128, [(24, 618, 561, 57)]),
        ("aloha_length", 1, 1168, 32, 32, 128, [(24, 1168, 817, 351)]),
        ("gqa", 1, 618, 32, 8, 128, [(24, 618, 561, 57)]),
        ("dead_rows", 1, 618, 32, 32, 128, [(150, 618, 561, 57)]),
        # the diffusion head's prefix prefill: causal, every key valid, no window
        ("diffusion_prefix", 1, 514, 32, 32, 128, [(0, 514, 0, 0)]),
        # the autoregressive decode's prefill: causal, 24 left pads, no window
        ("ar_prefill", 1, 304, 32, 32, 128, [(24, 304, 0, 0)]),
        ("training", 8, s, 32, 32, 128, train_rows),
    ]
    results = {}
    flush = l2_flush_buffer()
    for name, b, s_len, h, hkv, d, rows in cases:
        gen = torch.Generator(device=dev).manual_seed(s_len + hkv)
        # q/k/v as views of one fused projection output, as the Llama path has them.
        qkv = torch.randn((b, s_len, (h + 2 * hkv) * d), generator=gen, device=dev).bfloat16()
        q = qkv[..., :h * d].view(b, s_len, h, d)
        k = qkv[..., h * d:(h + hkv) * d].view(b, s_len, hkv, d)
        v = qkv[..., (h + hkv) * d:].view(b, s_len, hkv, d)
        key_valid = torch.zeros((b, s_len), dtype=torch.bool, device=dev)
        bidir = torch.zeros((b, s_len), dtype=torch.bool, device=dev)
        for i, (lo, hi, w0, wl) in enumerate(rows):
            key_valid[i, lo:hi] = True
            bidir[i, w0:w0 + wl] = True
        o, lse = fa.flash_attention_fwd(q, k, v, True, key_valid, bidir)
        again = fa.flash_attention_fwd(q, k, v, True, key_valid, bidir)
        torch.cuda.synchronize()
        bitwise = bool(torch.equal(o, again[0]) and torch.equal(lse, again[1]))
        del again
        o_ref, lse_ref = fa.flash_attention_ref(q, k, v, True, key_valid, bidir)
        live = fa._allow(q, True, key_valid, bidir)[:, 0].any(-1)          # (B, S)
        err = (o.float() - o_ref.float())[live].abs()
        max_err, mean_err = err.max().item(), err.mean().item()
        lse_err = (lse - lse_ref).transpose(1, 2)[live].abs().max().item()
        dead_zero = bool(torch.all(o[~live] == 0).item())
        finite = bool(torch.isfinite(o).all())
        masks = fa._mask_u8(b, s_len, key_valid, bidir, dev)
        dev_ms, how = device_ms(lambda: fa._launch(q, k, v, True, *masks), flush)
        qkv_t, kw = sdpa_args(q, k, v, key_valid, bidir)
        library_ms, how_lib = device_ms(lambda: sdpa(*qkv_t, **kw), flush)
        ms = cuda_time_ms(lambda: fa.flash_attention_fwd(q, k, v, True, key_valid, bidir))
        library_events = cuda_time_ms(lambda: sdpa(*qkv_t, **kw))
        plain_ms = cuda_time_ms(lambda: fa.flash_attention_ref(q, k, v, True, key_valid,
                                                               bidir))
        dense_ms = cuda_time_ms(lambda: attention(q, k, v, is_causal=True, use_flash=False,
                                                  key_valid=key_valid, bidir_mask=bidir))
        pairs = fa._live_pairs(True, key_valid, bidir)
        entries = allowed_entries(q, key_valid, bidir)
        flops = 2 * 2 * d * h * entries      # QK^T and PV over the allowed entries, every head
        # K1's own traffic: q, k, v and the masks read, O and LSE written.
        bound_ms, bound_by = bound(flops, nbytes(q, k, v, *masks, o, lse), PEAK_BF16)
        plan = fa._fwd_plan(b, s_len, h)
        log(f"[kernel] K1 {name}: B={b} S={s_len} H={h} Hkv={hkv} D={d} rows={rows[:2]}"
            f"{'...' if len(rows) > 2 else ''} | max|dO|={max_err:.3e} mean|dO|={mean_err:.3e} "
            f"max|dLSE|={lse_err:.3e} dead_rows_zero={dead_zero} finite={finite} two calls "
            f"bitwise equal: {bitwise}")
        log(f"[kernel] K1 {name}: plan rows={plan['rows']} tile={plan['tile']} stages="
            f"{plan['stages']} grid {plan['grid']} ({plan['grid'][0] * h * b} CTAs, q0 order "
            f"{plan['q0_order']}); K1 {dev_ms:.4f} ms ({flops / dev_ms / 1e9:.1f} TFLOP/s of "
            f"allowed work, {bound_ms / dev_ms:.3f} of the bound; {how}), SDPA with the boolean "
            f"mask {library_ms:.4f} ms ({how_lib}) (K1 / SDPA {dev_ms / library_ms:.2f}); bound "
            f"{bound_ms:.4f} ms ({bound_by}; {entries} allowed entries and {pairs} live 64x64 "
            f"tile pairs per head) (device time, mean of 10, L2 flushed; {card})")
        log(f"[kernel] K1 {name}, CUDA events (median of 20, wrapper included): K1 {ms:.4f} ms,"
            f" SDPA {library_events:.4f} ms, plain {plain_ms:.4f} ms, dense path "
            f"{dense_ms:.4f} ms")
        if not (max_err <= MAX_ABS_O and mean_err <= MEAN_ABS_O and lse_err <= MAX_ABS_LSE
                and dead_zero and finite and bitwise):
            raise AssertionError(f"K1 disagrees with its plain version at {name}")
        results[name] = {"max_abs_err": max_err, "ms": dev_ms, "plain_ms": plain_ms,
                         "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                         "plan": plan, "timing": how if how == how_lib else
                         f"K1 {how}, SDPA {how_lib}", "events_ms": ms,
                         "library_events_ms": library_events}
        if name == "libero_prefill":
            # flash_attention_allheads (the TPU's all-heads-per-block variant)
            # is K1 reading (B, S, H, D) through its strides.
            o_all = fa.flash_attention_allheads(q, k, v, is_causal=True,
                                                key_valid=key_valid, bidir_mask=bidir)
            torch.cuda.synchronize()
            all_err = (o_all.float() - o_ref.float())[live].abs().max().item()
            log(f"[kernel] flash_attention_allheads (K1) {name}: max|dO|={all_err:.3e}")
            if not all_err <= MAX_ABS_O:
                raise AssertionError("flash_attention_allheads disagrees with its plain version")
        del q, k, v, qkv, o, lse, o_ref, lse_ref, masks, qkv_t, kw
    del flush
    torch.cuda.empty_cache()
    return results


def k1_parts_phase(card: str) -> dict:
    """The script exp_fwd_parts: K1's variants at S = 618, 1168 and the
    training batch, and the sweep over masks (it prints its own lines)."""
    from openvla_oft_tpu_torch.scripts import exp_fwd_parts

    t0 = time.perf_counter()
    out = exp_fwd_parts.main([])
    for name, err in out["variants"]["max_abs_err"].items():
        if not err <= MAX_ABS_O:
            raise AssertionError(f"K1's parts build disagrees with its reference at {name}: {err}")
    log(f"[k1-parts] exp_fwd_parts.main: {time.perf_counter() - t0:.1f} s, the variants' and "
        f"masks' times above (ms, device time, L2 flushed; {card})")
    return out


def ln_matmul_check(card: str) -> dict:
    """K4 against ln_matmul_ref at the ViT serving shapes and the extra
    cases, with its plan; device times (torch.profiler, L2 flushed) of K4
    and of `torch.matmul` on the product alone (no single PyTorch call
    computes LN + matmul + activation), CUDA-event times beside its plain
    version and the port's unfused sequence (layer_norm -> linear ->
    activation, what the dense ViT path runs, GELU as serving's
    gelu_erf_fast), and the bound; two calls bitwise equal at DINOv2 fc1."""
    from openvla_oft_tpu_torch.models import vit as V
    from openvla_oft_tpu_torch.ops import vit_fused as VF
    from openvla_oft_tpu_torch.scripts.exp_k4_parts import operands

    dev = torch.device("cuda")
    flush = l2_flush_buffer(dev)
    results = {}
    for name, m, d, n, act in K4_SHAPES + K4_EXTRA:
        x, w, b = operands(m, d, n, seed=m + d + n, large_mean=name in K4_LARGE_MEAN)
        y = VF.ln_matmul(x, w, b, act)
        torch.cuda.synchronize()
        ref = VF.ln_matmul_ref(x, w, b, act)
        err, rel, cos = _rel_cos(y, ref)
        finite = bool(torch.isfinite(y).all())
        dense_act = "gelu_erf_fast" if act == "gelu" else act
        ms = cuda_time_ms(lambda: VF.ln_matmul(x, w, b, act), flush=flush)
        plain_ms = cuda_time_ms(lambda: VF.ln_matmul_ref(x, w, b, act), flush=flush)
        unfused_ms = cuda_time_ms(lambda: V._ln_linear({}, {"kernel": w, "bias": b}, x,
                                                       dense_act), flush=flush)
        library_ms = cuda_time_ms(lambda: torch.matmul(x, w), flush=flush)
        dev_ms, how = device_ms(lambda: VF.ln_matmul(x, w, b, act), flush)
        dev_lib, how_lib = device_ms(lambda: torch.matmul(x, w), flush)
        ops = 2 * m * d * n
        bound_ms, bound_by = bound(ops, nbytes(x, w, b, y), PEAK_BF16)
        plan = VF._k4_plan(m, d, n)
        log(f"[k4] {name}: M={m} D={d} N={n} act={act} | max|d|={err:.3e} rel={rel:.3e} "
            f"cos={cos:.6f} finite {finite} | plan (BM {plan[0]}, BN {plan[1]}, {plan[2]} "
            f"CTAs): K4 {dev_ms:.4f} ms ({ops / dev_ms / 1e9:.1f} TFLOP/s, "
            f"{bound_ms / dev_ms:.3f} of the bound; {how}), torch.matmul on the product "
            f"alone {dev_lib:.4f} ({how_lib}) (K4 / matmul {dev_ms / dev_lib:.2f}) (mean of 10, "
            f"L2 flushed); CUDA events around the calls: K4 {ms:.4f}, torch.matmul "
            f"{library_ms:.4f}, plain {plain_ms:.4f}, unfused sequence ({dense_act}) "
            f"{unfused_ms:.4f} (median of 20, L2 flushed); bound {bound_ms:.4f} ({bound_by}) "
            f"({card})")
        if not (finite and rel <= K4_REL and cos >= K4_COSINE):
            raise AssertionError(f"K4 disagrees with its plain version at {name}")
        if name == "DINOv2 fc1 ALOHA":
            again = VF.ln_matmul(x, w, b, act)
            torch.cuda.synchronize()
            same = torch.equal(y, again)
            log(f"[k4] {name}: two K4 calls bitwise equal: {same}")
            if not same:
                raise AssertionError(f"K4 is not deterministic at {name}")
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "unfused_ms": unfused_ms, "library_ms": library_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by, "dev_ms": dev_ms,
                         "dev_lib": dev_lib, "plan": plan,
                         "timing": how if how == how_lib else f"K4 {how}, library {how_lib}"}
    del flush
    torch.cuda.empty_cache()
    return results


def k4_parts_phase(card: str) -> dict:
    """The script exp_k4_parts: K4's variants at DINOv2 fc1 ALOHA, then every
    compiled tile at the 8 ViT shapes (it prints its own lines)."""
    from openvla_oft_tpu_torch.scripts import exp_k4_parts

    t0 = time.perf_counter()
    out = exp_k4_parts.main([])
    for name, err in out["variants"]["rel_err"].items():
        if not err <= K4_REL:
            raise AssertionError(f"K4's {name} variant disagrees with its reference: {err}")
    log(f"[k4-parts] exp_k4_parts.main: {time.perf_counter() - t0:.1f} s, the variants' and "
        f"tiles' times above (ms, device time, L2 flushed; {card})")
    return out


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def observation(policy, rng) -> dict:
    """One client observation for the policy's deployment: LIBERO's client
    sends two 256 x 256 frames, ALOHA's three 224 x 224 frames
    (run_aloha_eval.py:76-86), each with its proprio state."""
    from openvla_oft_tpu_torch.serving.deploy import CLIENT_FRAME_HW

    if policy.cfg.num_images_in_input == 3:
        cams, task = ("full_image", "left_wrist_image", "right_wrist_image"), "fold the towel"
    else:
        cams, task = ("full_image", "wrist_image"), "put the bowl on the plate"
    shape = (*CLIENT_FRAME_HW[policy.platform.name], 3)
    obs = {cam: rng.integers(0, 256, shape, dtype=np.uint8) for cam in cams}
    obs["state"] = rng.standard_normal(policy.platform.proprio_dim).astype(np.float32)
    obs["instruction"] = task
    return obs


def frames_of(policy, obs) -> np.ndarray:
    from openvla_oft_tpu_torch.serving.deploy import observation_frames

    return observation_frames(obs, policy.cfg.num_images_in_input)


def serve(policy, card: str, rng, label: str, expect: dict, warm: bool = True,
          stdlib_check: bool = False) -> tuple:
    """3 /act requests through the HTTP server that `build_server` gives (the
    deploy CLI's warm-up first, unless `warm` is off: then the first request
    is the cold one). `expect` gives each kernel's launches per request; the
    counts are set to 0 after the warm-up. With `stdlib_check`, the first
    observation goes once more to the stdlib server, whose answer must be
    FastAPI's. Returns (observations, answers, launches in the run, request
    ms)."""
    from openvla_oft_tpu_torch.serving.deploy import build_server, get_action_from_server, warmup

    platform = policy.platform
    server = build_server(policy)
    if warm:
        log(f"[serve] {label}: warm-up (one synthetic predict before the server binds) "
            f"{warmup(server, policy) * 1e3:.2f} ms (host clock; {card})")
    port = free_port()
    server.run("127.0.0.1", port, background=True)
    front = "FastAPI" if getattr(server, "_uvicorn", None) is not None else "stdlib"
    observations, answers, latencies = [], [], []
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        for i in range(3):
            obs = observation(policy, rng)
            before = launch_counts()
            t0 = time.perf_counter()
            action = get_action_from_server(obs, f"http://127.0.0.1:{port}/act")
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            per_request = {k: n - before[k] for k, n in launch_counts().items() if k in expect}
            if not isinstance(action, np.ndarray):
                raise AssertionError(f"/act answered {action!r}")
            when = ("first after the warm-up" if warm else "cold, no warm-up") if i == 0 else "warm"
            log(f"[serve] {label} request {i} ({when}): {front} /act -> {action.shape} "
                f"{action.dtype} finite={bool(np.isfinite(action).all())}, launches "
                f"{per_request}, latency {dt * 1e3:.2f} ms (host wall clock around the HTTP "
                f"round trip, ends in torch.cuda.synchronize; {card})")
            if action.shape != (platform.num_actions_chunk, platform.action_dim) \
                    or not np.isfinite(action).all():
                raise AssertionError("bad action chunk")
            if per_request != expect:
                raise AssertionError(f"one {label} request launched {per_request}, "
                                     f"expected {expect}")
            observations.append(obs)
            answers.append(action)
            latencies.append(dt * 1e3)
        launches = launch_counts()
        if stdlib_check:
            if front != "FastAPI":
                raise AssertionError("ActionServer.run did not take FastAPI: is it installed?")
            std_port = free_port()
            server._run_stdlib("127.0.0.1", std_port, background=True)
            std = get_action_from_server(observations[0], f"http://127.0.0.1:{std_port}/act")
            d = float(np.abs(np.asarray(std) - answers[0]).max())
            log(f"[serve] {label}: FastAPI /act answered 200 with {answers[0].shape}; the stdlib "
                f"server's answer to the same observation differs by max|d| = {d:.3e}")
            if not d <= 1e-3:
                raise AssertionError("FastAPI's /act and the stdlib server's disagree")
    finally:
        server.shutdown()
    log(f"[serve] {label}: torch.cuda.max_memory_allocated during serving: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB ({card})")
    return observations, answers, launches, latencies


def model_inputs(policy, obs) -> tuple:
    """(frames, ids, mask, pixels, proprio) of one observation on the card,
    as serve_action_chunk builds them (proprio clamped to the [-1, 1] stats)."""
    from openvla_oft_tpu_torch.models.prismatic import prepare_prompt_ids
    from openvla_oft_tpu_torch.processing.image_processing import device_preprocess

    dev = policy.device
    frames = torch.tensor(frames_of(policy, obs), device=dev)[None]
    ids, mask = prepare_prompt_ids(policy.tokenizer, obs["instruction"],
                                   policy.prompt_bucket)
    ids = torch.as_tensor(ids, device=dev)[None]
    mask = torch.as_tensor(mask, device=dev)[None]
    proprio = torch.tensor(obs["state"], device=dev)[None]
    with torch.inference_mode():
        pixels = device_preprocess(policy.cfg, frames[0],
                                   policy.cfg.vision_configs[0].image_size)[None]
    return frames, ids, mask, pixels, proprio


def actions_hidden(policy, inputs, use_flash=True, vit_fused=False) -> torch.Tensor:
    from openvla_oft_tpu_torch.models.prismatic import predict_action_hidden
    from openvla_oft_tpu_torch.ops.vit_fused import vit_fused as vit_fused_mode

    _, ids, mask, pixels, proprio = inputs
    with torch.inference_mode(), vit_fused_mode(vit_fused):
        return predict_action_hidden(policy.params, policy.cfg, policy.platform, ids, mask,
                                     pixels, proprio=proprio.clamp(-1, 1),
                                     use_flash=use_flash).actions_hidden.float()


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    return torch.nn.functional.cosine_similarity(a.double().flatten(), b.double().flatten(),
                                                 dim=0).item()


def path_parity(policy, obs, served) -> torch.Tensor:
    """serve_action_chunk / predict_action_hidden through K1 and through the
    dense oracle on the same inputs, both on the card. Returns the K1 path's
    actions_hidden (on the host)."""
    from openvla_oft_tpu_torch.policy import serve_action_chunk

    dev = policy.device
    cfg, platform = policy.cfg, policy.platform
    inputs = model_inputs(policy, obs)
    frames, ids, mask, _, proprio = inputs
    d = platform.action_dim
    common = dict(action_low=torch.full((d,), -1.0, device=dev),
                  action_high=torch.full((d,), 1.0, device=dev),
                  action_mask=torch.tensor([True] * (d - 1) + [False], device=dev),
                  proprio_low=torch.full((platform.proprio_dim,), -1.0, device=dev),
                  proprio_high=torch.full((platform.proprio_dim,), 1.0, device=dev),
                  resize_size=cfg.vision_configs[0].image_size)
    hidden, actions = {}, {}
    for use_flash in (True, False):
        hidden[use_flash] = actions_hidden(policy, inputs, use_flash)
        with torch.inference_mode():
            actions[use_flash] = serve_action_chunk(
                policy.params, cfg, platform, frames, ids, mask, proprio,
                use_flash=use_flash, **common)[0].cpu().numpy()
    cos = cosine(hidden[True], hidden[False])
    d_act = float(np.abs(actions[True] - actions[False]).max())
    d_served = float(np.abs(actions[True] - served).max())
    log(f"[parity] S = {policy.prompt_bucket + policy.cfg.num_images_in_input * 256 + 1}"
        f" + {platform.chunk_len + 1}: actions_hidden cosine(K1 path, dense path) = {cos:.6f}; "
        f"max|d actions| K1 vs dense = {d_act:.4e}; served /act vs direct K1 call "
        f"max|d| = {d_served:.4e}")
    if not cos >= PARITY_COSINE:
        raise AssertionError(f"K1 path and dense path disagree: cosine {cos}")
    if not np.isfinite(actions[False]).all() or d_served > 1e-3:
        raise AssertionError("served answer differs from the direct call")
    return hidden[True].cpu()


def int_mm_times(x8: torch.Tensor, w8: torch.Tensor, flush) -> tuple:
    """torch._int_mm (int8 x int8 -> int32) on the unpacked int8 weight: K6's
    products without its group and token scales, on the faster of a
    row-major and a column-major weight. (CUDA-event ms, device ms, how the
    device time was taken); Nones for T <= 16, which it does not take."""
    if x8.shape[0] <= 16:
        return None, None, None
    times = []
    for w in (w8, w8.t().contiguous().t()):
        try:
            torch._int_mm(x8, w)
            torch.cuda.synchronize()
        except RuntimeError as err:
            log(f"[int4] torch._int_mm refused weight strides {w.stride()}: {err}")
            continue
        times.append((*device_ms(lambda: torch._int_mm(x8, w), flush),
                      cuda_time_ms(lambda: torch._int_mm(x8, w), flush=flush)))
    if not times:
        return None, None, None
    dev, how, events = min(times)
    return events, dev, how


def int4_check(card: str) -> dict:
    """K5 and K6 against int4_matmul_ref and int4_matmul_a8_ref at the 7B's
    int4 shapes, timed (L2 flushed before each call) beside the library call
    and the bound; then K5 and the dequant path at T = 618 and 2048."""
    from openvla_oft_tpu_torch.ops import int4_matmul as M
    from openvla_oft_tpu_torch.ops.quant import _unpack_int4, dequantize_int4, quantize_weight_int4

    dev = torch.device("cuda")
    # (name, T, K, N, how the weight is handed over)
    # T: the L1 prefill (618), the diffusion prefix (514), the AR prefill
    # (304), the out_window layer (57) and one AR decode step (1).
    cases = [(f"{name} T={t}", t, k, n, "whole") for t in (618, 514, 304, 57, 1)
             for name, k, n in INT4_SHAPES]
    cases += [("q column view of wqkv T=57", 57, 4096, 4096, "column"),
              ("wo layer view of a stacked L=2 weight T=618", 618, 4096, 4096, "layer"),
              ("group 16 (d_in 4304) T=618", 618, 4304, 1152, "whole")]
    flush = l2_flush_buffer(dev)
    results = {}

    def weight(gen, k, n, how):
        shape = {"layer": (2, k, n), "column": (k, 3 * n)}.get(how, (k, n))
        q = quantize_weight_int4(torch.randn(shape, generator=gen, device=dev) * 0.02)
        if how == "layer":
            return q["kernel_q4"][1], q["scale_w4"][1]
        if how == "column":                            # the q columns of q|k|v
            return q["kernel_q4"][:, :n], q["scale_w4"][:, :n]
        return q["kernel_q4"], q["scale_w4"]

    for name, t, k, n, how in cases:
        gen = torch.Generator(device=dev).manual_seed(t + k + n)
        x = torch.randn((t, k), generator=gen, device=dev).bfloat16()
        packed, scales = weight(gen, k, n, how)
        y5, y6 = M.int4_matmul_fused(x, packed, scales), M.int4_matmul_fused_a8(x, packed, scales)
        torch.cuda.synchronize()
        r5, r6 = M.int4_matmul_ref(x, packed, scales), M.int4_matmul_a8_ref(x, packed, scales)
        err5, err6 = (y5 - r5).abs().max().item(), (y6 - r6).abs().max().item()
        rel5, rel6 = err5 / r5.abs().max().item(), err6 / r6.abs().max().item()
        finite = bool(torch.isfinite(y5).all() and torch.isfinite(y6).all())
        w16, w8 = dequantize_int4(packed, scales, torch.bfloat16), _unpack_int4(packed)
        x8, _ = M.quantize_act_rows(x)
        ms5 = cuda_time_ms(lambda: M.int4_matmul_fused(x, packed, scales), flush=flush)
        ms6 = cuda_time_ms(lambda: M.int4_matmul_fused_a8(x, packed, scales), flush=flush)
        plain5 = cuda_time_ms(lambda: M.int4_matmul_ref(x, packed, scales), flush=flush)
        plain6 = cuda_time_ms(lambda: M.int4_matmul_a8_ref(x, packed, scales), flush=flush)
        lib5 = cuda_time_ms(lambda: torch.matmul(x, w16), flush=flush)
        dev5, how5 = device_ms(lambda: M.int4_matmul_fused(x, packed, scales), flush)
        dev_lib5, how_lib5 = device_ms(lambda: torch.matmul(x, w16), flush)
        dev6, how6 = device_ms(lambda: M.int4_matmul_fused_a8(x, packed, scales), flush)
        lib6, dev_lib6, how_lib6 = int_mm_times(x8, w8, flush)
        ops = 2 * t * k * n
        moved = nbytes(x, packed, scales, y5)             # x in, fp32 y out
        b5, by5 = bound(ops, moved, PEAK_BF16)
        b6, by6 = bound(ops, moved, PEAK_INT8)
        group = k // scales.shape[0]
        log(f"[int4] {name}: K={k} N={n} group={group} packed strides "
            f"{packed.stride()} | K5 max|d|={err5:.3e} rel={rel5:.3e}; K6 max|d|={err6:.3e} "
            f"rel={rel6:.3e}; finite {finite}")
        plan = M._k5_plan(t, k, n, group)
        log(f"[int4] {name}: K5 plan (t_tile {plan[0]}, splits {plan[1]}, {plan[2]} CTAs): "
            f"{dev5:.4f} ms ({ops / dev5 / 1e9:.1f} TFLOP/s, {b5 / dev5:.3f} of the "
            f"bound; {how5}), torch.matmul on the bf16 weight {dev_lib5:.4f} ({how_lib5}) "
            f"(K5 / matmul {dev5 / dev_lib5:.2f}) (mean of 10, L2 flushed); CUDA events "
            f"around the calls: K5 {ms5:.4f} ms, torch.matmul {lib5:.4f}; plain {plain5:.4f}, "
            f"bound {b5:.4f} ({by5}) ({card})")
        plan6 = M._k6_plan(t, k, n, group)
        vs6 = "n/a" if dev_lib6 is None else f"{dev_lib6:.4f} ({how_lib6})"
        ratio6 = "" if dev_lib6 is None else f" (K6 / _int_mm {dev6 / dev_lib6:.2f})"
        log(f"[int4] {name}: K6 plan (t_tile {plan6[0]}, splits {plan6[1]}, {plan6[2]} CTAs"
            f"{', HALF: a k32 step per 16 k' if group % 32 else ''}): {dev6:.4f} ms "
            f"({ops / dev6 / 1e9:.1f} TOP/s, {b6 / dev6:.3f} of the bound; {how6}), "
            f"torch._int_mm without scales {vs6}{ratio6} (mean of 10, L2 flushed); CUDA "
            f"events around the calls: K6 {ms6:.4f} ms (the wrapper's quantize_act_rows "
            f"included), torch._int_mm {'n/a' if lib6 is None else f'{lib6:.4f}'}; plain "
            f"{plain6:.4f}, bound {b6:.4f} ({by6}) ({card})")
        if not (finite and rel5 <= INT4_K5_REL and rel6 <= INT4_K6_REL):
            raise AssertionError(f"K5/K6 disagree with their plain versions at {name}")
        results[name] = {"err5": err5, "err6": err6, "ms5": ms5, "ms6": ms6,
                         "plain5": plain5, "plain6": plain6, "lib5": lib5, "lib6": lib6,
                         "bound5": (b5, by5), "bound6": (b6, by6), "plan5": plan,
                         "plan6": plan6, "dev5": dev5, "dev_lib5": dev_lib5, "dev6": dev6,
                         "dev_lib6": dev_lib6,
                         "timing": how5 if how5 == how_lib5 else f"K5 {how5}, library {how_lib5}",
                         "timing6": how6 if how6 == how_lib6 else f"K6 {how6}, library {how_lib6}"}
        if name in ("wo T=57", "wqkv T=618"):
            # Split-K adds its partials in split order: two calls are bitwise equal.
            for label, fn, first, kplan in (("K5", M.int4_matmul_fused, y5, plan),
                                            ("K6", M.int4_matmul_fused_a8, y6, plan6)):
                again = fn(x, packed, scales)
                torch.cuda.synchronize()
                same = torch.equal(first, again)
                log(f"[int4] {name}: two {label} calls bitwise equal: {same} (plan {kplan})")
                if not same:
                    raise AssertionError(f"{label} is not deterministic at {name}")
                del again
        del x, packed, scales, y5, y6, r5, r6, w16, w8, x8
    # The dispatch rule (rows <= 1024 take the kernel) is the TPU's crossover,
    # kept as the reference's shape rule; these are the card's two sides of it.
    for name, k, n in INT4_SHAPES:
        for t in (618, 2048):
            gen = torch.Generator(device=dev).manual_seed(t + k + n)
            x = torch.randn((t, k), generator=gen, device=dev).bfloat16()
            packed, scales = weight(gen, k, n, "whole")
            ms5 = cuda_time_ms(lambda: M.int4_matmul_fused(x, packed, scales), flush=flush)
            deq = cuda_time_ms(lambda: M.int4_matmul_ref(x, packed, scales), flush=flush)
            log(f"[int4] dispatch {name} T={t}: K5 {ms5:.4f} ms, dequant path "
                f"(int4_matmul_ref) {deq:.4f} ms ({card})")
    del flush
    torch.cuda.empty_cache()
    return results


def int4_parity(policy, obs, bf16_hidden, card: str) -> None:
    """predict_action_hidden on the int4 weights through K5 (and K6) against
    the same call with the plain versions swapped in, on the card; then the
    int4 answer against the bf16 one (no bound: random weights say nothing
    about accuracy)."""
    from openvla_oft_tpu_torch.ops import int4_matmul as M
    from openvla_oft_tpu_torch.ops.quant import int4_a8

    inputs = model_inputs(policy, obs)
    per_request = 4 * (policy.cfg.llm.num_layers - 1) + 6
    hidden = {}
    for a8, kernel, plain, counter in ((False, "int4_matmul_fused", "int4_matmul_ref", "K5"),
                                       (True, "int4_matmul_fused_a8", "int4_matmul_a8_ref", "K6")):
        fused = getattr(M, kernel)
        with int4_a8(a8):
            before = launch_counts()[counter]
            hidden[counter] = actions_hidden(policy, inputs)
            used = launch_counts()[counter] - before
            setattr(M, kernel, getattr(M, plain))
            try:
                ref = actions_hidden(policy, inputs)
            finally:
                setattr(M, kernel, fused)
        cos = cosine(hidden[counter], ref)
        log(f"[int4-parity] actions_hidden cosine({counter} path, plain path) = {cos:.6f}, "
            f"max|d| = {(hidden[counter] - ref).abs().max().item():.4e}, {counter} launches "
            f"{used}, finite {bool(torch.isfinite(hidden[counter]).all())} ({card})")
        if not (cos >= PARITY_COSINE and used == per_request
                and torch.isfinite(hidden[counter]).all()):
            raise AssertionError(f"the {counter} path disagrees with the plain path")
    log(f"[int4-vs-bf16] actions_hidden cosine(W4A16, bf16) = "
        f"{cosine(hidden['K5'].cpu(), bf16_hidden):.6f}, cosine(W4A8, bf16) = "
        f"{cosine(hidden['K6'].cpu(), bf16_hidden):.6f}, cosine(W4A8, W4A16) = "
        f"{cosine(hidden['K6'], hidden['K5']):.6f} (random weights: no bound)")


def int4_serving(card: str, rng, obs, bf16_hidden) -> dict:
    """The flagship policy rebuilt with load_in_4bit from the same seed;
    3 /act requests W4A16, then 3 W4A8; then int4 path parity. Returns the
    launches of each serving run."""
    from openvla_oft_tpu_torch.serving.deploy import flagship_policy

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    policy = flagship_policy("cuda", seed=0, load_in_4bit=True)
    torch.cuda.synchronize()
    log(f"[int4-init] load_in_4bit flagship on the card: "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated, peak during the build "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, built in "
        f"{time.perf_counter() - t0:.1f} s")
    n_layers = policy.cfg.llm.num_layers
    per_request = 4 * (n_layers - 1) + 6          # 4 linears a layer, 6 in the window layer
    _, _, w4a16, _ = serve(policy, card, rng, "int4 W4A16",
                           {"K1": n_layers - 1, "K4": 0, "K5": per_request, "K6": 0,
                            "int8": 0})
    policy.int4_a8 = True
    _, _, w4a8, _ = serve(policy, card, rng, "int4 W4A8",
                          {"K1": n_layers - 1, "K4": 0, "K5": 0, "K6": per_request,
                           "int8": 0})
    for a8, label in ((False, "int4 W4A16"), (True, "int4 W4A8")):
        policy.int4_a8 = a8
        busy, by_class = profile_request(policy, obs, label, card)
        if busy is not None:
            kernel, first = ("K6", "159 ms, 0.805") if a8 else ("K5", "211-219 ms, 0.86-0.88")
            k_ms, k_n = by_class.get(kernel, (0.0, 0))
            log(f"[int4-profile] {label[5:]} request: {kernel} {k_ms:.2f} ms over {k_n} "
                f"launches, {k_ms / busy:.3f} of the device time (the first, wmma {kernel}: "
                f"{first}) ({card})")
    int4_parity(policy, obs, bf16_hidden, card)
    return {"W4A16": w4a16, "W4A8": w4a8}


def int8_linear_parts(card: str) -> None:
    """One int8_linear at the LLM's wqkv (T = 618, layer view) and its
    out_window q column view (T = 57), dynamic and static, traced: the
    kernels a linear launches and their device time by class (the int8 GEMM
    against the activation quantize and the epilogue), beside the int8
    product's bound. Each trace must hold one `int8 GEMM` kernel: the check
    of the class's name tags."""
    from openvla_oft_tpu_torch.ops import quant as Q

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    stacked = Q.quantize_weight(torch.randn((2, 4096, 12288), generator=gen, device=dev) * 0.02)
    # The stored layout: torch._int_mm on the column-major weight that
    # quantize_weight stores, against the same weight row-major.
    flush = l2_flush_buffer(dev)
    x8 = torch.randint(-127, 128, (618, 4096), generator=gen, device=dev, dtype=torch.int8)
    col = stacked["kernel"][1]
    row = col.contiguous()
    times = {name: device_ms(lambda: torch._int_mm(x8, w), flush)
             for name, w in (("column-major", col), ("row-major", row))}
    log(f"[int8] torch._int_mm at wqkv T=618: " + ", ".join(
        f"{name} weight (strides {w.stride()}) {ms:.4f} ms ({how})"
        for (name, (ms, how)), w in zip(times.items(), (col, row)))
        + f" (device time, mean of 10, L2 flushed; {card})")
    del x8, row, flush
    for name, t, lo, hi in (("wqkv layer view", 618, 0, 12288),
                            ("q column view of wqkv", 57, 0, 4096)):
        layer = {k: v[1][..., lo:hi] for k, v in stacked.items()}
        x = torch.randn((t, 4096), generator=gen, device=dev).bfloat16()
        for static in (False, True):
            p = {**layer, "scale_x": torch.tensor(0.02, device=dev)} if static else layer
            Q.int8_linear(p, x)
            wall, n, busy, by_class = trace(lambda: Q.int8_linear(p, x))
            gemm = by_class.get("int8 GEMM", (0.0, 0))
            b_ms, b_by = bound(2 * t * 4096 * (hi - lo), nbytes(x, layer["kernel"],
                                                              layer["scale_w"]) + t * (hi - lo) * 2,
                               PEAK_INT8)
            if busy is None:
                log(f"[int8] {name} T={t} {'static' if static else 'dynamic'}: not measured")
                continue
            if gemm[1] != 1:
                raise AssertionError(f"the int8 GEMM class found {gemm[1]} kernels in one "
                                     f"int8_linear: {by_class}")
            log(f"[int8] {name} T={t} {'static' if static else 'dynamic'}: {n} kernels, "
                f"{busy:.4f} ms of device time, the int8 GEMM {gemm[0]:.4f} ms over {gemm[1]} "
                f"(the rest: activation quantize, padding and epilogue, "
                f"{busy - gemm[0]:.4f} ms over {n - gemm[1]}); bound of the product "
                f"{b_ms:.4f} ms ({b_by}); host wall {wall:.3f} ms ({card})")
            log_classes("int8", by_class)
    del stacked
    torch.cuda.empty_cache()


def int8_per_request(cfg, llm_int8: bool) -> int:
    """The int8 products of one request, from the model's structure: 4 per
    LLM layer and 6 in the out_window layer (q, k, v column views, wo,
    gate_up, down), 4 per ViT block that runs (qkv, proj, fc1, fc2; the
    patch embeddings' d_in 588 is under min_dim), 3 in the projector."""
    vit = 4 * sum(v.depth - 1 for v in cfg.vision_configs) + 3
    return vit + (4 * (cfg.llm.num_layers - 1) + 6 if llm_int8 else 0)


def int8_parity(policy, obs, bf16_hidden, card: str) -> torch.Tensor:
    """actions_hidden on the int8 weights through torch._int_mm against the
    same call with the product swapped for its plain version (float64,
    exact), the K1 path against the dense path, and int8 against bf16 (no
    bound). Returns the int8 path's actions_hidden."""
    from openvla_oft_tpu_torch.ops import quant as Q

    inputs = model_inputs(policy, obs)
    before = launch_counts()["int8"]
    hidden = actions_hidden(policy, inputs)
    used = launch_counts()["int8"] - before
    product = Q.int8_mm
    Q.int8_mm = Q.int8_mm_ref
    try:
        plain = actions_hidden(policy, inputs)
    finally:
        Q.int8_mm = product
    d = (hidden - plain).abs().max().item()
    rel = d / plain.abs().max().item()
    dense = actions_hidden(policy, inputs, use_flash=False)
    cos_dense = cosine(hidden, dense)
    log(f"[int8-parity] actions_hidden through torch._int_mm against the float64 product: "
        f"max|d| = {d:.4e}, {rel:.3e} of max|ref|, bitwise equal {torch.equal(hidden, plain)}; "
        f"{used} int8 products; cosine(K1 path, dense path) = {cos_dense:.6f}; cosine(int8, "
        f"bf16) = {cosine(hidden.cpu(), bf16_hidden):.6f} (random weights: no bound) ({card})")
    if not (rel <= INT8_REL and cos_dense >= PARITY_COSINE and torch.isfinite(hidden).all()
            and used == int8_per_request(policy.cfg, True)):
        raise AssertionError("the int8 path disagrees with its plain product or the dense path")
    return hidden


def int8_profile(policy, obs, label: str, card: str) -> dict:
    busy, by_class = profile_request(policy, obs, label, card)
    if busy is None:
        return {"busy_ms": None}
    gemm_ms, gemm_n = by_class.get("int8 GEMM", (0.0, 0))
    n = sum(k for _, k in by_class.values())
    log(f"[int8-profile] {label} request: {n} kernels, {busy:.1f} ms of device time; the int8 "
        f"GEMMs {gemm_ms:.2f} ms over {gemm_n} = {gemm_ms / busy:.3f} of it ({card})")
    return {"busy_ms": busy, "kernels": n, "int8_ms": gemm_ms}


def int8_serving(card: str, rng, obs, bf16_hidden) -> dict:
    """The flagship rebuilt with load_in_8bit (the LLM, the ViTs and the
    projector in int8): build memory, 3 /act requests, a traced request,
    parity; then static activation scales (attach_static_act_scales on 2
    random_observations), 3 requests and a traced one; then
    load_vision_in_8bit: 3 requests and a traced one. Returns the launches
    of each serving run."""
    from openvla_oft_tpu_torch.ops.quant_calibrate import (attach_static_act_scales,
                                                           random_observations)
    from openvla_oft_tpu_torch.serving.deploy import flagship_policy

    int8_linear_parts(card)
    runs = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    policy = flagship_policy("cuda", seed=0, load_in_8bit=True)
    torch.cuda.synchronize()
    log(f"[int8-init] load_in_8bit flagship on the card: "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated, peak during the build "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, built in "
        f"{time.perf_counter() - t0:.1f} s ({card})")
    n_layers = policy.cfg.llm.num_layers
    per_request = int8_per_request(policy.cfg, True)
    log(f"[int8] products per load_in_8bit request from the model's structure: {per_request}")
    expect = {"K1": n_layers - 1, "K4": 0, "K5": 0, "K6": 0, "int8": per_request}
    _, _, runs["dynamic"], _ = serve(policy, card, rng, "int8 load_in_8bit", expect)
    dyn = int8_profile(policy, obs, "int8 dynamic", card)
    hidden = int8_parity(policy, obs, bf16_hidden, card)

    cal = random_observations(policy.cfg, policy.platform, n=2, seed=0, device="cuda")
    t0 = time.perf_counter()
    policy.params = attach_static_act_scales(policy.params, policy.cfg, policy.platform, cal)
    torch.cuda.synchronize()
    log(f"[int8-static] attach_static_act_scales over 2 random_observations: "
        f"{time.perf_counter() - t0:.1f} s (host clock; {card})")
    _, _, runs["static"], _ = serve(policy, card, rng, "int8 static scales", expect)
    stat = int8_profile(policy, obs, "int8 static", card)
    static_hidden = actions_hidden(policy, model_inputs(policy, obs))
    log(f"[int8-static] actions_hidden cosine(static, dynamic) = "
        f"{cosine(static_hidden, hidden):.6f} (random weights: no bound); device time per "
        f"request static {stat['busy_ms']} ms over {stat.get('kernels')} kernels, dynamic "
        f"{dyn['busy_ms']} ms over {dyn.get('kernels')} ({card})")
    if not torch.isfinite(static_hidden).all():
        raise AssertionError("the static int8 path gives non-finite hidden states")
    del policy, hidden, static_hidden
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    policy = flagship_policy("cuda", seed=0, load_vision_in_8bit=True)
    torch.cuda.synchronize()
    log(f"[int8-init] load_vision_in_8bit flagship on the card: "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated, peak during the build "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, built in "
        f"{time.perf_counter() - t0:.1f} s ({card})")
    expect = {"K1": n_layers - 1, "K4": 0, "K5": 0, "K6": 0,
              "int8": int8_per_request(policy.cfg, False)}
    _, _, runs["vision"], _ = serve(policy, card, rng, "int8 load_vision_in_8bit", expect)
    int8_profile(policy, obs, "int8 vision", card)
    del policy
    gc.collect()
    torch.cuda.empty_cache()
    return runs


def libero_vit_fused(policy, obs, card: str) -> dict:
    """The LIBERO bf16 policy's request with vit_fused on (K4 98 launches: 2
    per ViT block that runs, DINOv2 23 and SigLIP 26) and off (none), each
    counted once, then traced (`profile_request`). vit_fused is off after."""
    k4 = 2 * sum(v.depth - 1 for v in policy.cfg.vision_configs)
    frames = frames_of(policy, obs)
    out = {}
    try:
        for fused in (True, False):
            policy.vit_fused = fused
            reset_launch_counts()
            policy.predict_action_from_frames(frames, obs["instruction"], proprio=obs["state"])
            torch.cuda.synchronize()
            launched = launch_counts()["K4"]
            log(f"[libero-k4] LIBERO bf16 request, vit_fused={fused}: {launched} K4 launches")
            if launched != (k4 if fused else 0):
                raise AssertionError(f"a LIBERO request with vit_fused={fused} launched K4 "
                                     f"{launched} times, expected {k4 if fused else 0}")
            out[fused] = profile_request(policy, obs, f"LIBERO bf16 vit_fused={fused}", card)
    finally:
        policy.vit_fused = False
    return out


def vision_features(policy, inputs, vit_fused: bool) -> torch.Tensor:
    """The FiLM-conditioned ViT pair's features for one observation, through
    K4 or the unfused ops."""
    from openvla_oft_tpu_torch.models.prismatic import _film_language_embedding
    from openvla_oft_tpu_torch.models.vision_backbone import vision_backbone_forward
    from openvla_oft_tpu_torch.ops.vit_fused import vit_fused as vit_fused_mode

    _, ids, mask, pixels, _ = inputs
    params, cfg = policy.params, policy.cfg
    dtype = params["llm"]["embed"]["embedding"].dtype
    with torch.inference_mode(), vit_fused_mode(vit_fused):
        le = _film_language_embedding(params, ids, mask, dtype)
        return vision_backbone_forward(params["vision_backbone"], cfg, pixels.to(dtype),
                                       film_params=params["film"],
                                       language_embedding=le).float()


def aloha_serving(card: str, rng) -> dict:
    """The ALOHA deployment (3 cameras, FiLM, 25 x 14 chunk) with the ViTs
    through K4: 3 /act requests, then 3 with vit_fused off; K4 path parity,
    K1 path parity at S = 1168, one traced request each way. Returns the
    launches and request times of both runs."""
    from openvla_oft_tpu_torch.serving.deploy import flagship_policy

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    policy = flagship_policy("cuda", seed=0, platform="aloha", vit_fused=True)
    torch.cuda.synchronize()
    log(f"[aloha-init] ALOHA flagship (3 images, FiLM) on the card: "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated, peak during the build "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, built in "
        f"{time.perf_counter() - t0:.1f} s")
    n_layers = policy.cfg.llm.num_layers
    k4 = 2 * sum(v.depth - 1 for v in policy.cfg.vision_configs)      # 98
    runs = {}
    for vit_fused in (True, False):
        policy.vit_fused = vit_fused
        label = f"ALOHA bf16 vit_fused={vit_fused}"
        obs, answers, launches, ms = serve(
            policy, card, rng, label,
            {"K1": n_layers - 1, "K4": k4 if vit_fused else 0, "K5": 0, "K6": 0,
             "int8": 0})
        runs[vit_fused] = {"obs": obs, "answers": answers, "launches": launches, "ms": ms}
    obs = runs[False]["obs"][0]
    inputs = model_inputs(policy, obs)
    feats = {f: vision_features(policy, inputs, f) for f in (True, False)}
    hidden = {f: actions_hidden(policy, inputs, vit_fused=f) for f in (True, False)}
    cos_feats, cos_hidden = cosine(feats[True], feats[False]), cosine(hidden[True],
                                                                      hidden[False])
    log(f"[aloha-parity] vision features cosine(K4 path, unfused path) = {cos_feats:.6f}, "
        f"max|d| {(feats[True] - feats[False]).abs().max().item():.4e}; actions_hidden "
        f"cosine(K4 path, unfused path) = {cos_hidden:.6f} ({card})")
    if not (cos_feats >= PARITY_COSINE and cos_hidden >= PARITY_COSINE):
        raise AssertionError("the K4 path disagrees with the unfused path")
    del feats
    path_parity(policy, obs, runs[False]["answers"][0])
    for vit_fused in (True, False):
        policy.vit_fused = vit_fused
        profile_request(policy, obs, f"ALOHA vit_fused={vit_fused}", card)
    del policy
    gc.collect()
    torch.cuda.empty_cache()
    return runs


def staged_requests(policy, rng, n: int, label: str, expect: dict, card: str) -> dict:
    """n requests of the staged `predict_action` (the diffusion or the
    discrete head) on pixels from the port's `device_preprocess` of random
    frames, each checked (shape, finite, launches per request = `expect`);
    the counts are set to 0 before the first and read after the last.
    Returns those launches."""
    tag = policy.head
    platform = policy.platform
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    for i in range(n):
        obs = observation(policy, rng)
        _, _, _, pixels, proprio = model_inputs(policy, obs)
        before = launch_counts()
        t0 = time.perf_counter()
        action = policy.predict_action(pixels[0], obs["instruction"],
                                       proprio=proprio[0].clamp(-1, 1))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        per_request = {k: c - before[k] for k, c in launch_counts().items() if k in expect}
        step = (f", {dt * 1e3 / policy.num_diffusion_steps:.2f} ms a step"
                if tag == "diffusion" else "")
        log(f"[{tag}] {label} request {i} ({'first' if i == 0 else 'warm'}): "
            f"predict_action -> {action.shape} finite={bool(np.isfinite(action).all())}, "
            f"launches {per_request}, {dt * 1e3:.1f} ms a chunk{step} (host clock, ends in "
            f"torch.cuda.synchronize; {card})")
        if action.shape != (platform.num_actions_chunk, platform.action_dim) \
                or not np.isfinite(action).all():
            raise AssertionError(f"bad {tag} action chunk")
        if per_request != expect:
            raise AssertionError(f"one {label} request launched {per_request}, expected {expect}")
    launches = launch_counts()
    log(f"[{tag}] {label}: torch.cuda.max_memory_allocated during the requests "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB ({card})")
    return launches


def diffusion_profile(policy, rng, label: str, card: str) -> None:
    obs = observation(policy, rng)
    _, _, _, pixels, proprio = model_inputs(policy, obs)

    def request():
        policy.predict_action(pixels[0], obs["instruction"], proprio=proprio[0].clamp(-1, 1))

    busy, by_class = profile_request(policy, obs, label, card, request=request, runs=1)
    if busy is not None:
        for kernel in ("K1", "K5"):
            ms, count = by_class.get(kernel, (0.0, 0))
            log(f"[diffusion-profile] {label}: {kernel} {ms:.2f} ms over {count} launches, "
                f"{ms / busy:.3f} of the request's {busy:.1f} ms of device time, "
                f"{busy / policy.num_diffusion_steps:.2f} ms of device time a step ({card})")


def diffusion_parity(policy, rng, card: str) -> None:
    """On the card: the prefix K/V through K1 against the dense path; one
    suffix step against `predict_action_hidden` with the same noisy actions
    and t; the loop at 5 steps, prefix-KV against full prefill and split-KV
    against concatenation, from the same starting noise. Cosine >= 0.99."""
    from openvla_oft_tpu_torch.models.action_heads import sinusoidal_time_encoding
    from openvla_oft_tpu_torch.models.prismatic import (build_diffusion_prefix,
                                                       diffusion_suffix_step,
                                                       predict_action_hidden)

    params, cfg, platform, dev = policy.params, policy.cfg, policy.platform, policy.device
    obs = observation(policy, rng)
    _, ids, mask, pixels, proprio = model_inputs(policy, obs)
    proprio = proprio.clamp(-1, 1)
    gen = torch.Generator(device=dev).manual_seed(7)
    x_t = torch.randn((1, platform.num_actions_chunk, platform.action_dim), generator=gen,
                      device=dev)
    t_emb = sinusoidal_time_encoding(torch.tensor([27], device=dev), cfg.llm_dim)[:, None]

    def check(name, got, ref, note=""):
        cos = cosine(got, ref)
        d = (got.float() - ref.float()).abs().max().item()
        log(f"[diffusion-parity] {name}: cosine {cos:.6f}, max|d| {d:.4e}{note} ({card})")
        if not (cos >= PARITY_COSINE and torch.isfinite(got).all()):
            raise AssertionError(f"diffusion parity failed: {name}")

    with torch.inference_mode():
        before = launch_counts()["K1"]
        k1 = build_diffusion_prefix(params, cfg, ids, mask, pixels, proprio,
                                    use_flash=policy.use_flash)
        used = launch_counts()["K1"] - before
        dense = build_diffusion_prefix(params, cfg, ids, mask, pixels, proprio, use_flash=False)
        if used != cfg.llm.num_layers:
            raise AssertionError(f"the prefix prefill launched K1 {used} times")
        n_pre = k1.prefix_k.shape[2]
        check(f"prefix K through K1 against dense (T = {n_pre})", k1.prefix_k, dense.prefix_k,
              f", K1 launches {used}")
        check(f"prefix V through K1 against dense (T = {n_pre})", k1.prefix_v, dense.prefix_v)
        step = diffusion_suffix_step(params, cfg, platform, k1, t_emb, x_t)
        full = predict_action_hidden(params, cfg, platform, ids, mask, pixels, proprio=proprio,
                                     use_flash=policy.use_flash, noisy_actions=x_t,
                                     diffusion_t_emb=t_emb).actions_hidden
        s_suf = k1.text_rest.shape[1] + 1 + platform.chunk_len + 1
        check(f"one step's actions_hidden, suffix (S = {s_suf} against {n_pre} + {s_suf} "
              f"keys) against predict_action_hidden", step, full)
    noise = torch.randn((1, platform.num_actions_chunk, platform.action_dim), generator=gen,
                        device=dev)
    saved = (policy.num_diffusion_steps_inference, policy.diffusion_prefix_kv, policy.split_kv)
    actions = {}
    try:
        policy.num_diffusion_steps_inference = 5
        for name, prefix_kv, split in (("prefix-kv", True, False), ("full-prefill", False, False),
                                       ("split-kv", True, True)):
            policy.diffusion_prefix_kv, policy.split_kv = prefix_kv, split
            actions[name] = torch.from_numpy(policy.predict_action(
                pixels[0], obs["instruction"], proprio=proprio[0], noise=noise))
    finally:
        policy.num_diffusion_steps_inference, policy.diffusion_prefix_kv, policy.split_kv = saved
    check("the loop at 5 steps, prefix-KV against full prefill", actions["prefix-kv"],
          actions["full-prefill"])
    check("the loop at 5 steps, split-KV against concatenation", actions["split-kv"],
          actions["prefix-kv"])


def diffusion_k5_parity(policy, rng, card: str) -> None:
    """On the int4 LLM, the prefix (T = 514, 4 K5 launches a layer) and one
    suffix step's actions_hidden (T = 105) through K5 against the same calls
    with K5's plain version swapped in: the prefix K/V, the step on each
    side's own prefix, and the step through K5 on the plain prefix."""
    from openvla_oft_tpu_torch.models.action_heads import sinusoidal_time_encoding
    from openvla_oft_tpu_torch.models.prismatic import (build_diffusion_prefix,
                                                       diffusion_suffix_step)
    from openvla_oft_tpu_torch.ops import int4_matmul as M

    params, cfg, platform, dev = policy.params, policy.cfg, policy.platform, policy.device
    obs = observation(policy, rng)
    _, ids, mask, pixels, proprio = model_inputs(policy, obs)
    proprio = proprio.clamp(-1, 1)
    x_t = torch.randn((1, platform.num_actions_chunk, platform.action_dim), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(8))
    t_emb = sinusoidal_time_encoding(torch.tensor([27], device=dev), cfg.llm_dim)[:, None]
    linears = 4 * cfg.llm.num_layers
    fused = M.int4_matmul_fused
    with torch.inference_mode():
        before = launch_counts()["K5"]
        prefix = build_diffusion_prefix(params, cfg, ids, mask, pixels, proprio)
        used_prefix = launch_counts()["K5"] - before
        got = diffusion_suffix_step(params, cfg, platform, prefix, t_emb, x_t)
        used_step = launch_counts()["K5"] - before - used_prefix
        M.int4_matmul_fused = M.int4_matmul_ref
        try:
            plain_prefix = build_diffusion_prefix(params, cfg, ids, mask, pixels, proprio)
            ref = diffusion_suffix_step(params, cfg, platform, plain_prefix, t_emb, x_t)
        finally:
            M.int4_matmul_fused = fused
        on_plain = diffusion_suffix_step(params, cfg, platform, plain_prefix, t_emb, x_t)
    n_pre = prefix.prefix_k.shape[2]
    ok = used_prefix == linears and used_step == linears
    for name, a, b in ((f"prefix K (T = {n_pre}, {used_prefix} K5 launches)", prefix.prefix_k,
                        plain_prefix.prefix_k),
                       (f"prefix V (T = {n_pre})", prefix.prefix_v, plain_prefix.prefix_v),
                       (f"one step's actions_hidden on its own prefix ({used_step} K5 launches "
                        f"in the step)", got, ref),
                       ("one step's actions_hidden through K5 on the plain prefix", on_plain,
                        ref)):
        cos = cosine(a, b)
        log(f"[diffusion-int4-parity] {name} against K5's plain version: cosine {cos:.6f}, "
            f"max|d| {(a.float() - b.float()).abs().max().item():.4e} ({card})")
        ok = ok and cos >= PARITY_COSINE and bool(torch.isfinite(a).all())
    if not ok:
        raise AssertionError(f"the diffusion path through K5 disagrees with the plain path "
                             f"(K5 launches: prefix {used_prefix}, step {used_step}, expected "
                             f"{linears} each)")


def diffusion_serving(card: str, rng) -> dict:
    """The flagship with the diffusion head (LIBERO, 50 DDIM steps, the
    prefix-KV loop) in bf16: build memory, 3 requests (K1 32 each, the
    prefix prefill), a traced one, parity on the card; then rebuilt with
    load_in_4bit: 2 requests (K5 128 + 50 x 32 x 4 each), a traced one, the
    prefix and one step through K5 against its plain version. Returns the
    launches of each run of requests."""
    from openvla_oft_tpu_torch.serving.deploy import flagship_policy

    t_phase = time.perf_counter()
    runs = {}
    for label, quant in (("bf16", {}), ("int4 W4A16", {"load_in_4bit": True})):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        policy = flagship_policy("cuda", seed=0, head="diffusion", **quant)
        torch.cuda.synchronize()
        log(f"[diffusion-init] {label} flagship, diffusion head, "
            f"{policy.num_diffusion_steps} steps: {torch.cuda.memory_allocated() / 2**30:.3f} GiB "
            f"allocated, peak during the build {torch.cuda.max_memory_allocated() / 2**30:.3f} "
            f"GiB, built in {time.perf_counter() - t0:.1f} s ({card})")
        n_layers = policy.cfg.llm.num_layers
        k5 = 4 * n_layers * (1 + policy.num_diffusion_steps) if quant else 0
        expect = {"K1": n_layers, "K4": 0, "K5": k5, "K6": 0, "int8": 0}
        runs[label] = staged_requests(policy, rng, 2 if quant else 3, label, expect, card)
        diffusion_profile(policy, rng, f"diffusion {label}", card)
        if quant:
            diffusion_k5_parity(policy, rng, card)
        else:
            diffusion_parity(policy, rng, card)
        del policy
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[diffusion] phase took {time.perf_counter() - t_phase:.1f} s (host clock)")
    return runs


def build_policy(label: str, card: str, **kw):
    """flagship_policy("cuda", seed=0, **kw), its build time and memory logged."""
    from openvla_oft_tpu_torch.serving.deploy import flagship_policy

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    policy = flagship_policy("cuda", seed=0, **kw)
    torch.cuda.synchronize()
    log(f"[{policy.head}-init] {label}: {torch.cuda.memory_allocated() / 2**30:.3f} GiB "
        f"allocated, peak during the build {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, "
        f"built in {time.perf_counter() - t0:.1f} s ({card})")
    return policy


def discrete_parity(policy, rng, card: str) -> None:
    """On the card: the discrete head's action-row logits through K1 against
    the dense path (cosine >= 0.99, argmax agreement logged); the lm_head
    product (`lm_logits`, fp32 out of bf16 operands) against the plain fp32
    product of the same bf16 values (max|d| <= 1e-4 * max|ref|), timed
    beside the plain product and its bound, and the argmax flips that a
    bf16-rounded product would make."""
    from openvla_oft_tpu_torch.models.llama import lm_logits
    from openvla_oft_tpu_torch.models.prismatic import predict_action_hidden

    params, cfg, platform = policy.params, policy.cfg, policy.platform
    _, ids, mask, pixels, proprio = model_inputs(policy, observation(policy, rng))
    out = {}
    with torch.inference_mode():
        for use_flash in (True, False):
            before = launch_counts()["K1"]
            out[use_flash] = predict_action_hidden(params, cfg, platform, ids, mask, pixels,
                                                   proprio=proprio.clamp(-1, 1),
                                                   use_flash=use_flash, compute_logits=True)
            used = launch_counts()["K1"] - before
            if used != (cfg.llm.num_layers - 1 if use_flash else 0):
                raise AssertionError(f"use_flash={use_flash} launched K1 {used} times")
    logits = {k: o.action_logits for k, o in out.items()}
    cos = cosine(logits[True], logits[False])
    agree = (logits[True].argmax(-1) == logits[False].argmax(-1)).float().mean().item()
    log(f"[discrete-parity] action-row logits (1, {logits[True].shape[1]}, "
        f"{logits[True].shape[2]}) fp32, cosine(K1 path, dense path) = {cos:.6f}, argmax "
        f"agreement {agree:.3f} ({card})")
    if not (cos >= PARITY_COSINE and torch.isfinite(logits[True]).all()):
        raise AssertionError("the discrete head's logits through K1 disagree with the dense path")
    hidden, w = out[True].actions_hidden, params["llm"]["lm_head"]["kernel"]
    with torch.inference_mode():
        got = lm_logits(params["llm"], hidden)
        ref = hidden.float() @ w.float()
        rounded = torch.matmul(hidden, w)
    rel = (got - ref).abs().max().item() / ref.abs().max().item()
    flips = (rounded.argmax(-1) != ref.argmax(-1)).sum().item()
    ms = cuda_time_ms(lambda: lm_logits(params["llm"], hidden))
    plain_ms = cuda_time_ms(lambda: hidden.float() @ w.float())
    b_ms, b_by = bound(2 * hidden[0].numel() * w.shape[1], nbytes(hidden, w, got), PEAK_BF16)
    log(f"[discrete-parity] lm_head product at M = {hidden.shape[1]}: torch.mm(out_dtype="
        f"float32) against the fp32 product of the same bf16 values max|d| = "
        f"{(got - ref).abs().max().item():.3e} ({rel:.3e} of max|ref|), dtype {got.dtype}; a "
        f"bf16-rounded product flips {flips} of {ref.shape[1]} argmaxes; {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}) (CUDA events; {card})")
    if not rel <= 1e-4 or got.dtype != torch.float32:
        raise AssertionError("the lm_head product disagrees with its fp32 plain product")


def ar_inputs(cfg, dev) -> tuple:
    """The base-OpenVLA request of `scripts/bench_ar.py`: 24 real prompt
    tokens in a 48-token bucket, and one camera's pixels from
    `device_preprocess` of a random 256 x 256 frame."""
    from openvla_oft_tpu_torch.processing.image_processing import device_preprocess
    from openvla_oft_tpu_torch.scripts.bench_ar import prompt

    frame = torch.randint(0, 256, (1, 256, 256, 3), dtype=torch.uint8, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(3))
    with torch.inference_mode():
        pixels = device_preprocess(cfg, frame, cfg.vision_configs[0].image_size)[None]
    return (*prompt(dev), pixels)


def ar_requests(params, cfg, platform, lengths, label: str, expect: dict, card: str) -> dict:
    """One `predict_action_autoregressive` request per entry of `lengths`
    (new tokens), each checked (shape, launches per request = `expect`, the
    K5 count scaled by the request's length) and timed; the counts are set
    to 0 before the first and read after the last. Returns those launches."""
    from openvla_oft_tpu_torch.models.prismatic import predict_action_autoregressive

    inputs = ar_inputs(cfg, params["llm"]["embed"]["embedding"].device)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    for i, n in enumerate(lengths):
        before = launch_counts()
        t0 = time.perf_counter()
        with torch.inference_mode():
            tokens = predict_action_autoregressive(params, cfg, platform, *inputs,
                                                   num_new_tokens=n)
        tokens = tokens.cpu()
        dt = (time.perf_counter() - t0) * 1e3
        per_request = {k: c - before[k] for k, c in launch_counts().items() if k in expect}
        want = {k: v(n) if callable(v) else v for k, v in expect.items()}
        log(f"[discrete-ar] {label} request {i} ({n} tokens{', first' if i == 0 else ''}): "
            f"tokens {tokens.tolist()[0][:8]}{'...' if n > 8 else ''}, launches {per_request}, "
            f"{dt:.1f} ms, {dt / n:.2f} ms a token (host clock, ends in the tokens' copy to "
            f"the host; {card})")
        if tokens.shape != (1, n) or per_request != want:
            raise AssertionError(f"one {label} request of {n} tokens launched {per_request}, "
                                 f"expected {want}")
    launches = launch_counts()
    log(f"[discrete-ar] {label}: torch.cuda.max_memory_allocated during the requests "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB ({card})")
    return launches


def ar_parity(params, cfg, platform, card: str) -> None:
    """On the card, bf16: the cached decode's hidden states (the prefill's
    last row, then 6 decode steps fed the generated tokens) against one
    no-cache `llama_model` forward over the prefix and the same tokens
    (dense both, teacher-forced), cosine >= 0.999; the prefill through K1
    against the dense path at the valid rows (hidden states and cached K/V),
    cosine >= 0.99."""
    from openvla_oft_tpu_torch.models.llama import (KVCache, embed_tokens, llama_decode_step,
                                                   llama_model, llama_prefill)
    from openvla_oft_tpu_torch.models.prismatic import (autoregressive_layout,
                                                       predict_action_autoregressive)

    llm, dev = params["llm"], params["llm"]["embed"]["embedding"].device
    ids, mask, pixels = ar_inputs(cfg, dev)
    n = platform.action_dim
    with torch.inference_mode():
        tokens = predict_action_autoregressive(params, cfg, platform, ids, mask, pixels, n,
                                               use_flash=False)
        embeds, positions, key_valid, pads = autoregressive_layout(params, cfg, ids, mask,
                                                                   pixels)
        s = embeds.shape[1]
        caches, hidden = {}, {}
        for use_flash in ("auto", False):
            caches[use_flash] = KVCache.create(cfg.llm, 1, s + n - 1, device=dev)
            before = launch_counts()["K1"]
            hidden[use_flash], _ = llama_prefill(llm, cfg.llm, embeds, caches[use_flash],
                                                 positions=positions, key_valid=key_valid,
                                                 use_flash=use_flash)
            used = launch_counts()["K1"] - before
            if used != (cfg.llm.num_layers if use_flash else 0):
                raise AssertionError(f"the AR prefill (use_flash={use_flash}) launched K1 "
                                     f"{used} times")
        cache = caches[False]
        cached = [hidden[False][:, -1]]
        for j in range(n - 1):
            step, cache = llama_decode_step(llm, cfg.llm, embed_tokens(llm, tokens[:, j:j + 1]),
                                            cache, positions=(cache.index - pads)[:, None])
            cached.append(step[:, 0])
        gen = embed_tokens(llm, tokens[:, :n - 1]).to(embeds.dtype)
        steps = torch.arange(1, n, device=dev)[None]
        full_valid = torch.cat([key_valid, torch.ones_like(steps, dtype=torch.bool)], dim=1)
        full = llama_model(llm, cfg.llm, torch.cat([embeds, gen], dim=1),
                           padding_mask=full_valid,
                           positions=torch.cat([positions, positions[:, -1:] + steps], dim=1),
                           use_flash=False)[:, s - 1:]
    cached = torch.stack(cached, dim=1)
    valid = key_valid[0]
    checks = [(f"the cached decode's hidden states ({n} tokens, the prefill's last row and "
               f"{n - 1} steps) against the no-cache forward over S = {s} + {n - 1}", cached,
               full, 0.999),
              (f"the prefill's hidden states through K1 against dense (S = T = {s}, "
               f"{int((~valid).sum())} left pads; valid rows)", hidden["auto"][:, valid],
               hidden[False][:, valid], PARITY_COSINE),
              ("the prefill's cached K through K1 against dense (valid rows)",
               caches["auto"].k[:, :, :s][:, :, valid], cache.k[:, :, :s][:, :, valid],
               PARITY_COSINE)]
    for name, got, ref, floor in checks:
        cos = cosine(got, ref)
        log(f"[discrete-ar-parity] {name}: cosine {cos:.6f}, max|d| "
            f"{(got.float() - ref.float()).abs().max().item():.4e} ({card})")
        if not (cos >= floor and torch.isfinite(got).all()):
            raise AssertionError(f"AR parity failed: {name}")


def ar_profile(params, cfg, platform, policy, label: str, card: str) -> None:
    """One 7-token AR request traced: device time by class, kernels per
    token, idle share (`profile_request`)."""
    from openvla_oft_tpu_torch.models.prismatic import predict_action_autoregressive

    inputs = ar_inputs(cfg, params["llm"]["embed"]["embedding"].device)
    n = platform.action_dim

    def request():
        with torch.inference_mode():
            predict_action_autoregressive(params, cfg, platform, *inputs, n).cpu()

    busy, by_class = profile_request(policy, None, label, card, request=request, runs=1)
    if busy is not None:
        kernels = sum(c for _, c in by_class.values())
        log(f"[discrete-ar-profile] {label}: {kernels} kernels, {kernels / n:.0f} a token; "
            f"{busy:.1f} ms of device time, {busy / n:.2f} ms a token ({card})")


def ar_k5_parity(params, cfg, platform, card: str) -> None:
    """On the int4 LLM: one decode step (T = 1 in every linear, 128 K5
    launches) against the same step with K5's plain version swapped in, on
    a copy of the same cache (filled by a prefill through K5)."""
    from openvla_oft_tpu_torch.models.llama import (KVCache, embed_tokens, llama_decode_step,
                                                   llama_prefill)
    from openvla_oft_tpu_torch.models.prismatic import autoregressive_layout
    from openvla_oft_tpu_torch.ops import int4_matmul as M

    llm, dev = params["llm"], params["llm"]["embed"]["embedding"].device
    fused = M.int4_matmul_fused
    with torch.inference_mode():
        embeds, positions, key_valid, pads = autoregressive_layout(params, cfg, *ar_inputs(cfg,
                                                                                          dev))
        cache = KVCache.create(cfg.llm, 1, embeds.shape[1] + 1, device=dev)
        _, cache = llama_prefill(llm, cfg.llm, embeds, cache, positions=positions,
                                 key_valid=key_valid)
        copy = KVCache(cache.k.clone(), cache.v.clone(), cache.valid.clone(), cache.index)
        token = embed_tokens(llm, torch.tensor([[31900]], device=dev))
        pos = (cache.index - pads)[:, None]
        before = launch_counts()["K5"]
        got, _ = llama_decode_step(llm, cfg.llm, token, cache, positions=pos)
        used = launch_counts()["K5"] - before
        M.int4_matmul_fused = M.int4_matmul_ref
        try:
            ref, _ = llama_decode_step(llm, cfg.llm, token, copy, positions=pos)
        finally:
            M.int4_matmul_fused = fused
    cos = cosine(got, ref)
    log(f"[discrete-ar-int4-parity] one decode step through K5 ({used} launches at T = 1) "
        f"against K5's plain version: cosine {cos:.6f}, max|d| "
        f"{(got.float() - ref.float()).abs().max().item():.4e} ({card})")
    if not (cos >= PARITY_COSINE and used == 4 * cfg.llm.num_layers
            and torch.isfinite(got).all()):
        raise AssertionError("the int4 decode step through K5 disagrees with the plain path")


def discrete_serving(card: str, rng) -> dict:
    """Phase 8d. (a) `flagship_policy(head="discrete")` at LIBERO: 3
    `predict_action` requests (K1 31 each), the logits through K1 against
    dense and the lm_head product against its plain version; (b) base
    OpenVLA on the same tree at 1 image (the tree does not depend on the
    image count): 3 AR requests of 7 tokens and 2 of 56 in bf16 (K1 32
    each, the prefill), the cached decode and the K1 prefill against dense,
    one traced request; (c) `load_in_4bit`, 2 requests of 7 tokens (K5 128
    for the prefill + 128 a step), one traced, one step through K5 against
    its plain version; (d) `load_in_8bit`, one request of 7 tokens (199
    int8 products in the ViTs and the projector, 128 a pass in the LLM);
    (e) `scripts/bench_ar.py` in bf16 and with `--quant int4`. Returns the
    launches of each run of requests."""
    import dataclasses

    from openvla_oft_tpu_torch.scripts import bench_ar

    t_phase = time.perf_counter()
    runs = {}
    none = {"K4": 0, "K5": 0, "K6": 0, "int8": 0}
    policy = build_policy("bf16 flagship, discrete head, LIBERO", card, head="discrete")
    n_layers, platform = policy.cfg.llm.num_layers, policy.platform
    runs["parallel bf16"] = staged_requests(policy, rng, 3, "discrete bf16",
                                            {"K1": n_layers - 1, **none}, card)
    discrete_parity(policy, rng, card)
    ar_cfg = dataclasses.replace(policy.cfg, num_images_in_input=1)
    runs["AR bf16"] = ar_requests(policy.params, ar_cfg, platform, [7, 7, 7, 56, 56],
                                  "AR bf16", {"K1": n_layers, **none}, card)
    ar_parity(policy.params, ar_cfg, platform, card)
    ar_profile(policy.params, ar_cfg, platform, policy, "AR bf16 7 tokens", card)
    del policy
    gc.collect()
    torch.cuda.empty_cache()

    linears = 4 * n_layers
    for label, quant in (("AR int4 W4A16", {"load_in_4bit": True}),
                         ("AR int8", {"load_in_8bit": True})):
        policy = build_policy(f"{label[3:]} flagship, discrete head, 1 image", card,
                              head="discrete", num_images=1, **quant)
        if "load_in_4bit" in quant:
            expect = {"K1": n_layers, **none, "K5": lambda n: linears * n}
            runs[label] = ar_requests(policy.params, policy.cfg, platform, [7, 7], label,
                                      expect, card)
            ar_profile(policy.params, policy.cfg, platform, policy, f"{label} 7 tokens", card)
            ar_k5_parity(policy.params, policy.cfg, platform, card)
        else:
            vit = int8_per_request(policy.cfg, False)
            expect = {"K1": n_layers, **none, "int8": lambda n: vit + linears * n}
            runs[label] = ar_requests(policy.params, policy.cfg, platform, [7], label, expect,
                                      card)
        del policy
        gc.collect()
        torch.cuda.empty_cache()

    for flags in ([], ["--quant", "int4"]):
        t0 = time.perf_counter()
        out = bench_ar.main(["--k", "3", *flags])
        log(f"[bench_ar] {out['tag']}: " + ", ".join(f"{k} {v:.1f} ms" for k, v in
                                                     out["ms"].items())
            + f"; AR 56 / parallel {out['ratio']:.2f}x; peak {out['peak_bytes'] / 2**30:.3f} "
            f"GiB; {time.perf_counter() - t0:.1f} s with its build (host clock; {card})")
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[discrete] phase took {time.perf_counter() - t_phase:.1f} s (host clock)")
    return runs


def probe_phase(card: str) -> dict:
    """The probe script's main (its launches are the probe's main path: K5,
    the three probe modes, K6 and torch.matmul by device time at T = 112 and
    the 7B's three shapes, and the split of K5's time); then, at each shape,
    each mode against its plain version and the bound; group-dots' plain
    version timed at qkv."""
    from openvla_oft_tpu_torch.ops.int4_probe import MODES, _probe_plan, int4_probe, int4_probe_ref
    from openvla_oft_tpu_torch.ops.quant import quantize_weight_int4
    from openvla_oft_tpu_torch.scripts import exp_int4_probe as P

    reset_launch_counts()
    t0 = time.perf_counter()
    out = P.main(["--iters", "10"])
    launches = launch_counts()["probe"]
    log(f"[probe] exp_int4_probe.main: {time.perf_counter() - t0:.1f} s, {launches} probe "
        f"launches; group-dots rel error against K5 {out['group_dots_vs_fused']:.3e}, against "
        f"int4_matmul_ref {out['group_dots_vs_ref']:.3e} ({card})")
    dev = torch.device("cuda")
    flush = l2_flush_buffer(dev)
    errs, bounds = {}, {}
    for name, k, n in P.SHAPES:
        gen = torch.Generator(device=dev).manual_seed(k + n)
        x = torch.randn((P.T, k), generator=gen, device=dev).bfloat16()
        q = quantize_weight_int4(torch.randn((k, n), generator=gen, device=dev) * 0.02)
        packed, scales = q["kernel_q4"], q["scale_w4"]
        for mode in MODES:
            got = int4_probe(x, packed, scales, mode)
            torch.cuda.synchronize()
            err, rel, _ = _rel_cos(got, int4_probe_ref(x, packed, scales, mode))
            errs[(name, mode)] = err
            finite = bool(torch.isfinite(got).all())
            log(f"[probe] {mode} {name} T={P.T}: plan {_probe_plan(P.T, k, n, 128, mode)}, "
                f"max|d|={err:.3e} rel={rel:.3e} against its plain version, finite {finite}")
            if not (rel <= PROBE_REL and finite):
                raise AssertionError(f"the probe's {mode} disagrees with its plain version at "
                                     f"{name}")
        bounds[name] = bound(2 * P.T * k * n, nbytes(x, packed, scales, got), PEAK_BF16)
        times, split = out["ms"][name], out["split"][name]
        log(f"[probe] {name} T={P.T}: " + ", ".join(f"{v} {ms:.4f}" for v, ms in times.items())
            + f" ms (device time, mean of 10, L2 flushed); bound {bounds[name][0]:.4f} "
            f"({bounds[name][1]}); split: " + ", ".join(f"{d} {v:.4f}" for d, v in split.items())
            + f" ms; stacked layer view K5 {out['stacked_ms'][name]:.4f} ms; byte floor "
            f"{out['floor_ms'][name]:.4f} ms ({card})")
        if name == "qkv":
            plain_ms = cuda_time_ms(lambda: int4_probe_ref(x, packed, scales, "group-dots"),
                                    flush=flush)
        del x, q, packed, scales, got
    name = P.SHAPES[0][0]
    ms = out["ms"][name]["group-dots"]
    log(f"[probe] group-dots {name} T={P.T}: {ms:.4f} ms ({out['how'][name]['group-dots']}), "
        f"plain {plain_ms:.4f} (CUDA events), torch.matmul on the bf16 weight "
        f"{out['ms'][name]['torch.matmul']:.4f}, bound {bounds[name][0]:.4f} ({card})")
    del flush
    torch.cuda.empty_cache()
    return {"launches": launches, "max_abs_err": max(errs.values()), "ms": ms,
            "plain_ms": plain_ms, "library_ms": out["ms"][name]["torch.matmul"],
            "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
            "modes": {s: {"ms": out["ms"][s], "split": out["split"][s],
                          "bound_ms": bounds[s][0]} for s, _, _ in P.SHAPES}}


def tiny_auto_request(card: str) -> dict:
    """One request of a policy at the stock TINY_LLAMA (head_dim 16, which K1
    does not take; the `--vla_path random:tiny` model) under use_flash="auto":
    it must take the dense path, with no K1 launch, and answer as
    use_flash=False does. Returns the auto request's launches."""
    from openvla_oft_tpu_torch.bridge import init_params
    from openvla_oft_tpu_torch.constants import LIBERO
    from openvla_oft_tpu_torch.policy import OpenVLAPolicy
    from openvla_oft_tpu_torch.serving.deploy import placeholder_norm_stats
    from openvla_oft_tpu_torch.training.finetune import model_config, parse_config

    cfg = model_config(parse_config(["--vla_path", "random:tiny"]))
    dev = torch.device("cuda")
    params = init_params(cfg, LIBERO, torch.Generator(device=dev).manual_seed(0), device=dev,
                         dtype=torch.bfloat16)
    frames = (np.random.default_rng(0).random((2, 40, 40, 3)) * 255).astype(np.uint8)
    actions, launches = {}, {}
    for use_flash in ("auto", False):
        policy = OpenVLAPolicy(cfg=cfg, platform=LIBERO, params=params,
                               norm_stats=placeholder_norm_stats(LIBERO), prompt_bucket=32,
                               use_flash=use_flash)
        reset_launch_counts()
        actions[use_flash] = policy.predict_action_from_frames(frames, "open the drawer")
        torch.cuda.synchronize()
        launches[use_flash] = launch_counts()
    d = float(np.abs(actions["auto"] - actions[False]).max())
    log(f"[auto] TINY_LLAMA policy (head_dim {cfg.llm.head_dim}) under use_flash=\"auto\": "
        f"{actions['auto'].shape} finite {bool(np.isfinite(actions['auto']).all())}, launches "
        f"{launches['auto']}; max|d| against use_flash=False {d:.3e} ({card})")
    if launches["auto"]["K1"] != 0 or not np.isfinite(actions["auto"]).all() or d > 1e-5:
        raise AssertionError("use_flash=\"auto\" did not serve the head_dim-16 policy through "
                             "the dense path")
    del params
    torch.cuda.empty_cache()
    return launches["auto"]


def counted_wrappers() -> dict:
    """Each kernel's wrapper, which counts that kernel's launches, and the
    int8 product's (`ops/quant.py::int8_mm`, the library's torch._int_mm)."""
    from openvla_oft_tpu_torch.ops import flash_attention as fa
    from openvla_oft_tpu_torch.ops import int4_matmul as M
    from openvla_oft_tpu_torch.ops import int4_probe as IP
    from openvla_oft_tpu_torch.ops import quant as Q
    from openvla_oft_tpu_torch.ops import vit_fused as VF

    return {"K1": fa.flash_attention, "K2": fa.flash_attention_dq, "K3": fa.flash_attention_dkv,
            "K4": VF.ln_matmul, "K5": M.int4_matmul_fused, "K6": M.int4_matmul_fused_a8,
            "probe": IP.int4_probe, "int8": Q.int8_mm}


def launch_counts() -> dict:
    return {k: fn.launches for k, fn in counted_wrappers().items()}


def reset_launch_counts() -> None:
    for fn in counted_wrappers().values():
        fn.launches = 0


def training_setup():
    """The fine-tuning CLI's flags parsed, its model config, platform,
    TrainConfig and first batch (numpy), all as the CLI builds them."""
    from openvla_oft_tpu_torch.training import finetune as FT

    cfg = FT.parse_config(TRAIN_FLAGS)
    return (FT.model_config(cfg), FT.platform_of(cfg), FT.train_config(cfg),
            FT.first_batch(cfg))


def _rel_cos(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    g, r = got.double().flatten(), ref.double().flatten()
    rel = ((g - r).abs().max() / r.abs().max()).item()
    cos = torch.nn.functional.cosine_similarity(g, r, dim=0).item()
    return (g - r).abs().max().item(), rel, cos


def stats_check(args, card: str) -> dict:
    """The stats rows (LSE, delta) that K2 writes on the way against the
    stats pass that a K3 called alone runs (bitwise: one code path) and
    against the plain LSE and delta; the pass's device time."""
    from openvla_oft_tpu_torch.ops import flash_attention as fa

    q, k, v, o, lse, do, causal, key_valid, bidir = args
    masks = fa._mask_u8(q.shape[0], q.shape[1], key_valid, bidir, q.device)
    q, k, v, do = fa._bwd_operands(q, k, v, o, lse, do)
    plan = fa._plan_of(q, k)
    rows = fa._stats_rows(q, plan)
    fa._launch_dq(q, k, v, o, lse, do, causal, *masks, plan, rows)
    passed = fa._launch_stats(o, lse, do, plan)
    torch.cuda.synchronize()
    s = q.shape[1]
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
    same = bool(torch.equal(rows[:, :, :s], passed[:, :, :s]))
    lse_exact = bool(torch.equal(rows[:, :, :s, 0], lse))
    delta_rel = ((rows[:, :, :s, 1] - delta).abs().max() / delta.abs().max()).item()
    pad_ok = bool(torch.all(rows[:, :, s:, 1] == 0) and torch.all(rows[:, :, s:, 0] == 1e30))
    flush = l2_flush_buffer()
    ms, how = device_ms(lambda: fa._launch_stats(o, lse, do, plan), flush)
    del flush
    log(f"[bwd] stats rows: K2's equal the stats pass's bitwise: {same}; LSE copied exactly: "
        f"{lse_exact}; delta max|d|/max|ref| {delta_rel:.3e}; rows past S (1e30, 0): {pad_ok};"
        f" the stats pass {ms:.4f} ms ({how}; {card})")
    if not (same and lse_exact and delta_rel <= 1e-5 and pad_ok):
        raise AssertionError("the stats rows disagree")
    return {"ms": ms, "timing": how}


def backward_check(card: str, s_train: int) -> dict:
    """K2 and K3 against flash_attention_bwd_ref at the training shape, the
    ALOHA length, GQA and dead rows, with two bitwise-equal calls of each;
    timed by device time (torch.profiler, L2 flushed) beside the bound and
    SDPA's backward with the boolean OFT mask (its backward kernels alone:
    autograd.grad on a retained graph; dq, dk and dv in one call), with the
    CUDA-event times beside them (SDPA: forward and backward less forward,
    and the backward alone)."""
    from openvla_oft_tpu_torch.ops import flash_attention as fa

    sdpa = torch.nn.functional.scaled_dot_product_attention

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
    flush = l2_flush_buffer()
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
        again = (fa.flash_attention_dq(*args),) + fa.flash_attention_dkv(*args)
        torch.cuda.synchronize()
        bitwise = all(bool(torch.equal(a, b_)) for a, b_ in zip((dq, dk, dv), again))
        del again
        refs = fa.flash_attention_bwd_ref(*args)
        errs = {n: _rel_cos(g, r) for n, g, r in zip(("dq", "dk", "dv"), (dq, dk, dv), refs)}
        dead = ~fa._allow(q, True, key_valid, bidir)[:, 0].any(-1)
        zeros = bool(torch.all(dq[dead] == 0) and torch.all(dk[~key_valid] == 0)
                     and torch.all(dv[~key_valid] == 0))
        finite = all(bool(torch.isfinite(t).all()) for t in (dq, dk, dv))
        # K2 and K3 as the op's backward launches them: K2 writes the stats
        # rows, K3 reads them (no stats pass).
        masks = fa._mask_u8(b, s_len, key_valid, bidir, dev)
        ops = fa._bwd_operands(q, k, v, o, lse, do)
        plan = fa._plan_of(ops[0], ops[1])
        stats = fa._stats_rows(ops[0], plan)
        fa._launch_dq(*ops[:3], o, lse, ops[3], True, *masks, plan, stats)
        dev_dq, how_dq = device_ms(
            lambda: fa._launch_dq(*ops[:3], o, lse, ops[3], True, *masks, plan, stats), flush)
        dev_dkv, how_dkv = device_ms(
            lambda: fa._launch_dkv(*ops, True, *masks, plan, stats), flush)
        ms_dq = cuda_time_ms(lambda: fa.flash_attention_dq(*args))
        ms_dkv = cuda_time_ms(lambda: fa.flash_attention_dkv(*args))
        plain_dq = cuda_time_ms(lambda: fa.flash_attention_dq_ref(*args))
        plain_dkv = cuda_time_ms(lambda: fa.flash_attention_dkv_ref(*args))
        (qt, kt, vt), kw = sdpa_args(q, k, v, key_valid, bidir)
        leaves = [t.detach().requires_grad_() for t in (qt, kt, vt)]
        do_t = do.transpose(1, 2)
        sdpa_fwd = cuda_time_ms(lambda: sdpa(*leaves, **kw))
        sdpa_fwd_bwd = cuda_time_ms(lambda: torch.autograd.grad(sdpa(*leaves, **kw), leaves, do_t))
        out_t = sdpa(*leaves, **kw)
        sdpa_bwd_events = cuda_time_ms(
            lambda: torch.autograd.grad(out_t, leaves, do_t, retain_graph=True))
        library_ms, how_lib = device_ms(
            lambda: torch.autograd.grad(out_t, leaves, do_t, retain_graph=True), flush)
        del leaves, kw, out_t
        pairs = fa._live_pairs(True, key_valid, bidir)
        entries = allowed_entries(q, key_valid, bidir)
        mm = 2 * d * h * entries          # one product over the allowed entries, every head
        tf_dq, tf_dkv = 3 * mm / dev_dq / 1e9, 4 * mm / dev_dkv / 1e9
        # Each kernel's own traffic: K2 reads q, k, v, O, LSE, dO and the
        # masks and writes dq and the stats rows; K3 reads q, k, v, dO, the
        # stats rows and the masks and writes dk and dv.
        shared = nbytes(q, k, v, do, *masks)
        bound_dq = bound(3 * mm, shared + nbytes(o, lse, dq, stats), PEAK_BF16)
        bound_dkv = bound(4 * mm, shared + nbytes(stats, dk, dv), PEAK_BF16)
        log(f"[bwd] {name}: B={b} S={s_len} H={h} Hkv={hkv} D={d} rows={rows[:2]}"
            f"{'...' if len(rows) > 2 else ''} | " + " ".join(
                f"{n} max|d|={e[0]:.3e} rel={e[1]:.3e} cos={e[2]:.6f}" for n, e in errs.items())
            + f" | dead rows and invalid keys exactly 0: {zeros}, finite: {finite}, two calls "
              f"bitwise equal: {bitwise}")
        log(f"[bwd] {name}: plan rows={plan['rows']} tile={plan['tile']} stages="
            f"{plan['stages']} s_pad={plan['s_pad']} K2 grid {plan['dq_grid']} K3 grid "
            f"{plan['dkv_grid']}; K2 {dev_dq:.4f} ms ({tf_dq:.1f} TFLOP/s, "
            f"{bound_dq[0] / dev_dq:.3f} of the bound), K3 {dev_dkv:.4f} ms ({tf_dkv:.1f} "
            f"TFLOP/s, {bound_dkv[0] / dev_dkv:.3f} of the bound), K2 + K3 "
            f"{dev_dq + dev_dkv:.4f} ms ({how_dq}; {how_dkv}); SDPA's backward {library_ms:.4f}"
            f" ms ({how_lib}); bounds K2 {bound_dq[0]:.4f} ms ({bound_dq[1]}), K3 "
            f"{bound_dkv[0]:.4f} ms ({bound_dkv[1]}) ({entries} allowed entries and {pairs} "
            f"live 64x64 tile pairs per head; {card})")
        log(f"[bwd] {name}, CUDA events (median of 20, wrapper included): K2 {ms_dq:.4f} ms, "
            f"K3 with its stats pass {ms_dkv:.4f} ms, plain dq {plain_dq:.4f} ms, plain dk/dv "
            f"{plain_dkv:.4f} ms; SDPA with the boolean mask: forward {sdpa_fwd:.4f} ms, "
            f"forward and backward {sdpa_fwd_bwd:.4f} ms, their difference "
            f"{sdpa_fwd_bwd - sdpa_fwd:.4f} ms, the backward alone {sdpa_bwd_events:.4f} ms")
        if not (zeros and finite and bitwise and all(e[1] <= BWD_REL and e[2] >= BWD_COSINE
                                                     for e in errs.values())):
            raise AssertionError(f"K2/K3 disagree with their plain version at {name}")
        results[name] = {"dq_err": errs["dq"][0], "dkv_err": max(errs["dk"][0], errs["dv"][0]),
                         "ms_dq": dev_dq, "ms_dkv": dev_dkv, "plain_dq": plain_dq,
                         "plain_dkv": plain_dkv, "library_ms": library_ms,
                         "bound_dq": bound_dq, "bound_dkv": bound_dkv, "plan": plan,
                         "timing": how_dq, "events_dq": ms_dq, "events_dkv": ms_dkv,
                         "library_events_ms": sdpa_bwd_events}
        if name == "training":
            results["stats"] = stats_check(args, card)
        del q, k, v, qkv, do, o, lse, dq, dk, dv, refs, args, ops, stats
    del flush
    torch.cuda.empty_cache()
    return results


def train(card: str, n_layers: int):
    """3 steps of the fine-tuning CLI (in process); returns (state, launches)."""
    from openvla_oft_tpu_torch.bridge import tree_leaves
    from openvla_oft_tpu_torch.training import finetune as FT

    run_root = tempfile.mkdtemp(prefix="chip_smoke_runs_")
    expect = {"K1": 2 * n_layers, "K2": n_layers, "K3": n_layers,   # remat "all"
              "K4": 0, "K5": 0, "K6": 0, "probe": 0, "int8": 0}
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

    from openvla_oft_tpu_torch.ops import flash_attention as fa

    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        reset_launch_counts()
        stats_before = fa.flash_attention_dkv.stats_launches
        out = FT.main(TRAIN_FLAGS + ["--run_root_dir", run_root], on_step=on_step)
        launches = launch_counts()
        if fa.flash_attention_dkv.stats_launches != stats_before:
            raise AssertionError("the training backward ran the stats pass: K3 did not read "
                                 "K2's stats rows")
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


# The int8 GEMM class of a trace: torch._int_mm's device kernels, by the
# int8 operand tag of the one kernel seen on the H100
# (`cutlass_80_tensorop_i16832gemm_s8_*`). `int8_linear_parts` fails the run
# where a traced int8_linear holds no such kernel, so a new tag shows there.
INT8_GEMM_TAGS = ("gemm_s8",)


def kernel_class(name: str) -> str:
    n = name.lower()
    for cls, keys in (("K1", ("flash_fwd",)), ("K2", ("flash_bwd_dq",)), ("K4", ("ln_matmul",)),
                      ("K3", ("flash_bwd_dkv",)), ("K5", ("int4_w4a16",)),
                      ("K6", ("int4_w4a8",)), ("int8 GEMM", INT8_GEMM_TAGS),
                      ("fp32 GEMM", ("sgemm", "f32f32", "simt")),
                      ("bf16 GEMM", ("gemm", "cutlass", "xmma", "nvjet", "sm90")),
                      ("AdamW", ("multi_tensor", "adam")),
                      ("reduction", ("reduce", "norm")),
                      ("copy and cat", ("copy", "cat", "memcpy", "memset")),
                      ("elementwise", ("elementwise", "vectorized", "unrolled"))):
        if any(k in n for k in keys):
            return cls
    return "other"


def timed(fn) -> float:
    """fn() on the host clock, ms, ending in torch.cuda.synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def trace(fn) -> tuple:
    """fn() once under torch.profiler (device activity only): (wall ms,
    kernel count, device ms as the union of kernel intervals, {kernel class:
    (ms, count)}). Tracing slows the host, so 1 - device / wall is an upper
    bound of the idle share. Device ms is None where no window recorded
    device activity (`profiled`)."""
    walls = []
    kernels = profiled(lambda: walls.append(timed(fn)))
    wall = walls[-1]
    if not kernels:
        log("[profile] torch.profiler recorded no device activity: not measured")
        return wall, 0, None, {}
    busy, end = 0.0, float("-inf")
    for s, e in sorted((k.time_range.start, k.time_range.end) for k in kernels):
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    by_class = {}
    for k in kernels:
        cls = kernel_class(k.name)
        ms, n = by_class.get(cls, (0.0, 0))
        by_class[cls] = (ms + (k.time_range.end - k.time_range.start) / 1e3, n + 1)
    return wall, len(kernels), busy / 1e3, by_class


def log_classes(tag: str, by_class: dict) -> None:
    for cls, (ms, n) in sorted(by_class.items(), key=lambda kv: -kv[1][0]):
        log(f"[{tag}]   {cls}: {ms:.1f} ms, {n} kernels")


def profile_request(policy, obs, label: str, card: str, request=None, runs: int = 3) -> tuple:
    """One request of `policy` without HTTP (`predict_action_from_frames`
    on `obs`, or the given `request`), timed `runs` times untraced and then
    traced: device time by kernel class and the share of K1, of K4 and of
    the int4 kernels (K5, K6)."""
    if request is None:
        frames = frames_of(policy, obs)

        def request():
            policy.predict_action_from_frames(frames, obs["instruction"], proprio=obs["state"])

    untraced = [timed(request) for _ in range(runs)]
    wall, n, busy, by_class = trace(request)
    if busy is None:
        log(f"[profile] {label} request: untraced {', '.join(f'{t:.1f}' for t in untraced)} "
            f"ms; device time by kernel class not measured ({card})")
        return None, {}
    int4 = sum(by_class.get(c, (0.0, 0))[0] for c in ("K5", "K6"))
    k4 = by_class.get("K4", (0.0, 0))[0]
    k1 = by_class.get("K1", (0.0, 0))[0]
    log(f"[profile] {label} request: untraced {', '.join(f'{t:.1f}' for t in untraced)} ms; "
        f"traced {wall:.1f} ms with {n} kernels and {busy:.1f} ms of device time; K1 "
        f"{k1:.1f} ms = {k1 / busy:.3f}, K4 "
        f"{k4:.1f} ms = {k4 / busy:.3f} and K5+K6 {int4:.1f} ms = {int4 / busy:.3f} of the "
        f"device time; idle share of the traced "
        f"request {1 - busy / wall:.3f}, estimate for the untraced ones "
        f"{1 - busy / float(np.median(untraced)):.3f} (host clock, ends in "
        f"torch.cuda.synchronize; {card})")
    log_classes("profile", by_class)
    return busy, by_class


def profile_step(state, card: str) -> dict:
    """The CLI's train_step on its final state and first batch: 3 steps
    timed without the profiler, then one traced with torch.profiler (device
    activity only). The idle share of the traced step is 1 - (union of kernel
    intervals) / (its wall time); tracing slows the host, so that is an upper
    bound. Kernel durations do not depend on the host, so 1 - (device time) /
    (median untraced step) estimates the idle share of an untraced step."""
    from openvla_oft_tpu_torch.training.train_step import train_step

    model_cfg, platform, tcfg, batch = training_setup()
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}

    def step():
        train_step(state, batch, model_cfg, platform, tcfg)

    untraced = [timed(step) for _ in range(3)]
    wall, n, busy, by_class = trace(step)
    if busy is None:
        log(f"[profile] train_step at B=8: untraced {', '.join(f'{t:.1f}' for t in untraced)} "
            f"ms; device time not measured ({card})")
        return {"untraced_ms": untraced, "traced_ms": wall, "busy_ms": None}
    log(f"[profile] train_step at B=8: untraced {', '.join(f'{t:.1f}' for t in untraced)} ms;"
        f" traced {wall:.1f} ms with {n} kernels and {busy:.1f} ms of device time"
        f" (union of kernel intervals); idle share of the traced step "
        f"{1 - busy / wall:.3f}; estimate for the untraced steps "
        f"{1 - busy / float(np.median(untraced)):.3f} (host clock, ends in "
        f"torch.cuda.synchronize; {card})")
    log_classes("profile", by_class)
    k1 = by_class.get("K1", (0.0, 0))[0]
    k23 = sum(by_class.get(c, (0.0, 0))[0] for c in ("K2", "K3"))
    log(f"[profile] train_step at B=8: K1 {k1:.1f} ms = {k1 / busy:.3f} and K2 + K3 {k23:.1f} "
        f"ms = {k23 / busy:.3f} of the device time ({card})")
    return {"untraced_ms": untraced, "traced_ms": wall, "busy_ms": busy, "k1_ms": k1,
            "k23_ms": k23}


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


def kernel_entry(name, source, replaces, launches, max_abs_err, ms, plain_ms, bound_ms,
                 bound_by, library_ms, **extra) -> dict:
    return {"name": name, "route": "cuda", "source": "openvla_oft_tpu_torch/csrc/" + source,
            "replaces": replaces, "launches": launches, "max_abs_err": max_abs_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, **extra}


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
    wgmma = wgmma_build_report(lib_path)

    cfg, _, _, batch = training_setup()
    s_train = (batch["input_ids"].shape[1] + 1                      # + proprio token
               + cfg.num_images_in_input * cfg.vision_configs[0].num_patches)
    log(f"[bwd] training layout: S = {s_train} (text bucket + "
        f"{cfg.num_images_in_input} x {cfg.vision_configs[0].num_patches} patches + proprio)")
    checks = kernel_check(card, s_train)
    tiny_launches = tiny_auto_request(card)
    k4 = ln_matmul_check(card)
    k4_parts_phase(card)
    k1_parts_phase(card)

    t0 = time.perf_counter()
    policy = flagship_policy("cuda", seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(policy.params))
    log(f"[init] flagship params on the card: {n_params / 1e9:.3f} B, "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB, built in "
        f"{time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)
    n_layers = policy.cfg.llm.num_layers
    observations, answers, serve_launches, _ = serve(
        policy, card, rng, "bf16", {"K1": n_layers - 1, "K4": 0, "K5": 0, "K6": 0, "int8": 0},
        warm=False, stdlib_check=True)
    bf16_hidden = path_parity(policy, observations[0], answers[0])
    libero_vit_fused(policy, observations[0], card)
    del policy
    gc.collect()
    torch.cuda.empty_cache()

    aloha = aloha_serving(card, rng)
    aloha_k4 = aloha[True]["launches"]

    int4 = int4_check(card)
    int4_launches = int4_serving(card, rng, observations[0], bf16_hidden)
    gc.collect()
    torch.cuda.empty_cache()
    probe = probe_phase(card)
    int8_launches = int8_serving(card, rng, observations[0], bf16_hidden)
    diffusion = diffusion_serving(card, rng)
    discrete = discrete_serving(card, rng)

    bwd = backward_check(card, s_train)
    state, train_launches = train(card, n_layers)
    profile_step(state, card)
    training_parity(state, card)

    # Each kernel at its main path's shape: K1 the LIBERO prefill, K2/K3 the
    # training batch, K4 the DINOv2 fc1 at ALOHA, K5/K6 the wqkv projection
    # at T = 618, the probe group-dots at qkv T = 112. K1's to K6's times and
    # their library times are device times: at their speed the wrapper's
    # host time shows in CUDA events around the call (logged beside them).
    # SDPA computes dq, dk and dv in one backward, so K2 and K3 share its
    # time; for K4 the library time is torch.matmul on the product alone.
    libero, tr, wqkv = checks["libero_prefill"], bwd["training"], int4["wqkv T=618"]
    bwd_cases = {n: c for n, c in bwd.items() if n != "stats"}
    fc1 = k4["DINOv2 fc1 ALOHA"]
    w4a16, w4a8 = int4_launches["W4A16"], int4_launches["W4A8"]
    k1_launches = (serve_launches["K1"] + aloha[True]["launches"]["K1"]
                   + aloha[False]["launches"]["K1"] + w4a16["K1"] + w4a8["K1"]
                   + sum(run["K1"] for run in int8_launches.values())
                   + sum(run["K1"] for run in diffusion.values())
                   + sum(run["K1"] for run in discrete.values()) + train_launches["K1"])
    kernels = [
        kernel_entry("flash_attention_fwd", "flash_attention_fwd.cu",
                     "openvla_oft_tpu/ops/flash_attention.py:50", k1_launches,
                     max(c["max_abs_err"] for c in checks.values()), libero["ms"],
                     libero["plain_ms"], libero["bound_ms"], libero["bound_by"],
                     libero["library_ms"],
                     library_call="SDPA with the boolean OFT mask (forward)",
                     plan=libero["plan"], hgmma=wgmma["K1"], timing=libero["timing"],
                     events_ms=libero["events_ms"],
                     library_events_ms=libero["library_events_ms"],
                     other_cases={n: {"ms": c["ms"], "library_ms": c["library_ms"],
                                      "bound_ms": c["bound_ms"], "timing": c["timing"]}
                                  for n, c in checks.items() if n != "libero_prefill"}),
        kernel_entry("flash_attention_dq", "flash_attention_bwd.cu",
                     "openvla_oft_tpu/ops/flash_attention.py:181", train_launches["K2"],
                     max(c["dq_err"] for c in bwd_cases.values()), tr["ms_dq"],
                     tr["plain_dq"], *tr["bound_dq"], tr["library_ms"],
                     library_call="SDPA's backward with the boolean OFT mask (dq, dk, dv)",
                     plan=tr["plan"], hgmma=wgmma["K2"], timing=tr["timing"],
                     events_ms=tr["events_dq"], library_events_ms=tr["library_events_ms"]),
        kernel_entry("flash_attention_dkv", "flash_attention_bwd.cu",
                     "openvla_oft_tpu/ops/flash_attention.py:207", train_launches["K3"],
                     max(c["dkv_err"] for c in bwd_cases.values()), tr["ms_dkv"],
                     tr["plain_dkv"], *tr["bound_dkv"], tr["library_ms"],
                     library_call="SDPA's backward with the boolean OFT mask (dq, dk, dv)",
                     plan=tr["plan"], hgmma=wgmma["K3"], timing=tr["timing"],
                     events_ms=tr["events_dkv"], library_events_ms=tr["library_events_ms"],
                     stats_pass_ms=bwd["stats"]["ms"]),
        kernel_entry("ln_matmul", "ln_matmul.cu", "openvla_oft_tpu/ops/vit_fused.py:47",
                     aloha_k4["K4"], max(c["max_abs_err"] for c in k4.values()),
                     fc1["dev_ms"], fc1["plain_ms"], fc1["bound_ms"], fc1["bound_by"],
                     fc1["dev_lib"], library_call="torch.matmul on the product alone",
                     unfused_ms=fc1["unfused_ms"], plan=list(fc1["plan"]), hgmma=wgmma["K4"],
                     timing=fc1["timing"], events_ms=fc1["ms"],
                     library_events_ms=fc1["library_ms"]),
        kernel_entry("int4_matmul", "int4_w4a16.cu", "openvla_oft_tpu/ops/int4_matmul.py:43",
                     w4a16["K5"] + diffusion["int4 W4A16"]["K5"]
                     + discrete["AR int4 W4A16"]["K5"],
                     max(c["err5"] for c in int4.values()), wqkv["dev5"],
                     wqkv["plain5"], *wqkv["bound5"], wqkv["dev_lib5"],
                     also_replaces="openvla_oft_tpu/ops/int4_matmul.py:199",
                     plan=list(wqkv["plan5"]), hgmma=wgmma["K5"], timing=wqkv["timing"],
                     events_ms=wqkv["ms5"], library_events_ms=wqkv["lib5"]),
        kernel_entry("int4_matmul_a8", "int4_w4a8.cu", "openvla_oft_tpu/ops/int4_matmul.py:432",
                     w4a8["K6"], max(c["err6"] for c in int4.values()), wqkv["dev6"],
                     wqkv["plain6"], *wqkv["bound6"], wqkv["dev_lib6"],
                     also_replaces="openvla_oft_tpu/ops/int4_matmul.py:527",
                     library_call="torch._int_mm on the unpacked int8 weight, no scales",
                     plan=list(wqkv["plan6"]), igmma=wgmma["K6"], timing=wqkv["timing6"],
                     events_ms=wqkv["ms6"], library_events_ms=wqkv["lib6"]),
        kernel_entry("int4_probe", "int4_probe.cu", "vla_scripts/exp_int4_probe.py:53",
                     probe["launches"], probe["max_abs_err"], probe["ms"], probe["plain_ms"],
                     probe["bound_ms"], probe["bound_by"], probe["library_ms"],
                     library_call="torch.matmul on the dequantized bf16 weight",
                     hgmma=wgmma["probe"], timing="device time (torch.profiler)",
                     shapes_t112=probe["modes"])]
    log(f"[launches] bf16 serving run: {serve_launches}; ALOHA serving runs: vit_fused "
        f"{aloha_k4}, unfused {aloha[False]['launches']}; int4 serving runs: W4A16 {w4a16}, "
        f"W4A8 {w4a8}; probe run: {probe['launches']}; training run: {train_launches}; "
        f"TINY_LLAMA request under auto: {tiny_launches}")
    log(f"[int8] launches of the int8 serving runs (3 requests each): load_in_8bit "
        f"{int8_launches['dynamic']}, with static scales {int8_launches['static']}, "
        f"load_vision_in_8bit {int8_launches['vision']}")
    log(f"[diffusion] launches of the diffusion runs: bf16 (3 requests) "
        f"{diffusion['bf16']}, int4 W4A16 (2 requests) {diffusion['int4 W4A16']}")
    log(f"[discrete] launches of the discrete runs: parallel bf16 (3 requests) "
        f"{discrete['parallel bf16']}, AR bf16 (3 x 7 and 2 x 56 tokens) {discrete['AR bf16']}, "
        f"AR int4 W4A16 (2 x 7) {discrete['AR int4 W4A16']}, AR int8 (1 x 7) "
        f"{discrete['AR int8']}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
