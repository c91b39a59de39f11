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
`openvla_oft_tpu_torch.training.finetune` (LoRA r=32: the L1 objective at
B=8, the diffusion and discrete objectives at B=8, OFT+ ALOHA with FiLM at
B=4, and L1 from a checkpoint dir), and the full-parameter scripts
`openvla_oft_tpu_torch.scripts.train` (the four freeze stages) and
`scripts.pretrain` (align, finetune on LLaVA-format data) at B=8, the
VLM REPL `scripts.generate`, and the robot eval clients (LIBERO, ALOHA,
UR5e-robosuite, Bridge) and the quickstart, and multi-GPU execution: the
CLI on a one-rank NCCL mesh and tp = 2 serving on two processes of the card.

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
     launches) and one with it off (device time by kernel class); then the
     joint ViT pair (`models/vit_joint.py`), built from the policy's folded
     pair and swapped in: the same observation served with each pair, one
     counted request each (K1 31, K4 0; the joint pair's batched products
     104 = 26 x 4, where the pair takes 4 x 49 = 196 products), the ViT
     stage and a request traced (device time, kernels), then 5 rounds that
     time each pair in turn, the ViT stage by CUDA events and the request by
     the host clock (medians, the idle share), the joint tree's GiB;
     the joint features and actions_hidden against the per-backbone ones
     (cosine >= 0.99);
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
     traced one, static against dynamic (logged); before them, the int8
     joint ViT pair: an unfolded bf16 pair drawn from seed 0 alone, its
     int8 joint tree (`quantize_joint_vit`) and its per-backbone int8 tree
     each swapped into the load_in_8bit policy, measured as in phase 5
     (341 int8 products a request with the joint pair: 130 + 26 x 4 x 2 +
     3, against 329), held to each other (cosine >= 0.99);
     `load_vision_in_8bit`, 3 requests (199 int8 products each) and a
     traced one;
  8c. (this phase and 8d serve the flagship with its Llama cut to 2 of 32
     layers, every width kept: `cut_serving_flagship`; the counts below are
     those of a cut to 8 layers, and the per-layer ones scale with the cut) diffusion serving: `flagship_policy(head="diffusion")` (LIBERO, 50
     DDIM steps, the [BOS][patches][proprio] prefix K/V computed once, each
     step a 105-row suffix forward against 514 + 105 keys): build memory, 3
     `predict_action` requests on pixels from `device_preprocess` (K1 8
     each, the prefix prefill; K4/K5/K6 0), one traced (device time by
     class, idle share), wall and device time per chunk and per step; on
     the card the prefix K/V through K1 against the dense path, one suffix
     step against `predict_action_hidden`, the loop at 5 steps prefix-KV
     against full prefill and split-KV against concatenation (cosine >=
     0.99 each); then rebuilt with `load_in_4bit`: 2 requests (K5 32 +
     50 x 8 x 4 = 1,632 each), one traced, the prefix (T = 514) and one
     step (T = 105) through K5 against K5's plain version (cosine >= 0.99);
  8d. discrete decoding: `flagship_policy(head="discrete")` (LIBERO): 3
     `predict_action` requests (K1 7 each; K4/K5/K6 0), the action-row
     logits through K1 against dense (cosine >= 0.99, argmax agreement
     logged), the lm_head product (`torch.mm(..., out_dtype=float32)`)
     against the fp32 product of the same bf16 values (max|d| <= 1e-4 of
     max|ref|); base OpenVLA on the same tree at 1 image (bucket 48, 24
     real tokens, S = 304): `predict_action_autoregressive`, 3 requests of 7
     tokens and 2 of 56 (K1 8 each, the prefill), the cached decode against
     a no-cache forward over the same tokens (dense both, cosine >= 0.999),
     the prefill through K1 against dense (cosine >= 0.99), one request
     traced (device time by class, kernels a token, idle share); rebuilt
     with `load_in_4bit`: 2 requests of 7 tokens (K5 32 + 6 x 32 = 224
     each), one traced, one decode step through K5 against its plain version
     (cosine >= 0.99); with `load_in_8bit`: one request (the ViTs' and
     projector's int8 products and 4 x 8 a token, one padded row per
     product in each step); `bench_ar` in bf16
     and with `--quant int4` (its 7-token, 56-token and parallel rows);
  8e. checkpoint: the flagship's widths with its Llama cut to 2 of 32 layers
     (registered as "llama2-7b-pure-2l"; both ViTs at full depth; phase 20
     (e) round-trips all 32), seeded
     bf16 weights exported by `utils/hf_import.py::export_openvla_checkpoint`
     into a temporary dir with `dataset_statistics.json`, the L1 head's and
     the proprio projector's `.pt` files and a synthetic Llama-like
     `tokenizer.model` (32,000 pieces, BPE, byte fallback); the dir loaded
     on the card by `load_openvla_checkpoint` (leaf for leaf bitwise equal
     to the exported tree; the host's resident set sampled during the load)
     and served by the deploy CLI's `OpenVLAServer` (`get_vla`,
     `device_preprocess`, LIBERO, bucket 64, S = 634): 3 /act requests (K1
     1 each), bitwise equal to an in-memory policy built from the same seed
     with `serving_params`; one request to the deploy CLI (`python -m
     openvla_oft_tpu_torch.serving.deploy --pretrained-checkpoint DIR
     --unnorm-key K --device-preprocess`) in a process of its own, and one
     to a second CLI without `--device-preprocess` (the CLI's default, the
     staged path; phase 8f (c)), both started at once and stopped after
     their request; the device peak of the build from disk against
     the build from seeded weights; then `load_in_4bit`, one request (K5
     10); bytes, write and load seconds, load GB/s, host and device peaks,
     the warm-up and each request's time; the dir removed;
  8f. staged serving, the reference's eval conditioning on the card (run
     inside phases 5, 8c, 8d and 8e, on their policies): (a) after phase 5,
     the JPEG round trip (`processing/jpeg.py`) on every frame of
     `tests/goldens/jpeg_tf_q95.npz`, bitwise equal to TF's stored round
     trips and to its CPU run, two CUDA calls bitwise equal, its kernels and
     time per 256 x 256 frame, LIBERO request and ALOHA request; (b) the
     flagship L1 (after phase 5), diffusion (8c, bf16) and discrete (8d)
     policies through `get_vla_action` with `device_preprocess=False`: 2
     requests each (K1 31 / 32 / 31), one /act through an `ActionServer`
     whose predict makes that call, bitwise equal to the in-process answer
     (the diffusion generator reseeded); for L1 the same observations
     through the `device_preprocess` route, and each route's conditioning
     alone, timed; (c) in phase 8e, the deploy CLI without
     `--device-preprocess`, bitwise equal to `OpenVLAServer.predict` in
     process;
  9. backward kernel check: K2 (dq) and K3 (dk, dv) against their plain
     version at the training shape (B=8, per-row pads and windows), ALOHA's
     training shape (B=4, S=1137, 351-slot windows), the ALOHA length, GQA
     and dead rows, two calls of each bitwise equal, with
     their plan; device times (torch.profiler, L2 flushed) beside SDPA's
     backward kernels alone and the bound, CUDA events beside them; the
     stats rows K2 writes against the stats pass and the plain LSE, delta;
 10. training (this phase, 11, 12, 11b, 13, 14 and 15 run random:7b with
     its Llama cut to 2 of 32 layers, every width kept: `cut_flagship`): 3
     steps of the fine-tuning CLI at B=8 (remat "all": K1 2n, K2 n and K3 n
     launches per step at n layers; the counts named below are those of 4), loss, grad norm, step time, peak memory, no stats
     pass (K3 reads K2's stats rows), every step's metrics logged for phase
     19; the run is phase 18 (a)'s run without a mesh;
 11. step profile: the CLI's train_step on its final state and first batch,
     3 steps timed, then one traced with torch.profiler (device activity
     only): device time by kernel class, K1's and K2 + K3's shares, the idle
     share;
 12. training-path parity: one loss and backward through K1/K2/K3 against
     the dense path on the same weights and batch;
 11b. (run after 12, which needs phase 10's state) the other objectives
     through the same CLI, 3 steps each, every step K1 8, K2
     4, K3 4, each run's step times, peak memory and every trainable
     group moving, then its K1/K2/K3 path against the dense path on the same
     weights, batch and draws (phase 12's bounds): (a) diffusion, B=8,
     S=586, 50 DDIM steps, the sampling metric at step 3 (K1 200 more, no
     K2/K3, finite); (b) discrete, B=8, and the lm_head product's backward
     on the card against its float64 product; (c) OFT+ ALOHA (FiLM, 3
     images, B=4, S=1137; the parity with every target at 10, so that the
     L1 gradient's signs do not flip with bf16 noise); (d) inside phase 8e,
     before its dir is removed: L1 from the dir (K1 8, K2 4, K3 4 a step),
     the trained base bitwise equal to the exported tree, and a discrete
     run from the dir, which has no lm_head, raising on its name before any
     step.
 13. the episode data path (after 11b): (a) the host library (the JPEG
     decoder, augmentation and CRC-32C, `hostsrc/`) built with the host's
     C++ compiler;
     (b) both JPEG decoders, the host library's and the plain one, bitwise
     against TF's pixels on every entry of `tests/goldens/jpeg_decode_tf.npz`,
     and the library's augmentation against its numpy plain version;
     (c) a raw LIBERO dataset written in RLDS shards by the port's writer
     (`libero_spatial_no_noops`, 24 episodes of 40-60 steps, two cameras of
     the golden's 256 x 256 frames); (d) the loader alone, image_aug off and
     on: frames/s, decode and augmentation ms a frame, the resident set with
     a 10,000-frame buffer; (e) the CLI at random:7b on it (B=8, 2 images,
     proprio, L1, image_aug, 4 steps, validation every 2): K1 8, K2 4, K3
     4 a step and K1 4 a validation batch with no K2/K3, the step times
     beside phase 10's, val_loss finite, peak memory, the run dir's
     statistics the pipeline's; one step traced fed by the prefetcher, with
     its idle share; (f) the dataset removed.
 14. (after 13) the rest of the
     fine-tuning CLI: (a) QLoRA int8 (B=8, remat
     "all", 3 steps): the int8 products a step against the count from the
     widths (the forward's and its recompute's), K1/K2/K3 twice and once
     the layers a step, the step times, the peak beside phase 10's, and one loss and backward
     against the plain int8 product (float64) within phase 12's bounds; (b)
     QLoRA int4 at B=1 (K5 in every int4 linear, counted alike) against
     `int4_matmul_ref`, then B=8 (the dequant path, 2 steps), K5 at the
     LLM's training shapes (T = 585) beside torch.matmul, and the dequant
     products' share of the B=8 step; (c) the remat policies "all",
     "dots", "attn_out", "none" at B=8 from the same weights and batch: the
     loss and gradients bitwise those of "all", the launches, median time
     and peak of each; (d) (inside phase 8e, on its 2-layer dir) the CLI
     with the merged export every 2 steps: the `--2_chkpt` and `--3_chkpt`
     dirs, the re-imported `.pt` files bitwise the trained state, `/act` on
     the merged dir (get_vla) bitwise the in-memory merge, a resume from
     step 2 to 4 with the restored state bitwise the saved one, the save's
     host snapshot and background write; (e) SIGTERM at the third
     micro-step: a checkpoint at 3, final_step 3, the handler restored, a
     resumed run to step 4 (one step).
 15. (after 14) full-parameter training and VLM pretraining, each run at
     random:7b's full width (the Llama at 2 layers), B=8, 3 steps, through
     the scripts' entry points: (a) both JPEG decoders with the ISLOW inverse DCT bitwise
     PIL's pixels on every entry of `tests/goldens/jpeg_decode_pil.npz`;
     (b), (c) `scripts/pretrain.py` align and finetune on a LLaVA JSON of
     32 records whose images are the two JPEG goldens' bytes (seq_bucket
     128: S = 384); (d) `scripts/train.py`'s four stages on dummy LIBERO
     data. Each run: K1 8, K2 4, K3 4 a step (twice and once the 4
     layers), the step times, the peak, the optimizer's share of a step,
     every trainable group moved (the share of sampled entries that
     changed), every frozen leaf bitwise its value before the first step,
     its checkpoint saved and restored bitwise; (e) vla-full-train's
     loss and backward through K1/K2/K3 against the dense path (phase 12's
     bounds, the cosine over all trainables and per group); (f)
     `scripts/generate.py` at random:7b with the stand-in tokenizer: one
     prompt on its input stream, 8 new tokens, K1 32 in the prefill.
 16. (after 15) Phi-2 as the VLA's LLM and the TFDS-format data path: the
     `phi-2+3b` model (CLIP ViT-L/14 at 336 px, Phi-2) at full width with
     its LLM cut to 2 of 32 layers (`cut_llm`), seeded bf16 weights drawn on the card
     (`bridge.init_params`), LIBERO's geometry (2 images, bucket 48, S =
     1,258): (a) the L1 head through `predict_action_from_frames` with
     `vit_fused` off and on (K4 46 a request at CLIP's qkv and fc1, which
     phase 3 checks at those shapes; no K1: Phi-2 takes the dense
     attention), the K4 path against the unfused one (cosine >= 0.99); the
     diffusion head, 50 DDIM steps through the full-prefill route (50
     `predict_action_hidden` calls a chunk, no prefix K/V); the discrete
     head; the AR decode at 1 image, 7 tokens, its cached logits against a
     no-cache forward (cosine >= 0.999, argmax equal); the L1 head with
     `load_in_4bit` (all 6 x 8 LLM linears int4): one request at 2 images
     (S = 1,258, above FUSED_MAX_ROWS: the dequant path, no K5) and one at
     1 image (S = 682: K5 48 a request), the K5 path against the plain
     one (cosine >= 0.99), then K5 against int4_matmul_ref at Phi-2's wq,
     fc1 and fc2 at those rows and at T = 1; each with its times, peak and
     a traced request's idle share; (b) the tree written as an HF
     Phi checkpoint dir (2 GB shards, a 51,200-piece
     `tokenizer.model`), loaded bitwise equal; 3 LoRA L1 steps of the
     fine-tuning CLI from the dir at B = 8 (LoRA on wq/wk/wv/wo only, the
     frozen base bitwise the dir's), one traced; `scripts/pretrain.py
     --stage align` from the dir (3 steps, phase 15's LLaVA JSON, saved and
     restored bitwise); `scripts/generate.py` on the dir (the Phi prompt
     builder, 8 tokens); (c) two TFDS-layout datasets in raw LIBERO's
     features (`libero_spatial_no_noops`, `libero_object_no_noops`),
     converted by `data/rlds/tfds_format.py::convert_tfds_to_native`, mixed
     0.7 / 0.3 by `make_interleaved_iterator` (frames/s alone; each share
     within 0.05 of its weight over 2,000 frames), then 3 L1 LoRA steps of
     the CLI at random:7b cut to 2 layers (`cut_flagship`), B = 8, fed by
     the mixture: K1 4, K2 2, K3 2 a step.
 17. (after 16) the robot eval clients of `openvla_oft_tpu_torch/experiments/`
     and the quickstart, each through its own entry point at random:7b in
     bf16, on scripted stand-in environments that replay frames and states
     drawn from seed 0 (what a client builds itself, the WidowX client and
     `input()`, patched from outside its module): (a)
     `scripts/quickstart.py::main` on the committed LIBERO fixture (2
     queries); (b) one LIBERO spatial episode through
     `run_libero_eval.run_episode` (10 settle steps, 220 of the policy's, 28
     queries of 8), its rollout written as PNG frames by the port's writer
     with imageio hidden and read back; (c) one ALOHA episode through
     `run_aloha_eval.run_episode` against phase 5a's deployment (3 cameras,
     FiLM, `vit_fused`) behind the deploy CLI's warmed-up /act server (50
     steps at 25 Hz, 2 queries of 25, 480 x 640 frames resized on the
     card); (d) one UR5e episode through `run_robosuite_eval.run_episode`
     (the 200 x 360 front camera cropped and resized, 40 steps, 5 queries
     of 8); (e) `run_bridgev2_eval.eval_bridge`, the discrete head, 1
     episode of 10 queries whose 5 actions go to the arm at 5 Hz. Each
     client: K1 31 a query (and K4 98 for ALOHA), every stepped action
     bitwise equal to what `get_vla_action` (or the server) gives on the
     same observation followed by the client's own action processing, the
     episode's wall time and its queries' median on the host clock.
 18. (after 17) multi-GPU execution (`openvla_oft_tpu_torch/parallel/`) on
     the one card: (a) the fine-tuning CLI at phase 10's cut and flags with
     `--multihost True` on a one-rank NCCL group, against phase 10's run (every leaf a DTensor on the (1, 1, 1) mesh):
     losses and trainables bitwise equal (else within phase 12's bounds),
     K1 8, K2 4, K3 4 a step, the step times side by side (the DTensor
     overhead); then `flash_attention_tp` on the one-rank tp mesh at the
     training shape, K1 forward and K2/K3 backward under `local_map`,
     bitwise the unsharded call; (b) tp = 2 serving of the flagship on the
     one card: two processes on cuda:0 in a gloo group (NCCL refuses two
     ranks on one device), `flagship_policy(tp_mesh=...)`, 2 requests each
     through `predict_action_from_frames`, K1 31 a request over 16 of the 32
     heads a rank; the actions_hidden cosine against the one-rank policy
     (phase 5's bound), both ranks' answers equal, each rank's weights and
     peak memory; the request times are this harness's cost only (gloo
     stages every collective through the host); (c) in the same two
     processes, quantized tp = 2 serving of the flagship (both (b) and (c)
     with its Llama cut to 2 of 32 layers, `cut_serving_flagship`
     in the parent and in each rank; the counts here are at 32
     layers, and a cut of n takes n - 1 K1 and 4 n K5 + K5s or K6 + K6s a
     request and 4 (32 - n) fewer int8 products: at 2, K1 1, 8 and 207): the bf16
     policy with `vit_fused` (K4 98 a request on each rank's column blocks),
     `load_in_4bit` W4A16 and W4A8 (K5 + K5s or K6 + K6s 128 a request: the
     out_window layer projects wqkv once over its tp columns, where one rank
     takes q, k and v apart) and `load_in_8bit` (327 int8 products a
     request, 2 fewer than phase 8b for the same reason), 1 request each,
     K1 31 a request a rank; each variant's actions_hidden cosine against
     the same variant on one rank (phase 5's bound), both ranks' answers
     equal, the weights, peak and collectives a rank; on each rank one K5
     and one K6 launch at the local down shape (T = 618, K = 5,504) against
     their plain versions; then, in the parent alone on the card, K4, K5
     and K6 timed at tp = 2's local shapes beside their bounds and the
     library call; (e) (after 19) the 7B memory audit
     (`scripts/dryrun_multichip.py::audit_7b_memory`, on meta tensors, no
     process group): the flagship LoRA train state's GB a device at n = 1
     and at each n = 8 factorization, against this card's memory, and the
     share of big arrays the rules split (the dryrun's (a)-(c) are a CPU
     harness: tier-1 runs them); (d) QLoRA through the CLI on the one-rank NCCL mesh
     (`--quantize_base`, bits 8 at B = 8 and bits 4 at B = 1, phase 14's cut
     and flags, 3 steps): losses and trainables bitwise equal to phase 14's
     runs without a mesh (else within phase 12's bounds), the int8 products
     and K5 launches a step as phase 14's, K1 2n, K2 n, K3 n at n layers.
 19. (after 18) the run tools: `scripts/verify_openvla.py` at random:7b
     (`zero_init`), 5 calls of the staged `predict_action`, bf16 and then
     `--quant int8` (the LLM W8A8): p50, p90 and the launches a call;
     `scripts/summarize_run.py` on phase 10's metrics JSONL (the CLI run
     with `--wandb_log_freq 1`), its summary JSON printed.
 20. (after 19) image files, the JPEG encoder, the data scripts and the
     converter's round trip at full depth: (a) the JPEG decoders, host
     library and plain, on every stream of `tests/goldens/image_modes.npz`
     (PIL's progressive, restart, optimize, grey, 4:2:2, 4:4:4 and CMYK
     streams; 4:1:1, 4:4:0, 3:1, mixed samplings, YCCK, Adobe RGB and RGB
     by ids from the port's encoder; progressive streams cut after their
     early scans, which smooth), ISLOW bitwise PIL's pixels and IFAST TF's,
     the host library's ms a 256 x 256 frame of the synthetic set under
     ISLOW and IFAST; the PNG decoder on every colour type
     and depth, plain and interlaced, bitwise PIL's; (b)
     `scripts/generate.py` at random:7b on a progressive JPEG and on a PNG
     of the golden, K1 32 in each prefill; (c)
     `scripts/make_synthetic_rlds.py` at its defaults (48 episodes of 64
     to 71 steps at 256 x 256, frames through the host encoder): frames/s
     encoded, held to `tests/goldens/synthetic_rlds.npz`, the JAX script's
     set (every frame and all but the floats bitwise, the actions within 1
     ULP of NumPy's float32 sine, the proprio their running sum), then the
     fine-tuning CLI on it at phase 10's cut (1 image; phase 13 keeps its
     own set, whose name takes the OXE registry's LIBERO transform, which
     the synthetic set, marked standardized, skips), K1 8, K2 4, K3 4 a
     step; (d) `scripts/make_quickstart_fixture.py`,
     its object bitwise the committed pickle; (e)
     `scripts/exp_roundtrip_7b.py --scale 7b`: the 32-layer tree drawn on
     the card, its action chunk (K1 31), exported, freed, loaded back, every
     leaf bitwise the tree drawn again and the chunk bitwise the first:
     bytes, the write's seconds, the load's GB/s and the host's peak
     resident set.
 21. (after 20) the bench contract, its aids and the launchers
     (`openvla_oft_tpu_torch/scripts/bench*.py`, `scripts/*.sh`): (a), (b)
     one request of the bench's timed call (`bench_entry.entry`: the
     flagship's zero tree at full width and depth, LIBERO) per config,
     counted: bf16 K1 31 (and 31 K1 kernels in a torch.profiler trace of
     one more request, or "not measured" where the window is empty), the
     JAX bench's int4 tree (LLM int4, projector and ViTs int8) K5 + K5s 130
     and int8 199 a request, with `int4_a8` K6 + K6s 130; then, one after
     the other in one process of their own (started beside the counted
     requests, its timed loops after them): (a), (c) `bench --extra` (its
     one stdout line: the four keys, value > 0, vs_baseline = round(0.109 /
     value, 3); its bf16 and int8 stderr lines; the four extra rows, ALOHA
     bf16 and int8, diffusion int8 and int4a8 at --k 4, each in its own
     process), (b) `bench --quant int4` and `--quant int4 --int4-a8`, their
     lines checked the same way, (d) `bench_components --flash
     --vit-fused`, 11 rows (the joint ViT pair's among them), and (f) `bench_data` at its defaults, its
     pipeline line; (e) `bench_deploy --model 7b --n 10 --no_server` with
     `--quant bf16` and `int8`, each JSON summary, against the deploy CLI
     on the zero tree (bench_deploy's server command), both servers started
     beside (g) `scripts/finetune.sh random:7b` with EXTRA_ARGS for 2 steps
     at B = 8, the Llama cut to phase 10's layers (a `python` on PATH for
     the launcher that applies `cut_flagship`), K1 2n, K2 n, K3 n a step at
     n layers. Every process that exits non-zero fails the phase.
Each phase's host time is logged as `[phase-time]`, and all of them after
phase 21.
Every serving phase but the first builds its server with the deploy CLI's
warm-up (one synthetic predict before it binds) and logs the warm-up's time
and the first request after it. The line before the last is a JSON object
with one entry per kernel; the last line is {"ok": true, "device": {...}}.
"""

import builtins
import contextlib
import dataclasses
import gc
import json
import os
import re
import threading
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

T_START = time.perf_counter()

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
# Phase 11b's runs of the same CLI (later flags override earlier ones): the
# diffusion objective (the oft-libero-spatial-diffusion recipe's flags, 50
# DDIM steps, the sampling metric at the third step), the discrete CE, and
# OFT+ ALOHA (the oft-plus recipes' flags with their per-GPU batch, 4).
DIFFUSION_STEPS = 50
OBJECTIVE_RUNS = {
    "diffusion": TRAIN_FLAGS + ["--use_l1_regression", "False", "--use_diffusion", "True",
                                "--num_diffusion_steps", str(DIFFUSION_STEPS),
                                "--diffusion_sample_freq", "3"],
    "discrete": TRAIN_FLAGS + ["--use_l1_regression", "False"],
    "aloha_film": TRAIN_FLAGS + ["--dataset_name", "aloha_scoop_x_into_bowl",
                                 "--robot_platform", "aloha", "--use_film", "True",
                                 "--num_images_in_input", "3", "--batch_size", "4",
                                 "--num_steps_before_decay", "50000"],
}
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
# Phase 16's CLIP ViT-L/14 at 336 px (LIBERO: 2 images of 577 tokens, width
# 1024): qkv with no activation, fc1 with quick-GELU.
K4_CLIP = [("CLIP-336 qkv LIBERO", 1154, 1024, 3072, None),
           ("CLIP-336 fc1 LIBERO", 1154, 1024, 4096, "quick_gelu")]
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
        # a checkpoint served through get_vla: the reference's bucket of 64
        ("checkpoint_prefill", 1, 634, 32, 32, 128, [(34, 634, 577, 57)]),
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


def start_parts_builds(pool) -> dict:
    """The parts scripts' builds (each one nvcc of its own source) started
    in `pool`, beside the kernels' build: {script module: future}."""
    from openvla_oft_tpu_torch.scripts import exp_fwd_parts, exp_k4_parts

    return {m: pool.submit(m.build_parts) for m in (exp_k4_parts, exp_fwd_parts)}


def k1_parts_phase(card: str, built) -> dict:
    """The script exp_fwd_parts: K1's variants at S = 618, 1168 and the
    training batch, and the sweep over masks (it prints its own lines), on
    its library built by `start_parts_builds`."""
    from openvla_oft_tpu_torch.scripts import exp_fwd_parts

    t0 = time.perf_counter()
    with patched(exp_fwd_parts, "build_parts", built.result):
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
    for name, m, d, n, act in K4_SHAPES + K4_EXTRA + K4_CLIP:
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


def k4_parts_phase(card: str, built) -> dict:
    """The script exp_k4_parts: K4's variants at DINOv2 fc1 ALOHA, then every
    compiled tile at the 8 ViT shapes (it prints its own lines), on its
    library built by `start_parts_builds`."""
    from openvla_oft_tpu_torch.scripts import exp_k4_parts

    t0 = time.perf_counter()
    with patched(exp_k4_parts, "build_parts", built.result):
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
    # T: the L1 prefill (618; 634 at the bucket of 64 a loaded checkpoint
    # serves with), the diffusion prefix (514), the AR prefill (304), the
    # out_window layer (57) and one AR decode step (1).
    cases = [(f"{name} T={t}", t, k, n, "whole") for t in (634, 618, 514, 304, 57, 1)
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
    for name, row in joint_vit_int8(policy, obs, card).items():
        runs[f"joint-vit {name}"] = row["launches"]

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


JOINT_RUNS = 3           # rounds of the ViT stage and the request, each path in turn


def joint_expect(cfg, int8: bool) -> dict:
    """The launches of one LIBERO request with the per-backbone ViT pair and
    with the joint one (`models/vit_joint.py`): K1 31 and K4 0 both ways;
    the joint pair's batched products (`grouped_mm`) 4 a joint layer in
    bf16 (26 x 4 = 104, where the pair takes 4 x (23 + 26) = 196 products),
    none in int8, where each group's product is one int8 product (26 x 4 x
    2 = 208, where the pair takes 196: 341 a load_in_8bit request against
    329)."""
    n_joint = max(v.depth - 1 for v in cfg.vision_configs)
    base = {"K1": cfg.llm.num_layers - 1, "K4": 0, "K5": 0, "K6": 0}
    if not int8:
        return {"per-backbone": {**base, "int8": 0, "batched": 0},
                "joint": {**base, "int8": 0, "batched": 4 * n_joint}}
    pair = int8_per_request(cfg, True)
    return {"per-backbone": {**base, "int8": pair, "batched": 0},
            "joint": {**base, "int8": pair - 4 * sum(v.depth - 1 for v in cfg.vision_configs)
                      + 4 * n_joint * 2, "batched": 0}}


def tree_gib(tree) -> float:
    from openvla_oft_tpu_torch.bridge import tree_leaves

    return nbytes(*tree_leaves(tree)) / 2**30


def vit_paths(policy, obs, trees: dict, label: str, expect: dict, card: str) -> dict:
    """The same LIBERO observation served with each of `trees` ({"per-backbone":
    ..., "joint": ...}) as the policy's vision tree: one counted request
    (`expect[name]`, the joint's batched products as "batched"), the ViT
    stage alone and one request traced (device time, kernels, GEMM
    kernels), actions_hidden; then JOINT_RUNS rounds that time, path after
    path, the ViT stage by CUDA events and the request by the host clock
    (medians; the idle share from the traced device time). The joint answer
    is held to the per-backbone one (cosine >= PARITY_COSINE, phase 5's
    bound). The policy's own vision tree is put back after."""
    from openvla_oft_tpu_torch.models import vit_joint as VJ
    from openvla_oft_tpu_torch.models.vision_backbone import vision_backbone_forward

    own = policy.params["vision_backbone"]
    inputs = model_inputs(policy, obs)
    pixels = inputs[3].to(policy.params["llm"]["embed"]["embedding"].dtype)
    frames = frames_of(policy, obs)

    def request():
        policy.predict_action_from_frames(frames, obs["instruction"], proprio=obs["state"])

    def vit():
        with torch.inference_mode():
            return vision_backbone_forward(policy.params["vision_backbone"], policy.cfg, pixels)

    out = {}
    try:
        for name, tree in trees.items():
            policy.params["vision_backbone"] = tree
            reset_launch_counts()
            VJ.grouped_mm.launches = 0
            request()
            torch.cuda.synchronize()
            launched = {k: n for k, n in launch_counts().items() if k in expect[name]}
            launched["batched"] = VJ.grouped_mm.launches
            if launched != expect[name]:
                raise AssertionError(f"a {label} request with the {name} ViT pair launched "
                                     f"{launched}, expected {expect[name]}")
            _, vit_n, vit_busy, vit_classes = trace(vit)
            _, req_n, req_busy, _ = trace(request)
            out[name] = {"launches": launched, "vit_device_ms": vit_busy, "vit_kernels": vit_n,
                         "vit_gemm_kernels": {c: vit_classes[c][1]
                                              for c in ("bf16 GEMM", "int8 GEMM")
                                              if c in vit_classes},
                         "request_device_ms": req_busy, "request_kernels": req_n,
                         "features": vit().float(), "hidden": actions_hidden(policy, inputs),
                         "vit": [], "request": []}
        for _ in range(JOINT_RUNS):
            for name, tree in trees.items():
                policy.params["vision_backbone"] = tree
                out[name]["vit"].append(cuda_time_ms(vit, iters=1, warmup=0))
                out[name]["request"].append(timed(request))
    finally:
        policy.params["vision_backbone"] = own

    def shown(v, fmt):
        return "not measured" if v is None else format(v, fmt)

    for name, row in out.items():
        row["vit_ms"], row["request_ms"] = (float(np.median(row[k])) for k in ("vit", "request"))
        row["idle"] = None if row["request_device_ms"] is None else \
            1 - row["request_device_ms"] / row["request_ms"]
        log(f"[joint-vit] {label} {name}: launches a request {row['launches']}; the ViT stage "
            f"{row['vit_ms']:.3f} ms (CUDA events, median of {JOINT_RUNS}: "
            f"{', '.join(f'{t:.1f}' for t in row['vit'])}), device "
            f"{shown(row['vit_device_ms'], '.3f')} ms over {row['vit_kernels']} kernels, GEMM "
            f"kernels {row['vit_gemm_kernels']}; the request {row['request_ms']:.2f} ms (host "
            f"clock, median of {JOINT_RUNS}: {', '.join(f'{t:.1f}' for t in row['request'])}), "
            f"device {shown(row['request_device_ms'], '.2f')} ms over {row['request_kernels']} "
            f"kernels, idle share {shown(row['idle'], '.3f')} ({card})")
    pb, jt = out["per-backbone"], out["joint"]
    cos_f, cos_h = cosine(jt["features"], pb["features"]), cosine(jt["hidden"], pb["hidden"])
    log(f"[joint-vit] {label}: joint against per-backbone (timed in turns): vision features "
        f"cosine {cos_f:.6f}, max|d| {(jt['features'] - pb['features']).abs().max().item():.4e}; "
        f"actions_hidden cosine {cos_h:.6f}; the ViT stage {jt['vit_ms'] / pb['vit_ms']:.3f}x "
        f"by CUDA events, the request {jt['request_ms'] / pb['request_ms']:.3f}x by the host "
        f"clock ({card})")
    if not (cos_f >= PARITY_COSINE and cos_h >= PARITY_COSINE):
        raise AssertionError(f"the {label} joint ViT pair disagrees with the per-backbone pair")
    for row in out.values():
        del row["features"], row["hidden"]
    return out


def joint_vit_bf16(policy, obs, card: str) -> dict:
    """Phase 5's joint pair: the joint tree built from the live bf16
    policy's folded per-backbone tree, both served (`vit_paths`)."""
    from openvla_oft_tpu_torch.models.vit_joint import joint_vision

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    joint = joint_vision(policy.params["vision_backbone"], policy.cfg.vision_configs,
                         int8=False)["joint"]
    torch.cuda.synchronize()
    log(f"[joint-vit] bf16: the joint tree built from the policy's folded pair in "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms: its layers {tree_gib(joint['layers']):.3f} GiB "
        f"against the pair's {tree_gib(policy.params['vision_backbone']):.3f} GiB (the front "
        f"ends shared); {(torch.cuda.memory_allocated() - before) / 2**30:.3f} GiB allocated "
        f"by the build ({card})")
    out = vit_paths(policy, obs, {"per-backbone": policy.params["vision_backbone"],
                                  "joint": {"joint": joint}}, "bf16",
                    joint_expect(policy.cfg, False), card)
    del joint
    torch.cuda.empty_cache()
    return out


def joint_vit_int8(policy, obs, card: str) -> dict:
    """Phase 8b's joint pair: the unfolded bf16 ViT pair drawn from seed 0
    alone, then its int8 joint tree (`quantize_joint_vit`) and its
    per-backbone int8 tree (`quantize_tree_lowmem`, as `load_in_8bit`), each
    swapped into the load_in_8bit policy's vision tree (`vit_paths`)."""
    from openvla_oft_tpu_torch.bridge import init_params
    from openvla_oft_tpu_torch.models.vit import fuse_vit_inference_weights
    from openvla_oft_tpu_torch.models.vit_joint import joint_vision
    from openvla_oft_tpu_torch.ops.quant import quantize_tree_lowmem
    from openvla_oft_tpu_torch.serving.deploy import QUANT_MIN_DIM

    t0 = time.perf_counter()
    pair = init_params(policy.cfg, policy.platform, torch.Generator(device="cuda").manual_seed(0),
                       device="cuda", dtype=torch.bfloat16, keys=("vision_backbone",))
    unfolded = {name: fuse_vit_inference_weights(v, fold_norms=False)
                for name, v in pair.pop("vision_backbone").items()}
    joint = joint_vision(unfolded, policy.cfg.vision_configs, int8=True)["joint"]
    per_backbone = quantize_tree_lowmem(unfolded, min_dim=QUANT_MIN_DIM)
    torch.cuda.synchronize()
    log(f"[joint-vit] int8: the seeded unfolded pair drawn and quantized both ways in "
        f"{time.perf_counter() - t0:.2f} s: the joint tree's layers "
        f"{tree_gib(joint['layers']):.3f} GiB, the per-backbone tree "
        f"{tree_gib(per_backbone):.3f} GiB ({card})")
    out = vit_paths(policy, obs, {"per-backbone": per_backbone, "joint": {"joint": joint}},
                    "int8", joint_expect(policy.cfg, True), card)
    del joint, per_backbone
    torch.cuda.empty_cache()
    return out


def audit_phase(card: str) -> dict:
    """Item 34's 7B memory audit (`scripts/dryrun_multichip.py::
    audit_7b_memory`): the flagship LoRA train state on meta tensors, its GB
    a device at n = 1 and at each n = 8 factorization, against this card's
    memory."""
    from openvla_oft_tpu_torch.scripts.dryrun_multichip import (audit_7b_memory,
                                                                card_memory_gb,
                                                                flagship_train_state)

    budget = card_memory_gb()
    log(f"[7b-audit] budget: this card's memory, {budget:.2f} GB (2**30 bytes; {card})")
    state = flagship_train_state()
    return {n: audit_7b_memory(n, budget, state) for n in (1, 8)}


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
        if not quant:
            runs["staged bf16"] = staged_serving(policy, card, rng, expect)
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


# === Phase 8f: the staged eval conditioning on the card ===
JPEG_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "goldens",
                           "jpeg_tf_q95.npz")


def jpeg_check(card: str) -> None:
    """Phase 8f (a): the JPEG round trip (`processing/jpeg.py`) on the card.
    Every frame of `tests/goldens/jpeg_tf_q95.npz` through the codec on CUDA
    bitwise equal to TF's stored round trip and to the codec's CPU run, two
    CUDA calls bitwise equal; then its kernels and time per 256 x 256 frame,
    per LIBERO request (2 x 256 x 256) and per ALOHA request (3 x 224 x
    224): CUDA events around the call (host launches included: the card
    waits on them), the device time of its kernels (torch.profiler) and
    the host clock."""
    from openvla_oft_tpu_torch.processing.jpeg import jpeg_roundtrip

    stored = np.load(JPEG_GOLDEN)
    names = [k[len("frame_"):] for k in stored.files if k.startswith("frame_")]
    for name in names:
        frame = torch.from_numpy(stored["frame_" + name])[None]
        got, again = jpeg_roundtrip(frame.cuda()), jpeg_roundtrip(frame.cuda())
        if not np.array_equal(got[0].cpu().numpy(), stored["tf_" + name]):
            raise AssertionError(f"the codec on the card differs from TF's round trip of {name}")
        if not torch.equal(got.cpu(), jpeg_roundtrip(frame)) or not torch.equal(got, again):
            raise AssertionError(f"the codec's CUDA runs of {name} differ from its CPU run "
                                 "or from each other")
    log(f"[jpeg] the codec on the card: {len(names)} golden frames ({', '.join(names)}) "
        "bitwise equal to TF's stored round trips (quality 95) and to the codec's CPU run; "
        "two CUDA calls bitwise equal")
    rng = np.random.default_rng(0)
    for label, n, hw in (("one 256x256 frame", 1, (256, 256)),
                         ("LIBERO request, 2 x 256x256", 2, (256, 256)),
                         ("ALOHA request, 3 x 224x224", 3, (224, 224))):
        x = torch.from_numpy(rng.integers(0, 256, (n, *hw, 3), dtype=np.uint8)).cuda()
        ms = cuda_time_ms(lambda: jpeg_roundtrip(x), iters=20, warmup=3)
        host = float(np.median([timed(lambda: jpeg_roundtrip(x)) for _ in range(5)]))
        _, kernels, busy, _ = trace(lambda: jpeg_roundtrip(x))
        dev = "not measured" if busy is None else f"{busy:.4f} ms"
        log(f"[jpeg] {label}: {kernels} kernels a call; {ms:.3f} ms by CUDA events "
            f"({ms / n:.3f} ms a frame), host clock {host:.3f} ms, device time of its "
            f"kernels {dev} ({card})")


def staged_serving(policy, card: str, rng, expect: dict) -> dict:
    """Phase 8f (b): `policy` through `get_vla_action` on the staged path
    (`device_preprocess=False`: the JPEG round trip, lanczos3 resize and
    crop on the card, then `predict_action`), as `OpenVLAServer.predict`
    calls it: 2 requests in process, then one over HTTP /act through an
    `ActionServer` whose predict makes that call, bitwise equal to the
    in-process answer on the same observation (the diffusion head's
    generator reseeded before each of the two). Each request launches
    `expect`. For the L1 head, the same 2 observations also through the
    one-pass `device_preprocess` route, and the conditioning alone on each
    route. The counts are set to 0 before the first request and read after
    the last; returns them."""
    from openvla_oft_tpu_torch.processing.image_processing import (device_preprocess,
                                                                   prepare_images_for_policy)
    from openvla_oft_tpu_torch.serving.deploy import DeployConfig, get_action_from_server
    from openvla_oft_tpu_torch.serving.openvla_utils import get_vla_action
    from openvla_oft_tpu_torch.serving.server import ActionServer

    head, platform = policy.head, policy.platform
    cfg = DeployConfig(use_l1_regression=head == "l1", use_diffusion=head == "diffusion",
                       num_images_in_input=policy.cfg.num_images_in_input,
                       num_open_loop_steps=platform.num_actions_chunk, unnorm_key="random",
                       device_preprocess=False)

    def predict(observation: dict, instruction: str, route=cfg) -> np.ndarray:
        return np.stack(get_vla_action(route, policy, None, observation, instruction))

    def request(obs: dict, route=cfg) -> tuple:
        before = launch_counts()
        t0 = time.perf_counter()
        action = predict(dict(obs), obs["instruction"], route)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        per_request = {k: n - before[k] for k, n in launch_counts().items() if k in expect}
        if action.shape != (platform.num_actions_chunk, platform.action_dim) \
                or not np.isfinite(action).all():
            raise AssertionError(f"bad staged {head} action chunk")
        return action, per_request, dt

    reset_launch_counts()
    observations, walls = [observation(policy, rng) for _ in range(2)], []
    for i, obs in enumerate(observations):
        _, per_request, dt = request(obs)
        walls.append(dt)
        log(f"[staged] {head} request {i} through get_vla_action (device_preprocess=False): "
            f"launches {per_request}, {dt:.1f} ms (host clock, ends in "
            f"torch.cuda.synchronize; {card})")
        if per_request != expect:
            raise AssertionError(f"a staged {head} request launched {per_request}, "
                                 f"expected {expect}")
    server = ActionServer(predict)
    port = free_port()
    server.run("127.0.0.1", port, background=True)
    obs = observation(policy, rng)
    try:
        if policy.generator is not None:
            policy.generator.manual_seed(1234)
        before = launch_counts()
        t0 = time.perf_counter()
        served = get_action_from_server(obs, f"http://127.0.0.1:{port}/act")
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        per_request = {k: n - before[k] for k, n in launch_counts().items() if k in expect}
    finally:
        server.shutdown()
    if policy.generator is not None:
        policy.generator.manual_seed(1234)
    want, _, _ = request(obs)
    if not isinstance(served, np.ndarray) or served.shape != want.shape:
        raise AssertionError(f"the staged {head} /act answered {served!r}")
    if not np.array_equal(served, want) or per_request != expect:
        raise AssertionError(f"the staged {head} /act launched {per_request} (expected "
                             f"{expect}), max|d| = {np.abs(served - want).max():.3e} from the "
                             "in-process answer")
    launches = launch_counts()
    log(f"[staged] {head} /act (ActionServer, get_vla_action, staged): {served.shape}, launches "
        f"{per_request}, {dt:.1f} ms (host wall clock around the HTTP round trip); bitwise "
        f"equal to the in-process answer on the same observation ({card})")
    if head == "l1":
        one_pass = dataclasses.replace(cfg, device_preprocess=True)
        direct = [request(o, one_pass)[2] for o in observations]
        images = [[o["full_image"], o["wrist_image"]] for o in observations]
        staged_ms = [timed(lambda: prepare_images_for_policy(im, policy.cfg, device="cuda"))
                     for im in images]
        size = policy.cfg.vision_configs[0].image_size
        frames = [torch.from_numpy(np.stack(im)).cuda() for im in images]
        direct_ms = [timed(lambda: device_preprocess(policy.cfg, f, size)) for f in frames]
        log(f"[staged] L1 at LIBERO, the same 2 observations through get_vla_action: staged "
            f"{', '.join(f'{t:.1f}' for t in walls)} ms, device_preprocess "
            f"{', '.join(f'{t:.1f}' for t in direct)} ms; the conditioning alone: "
            f"prepare_images_for_policy (JPEG, resize, crop, transform) "
            f"{', '.join(f'{t:.2f}' for t in staged_ms)} ms, device_preprocess "
            f"{', '.join(f'{t:.2f}' for t in direct_ms)} ms (host clock, ends in "
            f"torch.cuda.synchronize; {card})")
    return launches


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
    runs["staged bf16"] = staged_serving(policy, card, rng, {"K1": n_layers - 1, **none})
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


# === Phase 8e: a checkpoint dir through get_vla and OpenVLAServer ===
CKPT_LLM_ID, CKPT_LAYERS = "llama2-7b-pure-2l", 2
CKPT_UNNORM_KEY = "libero_spatial_no_noops"
CKPT_WORDS = ("in", "what", "action", "should", "the", "robot", "take", "to", "put", "bowl",
              "on", "plate", "out", "do", "task")


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b, n = n & 0x7F, n >> 7
        out += bytes([b | (0x80 if n else 0)])
        if not n:
            return out


def _ld(field: int, payload: bytes) -> bytes:
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def _vi(field: int, value: int) -> bytes:
    return _varint(field << 3) + _varint(value)


def llama_like_tokenizer(n_pieces: int = 32000) -> bytes:
    """A synthetic Llama-like `tokenizer.model` (a SentencePiece ModelProto):
    <unk>, <s>, </s>, the 256 byte pieces, "▁", the letters, every prefix of
    "▁" + each word of CKPT_WORDS (so BPE merges reach the words), and filler
    pieces up to `n_pieces`; BPE, byte fallback, dummy prefix."""
    import struct

    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)]
    pieces += [(f"<0x{i:02X}>", 0.0, 6) for i in range(256)]
    normal = ["\u2581"] + list("abcdefghijklmnopqrstuvwxyzIOW")
    for w in CKPT_WORDS:
        normal += ["\u2581" + w[:k] for k in range(1, len(w) + 1)
                   if "\u2581" + w[:k] not in normal]
    normal += [f"\u2581f{i}" for i in range(n_pieces - len(pieces) - len(normal))]
    pieces += [(p, -float(i) / 64, 1) for i, p in enumerate(normal)]
    body = b""
    for text, score, ptype in pieces:
        piece = _ld(1, text.encode()) + _varint((2 << 3) | 5) + struct.pack("<f", score)
        body += _ld(1, piece + (_vi(3, ptype) if ptype != 1 else b""))
    return body + _ld(2, _vi(3, 2) + _vi(35, 1)) + _ld(3, _vi(3, 1))


def module_state_dicts(params: dict) -> dict:
    """The reference's per-module `.pt` state dicts of the L1 head and the
    proprio projector (DDP "module." prefixes, (out, in) weights), on the host."""
    def lin(sd, name, p):
        sd[f"module.{name}.weight"] = p["kernel"].T.contiguous().cpu()
        sd[f"module.{name}.bias"] = p["bias"].cpu()

    def ln(sd, name, p):
        sd[f"module.{name}.weight"] = p["scale"].cpu()
        sd[f"module.{name}.bias"] = p["bias"].cpu()

    head, sd_head = params["action_head"]["model"], {}
    ln(sd_head, "model.layer_norm1", head["ln_in"])
    lin(sd_head, "model.fc1", head["fc_in"])
    for i, blk in enumerate(head["blocks"]):
        ln(sd_head, f"model.mlp_resnet_blocks.{i}.ffn.0", blk["ln"])
        lin(sd_head, f"model.mlp_resnet_blocks.{i}.ffn.1", blk["fc"])
    ln(sd_head, "model.layer_norm2", head["ln_out"])
    lin(sd_head, "model.fc2", head["fc_out"])
    sd_proprio = {}
    for fc in ("fc1", "fc2"):
        lin(sd_proprio, fc, params["proprio_projector"][fc])
    return {"action_head": sd_head, "proprio_projector": sd_proprio}


def rss_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


class RssPeak:
    """The process's resident set, sampled every 2 ms on a thread while the
    block runs: `base` before it, `peak` the largest sample."""

    def __enter__(self):
        self.base = self.peak = rss_bytes()
        self._stop = threading.Event()

        def sample():
            while not self._stop.wait(0.002):
                self.peak = max(self.peak, rss_bytes())

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, rss_bytes())


def checkpoint_dir(need: int) -> str:
    """A fresh directory with room for `need` bytes: under TMPDIR, else in
    the checkout's git-ignored build directory."""
    from openvla_oft_tpu_torch import _build

    for root in (tempfile.gettempdir(), str(_build.PKG_DIR / "_build")):
        os.makedirs(root, exist_ok=True)
        free = shutil.disk_usage(root).free
        log(f"[checkpoint] {root}: {free / 1e9:.1f} GB free, {need / 1e9:.1f} GB needed")
        if free >= need:
            return tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=root)
    raise AssertionError("no directory with room for the checkpoint")


def trees_bitwise_equal(a, b, path="") -> int:
    """Every leaf of `a` equal to `b`'s bit for bit (same keys, dtype and
    shape); returns the number of leaves."""
    if isinstance(a, dict):
        if sorted(a) != sorted(b):
            raise AssertionError(f"{path}: keys {sorted(a)} != {sorted(b)}")
        return sum(trees_bitwise_equal(a[k], b[k], f"{path}/{k}") for k in a)
    if isinstance(a, (list, tuple)):
        return sum(trees_bitwise_equal(x, y, f"{path}/{i}") for i, (x, y) in
                   enumerate(zip(a, b, strict=True)))
    if a.dtype != b.dtype or a.shape != b.shape or a.device != b.device:
        raise AssertionError(f"{path}: {a.dtype} {tuple(a.shape)} {a.device} against "
                             f"{b.dtype} {tuple(b.shape)} {b.device}")
    bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    if not torch.equal(a.view(bits), b.view(bits)):
        raise AssertionError(f"{path}: the loaded leaf differs from the exported one")
    return 1


def start_deploy_cli(ckpt: str, device: str, device_preprocess: bool = True) -> dict:
    """`python -m openvla_oft_tpu_torch.serving.deploy --pretrained-checkpoint
    DIR --unnorm-key K [--device-preprocess]` started in a process of its own;
    `deploy_cli_answer` waits for it to bind, queries it and stops it."""
    port = free_port()
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "openvla_oft_tpu_torch.serving.deploy",
           "--pretrained-checkpoint", ckpt, "--unnorm-key", CKPT_UNNORM_KEY,
           *(["--device-preprocess"] if device_preprocess else []),
           "--num-images-in-input", "2", "--num-open-loop-steps", "8",
           "--host", "127.0.0.1", "--port", str(port), "--device", device]
    env = {**os.environ, "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    cli = {"cmd": cmd, "port": port, "proc": proc, "lines": [], "bound": threading.Event(),
           "t0": time.perf_counter(), "device_preprocess": device_preprocess}

    def read():
        for line in proc.stdout:
            cli["lines"].append(line.rstrip())
            if "serving /act on" in line:
                cli["bound"].set()

    threading.Thread(target=read, daemon=True).start()
    return cli


def stop(proc) -> None:
    """Terminates `proc` (a subprocess.Popen) and waits for it."""
    proc.terminate()
    try:
        proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def deploy_cli_answer(cli: dict, obs: dict, want: np.ndarray, card: str,
                      max_d: float = 1e-3) -> None:
    """Waits for the deploy CLI `cli` to bind, sends `obs` to its /act, holds
    the answer against `want` (the in-process server's, on the same
    observation) within `max_d`, and stops it."""
    from openvla_oft_tpu_torch.serving.deploy import get_action_from_server

    proc, lines = cli["proc"], cli["lines"]
    try:
        while not cli["bound"].wait(1.0):
            if proc.poll() is not None or time.perf_counter() - cli["t0"] > 300:
                raise AssertionError("the deploy CLI did not bind: " + " | ".join(lines[-20:]))
        t_bind = time.perf_counter() - cli["t0"]
        time.sleep(0.5)                    # the server thread starts after the line
        got = None
        for _ in range(20):
            try:
                got = get_action_from_server(obs, f"http://127.0.0.1:{cli['port']}/act")
                break
            except OSError:
                time.sleep(0.5)
        if not isinstance(got, np.ndarray):
            raise AssertionError(f"the deploy CLI's /act answered {got!r}")
        d = float(np.abs(got - want).max())
        route = ("--device-preprocess" if cli["device_preprocess"]
                 else "no --device-preprocess: staged")
        log(f"[checkpoint] deploy CLI ({' '.join(cli['cmd'][1:5])} ... {route}): bound "
            f"after {t_bind:.1f} s (process start, load, warm-up, beside the other route's "
            f"CLI starting at once; host clock), /act answered {got.shape}, max|d| = {d:.3e} "
            f"from the in-process server's answer ({card}); its log: "
            + " | ".join(line for line in lines if line.startswith("[deploy]")))
        if not d <= max_d:
            raise AssertionError("the deploy CLI's answer differs from the in-process server's")
    finally:
        stop(cli["proc"])


def checkpoint_serving(card: str, rng, device: str = "cuda") -> dict:
    """Phase 8e. Returns the launches of the bf16 and the int4 run of requests."""
    from openvla_oft_tpu_torch import config as C
    from openvla_oft_tpu_torch.bridge import init_params, tree_leaves
    from openvla_oft_tpu_torch.constants import get_platform
    from openvla_oft_tpu_torch.data.transforms import save_dataset_statistics
    from openvla_oft_tpu_torch.policy import OpenVLAPolicy
    from openvla_oft_tpu_torch.processing.sentencepiece import (SentencePieceTokenizer,
                                                                parse_model_proto)
    from openvla_oft_tpu_torch.serving.deploy import (FLAGSHIP_IDS, DeployConfig,
                                                      OpenVLAServer, get_action_from_server,
                                                      serving_params)
    from openvla_oft_tpu_torch.training.checkpoint import (import_action_head_pt,
                                                           import_projector_pt)
    from openvla_oft_tpu_torch.utils.hf_import import export_openvla_checkpoint, \
        load_openvla_checkpoint
    from openvla_oft_tpu_torch.utils.safetensors_io import SafetensorsIndex

    t_phase = time.perf_counter()
    C._LLM_REGISTRY[CKPT_LLM_ID] = dataclasses.replace(C.LLAMA2_7B, num_layers=CKPT_LAYERS)
    cfg = C.OpenVLAConfig(vision_backbone_id=FLAGSHIP_IDS[0], llm_backbone_id=CKPT_LLM_ID,
                          num_images_in_input=2)
    platform = get_platform("libero")
    log(f"[checkpoint] the flagship at full width ({FLAGSHIP_IDS[0]}, Llama 4096 wide, 32 "
        f"heads, 11008, vocab 32064), its Llama cut to {CKPT_LAYERS} of 32 layers (registered "
        f"as {CKPT_LLM_ID!r}; both ViTs at full depth): the serving code does not depend on "
        f"the depth; the cut writes about 3.0 GB to disk, and phase 20 (e) round-trips all 32 "
        f"layers")
    d, pd = platform.action_dim, platform.proprio_dim
    stats = {CKPT_UNNORM_KEY: {
        "action": {"q01": [-0.9] * d, "q99": [0.9] * d, "min": [-1.0] * d, "max": [1.0] * d,
                   "mask": [True] * (d - 1) + [False]},
        "proprio": {"q01": [-0.8] * pd, "q99": [0.8] * pd, "min": [-1.0] * pd,
                    "max": [1.0] * pd}}}
    tok_bytes = llama_like_tokenizer()

    def draw():
        return init_params(cfg, platform, torch.Generator(device=device).manual_seed(0),
                           device=device, dtype=torch.bfloat16, head="l1")

    # (a) the build from seeded weights, as flagship_policy builds: its peak.
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    memory_policy = OpenVLAPolicy(
        cfg=cfg, platform=platform, params=serving_params(draw()), norm_stats=stats,
        tokenizer=SentencePieceTokenizer(parse_model_proto(tok_bytes)))
    torch.cuda.synchronize()
    seed_build = (torch.cuda.memory_allocated() - base, torch.cuda.max_memory_allocated() - base)
    log(f"[checkpoint] build from seeded weights (init_params + serving_params): "
        f"{seed_build[0] / 2**30:.3f} GiB after it, {seed_build[1] / 2**30:.3f} GiB at its peak "
        f"(torch.cuda.max_memory_allocated above the {base / 2**30:.3f} GiB before it), "
        f"{time.perf_counter() - t0:.1f} s ({card})")

    # (b) the same weights drawn again and exported.
    params = draw()
    sizes = [t.numel() * t.element_size() for t in tree_leaves(params)]
    largest_layer = max(t[0].numel() * t.element_size() for t in
                        tree_leaves(params["llm"]["layers"]))
    ckpt = checkpoint_dir(sum(sizes) + 2**30)
    server = None
    try:
        t0 = time.perf_counter()
        export_openvla_checkpoint(cfg, {k: params[k] for k in ("llm", "vision_backbone",
                                                               "projector")},
                                  ckpt, norm_stats=stats)
        save_dataset_statistics(stats, ckpt)
        for name, sd in module_state_dicts(params).items():
            torch.save(sd, os.path.join(ckpt, f"{name}--0_checkpoint.pt"))
        with open(os.path.join(ckpt, "tokenizer.model"), "wb") as f:
            f.write(tok_bytes)
        os.sync()
        t_write = time.perf_counter() - t0
        st_bytes = SafetensorsIndex(ckpt).nbytes
        files = {f: os.path.getsize(os.path.join(ckpt, f)) for f in sorted(os.listdir(ckpt))}
        log(f"[checkpoint] exported in {t_write:.1f} s (host clock, synced to disk): "
            + ", ".join(f"{f} {n:,} B" for f, n in files.items())
            + f"; {sum(files.values()) / 1e9:.3f} GB in all, tensors {st_bytes / 1e9:.3f} GB "
            f"({card})")

        # (c) loaded on the card, leaf for leaf against the exported tree.
        gc.collect()
        with RssPeak() as rss:
            t0 = time.perf_counter()
            _, loaded, loaded_stats = load_openvla_checkpoint(ckpt, dtype=torch.bfloat16,
                                                              device=device, head="l1")
            torch.cuda.synchronize()
            t_load = time.perf_counter() - t0
        n_leaves = trees_bitwise_equal({k: params[k] for k in loaded}, loaded)
        modules = {"action_head": import_action_head_pt(
                       os.path.join(ckpt, "action_head--0_checkpoint.pt"), device=device),
                   "proprio_projector": import_projector_pt(
                       os.path.join(ckpt, "proprio_projector--0_checkpoint.pt"),
                       device=device)}
        n_leaves += trees_bitwise_equal({k: params[k] for k in modules}, modules)
        if loaded_stats != stats:
            raise AssertionError("the loaded statistics differ from the exported ones")
        log(f"[checkpoint] load_openvla_checkpoint onto the card: {t_load:.2f} s, "
            f"{st_bytes / t_load / 1e9:.2f} GB/s of tensors (host clock; the file just written, "
            f"so likely from the page cache); {n_leaves} leaves bitwise equal to the exported "
            f"tree (the .pt modules included); host resident set {rss.base / 2**30:.3f} GiB "
            f"before, peak {rss.peak / 2**30:.3f} GiB during the load "
            f"(+{(rss.peak - rss.base) / 2**20:.0f} MiB; the largest stacked leaf is {max(sizes) / 2**20:.0f} MiB, its "
            f"largest layer {largest_layer / 2**20:.0f} MiB, the tree {sum(sizes) / 2**30:.3f} "
            f"GiB) ({card})")
        del params, loaded, modules
        gc.collect()
        torch.cuda.empty_cache()

        # (d) the build from disk: OpenVLAServer (get_vla + the .pt modules).
        deploy_cfg = DeployConfig(pretrained_checkpoint=ckpt, device=device,
                                  unnorm_key=CKPT_UNNORM_KEY, num_images_in_input=2,
                                  device_preprocess=True, num_open_loop_steps=8, warmup=False,
                                  host="127.0.0.1", port=free_port())
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        server = OpenVLAServer(deploy_cfg)
        torch.cuda.synchronize()
        disk_build = (torch.cuda.memory_allocated() - base,
                      torch.cuda.max_memory_allocated() - base)
        log(f"[checkpoint] build from disk (OpenVLAServer: get_vla, serving_params, the .pt "
            f"modules): {disk_build[0] / 2**30:.3f} GiB after it, {disk_build[1] / 2**30:.3f} "
            f"GiB at its peak (seeded: {seed_build[0] / 2**30:.3f}, {seed_build[1] / 2**30:.3f}),"
            f" {time.perf_counter() - t0:.1f} s (host clock; {card})")
        if disk_build[1] > seed_build[1]:
            raise AssertionError("the build from disk peaks higher than the seeded build")
        log(f"[checkpoint] warm-up (one synthetic predict at {deploy_cfg.warmup_image_hw}): "
            f"{server._warmup() * 1e3:.1f} ms (host clock; {card})")
        server.run(background=True)

        runs = {}
        none = {"K4": 0, "K6": 0, "int8": 0}
        n_layers = CKPT_LAYERS
        url = f"http://127.0.0.1:{deploy_cfg.port}/act"
        observations, answers = [], []
        reset_launch_counts()
        for i in range(3):
            obs = observation(memory_policy, rng)
            before = launch_counts()
            t0 = time.perf_counter()
            action = get_action_from_server(obs, url)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            per_request = {k: n - before[k] for k, n in launch_counts().items()
                           if k in ("K1", "K5", *none)}
            log(f"[checkpoint] /act request {i}: {np.asarray(action).shape}, launches "
                f"{per_request}, {dt * 1e3:.2f} ms (host wall clock around the HTTP round "
                f"trip; {card})")
            if per_request != {"K1": n_layers - 1, "K5": 0, **none}:
                raise AssertionError(f"a checkpoint request launched {per_request}")
            observations.append(obs)
            answers.append(np.asarray(action))
        runs["checkpoint bf16"] = launch_counts()
        server.shutdown()
        for i, (obs, action) in enumerate(zip(observations, answers)):
            want = memory_policy.predict_action_from_frames(
                frames_of(memory_policy, obs), obs["instruction"], proprio=obs["state"],
                unnorm_key=CKPT_UNNORM_KEY)
            if action.shape != want.shape or not np.array_equal(action, want) \
                    or not np.isfinite(action).all():
                raise AssertionError(f"request {i}: /act answered max|d| = "
                                     f"{np.abs(action - want).max():.3e} from the in-memory "
                                     "policy")
        log("[checkpoint] the 3 /act answers are bitwise equal to the in-memory policy's on "
            "the same observations")
        # The deploy CLI on the dir in processes of its own, with
        # --device-preprocess and without (its default, the staged path),
        # both started at once: their start-ups overlap.
        clis = [start_deploy_cli(ckpt, device), start_deploy_cli(ckpt, device, False)]
        try:
            # Phase 8f (c): the staged path against OpenVLAServer.predict in
            # process on the same observation, bitwise.
            server.cfg = dataclasses.replace(deploy_cfg, device_preprocess=False)
            staged = server.predict(dict(observations[0]), observations[0]["instruction"])
            deploy_cli_answer(clis[0], observations[0], answers[0], card)
            deploy_cli_answer(clis[1], observations[0], staged, card, max_d=0.0)
        finally:
            for cli in clis:
                stop(cli["proc"])
        del server, memory_policy
        server = None
        gc.collect()
        torch.cuda.empty_cache()

        # (e) load_in_4bit from the same dir: one request through K5.
        t0 = time.perf_counter()
        server = OpenVLAServer(dataclasses.replace(deploy_cfg, load_in_4bit=True,
                                                   port=free_port()))
        torch.cuda.synchronize()
        log(f"[checkpoint] load_in_4bit build from disk: {time.perf_counter() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated ({card})")
        server.run(background=True)
        reset_launch_counts()
        obs = observation(server.vla, rng)
        t0 = time.perf_counter()
        action = get_action_from_server(obs, f"http://127.0.0.1:{server.cfg.port}/act")
        torch.cuda.synchronize()
        runs["checkpoint int4 W4A16"] = launch_counts()
        expect_k5 = 4 * (n_layers - 1) + 6
        log(f"[checkpoint] load_in_4bit /act request: {np.asarray(action).shape}, launches "
            f"{runs['checkpoint int4 W4A16']}, {(time.perf_counter() - t0) * 1e3:.2f} ms "
            f"(host clock, the first request: no warm-up; {card})")
        if runs["checkpoint int4 W4A16"]["K5"] != expect_k5 \
                or not np.isfinite(np.asarray(action)).all():
            raise AssertionError(f"the load_in_4bit request launched K5 "
                                 f"{runs['checkpoint int4 W4A16']['K5']} times, not {expect_k5}")
        server.shutdown()
        server = None
        gc.collect()
        torch.cuda.empty_cache()

        # (f) phase 11b (d): fine-tuning from the dir, before it is removed.
        runs["checkpoint training"] = checkpoint_training(ckpt, draw(), n_layers, card)
        # (g) phase 14 (d), (e): run management from the same dir.
        runs.update(run_management(ckpt, card, rng, n_layers))
    finally:
        if server is not None:
            server.shutdown()
        shutil.rmtree(ckpt, ignore_errors=True)
        C._LLM_REGISTRY.pop(CKPT_LLM_ID, None)
    log(f"[checkpoint] the dir is removed; phase took {time.perf_counter() - t_phase:.1f} s "
        f"(host clock)")
    gc.collect()
    torch.cuda.empty_cache()
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


def training_setup(flags=TRAIN_FLAGS):
    """The fine-tuning CLI's flags parsed, its model config, platform,
    TrainConfig and first batch (numpy), all as the CLI builds them."""
    from openvla_oft_tpu_torch.training import finetune as FT

    cfg = FT.parse_config(flags)
    return (FT.model_config(cfg), FT.platform_of(cfg), FT.train_config(cfg),
            FT.first_batch(cfg))


def training_length(cfg, batch, tcfg) -> int:
    """S of the training layout: the text bucket, the patches of every
    image, the proprio token and, for diffusion, the timestep token."""
    return (batch["input_ids"].shape[1] + int(tcfg.use_proprio)
            + int(tcfg.objective == "diffusion")
            + cfg.num_images_in_input * cfg.vision_configs[0].num_patches)


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


def backward_check(card: str, s_train: int, s_aloha: int) -> dict:
    """K2 and K3 against flash_attention_bwd_ref at the training shape, the
    ALOHA length, the ALOHA training shape (B = 4, S = s_aloha, a 351-slot
    window: 350 actions + STOP), GQA and dead rows, with two bitwise-equal
    calls of each;
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
    aloha_rows = [(0, s_aloha - 5 * i, s_aloha - 5 * i - 351, 351) for i in range(4)]
    cases = [
        ("training", 8, s, 32, 32, 128, train_rows),
        ("aloha_training", 4, s_aloha, 32, 32, 128, aloha_rows),
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


def train(card: str, n_layers: int, flags=TRAIN_FLAGS, label: str = "train",
          steps: int = 3, sample_freq: int = 0, expect_extra: dict = None,
          keep_first: bool = False) -> tuple:
    """`steps` steps of the fine-tuning CLI with `flags` (in process), the
    launch counts reset just before it and read just after. Each step must
    launch K1 2 x n_layers (remat "all": the forward and its recompute) and
    K2, K3 n_layers each, and nothing else but `expect_extra` (a QLoRA
    base's int8 products or K5 launches a step); a step that runs the diffusion
    sampling metric (every `sample_freq`) adds K1 n_layers for each of its
    forwards. Every trainable group must move between the first step and
    the last. Returns (state, launches, info); with `keep_first` the
    info holds the trainables after step 0 ("first")."""
    from openvla_oft_tpu_torch.bridge import tree_leaves
    from openvla_oft_tpu_torch.training import finetune as FT

    run_root = tempfile.mkdtemp(prefix="chip_smoke_runs_")
    expect = {"K1": 2 * n_layers, "K2": n_layers, "K3": n_layers,   # remat "all"
              "K4": 0, "K5": 0, "K6": 0, "probe": 0, "int8": 0, **(expect_extra or {})}
    sample_k1 = n_layers * FT.parse_config(flags).num_diffusion_steps
    seen = {"prev": {k: 0 for k in expect}, "times": [], "samples": []}

    def on_step(step, metrics, state):
        counts = launch_counts()
        per_step = {k: counts[k] - seen["prev"][k] for k in counts}
        seen["prev"], seen["state"] = counts, state
        want = dict(expect)
        if "sampled_actions_l1_loss" in metrics:
            want["K1"] += sample_k1
            seen["samples"].append({k: metrics[k] for k in metrics if "sampled" in k
                                    or k == "sample_time"})
        seen["times"].append(metrics["step_time"])
        seen.setdefault("losses", []).append(metrics["loss"])
        log(f"[{label}] step {step}: " + " ".join(
            f"{k}={v:.6f}" for k, v in sorted(metrics.items()) if k != "step_time")
            + f" step_time={metrics['step_time']:.4f} s (host clock, ends in "
            f"torch.cuda.synchronize) launches {per_step} ({card})")
        if not (np.isfinite(metrics["loss"]) and np.isfinite(metrics["grad_norm"])
                and metrics["grad_norm"] > 0):
            raise AssertionError(f"bad training step {step}: {metrics}")
        if "sampled_actions_l1_loss" in metrics and not all(
                np.isfinite(v) for v in seen["samples"][-1].values()):
            raise AssertionError(f"a non-finite sampling metric at step {step}: {metrics}")
        if per_step != want:
            raise AssertionError(f"step {step} launched {per_step}, expected {want}")
        if step == 0:
            seen["first"] = [t.detach().clone() for t in tree_leaves(state.trainables)]
            # The build's and the first step's peak; the later steps' from here.
            seen["peak0"] = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()

    from openvla_oft_tpu_torch.ops import flash_attention as fa

    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        reset_launch_counts()
        stats_before = fa.flash_attention_dkv.stats_launches
        out = FT.main(flags + ["--max_steps", str(steps), "--run_root_dir", run_root],
                      on_step=on_step)
        launches = launch_counts()
        step_peak = torch.cuda.max_memory_allocated()
        peak = max(seen["peak0"], step_peak)
        if fa.flash_attention_dkv.stats_launches != stats_before:
            raise AssertionError("the training backward ran the stats pass: K3 did not read "
                                 "K2's stats rows")
        log(f"[{label}] finetune: {out['final_step']} steps in {time.perf_counter() - t0:.1f} s "
            f"(weights made on the card, checkpoint written); launches {launches}; "
            f"torch.cuda.max_memory_allocated {peak / 2**30:.3f} GiB ({card})")
        state = seen["state"]
        if out["final_step"] != steps or out["ckpt"] is None:
            raise AssertionError(f"the training run ended at {out}")
        n_samples = steps // sample_freq if sample_freq else 0
        total = {k: steps * n for k, n in expect.items()}
        total["K1"] += n_samples * sample_k1
        if launches != total or len(seen["samples"]) != n_samples:
            raise AssertionError(f"training launched {launches} with {len(seen['samples'])} "
                                 f"sampling runs, expected {total} and {n_samples}")
        leaves = tree_leaves(state.trainables)
        start = 0
        for group, tree in state.trainables.items():
            stop = start + len(tree_leaves(tree))
            moved = max((a.detach() - b).abs().max().item()
                        for a, b in zip(leaves[start:stop], seen["first"][start:stop]))
            log(f"[{label}] {group}: max |change| between step 0 and step {steps - 1} = "
                f"{moved:.3e}")
            if not moved > 0:
                raise AssertionError(f"trainables {group} did not change")
            start = stop
        metrics_file = os.path.join(out["run_dir"], f"{os.path.basename(out['run_dir'])}"
                                    "-metrics.jsonl")
        with open(metrics_file) as f:
            metrics_jsonl = f.read()
        return state, launches, {"step_times": seen["times"], "peak": peak,
                                 "step_peak": step_peak, "losses": seen["losses"],
                                 "samples": seen["samples"], "metrics_jsonl": metrics_jsonl,
                                 "first": seen.pop("first") if keep_first else None}
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


def profile_step(state, card: str, flags=TRAIN_FLAGS, label: str = "train_step at B=8") -> dict:
    """The CLI's train_step on its final state and first batch: 3 steps
    timed without the profiler, then one traced with torch.profiler (device
    activity only). The idle share of the traced step is 1 - (union of kernel
    intervals) / (its wall time); tracing slows the host, so that is an upper
    bound. Kernel durations do not depend on the host, so 1 - (device time) /
    (median untraced step) estimates the idle share of an untraced step."""
    from openvla_oft_tpu_torch.training.train_step import train_step

    model_cfg, platform, tcfg, batch = training_setup(flags)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}

    def step():
        train_step(state, batch, model_cfg, platform, tcfg)

    untraced = [timed(step) for _ in range(3)]
    wall, n, busy, by_class = trace(step)
    if busy is None:
        log(f"[profile] {label}: untraced {', '.join(f'{t:.1f}' for t in untraced)} "
            f"ms; device time not measured ({card})")
        return {"untraced_ms": untraced, "traced_ms": wall, "busy_ms": None}
    log(f"[profile] {label}: untraced {', '.join(f'{t:.1f}' for t in untraced)} ms;"
        f" traced {wall:.1f} ms with {n} kernels and {busy:.1f} ms of device time"
        f" (union of kernel intervals); idle share of the traced step "
        f"{1 - busy / wall:.3f}; estimate for the untraced steps "
        f"{1 - busy / float(np.median(untraced)):.3f} (host clock, ends in "
        f"torch.cuda.synchronize; {card})")
    log_classes("profile", by_class)
    k1 = by_class.get("K1", (0.0, 0))[0]
    k23 = sum(by_class.get(c, (0.0, 0))[0] for c in ("K2", "K3"))
    log(f"[profile] {label}: K1 {k1:.1f} ms = {k1 / busy:.3f} and K2 + K3 {k23:.1f} "
        f"ms = {k23 / busy:.3f} of the device time ({card})")
    return {"untraced_ms": untraced, "traced_ms": wall, "busy_ms": busy, "k1_ms": k1,
            "k23_ms": k23}


def training_parity(state, card: str, flags=TRAIN_FLAGS, label: str = "train-parity",
                    far_targets: bool = False) -> None:
    """One loss and backward through K1/K2/K3 and through the dense path on
    the same 7B weights, batch (the CLI's first) and draws (each path's
    diffusion draws from a generator seeded alike), LoRA B drawn with std
    1e-3. far_targets: every target action 10, above the head's outputs, so
    that the L1 gradient, sign(residual), does not flip with the paths'
    bf16 noise at residuals near 0."""
    from openvla_oft_tpu_torch.bridge import tree_leaves
    from openvla_oft_tpu_torch.training import train_step as TT

    dev = state.base_params["llm"]["embed"]["embedding"].device
    cfg, platform, tcfg, batch = training_setup(flags)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    if far_targets:
        batch["actions"] = torch.full_like(batch["actions"], 10.0)
    gen = torch.Generator(device=dev).manual_seed(7)
    with torch.no_grad():
        for b in _lora_b(state.trainables["lora"]):
            b.normal_(0.0, 1e-3, generator=gen)
    leaves = tree_leaves(state.trainables)
    loss, grads = {}, {}
    for use_flash in (True, False):
        before = launch_counts()
        l, _ = TT.loss_and_metrics(state.trainables, state.base_params, batch, cfg,
                                   platform, tcfg, torch.Generator(device=dev).manual_seed(11),
                                   use_flash=use_flash)
        g = torch.autograd.grad(l, leaves)
        loss[use_flash] = l.item()
        grads[use_flash] = g
        used = {k: v - before[k] for k, v in launch_counts().items()}
        log(f"[{label}] use_flash={use_flash}: loss={loss[use_flash]:.6f} launches {used}")
    rel = abs(loss[True] - loss[False]) / abs(loss[False])
    log(f"[{label}] loss K1/K2/K3 path {loss[True]:.6f}, dense path {loss[False]:.6f}, "
        f"relative difference {rel:.3e} ({card})")
    ok = np.isfinite(loss[True]) and rel <= TRAIN_LOSS_REL
    start = 0
    for group, tree in state.trainables.items():
        stop = start + len(tree_leaves(tree))
        flat = [torch.cat([x.float().flatten() for x in grads[f][start:stop]])
                for f in (True, False)]
        cos = torch.nn.functional.cosine_similarity(flat[0], flat[1], dim=0).item()
        log(f"[{label}] {group}: gradient cosine(K1/K2/K3 path, dense path) = {cos:.6f}")
        ok = ok and cos >= TRAIN_GRAD_COSINE
        start = stop
    if not ok:
        raise AssertionError("the training path through K1/K2/K3 disagrees with the dense path")


def lm_head_backward_check(state, s_rows: int, card: str) -> None:
    """The lm_head product's backward on the card (`models/llama.py::
    _LmHeadProduct`, the discrete objective's): dh = g . w^T of the 7B's
    bf16 lm_head for B x S rows against the float64 product, and its time."""
    from openvla_oft_tpu_torch.models.llama import lm_logits

    w = state.base_params["llm"]["lm_head"]["kernel"]
    gen = torch.Generator(device=w.device).manual_seed(3)
    h = torch.randn((s_rows, w.shape[0]), generator=gen, device=w.device).bfloat16()
    h.requires_grad_()
    out = lm_logits({"lm_head": {"kernel": w}}, h)
    g = torch.randn(out.shape, generator=gen, device=w.device) * 1e-3
    (dh,) = torch.autograd.grad(out, h, g, retain_graph=True)
    ref = g.double() @ w.double().t()
    err = ((dh.double() - ref).abs().max() / ref.abs().max()).item()
    ms = cuda_time_ms(lambda: torch.autograd.grad(out, h, g, retain_graph=True))
    bound_ms = bound(2.0 * s_rows * w.shape[0] * w.shape[1],
                     nbytes(g, w, dh), PEAK_BF16)
    log(f"[lm_head] backward of lm_logits on the card: dh {tuple(dh.shape)} {dh.dtype} "
        f"{dh.device}, max|d| / max|ref| {err:.3e} against the float64 product; "
        f"{ms:.4f} ms by CUDA events (its fp32 product on an fp32 copy of the lm_head; bound "
        f"{bound_ms[0]:.4f} ms by {bound_ms[1]}) ({card})")
    if dh.dtype != torch.bfloat16 or not dh.is_cuda or not err <= 1e-2:
        raise AssertionError("the lm_head backward on the card disagrees with its product")


def objectives_phase(card: str, n_layers: int) -> dict:
    """Phase 11b: the diffusion and discrete objectives and OFT+ ALOHA with
    FiLM through the fine-tuning CLI at random:7b, each with its launches,
    step times, peak, every trainable group moving, and the K1/K2/K3 path
    against the dense path. Returns each run's launches."""
    runs = {}
    t_phase = time.perf_counter()
    for name, flags in OBJECTIVE_RUNS.items():
        cfg, _, tcfg, batch = training_setup(flags)
        s = training_length(cfg, batch, tcfg)
        log(f"[objectives] {name}: objective {tcfg.objective}, FiLM {tcfg.use_film}, batch "
            f"{batch['input_ids'].shape[0]}, {cfg.num_images_in_input} images, text bucket "
            f"{batch['input_ids'].shape[1]}, S = {s}")
        sample_freq = 3 if name == "diffusion" else 0
        state, launches, info = train(card, n_layers, flags, f"train-{name}",
                                      sample_freq=sample_freq)
        runs[name] = launches
        times = info["step_times"]
        log(f"[objectives] {name}: step times {', '.join(f'{t:.4f}' for t in times)} s, "
            f"peak {info['peak'] / 2**30:.3f} GiB, S = {s}"
            + "".join(f"; sampling metric ({DIFFUSION_STEPS} DDIM steps) "
                      + ", ".join(f"{k}={v:.6f}" for k, v in sorted(m.items()))
                      for m in info["samples"]) + f" ({card})")
        if name == "discrete":
            lm_head_backward_check(state, batch["input_ids"].shape[0] * s, card)
        training_parity(state, card, flags, f"parity-{name}",
                        far_targets=tcfg.objective == "l1")
        del state
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[objectives] phase 11b took {time.perf_counter() - t_phase:.1f} s (host clock)")
    return runs


def checkpoint_training(ckpt: str, ref: dict, n_layers: int, card: str) -> dict:
    """Phase 11b (d): L1 fine-tuning from phase 8e's checkpoint dir through
    the CLI (K1 2 x n_layers, K2 and K3 n_layers a step), its loaded base
    bitwise equal to the exported tree `ref`; a discrete run from the same
    dir, which has no lm_head, raises naming it before any step."""
    from openvla_oft_tpu_torch.training import finetune as FT

    flags = TRAIN_FLAGS + ["--vla_path", ckpt]
    state, launches, info = train(card, n_layers, flags, "train-checkpoint")
    n = trees_bitwise_equal({k: ref[k] for k in state.base_params}, state.base_params)
    log(f"[train-checkpoint] the trained base: {n} leaves bitwise equal to the exported tree; "
        f"step times {', '.join(f'{t:.4f}' for t in info['step_times'])} s, peak "
        f"{info['peak'] / 2**30:.3f} GiB ({card})")
    del state
    steps, run_root = [], tempfile.mkdtemp(prefix="chip_smoke_runs_")
    try:
        FT.main(flags + ["--use_l1_regression", "False", "--max_steps", "1", "--run_root_dir",
                         run_root], on_step=lambda *a: steps.append(a[0]))
    except KeyError as e:
        if "language_model.lm_head.weight" not in str(e) or steps:
            raise AssertionError(f"the discrete run raised {e!r} after {len(steps)} steps")
        log(f"[train-checkpoint] a discrete run from the dir without an lm_head raised before "
            f"any step: {e}")
    else:
        raise AssertionError("a discrete run from a dir without an lm_head did not raise")
    finally:
        shutil.rmtree(run_root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return launches

# Phase 13: the episode data path. A raw LIBERO dataset in its RLDS shards
# (the port's writer): 24 episodes of 40 to 60 steps, two cameras at 256 x
# 256 (the decode golden's frames), gripper -1..1 and an 8-dim state, so
# that "auto" standardization (the gripper clipped and inverted) and the
# gripper's normalization mask apply. The CLI's flags: phase 10's with the
# dataset, image augmentation, 4 steps and validation every 2.
EPISODE_FLAGS = TRAIN_FLAGS + ["--image_aug", "True", "--max_steps", "4",
                               "--shuffle_buffer_size", "2000", "--use_val_set", "True",
                               "--val_freq", "2", "--val_time_limit", "4"]
EPISODE_SHUFFLE = 10_000            # frames in the loader-alone runs' buffer


def decode_golden(card: str) -> list:
    """Phase 13 (a), (b): the host library built with the host's C++
    compiler, then both decoders bitwise against TF's pixels on every entry
    of the golden, and the library's augmentation against its plain
    version on those frames. Returns the golden's 256 x 256 JPEG bytes."""
    from openvla_oft_tpu_torch import _host_build
    from openvla_oft_tpu_torch.processing.jpeg_decode import decode_jpeg, decode_jpeg_plain

    t0 = time.perf_counter()
    lib = _host_build.build()
    log(f"[episodes] host library {lib.relative_to(_host_build.PKG_DIR.parent)} ready in "
        f"{time.perf_counter() - t0:.1f} s: "
        + (lib.parent / "build.log").read_text().strip().replace("\n", " | "))
    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "goldens",
                          "jpeg_decode_tf.npz")
    with np.load(golden) as z:
        entries = [(str(n), z[f"data_{i}"].tobytes(), z[f"pixels_{i}"])
                   for i, n in enumerate(z["names"])]
    for name, data, pixels in entries:
        for label, decoder in (("host library", decode_jpeg), ("plain", decode_jpeg_plain)):
            got = decoder(data)
            if got.shape != pixels.shape or not np.array_equal(got, pixels):
                raise AssertionError(f"the {label} JPEG decoder differs from TF on {name}")
    from openvla_oft_tpu_torch.data.rlds.augment import (augment_image, augment_image_plain,
                                                         draw_augmentation)

    rng = np.random.default_rng(0)
    for name, _, pixels in entries:
        for _ in range(2 if min(pixels.shape[:2]) > 1 else 0):   # 1 x 1 has no crop
            draws = draw_augmentation(rng, *pixels.shape[:2])
            if not np.array_equal(augment_image(pixels, draws),
                                  augment_image_plain(pixels, draws)):
                raise AssertionError(f"the host library's augmentation differs from its "
                                     f"plain version on {name}, {draws}")
    frames = [d for n, d, _ in entries if n.startswith("libero_")]
    log(f"[episodes] augmentation, host library and plain, bitwise equal on the "
        f"{len(entries)} golden frames, 2 draws each")
    log(f"[episodes] JPEG decoders, host library and plain, bitwise equal to "
        f"tf.io.decode_jpeg on all {len(entries)} golden entries "
        f"({', '.join(n for n, _, _ in entries)}); {len(frames)} frames of 256 x 256, "
        f"{', '.join(str(len(d)) for d in frames)} B")
    return frames


def write_episodes(frames: list, root: str) -> int:
    """Phase 13 (c): the raw LIBERO dataset; returns its number of steps."""
    from openvla_oft_tpu_torch.data.rlds.pipeline import write_episode_tfrecords

    rng = np.random.default_rng(13)
    episodes, steps = [], 0
    for e in range(24):
        t = int(rng.integers(40, 61))
        actions = rng.uniform(-0.5, 0.5, (t, 7))
        actions[:, -1] = np.where(rng.random(t) < 0.5, -1.0, 1.0)
        episodes.append({"images": [frames[(e + i) % len(frames)] for i in range(t)],
                         "wrist_images": [frames[(e + 2 * i + 1) % len(frames)]
                                          for i in range(t)],
                         "actions": actions, "proprio": rng.standard_normal((t, 8)),
                         "language_instruction": f"put the black bowl on plate {e % 6}"})
        steps += t
    t0 = time.perf_counter()
    paths = write_episode_tfrecords(os.path.join(root, "libero_spatial_no_noops"), episodes)
    size = sum(os.path.getsize(p) for p in paths)
    log(f"[episodes] wrote 24 episodes, {steps} steps, 2 cameras, {size / 1e6:.1f} MB in "
        f"{len(paths)} shard(s) in {time.perf_counter() - t0:.2f} s (host clock)")
    return steps


def loader_alone(root: str, platform, card: str) -> dict:
    """Phase 13 (d): the loader without the model or the batch transform,
    image_aug off and on: frames/s (each frame two cameras), the decode and
    augmentation ms of a frame on one thread, the threads, and the resident
    set with a shuffle buffer of EPISODE_SHUFFLE encoded frames."""
    from openvla_oft_tpu_torch.data.rlds.augment import augment_image, draw_augmentation
    from openvla_oft_tpu_torch.data.rlds.pipeline import (_files, _parse_episode,
                                                          make_rlds_iterator)
    from openvla_oft_tpu_torch.data.rlds.tfrecord import read_tfrecords
    from openvla_oft_tpu_torch.processing.jpeg_decode import decode_jpeg

    ep = _parse_episode(next(read_tfrecords(_files(root, "libero_spatial_no_noops")[0])),
                        platform, True)
    jpegs = list(ep["images"][:20])
    t0 = time.perf_counter()
    imgs = [decode_jpeg(d) for d in jpegs]
    decode_ms = (time.perf_counter() - t0) * 1e3 / len(jpegs)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for img in imgs:
        augment_image(img, draw_augmentation(rng, *img.shape[:2]))
    aug_ms = (time.perf_counter() - t0) * 1e3 / len(imgs)
    log(f"[episodes] one thread: decode {decode_ms:.3f} ms a 256 x 256 image (host library), "
        f"augmentation {aug_ms:.3f} ms an image (host clock, {card}'s host)")
    out = {"decode_ms": decode_ms, "aug_ms": aug_ms}
    threads = min(os.cpu_count() or 1, 8)
    for aug in (False, True):
        with RssPeak() as rss:
            t0 = time.perf_counter()
            it, _ = make_rlds_iterator(root, "libero_spatial_no_noops", lambda b: b, platform,
                                       shuffle_buffer_size=EPISODE_SHUFFLE, image_aug=aug,
                                       train=True, num_images=2)
            next(it)
            first = time.perf_counter() - t0
            t1 = time.perf_counter()
            for _ in range(320):
                frame = next(it)
            rate = 320 / (time.perf_counter() - t1)
            if frame["observation"]["image_wrist"].shape != (256, 256, 3):
                raise AssertionError("the loader's frames are not 256 x 256 x 3")
            del it
        out[aug] = rate
        log(f"[episodes] loader alone, image_aug {aug}: {rate:.1f} frames/s (2 images a "
            f"frame, {threads} decode threads, {os.cpu_count()} CPUs), first frame after "
            f"{first:.2f} s (a buffer of {EPISODE_SHUFFLE} encoded frames); resident set "
            f"{rss.base / 2**20:.0f} MiB before, {rss.peak / 2**20:.0f} MiB at its peak "
            f"(host clock)")
    return out


def episode_phase(card: str, n_layers: int, dummy_times: list) -> dict:
    """Phase 13: the episode data path end to end (see EPISODE_FLAGS): the
    decoders on the golden, the dataset written, the loader alone, then the
    CLI at random:7b on it with validation, every step K1 2 x n_layers and
    K2, K3 n_layers, every validation batch K1 n_layers and nothing else;
    one step traced fed by the prefetcher. Removes the dataset. Returns the
    launches of the run."""
    from openvla_oft_tpu_torch.data.collator import batch_iterator
    from openvla_oft_tpu_torch.data.prefetch import DevicePrefetcher
    from openvla_oft_tpu_torch.training import finetune as FT
    from openvla_oft_tpu_torch.training.train_step import train_step

    t_phase = time.perf_counter()
    frames = decode_golden(card)
    root = tempfile.mkdtemp(prefix="chip_smoke_episodes_")
    run_root = tempfile.mkdtemp(prefix="chip_smoke_runs_")
    try:
        write_episodes(frames, root)
        flags = EPISODE_FLAGS + ["--data_root_dir", root, "--run_root_dir", run_root]
        cfg = FT.parse_config(flags)
        platform = FT.platform_of(cfg)
        loader_alone(root, platform, card)

        step_want = {"K1": 2 * n_layers, "K2": n_layers, "K3": n_layers, "K4": 0, "K5": 0,
                     "K6": 0, "probe": 0, "int8": 0}
        seen = {"prev": launch_counts(), "times": [], "data": [], "val": []}

        def on_step(step, metrics, state):
            counts = launch_counts()
            per_step = {k: counts[k] - seen["prev"][k] for k in counts}
            seen["prev"], seen["state"] = counts, state
            seen["times"].append(metrics["step_time"])
            seen["data"].append(metrics["data_time"])
            log(f"[train-episodes] step {step}: loss={metrics['loss']:.6f} "
                f"grad_norm={metrics['grad_norm']:.6f} step_time={metrics['step_time']:.4f} s "
                f"data_time={metrics['data_time']:.4f} s (host clock) launches {per_step}")
            if not (np.isfinite(metrics["loss"]) and metrics["grad_norm"] > 0):
                raise AssertionError(f"bad training step {step}: {metrics}")
            if per_step != step_want:
                raise AssertionError(f"step {step} launched {per_step}, expected {step_want}")

        def on_validation(step, val, n):
            counts = launch_counts()
            per = {k: counts[k] - seen["prev"][k] for k in counts}
            seen["prev"] = counts
            want = {k: 0 for k in counts}
            want["K1"] = n * n_layers
            log(f"[train-episodes] validation after step {step}: {n} batches, "
                + " ".join(f"{k}={v:.6f}" for k, v in sorted(val.items()))
                + f", launches {per}")
            if n < 1 or not np.isfinite(val.get("val_loss", np.nan)) or per != want:
                raise AssertionError(f"validation after step {step}: {n} batches, {val}, "
                                     f"launches {per}, expected {want}")
            seen["val"].append(n)

        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        seen["prev"] = launch_counts()
        t0 = time.perf_counter()
        out = FT.main(flags, on_step=on_step, on_validation=on_validation)
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        n_val = sum(seen["val"])
        total = {k: 4 * n for k, n in step_want.items()}
        total["K1"] += n_val * n_layers
        if out["final_step"] != 4 or len(seen["val"]) != 2 or launches != total:
            raise AssertionError(f"the episode run ended at {out} with {seen['val']} "
                                 f"validation batches and launches {launches}, expected {total}")
        with open(os.path.join(out["run_dir"], "dataset_statistics.json")) as f:
            saved = json.load(f)
        with open(os.path.join(root, "libero_spatial_no_noops", "dataset_statistics.json")) as f:
            written = json.load(f)
        if saved != {"libero_spatial_no_noops": written} or \
                written.get("transform") != "libero_dataset_transform" or \
                written["action"].get("mask") != [True] * 6 + [False]:
            raise AssertionError("the run dir's dataset_statistics.json is not the pipeline's")
        times = seen["times"]
        log(f"[train-episodes] finetune on the episodes: 4 steps and {n_val} validation "
            f"batches in {time.perf_counter() - t0:.1f} s; step times "
            f"{', '.join(f'{t:.4f}' for t in times)} s (median of the last 3 "
            f"{float(np.median(times[1:])):.4f}) against phase 10's dummy-data steps at the same cut "
            f"{', '.join(f'{t:.4f}' for t in dummy_times)} s (median of the last 2 "
            f"{float(np.median(dummy_times[1:])):.4f}); waits for the prefetched batch "
            f"{', '.join(f'{t:.4f}' for t in seen['data'])} s; launches {launches}; "
            f"torch.cuda.max_memory_allocated {peak / 2**30:.3f} GiB; the run dir's "
            f"dataset_statistics.json equal to the pipeline's ({card})")

        # One step traced, fed by the prefetcher: the wait for the batch and
        # the step, as the CLI's loop runs them.
        state = seen.pop("state")
        model_cfg, tcfg = FT.model_config(cfg), FT.train_config(cfg)
        dataset, collator, _ = FT.training_data(cfg, model_cfg, platform, 8)
        prefetched = DevicePrefetcher(batch_iterator(dataset, cfg.batch_size, collator),
                                      torch.device(cfg.device))
        try:
            step = lambda: train_step(state, next(prefetched), model_cfg, platform, tcfg)  # noqa
            untraced = [timed(step) for _ in range(2)]
            wall, n, busy, by_class = trace(step)
        finally:
            prefetched.close()
        if busy is None:
            log(f"[profile] episode-fed step: untraced {untraced} ms; device time not measured")
        else:
            log(f"[profile] episode-fed step (prefetcher, B=8): untraced "
                f"{', '.join(f'{t:.1f}' for t in untraced)} ms; traced {wall:.1f} ms with {n} "
                f"kernels and {busy:.1f} ms of device time; idle share of the traced step "
                f"{1 - busy / wall:.3f}, estimate for the untraced ones "
                f"{1 - busy / float(np.median(untraced)):.3f} (host clock, ends in "
                f"torch.cuda.synchronize; {card})")
            log_classes("profile", by_class)
        del state
        gc.collect()
        torch.cuda.empty_cache()
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(run_root, ignore_errors=True)
        log(f"[episodes] the dataset is removed; phase 13 took "
            f"{time.perf_counter() - t_phase:.1f} s (host clock)")


# === Phase 14: QLoRA, the remat policies, run management (PR 19) ===
# The fine-tuning CLI's QLoRA runs: phase 10's flags on an int8 base (B = 8)
# and on an int4 base at B = 1, where every int4 linear takes K5 (at most
# FUSED_MAX_ROWS rows), and at B = 8, where none does.
QLORA_INT8_FLAGS = TRAIN_FLAGS + ["--quantize_base", "True"]
QLORA_INT4_FLAGS = QLORA_INT8_FLAGS + ["--quantize_base_bits", "4", "--batch_size", "1"]
QLORA_INT4_B8_FLAGS = QLORA_INT8_FLAGS + ["--quantize_base_bits", "4"]
REMAT_POLICIES = ("all", "dots", "attn_out", "none")
# The 7B's LLM linears at the training length T = 585 rows (B = 1):
# (names, K, N); wq, wk, wv and wo share a shape, and so do gate and up.
TRAIN_INT4_SHAPES = [("wq wk wv wo", 4096, 4096), ("gate up", 4096, 11008),
                     ("down", 11008, 4096)]


# Phases 10-15 and 18 (a), (d) run random:7b with its Llama cut to CUT_LAYERS of its 32
# layers, every width kept (registered as CUT_LLM_ID): their checks (the
# counts a step, bitwise restores and policies, parity, moved shares) do not
# depend on the depth, and the whole run, phase 21's full-depth bench
# included, must end within its time limit.
CUT_LAYERS = 2
CUT_LLM_ID = f"llama2-7b-pure-{CUT_LAYERS}-layers"


@contextlib.contextmanager
def cut_flagship():
    """The fine-tuning CLI's, train.py's and pretrain.py's `random:7b` model
    with its Llama cut to CUT_LAYERS layers inside the block."""
    import openvla_oft_tpu_torch.config as C
    from openvla_oft_tpu_torch.scripts import pretrain as PP
    from openvla_oft_tpu_torch.scripts import train as PT
    from openvla_oft_tpu_torch.training import finetune as FT

    def cut(cfg):
        return dataclasses.replace(cfg, llm_backbone_id=CUT_LLM_ID) \
            if cfg.llm_backbone_id == "llama2-7b-pure" else cfg

    C._LLM_REGISTRY[CUT_LLM_ID] = dataclasses.replace(C._LLM_REGISTRY["llama2-7b-pure"],
                                                      num_layers=CUT_LAYERS)
    ft_config, pt_config = FT.model_config, PT.model_config
    try:
        with patched(FT, "model_config", lambda cfg: cut(ft_config(cfg))), \
                patched(PT, "model_config", lambda ckpt: cut(pt_config(ckpt))), \
                patched(PP, "model_config", lambda ckpt: cut(pt_config(ckpt))):
            yield
    finally:
        C._LLM_REGISTRY.pop(CUT_LLM_ID, None)


# Phases 8c and 8d serve the flagship, and phase 16 Phi-2, with the LLM cut
# to SERVE_CUT_LAYERS of its 32 layers, every width kept (`cut_llm`): their
# checks count per layer and hold each path against its plain version, and
# the whole run, phase 21's full-depth bench included, must end within its
# time limit.
SERVE_CUT_LAYERS = 2


@contextlib.contextmanager
def cut_llm(llm_id: str, n_layers: int):
    """The registered LLM `llm_id` with its first `n_layers` layers,
    registered as f"{llm_id}-{n_layers}-layers" inside the block; yields
    that id."""
    import openvla_oft_tpu_torch.config as C

    cut = f"{llm_id}-{n_layers}-layers"
    C._LLM_REGISTRY[cut] = dataclasses.replace(C._LLM_REGISTRY[llm_id], num_layers=n_layers)
    try:
        yield cut
    finally:
        C._LLM_REGISTRY.pop(cut, None)


@contextlib.contextmanager
def cut_serving_flagship():
    """`serving/deploy.py::flagship_policy` (and `scripts/bench_ar.py`, which
    calls it) with its Llama cut to SERVE_CUT_LAYERS layers inside the block."""
    from openvla_oft_tpu_torch.serving import deploy

    vision, llm = deploy.FLAGSHIP_IDS
    with cut_llm(llm, SERVE_CUT_LAYERS) as cut, patched(deploy, "FLAGSHIP_IDS", (vision, cut)):
        yield


@contextlib.contextmanager
def patched(module, name: str, value):
    """module.name = value inside the block (the plain path of a parity check)."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def quantized_linear_calls(cfg, min_dim: int) -> tuple:
    """(LLM, ViT, projector) quantized linear calls in one training forward,
    from the model's widths and `quantize_base_min_dim`: each linear whose
    contraction dim is at least min_dim (`ops/quant.py::_is_quantizable`;
    every one of them is even, as int4 needs). The LLM's 7 linears in each
    of its layers, each ViT's qkv, proj, fc1 and fc2 in its depth - 1 blocks
    that run (the tap skips the last), the projector's fc1-fc3 once."""
    llm = cfg.llm
    n_llm = llm.num_layers * sum(k >= min_dim for k in [llm.hidden_size] * 6
                                 + [llm.intermediate_size])
    n_vit = sum((v.depth - 1) * sum(k >= min_dim for k in (v.width, v.width, v.width,
                                                            v.mlp_dim))
                for v in cfg.vision_configs)
    proj_in = ([cfg.vision_dim, 4 * cfg.vision_dim, cfg.llm_dim]
               if cfg.use_fused_vision_backbone else [cfg.vision_dim, cfg.llm_dim])
    return n_llm, n_vit, sum(k >= min_dim for k in proj_in)


def path_vs_plain(state, flags, label: str, plain, card: str) -> None:
    """One loss and backward from `state` and the CLI's first batch through
    the card's path and inside `plain` (a context that swaps the plain
    version in); phase 12's bounds: loss within TRAIN_LOSS_REL, gradient
    cosine >= TRAIN_GRAD_COSINE per group."""
    from openvla_oft_tpu_torch.bridge import tree_leaves
    from openvla_oft_tpu_torch.training import train_step as TT

    dev = state.base_params["llm"]["embed"]["embedding"].device
    cfg, platform, tcfg, batch = training_setup(flags)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    leaves = tree_leaves(state.trainables)
    loss, grads = {}, {}
    for name, ctx in (("card", contextlib.nullcontext()), ("plain", plain())):
        before = launch_counts()
        t0 = time.perf_counter()
        with ctx:
            l, _ = TT.loss_and_metrics(state.trainables, state.base_params, batch, cfg,
                                       platform, tcfg,
                                       torch.Generator(device=dev).manual_seed(11))
            grads[name] = torch.autograd.grad(l, leaves)
        torch.cuda.synchronize()
        loss[name] = l.item()
        used = {k: v - before[k] for k, v in launch_counts().items()}
        log(f"[{label}] {name} path: loss={loss[name]:.6f} launches {used}, "
            f"{time.perf_counter() - t0:.2f} s (host clock)")
    rel = abs(loss["card"] - loss["plain"]) / abs(loss["plain"])
    ok = np.isfinite(loss["card"]) and rel <= TRAIN_LOSS_REL
    start = 0
    for group, tree in state.trainables.items():
        stop = start + len(tree_leaves(tree))
        flat = [torch.cat([x.float().flatten() for x in grads[n][start:stop]])
                for n in ("card", "plain")]
        cos = torch.nn.functional.cosine_similarity(flat[0], flat[1], dim=0).item()
        same = all(torch.equal(a, b) for a, b in zip(grads["card"][start:stop],
                                                      grads["plain"][start:stop]))
        log(f"[{label}] {group}: gradient cosine(card, plain) = {cos:.6f}, bitwise equal "
            f"{same}")
        ok = ok and cos >= TRAIN_GRAD_COSINE
        start = stop
    log(f"[{label}] loss relative difference {rel:.3e} (bound {TRAIN_LOSS_REL}) ({card})")
    if not ok:
        raise AssertionError(f"{label}: the card's path disagrees with the plain one")


def int4_training_times(card: str, b1_step_s: float, b8_step_s: float,
                        layers: int) -> dict:
    """K5 at the LLM's training shapes (T = 585, B = 1) beside torch.matmul
    on the bf16 weight (device times, L2 flushed), and at B = 8 (T = 4,680)
    the dequant product that the int4 linears take (`int4_matmul_ref`: an
    fp32 product of bf16 values) beside `torch.mm(..., out_dtype=float32)`
    on bf16 operands (CUDA events), with the share of the B = 8 step that
    `layers` layers x 3 passes of the former come to (the forward, its
    recompute and the product of the backward)."""
    from openvla_oft_tpu_torch.ops import int4_matmul as M
    from openvla_oft_tpu_torch.ops.quant import dequantize_int4, quantize_weight_int4

    dev = torch.device("cuda")
    flush = l2_flush_buffer(dev)
    out = {}
    per_layer_ref = per_layer_mm = 0.0
    for names, k, n in TRAIN_INT4_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(k + n)
        q = quantize_weight_int4(torch.randn((k, n), generator=gen, device=dev) * 0.02)
        packed, scales = q["kernel_q4"], q["scale_w4"]
        w16 = dequantize_int4(packed, scales, torch.bfloat16)
        x = torch.randn((585, k), generator=gen, device=dev).bfloat16()
        dev5, how5 = device_ms(lambda: M.int4_matmul_fused(x, packed, scales), flush)
        dev_lib, how_lib = device_ms(lambda: torch.matmul(x, w16), flush)
        b5 = bound(2 * 585 * k * n, nbytes(x, packed, scales) + 585 * n * 4, PEAK_BF16)
        x8 = torch.randn((4680, k), generator=gen, device=dev).bfloat16()
        ref = cuda_time_ms(lambda: M.int4_matmul_ref(x8, packed, scales), flush=flush)
        try:
            mm = cuda_time_ms(lambda: torch.mm(x8, w16, out_dtype=torch.float32), flush=flush)
        except (RuntimeError, TypeError, NotImplementedError) as e:
            mm = None
            log(f"[qlora-int4] torch.mm(..., out_dtype=float32) is not at hand: {e}")
        count = len(names.split())
        per_layer_ref += count * ref
        per_layer_mm += count * (mm or 0.0)
        out[names] = {"k5": dev5, "matmul": dev_lib, "bound": b5, "ref_b8": ref, "mm_b8": mm}
        log(f"[qlora-int4] {names} ({k} -> {n}) at T = 585: K5 {dev5:.4f} ms ({how5}), "
            f"torch.matmul on the bf16 weight {dev_lib:.4f} ({how_lib}), K5 / matmul "
            f"{dev5 / dev_lib:.2f}, bound {b5[0]:.4f} ({b5[1]}); at T = 4,680: "
            f"int4_matmul_ref {ref:.4f} ms, torch.mm(bf16, bf16, out_dtype=float32) "
            f"{'n/a' if mm is None else f'{mm:.4f}'} ms (CUDA events, L2 flushed) ({card})")
        del q, packed, scales, w16, x, x8
    share = 3 * layers * per_layer_ref / 1e3 / b8_step_s
    log(f"[qlora-int4] the LLM's dequant products at B = 8: {3 * layers * per_layer_ref:.1f} "
        f"ms a step ({layers} layers x 3 passes), {share:.3f} of the median B = 8 step "
        f"({b8_step_s:.3f} s); with torch.mm(out_dtype=float32) "
        f"{3 * layers * per_layer_mm:.1f} ms; the B = 1 step {b1_step_s:.3f} s ({card})")
    del flush
    torch.cuda.empty_cache()
    return out


# Phase 14's QLoRA runs without a mesh, the references of phase 18 (d):
# their losses, trainables after the last step and after step 0, group sizes
# and the quantized products a step.
QLORA_REFS = {}


def reference_run(state, info, extra: dict) -> dict:
    """A CLI run's outcome, kept for a later run to be held against."""
    from openvla_oft_tpu_torch.bridge import tree_leaves

    return {"losses": info["losses"], "first": info["first"], "extra": extra,
            "trainables": [t.detach().clone() for t in tree_leaves(state.trainables)],
            "groups": {g: len(tree_leaves(t)) for g, t in state.trainables.items()}}


def qlora_phase(card: str, n_layers: int, bf16_peak: int) -> dict:
    """Phase 14 (a), (b): QLoRA int8 at B = 8 and int4 at B = 1 (K5) and
    B = 8 (the dequant path) through the fine-tuning CLI, each with its
    launches a step against the count from the widths, its step times and
    peak, and the card's path against the plain one. Returns the launches."""
    from openvla_oft_tpu_torch.ops import quant as Q

    runs = {}
    t_phase = time.perf_counter()
    cfg = training_setup(QLORA_INT8_FLAGS)[0]
    n_llm, n_vit, n_proj = quantized_linear_calls(cfg, 1024)
    per_step = 2 * (n_llm + n_vit) + n_proj          # remat "all": forward and recompute
    log(f"[qlora] quantized linears a forward: LLM {n_llm}, ViTs {n_vit}, projector "
        f"{n_proj}; a step under remat \"all\" launches 2 x ({n_llm} + {n_vit}) + {n_proj} = "
        f"{per_step} products (the backward's are dequantized bf16 products)")
    # (a) int8 at B = 8.
    state, runs["QLoRA int8"], info = train(card, n_layers, QLORA_INT8_FLAGS, "qlora-int8",
                                            expect_extra={"int8": per_step}, keep_first=True)
    QLORA_REFS["QLoRA int8"] = reference_run(state, info, {"int8": per_step})
    log(f"[qlora-int8] step times {', '.join(f'{t:.4f}' for t in info['step_times'])} s; "
        f"peak of steps 1-2 {info['step_peak'] / 2**30:.3f} GiB, of the run (build "
        f"included) {info['peak'] / 2**30:.3f} GiB, against phase 10's bf16 run "
        f"{bf16_peak / 2**30:.3f} GiB ({card})")
    path_vs_plain(state, QLORA_INT8_FLAGS, "qlora-int8-parity",
                  lambda: patched(Q, "int8_mm", Q.int8_mm_ref), card)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    # (b) int4 at B = 1: every int4 linear takes K5.
    state, runs["QLoRA int4 B=1"], info1 = train(card, n_layers, QLORA_INT4_FLAGS,
                                                 "qlora-int4", expect_extra={"K5": per_step},
                                                 keep_first=True)
    QLORA_REFS["QLoRA int4 B=1"] = reference_run(state, info1, {"K5": per_step})
    log(f"[qlora-int4] B = 1: step times {', '.join(f'{t:.4f}' for t in info1['step_times'])}"
        f" s; peak of steps 1-2 {info1['step_peak'] / 2**30:.3f} GiB, of the run (build "
        f"included) {info1['peak'] / 2**30:.3f} GiB ({card})")
    path_vs_plain(state, QLORA_INT4_FLAGS, "qlora-int4-parity",
                  lambda: patched(Q, "FUSED_MAX_ROWS", 0), card)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    # int4 at B = 8: above FUSED_MAX_ROWS every int4 linear takes the dequant path.
    state, runs["QLoRA int4 B=8"], info8 = train(card, n_layers, QLORA_INT4_B8_FLAGS,
                                                 "qlora-int4-b8", steps=2)
    log(f"[qlora-int4] B = 8: step times {', '.join(f'{t:.4f}' for t in info8['step_times'])}"
        f" s; peak of step 1 {info8['step_peak'] / 2**30:.3f} GiB, of the run (build "
        f"included) {info8['peak'] / 2**30:.3f} GiB ({card})")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    runs["int4 times"] = int4_training_times(card, float(np.median(info1["step_times"][1:])),
                                             float(np.median(info8["step_times"])), n_layers)
    log(f"[qlora] phase 14 (a), (b) took {time.perf_counter() - t_phase:.1f} s (host clock)")
    return runs


def remat_phase(card: str, n_layers: int) -> dict:
    """Phase 14 (c): the remat policies on the CLI's bf16 model at B = 8,
    from the same weights (LoRA B drawn with std 1e-3) and batch: 3 losses
    and backwards each, the first's loss and gradients bitwise those of
    "all" (or, where two runs of "all" differ, cosine >= 0.9999 per group),
    the median time, the peak, and the launches a step (K1 twice the layers
    except under "none"). Returns the launches."""
    from openvla_oft_tpu_torch.bridge import tree_leaves
    from openvla_oft_tpu_torch.training import finetune as FT
    from openvla_oft_tpu_torch.training import train_step as TT

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    cfg = FT.parse_config(TRAIN_FLAGS)
    model_cfg, platform = FT.model_config(cfg), FT.platform_of(cfg)
    base, trainables = FT.build_model(cfg, model_cfg, platform, dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    with torch.no_grad():
        for b in _lora_b(trainables["lora"]):
            b.normal_(0.0, 1e-3, generator=gen)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in FT.first_batch(cfg).items()}
    leaves = tree_leaves(trainables)
    groups = [(g, len(tree_leaves(t))) for g, t in trainables.items()]
    ref, runs, deterministic = None, {}, True
    for policy in REMAT_POLICIES:
        tcfg = dataclasses.replace(FT.train_config(cfg), remat_policy=policy)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        times, first = [], None
        for i in range(3):
            t0 = time.perf_counter()
            loss, _ = TT.loss_and_metrics(trainables, base, batch, model_cfg, platform, tcfg,
                                          torch.Generator(device=dev).manual_seed(11))
            grads = torch.autograd.grad(loss, leaves)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if i == 0:
                first = (loss.detach(), grads)
            elif i == 1 and policy == "all":
                deterministic = torch.equal(loss, first[0]) and all(
                    torch.equal(a, b) for a, b in zip(grads, first[1]))
                log(f"[remat] two runs of \"all\" bitwise equal: {deterministic}")
            del loss, grads
        peak = torch.cuda.max_memory_allocated()
        launches = {k: v // 3 for k, v in launch_counts().items()}
        runs[policy] = launch_counts()
        want = {"K1": (1 if policy == "none" else 2) * n_layers, "K2": n_layers,
                "K3": n_layers, "K4": 0, "K5": 0, "K6": 0, "probe": 0, "int8": 0}
        log(f"[remat] {policy}: loss {first[0].item():.6f}; times "
            f"{', '.join(f'{t:.4f}' for t in times)} s, median {float(np.median(times)):.4f} "
            f"s (host clock around loss and backward, ends in torch.cuda.synchronize); "
            f"peak {peak / 2**30:.3f} GiB; launches a step {launches} ({card})")
        if launches != want:
            raise AssertionError(f"remat {policy}: launched {launches} a step, expected {want}")
        if ref is None:
            ref = first
            continue
        same_loss = torch.equal(first[0], ref[0])
        start, ok = 0, same_loss or not deterministic
        for group, n in groups:
            a, b = first[1][start:start + n], ref[1][start:start + n]
            same = all(torch.equal(x, y) for x, y in zip(a, b))
            cos = torch.nn.functional.cosine_similarity(
                torch.cat([x.float().flatten() for x in a]),
                torch.cat([y.float().flatten() for y in b]), dim=0).item()
            log(f"[remat] {policy} against \"all\": {group} gradients bitwise equal {same}, "
                f"cosine {cos:.8f}")
            ok = ok and (same if deterministic else cos >= 0.9999)
            start += n
        log(f"[remat] {policy} against \"all\": loss bitwise equal {same_loss}")
        if not ok:
            raise AssertionError(f"remat {policy} changed the loss or the gradients")
        del first
    del base, trainables, ref, batch
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[remat] phase 14 (c) took {time.perf_counter() - t_phase:.1f} s (host clock)")
    return runs


def _lora_b(tree):
    """The LoRA B factors of a tree."""
    for key, node in tree.items():
        if key == "b":
            yield node
        elif isinstance(node, dict):
            yield from _lora_b(node)


def states_bitwise_equal(a, b, path="") -> int:
    """`trees_bitwise_equal` over a state dict: tensors bit for bit, other
    leaves (numbers, None, strings) equal; returns the number of tensors."""
    if isinstance(a, torch.Tensor):
        return trees_bitwise_equal(a.detach(), b.detach(), path)
    if isinstance(a, dict):
        if sorted(a, key=str) != sorted(b, key=str):
            raise AssertionError(f"{path}: keys {sorted(a, key=str)} != {sorted(b, key=str)}")
        return sum(states_bitwise_equal(a[k], b[k], f"{path}/{k}") for k in a)
    if isinstance(a, (list, tuple)):
        return sum(states_bitwise_equal(x, y, f"{path}/{i}")
                   for i, (x, y) in enumerate(zip(a, b, strict=True)))
    if a != b:
        raise AssertionError(f"{path}: {a!r} != {b!r}")
    return 0


def run_management(ckpt: str, card: str, rng, n_layers: int) -> dict:
    """Phase 14 (d), (e), inside phase 8e on its 2-layer dir: the CLI with
    the merged export every 2 steps (its dirs, the .pt files re-imported
    bitwise, the merged dir served bitwise as the in-memory merge), a resume
    from step 2 (the restored state bitwise the saved one), the save's times,
    and a SIGTERM at the third micro-step (a checkpoint at 3, final_step 3,
    the handler restored, a resumed run to the end). Returns the launches."""
    import signal

    from openvla_oft_tpu_torch import config as C
    from openvla_oft_tpu_torch.constants import get_platform
    from openvla_oft_tpu_torch.policy import OpenVLAPolicy
    from openvla_oft_tpu_torch.processing.sentencepiece import (SentencePieceTokenizer,
                                                                parse_model_proto)
    from openvla_oft_tpu_torch.serving.deploy import (DeployConfig, OpenVLAServer,
                                                      get_action_from_server, serving_params)
    from openvla_oft_tpu_torch.training import checkpoint as CK
    from openvla_oft_tpu_torch.training import finetune as FT
    from openvla_oft_tpu_torch.training.lora import apply_lora

    t_phase = time.perf_counter()
    root = checkpoint_dir(int(3 * sum(os.path.getsize(os.path.join(ckpt, f))
                                      for f in os.listdir(ckpt))))
    flags = TRAIN_FLAGS + ["--vla_path", ckpt, "--save_freq", "2", "--run_root_dir", root]
    per_step = {"K1": 2 * n_layers, "K2": n_layers, "K3": n_layers, "K4": 0, "K5": 0,
                "K6": 0, "probe": 0, "int8": 0}
    runs, server = {}, None

    def run(label, extra, steps, on_step=None):
        reset_launch_counts()
        CK.SAVE_LOG.clear()
        t0 = time.perf_counter()
        out = FT.main(flags + extra, on_step=on_step)
        launches = launch_counts()
        log(f"[{label}] finetune: final_step {out['final_step']} in "
            f"{time.perf_counter() - t0:.1f} s; launches {launches}; saves " + "; ".join(
                f"{os.path.basename(r['path'])}: {r['bytes'] / 2**20:.1f} MiB, host snapshot "
                f"{r['snapshot_s'] * 1e3:.1f} ms, background write "
                f"{r.get('write_s', float('nan')) * 1e3:.1f} ms" for r in CK.SAVE_LOG)
            + f" (host clock; {card})")
        want = {k: steps * v for k, v in per_step.items()}
        if launches != want:
            raise AssertionError(f"{label}: launched {launches}, expected {want}")
        runs[label] = launches
        return out

    try:
        # (d) the merged export every 2 steps.
        seen = {"times": []}

        def on_step(step, metrics, state):
            seen["times"].append(metrics["step_time"])
            seen["state"] = state
            if step == 1:
                seen["saved2"] = CK.host_snapshot({"trainables": state.trainables,
                                                   "optimizer": state.optimizer.state_dict()})

        out = run("run-management", ["--max_steps", "3", "--merge_lora_during_training",
                                     "True"], 3, on_step)
        run_dir, state = out["run_dir"], seen["state"]
        log(f"[run-management] step times {', '.join(f'{t:.4f}' for t in seen['times'])} s "
            f"(step 2 follows the save at 2: the resume file's background write and the "
            f"merged export) ({card})")
        for n in (2, 3):
            d = f"{run_dir}--{n}_chkpt"
            need = ["dataset_statistics.json", f"action_head--{n}_checkpoint.pt",
                    f"proprio_projector--{n}_checkpoint.pt", "config.json",
                    "model.safetensors", "tokenizer.model"]
            missing = [f for f in need if not os.path.isfile(os.path.join(d, f))]
            files = {f: os.path.getsize(os.path.join(d, f)) for f in sorted(os.listdir(d))}
            log(f"[run-management] {os.path.basename(d)}: " + ", ".join(
                f"{f} {b:,} B" for f, b in files.items()))
            if missing:
                raise AssertionError(f"{d} lacks {missing}")
        d3 = f"{run_dir}--3_chkpt"
        heads = {"action_head": CK.import_action_head_pt(
                     os.path.join(d3, "action_head--3_checkpoint.pt"), device="cuda"),
                 "proprio_projector": CK.import_projector_pt(
                     os.path.join(d3, "proprio_projector--3_checkpoint.pt"), device="cuda")}
        n_pt = trees_bitwise_equal({k: CK.host_snapshot(state.trainables[k]) for k in heads},
                                   CK.host_snapshot(heads))
        log(f"[run-management] the re-imported .pt files: {n_pt} leaves bitwise equal to the "
            f"trained state")
        shutil.rmtree(f"{run_dir}--2_chkpt")

        # get_vla on the merged dir against the in-memory merge of the trained state.
        model_cfg, norm_stats = C.OpenVLAConfig.from_json_file(os.path.join(d3, "config.json"))
        model_cfg = dataclasses.replace(model_cfg, num_images_in_input=2)
        with torch.no_grad():
            params = apply_lora(state.base_params, state.trainables["lora"], rank=32, alpha=16.0)
            params = _detached({**params, **{k: state.trainables[k] for k in heads}})
        with open(os.path.join(d3, "tokenizer.model"), "rb") as f:
            tokenizer = SentencePieceTokenizer(parse_model_proto(f.read()))
        memory_policy = OpenVLAPolicy(cfg=model_cfg, platform=get_platform("libero"),
                                      params=serving_params(params), norm_stats=norm_stats,
                                      tokenizer=tokenizer)
        del params, seen["state"], state
        deploy_cfg = DeployConfig(pretrained_checkpoint=d3, device="cuda",
                                  unnorm_key=CKPT_UNNORM_KEY, num_images_in_input=2,
                                  device_preprocess=True, num_open_loop_steps=8, warmup=False,
                                  host="127.0.0.1", port=free_port())
        server = OpenVLAServer(deploy_cfg)
        server.run(background=True)
        obs = observation(memory_policy, rng)
        action = np.asarray(get_action_from_server(obs, f"http://127.0.0.1:{deploy_cfg.port}/act"))
        server.shutdown()
        server = None
        want = memory_policy.predict_action_from_frames(
            frames_of(memory_policy, obs), obs["instruction"], proprio=obs["state"],
            unnorm_key=CKPT_UNNORM_KEY)
        if action.shape != want.shape or not np.array_equal(action, want) \
                or not np.isfinite(action).all():
            raise AssertionError(f"the merged dir answered max|d| = "
                                 f"{np.abs(action - want).max():.3e} from the in-memory merge")
        log(f"[run-management] /act on the merged dir (get_vla): {action.shape}, bitwise equal "
            f"to the in-memory policy built from apply_lora on the trained state ({card})")
        del memory_policy
        gc.collect()
        torch.cuda.empty_cache()

        # The resume from step 2 to 4, the restored state against the saved one.
        restored = {}
        original = FT.restore_training_state

        def capture(state, *args, **kw):
            step = original(state, *args, **kw)
            restored["state"] = CK.host_snapshot({"trainables": state.trainables,
                                                  "optimizer": state.optimizer.state_dict()})
            return step

        with patched(FT, "restore_training_state", capture):
            out2 = run("resume", ["--max_steps", "4", "--resume", "True", "--resume_step", "2",
                                  "--run_id_override", os.path.basename(run_dir),
                                  "--merge_lora_during_training", "False"], 2)
        n_state = states_bitwise_equal(seen["saved2"], restored["state"])
        if out2["final_step"] != 4 or CK.latest_step(os.path.join(run_dir, "ckpt")) != 4:
            raise AssertionError(f"the resumed run ended at {out2}")
        log(f"[resume] from step 2 to {out2['final_step']}: the restored trainables and "
            f"optimizer state, {n_state} tensors, bitwise equal to the saved ones")

        # (e) SIGTERM at the third micro-step.
        before = signal.getsignal(signal.SIGTERM)
        times = []

        def preempt(step, metrics, state):
            times.append(metrics["step_time"])
            if step == 2:
                os.kill(os.getpid(), signal.SIGTERM)

        pflags = ["--max_steps", "4", "--merge_lora_during_training", "False",
                  "--run_id_note", "preempt"]
        out3 = run("preempt", pflags, 3, preempt)
        ckpt_dir = os.path.join(out3["run_dir"], "ckpt")
        restored_handler = signal.getsignal(signal.SIGTERM) is before
        log(f"[preempt] step times {', '.join(f'{t:.4f}' for t in times)} s (step 2 follows "
            f"the save at 2 and overlaps its background write; step 1 follows none) "
            f"({card})")
        if out3["final_step"] != 3 or CK.latest_step(ckpt_dir) != 3 or not restored_handler:
            raise AssertionError(f"preemption: final_step {out3['final_step']}, latest "
                                 f"checkpoint {CK.latest_step(ckpt_dir)}, SIGTERM handler "
                                 f"restored {restored_handler}")
        out4 = run("preempt-resume", pflags + ["--resume", "True", "--run_id_override",
                                               os.path.basename(out3["run_dir"])], 1)
        if out4["final_step"] != 4:
            raise AssertionError(f"the run resumed after preemption ended at {out4}")
        log(f"[preempt] SIGTERM at micro-step 3: saved at 3, final_step 3, the SIGTERM handler "
            f"restored; resumed from 3 to {out4['final_step']} ({card})")
    finally:
        if server is not None:
            server.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    log(f"[run-management] phase 14 (d), (e) took {time.perf_counter() - t_phase:.1f} s "
        f"(host clock)")
    return runs


# === Phase 15: full-parameter training and VLM pretraining (PR 20) ===
# The scripts' runs at random:7b's full width, its Llama cut to CUT_LAYERS
# (`cut_flagship`): pretrain.py's align and finetune on a LLaVA JSON whose
# images are the JPEG goldens' bytes, train.py's four stages on dummy
# LIBERO data; B = 8, 3 steps each, each saved and restored bitwise.
FULL_BATCH, FULL_STEPS = 8, 3
LLAVA_RECORDS = 32
PROMPT = "What is on the table?"


def golden_entries() -> list:
    """The JPEG goldens' (name, bytes, pixels): PIL's ISLOW golden, then TF's."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "goldens")
    entries = []
    for name in ("jpeg_decode_pil.npz", "jpeg_decode_tf.npz"):
        with np.load(os.path.join(root, name)) as z:
            entries.append([(str(n), z[f"data_{i}"].tobytes(), z[f"pixels_{i}"])
                            for i, n in enumerate(z["names"])])
    return entries


def golden_jpegs(entries=None) -> list:
    """(name, bytes) of every golden JPEG at least 16 pixels a side."""
    return [(n, d) for part in entries or golden_entries() for n, d, px in part
            if min(px.shape[:2]) >= 16]


def islow_check(card: str) -> list:
    """Phase 15 (a): both decoders with `idct="islow"` bitwise PIL's pixels
    on the ISLOW golden. Returns the JPEG bytes of both goldens."""
    from openvla_oft_tpu_torch.processing.jpeg_decode import decode_jpeg, decode_jpeg_plain

    entries = golden_entries()
    t0 = time.perf_counter()
    for name, data, pixels in entries[0]:
        for label, decoder in (("host library", decode_jpeg), ("plain", decode_jpeg_plain)):
            got = decoder(data, idct="islow")
            if got.shape != pixels.shape or not np.array_equal(got, pixels):
                raise AssertionError(f"the {label} ISLOW decoder differs from PIL on {name}")
    log(f"[islow] JPEG decoders, host library and plain, idct=islow bitwise equal to PIL "
        f"on all {len(entries[0])} entries of jpeg_decode_pil.npz "
        f"({', '.join(n for n, _, _ in entries[0])}) in {time.perf_counter() - t0:.1f} s")
    return golden_jpegs(entries)


def llava_json(jpegs: list, root: str) -> tuple:
    """A LLaVA JSON of LLAVA_RECORDS records (2 or 4 turns) over the JPEG
    files written under root/images; returns (json path, image root)."""
    images = os.path.join(root, "images")
    os.makedirs(images, exist_ok=True)
    words = ("a table with two blocks on it near the wall and a bowl the robot holds a "
             "plate of red green blue objects in the light").split()
    rng = np.random.default_rng(0)
    recs = []
    for i in range(LLAVA_RECORDS):
        name, data = jpegs[i % len(jpegs)]
        fname = f"{i:03d}_{name}.jpg"
        with open(os.path.join(images, fname), "wb") as f:
            f.write(data)
        say = lambda n: " ".join(rng.choice(words, n))      # noqa: E731
        turns = [{"from": "human", "value": f"<image>\n{say(8)}?"},
                 {"from": "gpt", "value": say(int(rng.integers(20, 90)))}]
        if i % 2:
            turns += [{"from": "human", "value": f"{say(6)}?"},
                      {"from": "gpt", "value": say(int(rng.integers(10, 60)))}]
        recs.append({"id": str(i), "image": fname, "conversations": turns})
    path = os.path.join(root, "chat.json")
    with open(path, "w") as f:
        json.dump(recs, f)
    return path, images


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _sample(t: torch.Tensor) -> torch.Tensor:
    """About 65,536 evenly strided entries of a leaf, copied."""
    flat = t.detach().reshape(-1)
    return flat[::max(1, flat.numel() // 65536)].clone()


def _equal_on_host(a, b, path="") -> int:
    """`states_bitwise_equal` of a restored state (host tensors) and the
    live one, each live tensor brought to the host alone; returns the
    number of tensors."""
    if isinstance(a, torch.Tensor):
        return trees_bitwise_equal(a, b.detach().cpu(), path)
    if isinstance(a, dict):
        if sorted(a, key=str) != sorted(b, key=str):
            raise AssertionError(f"{path}: keys {sorted(a, key=str)} != {sorted(b, key=str)}")
        return sum(_equal_on_host(a[k], b[k], f"{path}/{k}") for k in a)
    if isinstance(a, (list, tuple)):
        return sum(_equal_on_host(x, y, f"{path}/{i}")
                   for i, (x, y) in enumerate(zip(a, b, strict=True)))
    if a != b:
        raise AssertionError(f"{path}: {a!r} != {b!r}")
    return 0


def full_stage(card: str, label: str, run, cfg, n_layers: int) -> dict:
    """One run of `run` (scripts/train.py's `train` or pretrain.py's
    `pretrain`) with `cfg`: launches K1 2 x n_layers, K2 and K3 n_layers a
    step and nothing else; step times; the peak (the build's and the first
    step's, then the later steps'); the optimizer's time a step (CUDA events
    recorded around its update, which add no synchronize); every group's sampled share of
    entries that moved (> 0); every frozen leaf bitwise its value before
    the first step (host copies); the checkpoint restored bitwise equal to
    the trained state. Returns launches, times, peaks and the state."""
    from openvla_oft_tpu_torch.bridge import tree_leaves
    from openvla_oft_tpu_torch.training import train_step as TT

    expect = {"K1": 2 * n_layers, "K2": n_layers, "K3": n_layers, "K4": 0, "K5": 0, "K6": 0,
              "probe": 0, "int8": 0}
    seen = {"prev": {k: 0 for k in expect}, "times": [], "opt": [], "events": []}

    def on_start(state):
        seen["frozen"] = {p: t.detach().to("cpu") for p, t in _paths(state.base_params).items()}
        seen["first"] = {p: _sample(t) for p, t in _paths(state.trainables).items()}
        seen["n_trainable"] = sum(t.numel() for t in tree_leaves(state.trainables))
        seen["n_frozen"] = sum(t.numel() for t in tree_leaves(state.base_params))

    def on_step(step, metrics, state):
        counts = launch_counts()
        per_step = {k: counts[k] - seen["prev"][k] for k in counts}
        seen["prev"] = counts
        seen["times"].append(metrics["step_time"])
        start, end = seen["events"][-1]     # the step ended in a synchronize
        seen["opt"].append(start.elapsed_time(end) / 1e3)
        log(f"[{label}] step {step}: loss={metrics['loss']:.6f} "
            f"grad_norm={metrics['grad_norm']:.6f} "
            f"token_accuracy={metrics['token_accuracy']:.4f} "
            f"step_time={metrics['step_time']:.4f} s (host clock, ends in "
            f"torch.cuda.synchronize), optimizer {seen['opt'][-1]:.4f} s (CUDA events "
            f"around the update); launches {per_step} ({card})")
        if not (np.isfinite(metrics["loss"]) and np.isfinite(metrics["grad_norm"])
                and metrics["grad_norm"] > 0):
            raise AssertionError(f"bad {label} step {step}: {metrics}")
        if per_step != expect:
            raise AssertionError(f"{label} step {step} launched {per_step}, expected {expect}")
        if step == 0:
            seen["peak0"] = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()

    update = TT.Optimizer.update

    def timed_update(self, grads):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = update(self, grads)
        end.record()
        seen["events"].append((start, end))
        return out

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with patched(TT.Optimizer, "update", timed_update):
        out = run(cfg, on_step=on_step, on_start=on_start)
    total = time.perf_counter() - t0
    launches = launch_counts()
    step_peak = torch.cuda.max_memory_allocated()
    state = out["state"]
    want = {k: FULL_STEPS * n for k, n in expect.items()}
    if out["final_step"] != FULL_STEPS or launches != want:
        raise AssertionError(f"{label}: {out['final_step']} steps, launches {launches}, "
                             f"expected {FULL_STEPS} and {want}")
    frozen_ok = all(torch.equal(t.detach().to("cpu"), seen["frozen"][p])
                    for p, t in _paths(state.base_params).items())
    if not frozen_ok or sorted(_paths(state.base_params)) != sorted(seen["frozen"]):
        raise AssertionError(f"{label}: a frozen leaf changed")
    moved = {}
    for group, tree in state.trainables.items():
        paths = _paths(tree, f"/{group}")
        changed = sum(int((_sample(t) != seen["first"][p]).sum()) for p, t in paths.items())
        n = sum(seen["first"][p].numel() for p in paths)
        moved[group] = changed / n
    log(f"[{label}] {out['final_step']} steps in {total:.1f} s (the model built on the card, "
        f"checkpoint written); {seen['n_trainable'] / 1e9:.3f} B "
        f"trainable, {seen['n_frozen'] / 1e9:.3f} B frozen (bitwise unchanged, "
        f"{len(seen['frozen'])} leaves); share of sampled entries moved by the 3 updates: "
        + ", ".join(f"{g} {m:.4f}" for g, m in moved.items())
        + f"; step times {', '.join(f'{t:.4f}' for t in seen['times'])} s, median of the "
        f"later {float(np.median(seen['times'][1:])):.4f} s; optimizer "
        f"{', '.join(f'{t:.4f}' for t in seen['opt'])} s, "
        f"{float(np.median(seen['opt'][1:])) / float(np.median(seen['times'][1:])):.3f} of a "
        f"later step; peak {max(seen['peak0'], step_peak) / 2**30:.3f} GiB (build and first "
        f"step {seen['peak0'] / 2**30:.3f}, later steps {step_peak / 2**30:.3f}); launches "
        f"{launches} ({card})")
    if not all(m > 0 for m in moved.values()):
        raise AssertionError(f"{label}: a trainable group did not move: {moved}")
    from openvla_oft_tpu_torch.training.checkpoint import SAVE_LOG

    rec = SAVE_LOG[-1]
    log(f"[{label}] save: {rec['bytes'] / 1e9:.2f} GB snapshotted to pinned host memory in "
        f"{rec['snapshot_s']:.2f} s, written in the background in {rec['write_s']:.2f} s")
    t1 = time.perf_counter()
    # Memory-mapped, so the file is read leaf by leaf, not held twice.
    restored = torch.load(out["ckpt"], map_location="cpu", mmap=True, weights_only=True)
    n = _equal_on_host(restored["trainables"], state.trainables)
    if "optimizer" in restored:
        n += _equal_on_host(restored["optimizer"], state.optimizer.state_dict())
    log(f"[{label}] checkpoint {out['ckpt']}: {os.path.getsize(out['ckpt']) / 1e9:.2f} GB, "
        f"restored bitwise equal to the trained state ({n} tensors, optimizer "
        f"{'included' if 'optimizer' in restored else 'not saved, as in JAX'}) in "
        f"{time.perf_counter() - t1:.1f} s")
    del restored
    shutil.rmtree(out["run_dir"], ignore_errors=True)
    return {"launches": launches, "times": seen["times"], "opt": seen["opt"],
            "peak": max(seen["peak0"], step_peak), "state": state}


def full_parity(state, model_cfg, card: str) -> None:
    """Phase 15 (e): one vla-full-train loss and backward through K1/K2/K3
    and through the dense path on the trained weights and the first dummy
    batch; phase 12's bounds, the cosine over all trainables and per group."""
    from openvla_oft_tpu_torch.bridge import tree_leaves
    from openvla_oft_tpu_torch.constants import LIBERO
    from openvla_oft_tpu_torch.data.collator import PaddedCollatorForActionPrediction
    from openvla_oft_tpu_torch.data.datasets import DummyDataset, RLDSBatchTransform
    from openvla_oft_tpu_torch.processing.action_tokenizer import ActionTokenizer
    from openvla_oft_tpu_torch.processing.processor import PrismaticProcessor
    from openvla_oft_tpu_torch.training import train_step as TT

    dev = tree_leaves(state.trainables)[0].device
    data = DummyDataset(RLDSBatchTransform(PrismaticProcessor(model_cfg), ActionTokenizer(),
                                           LIBERO),
                        image_size=model_cfg.vision_configs[0].image_size,
                        num_samples=FULL_BATCH)
    batch = PaddedCollatorForActionPrediction(pad_token_id=model_cfg.pad_token_id)(list(data))
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()
             if isinstance(v, np.ndarray)}
    tcfg = TT.TrainConfig(objective="discrete", use_proprio=False)
    leaves = tree_leaves(state.trainables)
    loss, grads = {}, {}
    for use_flash in (True, False):
        before = launch_counts()
        value, _ = TT.loss_and_metrics(state.trainables, state.base_params, batch, model_cfg,
                                       LIBERO, tcfg, use_flash=use_flash)
        grads[use_flash] = torch.autograd.grad(value, leaves)
        loss[use_flash] = value.item()
        used = {k: v - before[k] for k, v in launch_counts().items()}
        log(f"[full-parity] use_flash={use_flash}: loss={loss[use_flash]:.6f} launches {used}")
        del value
    rel = abs(loss[True] - loss[False]) / abs(loss[False])
    ok = np.isfinite(loss[True]) and rel <= TRAIN_LOSS_REL
    dot = {f: 0.0 for f in ("ab", "aa", "bb")}
    start = 0
    for group, tree in state.trainables.items():
        stop = start + len(tree_leaves(tree))
        g = {f: 0.0 for f in ("ab", "aa", "bb")}
        for a, b in zip(grads[True][start:stop], grads[False][start:stop]):
            a, b = a.double().flatten(), b.double().flatten()
            g["ab"] += float(a @ b)
            g["aa"] += float(a @ a)
            g["bb"] += float(b @ b)
        cos = g["ab"] / np.sqrt(g["aa"] * g["bb"])
        log(f"[full-parity] {group}: gradient cosine(K1/K2/K3 path, dense path) = {cos:.6f}")
        ok = ok and cos >= TRAIN_GRAD_COSINE
        for k in dot:
            dot[k] += g[k]
        start = stop
    cos_all = dot["ab"] / np.sqrt(dot["aa"] * dot["bb"])
    log(f"[full-parity] loss K1/K2/K3 path {loss[True]:.6f}, dense path {loss[False]:.6f}, "
        f"relative difference {rel:.3e} (bound {TRAIN_LOSS_REL}); gradient cosine over all "
        f"trainables {cos_all:.6f} (bound {TRAIN_GRAD_COSINE}) ({card})")
    if not (ok and cos_all >= TRAIN_GRAD_COSINE):
        raise AssertionError("full-parameter training through K1/K2/K3 disagrees with the "
                             "dense path")


def generate_phase(jpegs: list, root: str, card: str) -> dict:
    """Phase 15 (f): scripts/generate.py at random:7b, the stand-in
    tokenizer, a golden JPEG as the image, one prompt on its input stream:
    8 new tokens, K1 32 in the prefill and nothing else."""
    import io

    from openvla_oft_tpu_torch.scripts import generate as GEN

    path = os.path.join(root, "generate.jpg")
    with open(path, "wb") as f:
        f.write(jpegs[-1][1])
    gc.collect()
    torch.cuda.empty_cache()
    reset_launch_counts()
    t0 = time.perf_counter()
    answers = GEN.generate(GEN.GenerateConfig(model_path="random:7b", image_path=path,
                                              max_new_tokens=8, device="cuda"),
                           io.StringIO(PROMPT + "\n"))
    launches = launch_counts()
    want = {"K1": 32, "K2": 0, "K3": 0, "K4": 0, "K5": 0, "K6": 0, "probe": 0, "int8": 0}
    log(f"[generate] {PROMPT!r} -> {answers}; {time.perf_counter() - t0:.1f} s with the "
        f"7B's build; launches {launches} ({card})")
    if len(answers) != 1 or len(answers[0].split()) != 8 or launches != want:
        raise AssertionError(f"generate.py answered {answers} with launches {launches}, "
                             f"expected 8 tokens and {want}")
    return launches


def full_training_phase(card: str, n_layers: int) -> dict:
    """Phase 15, inside `cut_flagship`. Returns each run's launches (the
    parity's, which compare two paths, not counted)."""
    from openvla_oft_tpu_torch.scripts import pretrain as PP
    from openvla_oft_tpu_torch.scripts import train as PT

    t_phase = time.perf_counter()
    jpegs = islow_check(card)
    root = checkpoint_dir(24e9)
    runs = {}
    try:
        js, images = llava_json(jpegs, root)
        for stage in PP.STAGE_TRAINABLE:
            cfg = PP.PretrainConfig(stage=stage, pretrained_checkpoint="random:7b",
                                    llava_json=js, image_root=images, batch_size=FULL_BATCH,
                                    max_steps=FULL_STEPS, save_interval=FULL_STEPS,
                                    run_root_dir=Path(root), seq_bucket=128)
            log(f"[pretrain-{stage}] {LLAVA_RECORDS} records, seq_bucket {cfg.seq_bucket}: "
                f"S = {cfg.seq_bucket} text slots + 256 patches = {cfg.seq_bucket + 256}")
            out = full_stage(card, f"pretrain-{stage}", PP.pretrain, cfg, n_layers)
            runs[f"pretrain-{stage}"] = out.pop("launches")
            del out
        for stage in PT.STAGE_TRAINABLE:
            cfg = PT.TrainConfig(stage=stage, pretrained_checkpoint="random:7b",
                                 data_root_dir=Path("dummy"), dataset_name="libero_dummy",
                                 robot_platform="libero", batch_size=FULL_BATCH,
                                 max_steps=FULL_STEPS, save_interval=FULL_STEPS,
                                 run_root_dir=Path(root))
            out = full_stage(card, f"train-{stage}", PT.train, cfg, n_layers)
            runs[f"train-{stage}"] = out.pop("launches")
            if stage == "vla-full-train":
                state = out.pop("state")
                state.optimizer = None          # the moments, for the two gradients
                gc.collect()
                torch.cuda.empty_cache()
                full_parity(state, PT.model_config("random:7b"), card)
                del state
            del out
        runs["generate"] = generate_phase(jpegs, root, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[full-train] phase 15 took {time.perf_counter() - t_phase:.1f} s (host clock)")
    return runs


# === Phase 16: Phi-2 as the VLA's LLM; TFDS shards and the mixture ===
# The `phi-2+3b` registry row's model at full width and depth: CLIP ViT-L/14
# at 336 px (0.30 B) and Phi-2 (2.78 B with its biased lm_head: 32 layers of
# 32 x 80 heads, parallel blocks, partial RoPE, always the dense attention),
# seeded random bf16 weights drawn on the card, at LIBERO's geometry: 2
# images of 336², the 48-token bucket, the 8 x 7 chunk (S = 48 + 2 x 576 + 1
# + 57 = 1,258).
PHI_IDS = ("clip-vit-l-336px", "phi-2-3b")
PHI_TOKENIZER_PIECES = 51200            # every Phi-2 id decodes
PHI_SHARD_BYTES = 2 * 10**9
PHI_PRETRAIN_BUCKET = 128
# The TFDS datasets of (c): raw LIBERO layout, each EPISODES_PER_SET episodes
# of the golden's 256 x 256 frames, mixed MIX_WEIGHTS; shares over MIX_FRAMES
# frames within MIX_SHARE_TOL of the weights.
MIX_NAMES = ("libero_spatial_no_noops", "libero_object_no_noops")
MIX_WEIGHTS = (0.7, 0.3)
MIX_FRAMES, MIX_SHARE_TOL, MIX_SHUFFLE = 2000, 0.05, 2000
EPISODES_PER_SET = 12
MIX_FLAGS = TRAIN_FLAGS + ["--image_aug", "True", "--shuffle_buffer_size", str(MIX_SHUFFLE)]


# Phase 16 (a)'s int4 linears, (name, K, N): Phi-2's wq, wk, wv, wo and fc1
# read 2,560 columns (wq stands for the four attention projections), fc2
# reads 10,240. Every LLM linear is quantized under load_in_4bit (d_in >=
# QUANT_MIN_DIM); K5 takes those of a request with at most FUSED_MAX_ROWS
# rows, the dequant path the others.
PHI_INT4_SHAPES = [("wq", 2560, 2560), ("fc1", 2560, 10240), ("fc2", 10240, 2560)]


def phi_config(num_images: int = 2):
    from openvla_oft_tpu_torch.config import OpenVLAConfig

    return OpenVLAConfig(vision_backbone_id=PHI_IDS[0], llm_backbone_id=PHI_IDS[1],
                         num_images_in_input=num_images)


def phi_params(cfg, platform) -> tuple:
    """The discrete tree (the LLM with its biased lm_head, the ViT, the
    projector, the proprio projector), seed 0, and the L1 head (seed 1) and
    diffusion head with its noisy-action projector (seed 2), bf16, drawn on
    the card by `bridge.init_params`."""
    from openvla_oft_tpu_torch.bridge import init_params

    def draw(seed, head, keys=None):
        return init_params(cfg, platform, torch.Generator(device="cuda").manual_seed(seed),
                           device="cuda", dtype=torch.bfloat16, head=head, keys=keys)

    return draw(0, "discrete"), {"l1": draw(1, "l1", ("action_head",)),
                                 "diffusion": draw(2, "diffusion", ("action_head",
                                                                    "noisy_action_projector"))}


def no_launches(**extra) -> dict:
    return {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0, "K6": 0, "probe": 0, "int8": 0,
            **extra}


def phi_request(policy, request, label: str, expect: dict, card: str, runs: int = 2) -> dict:
    """`runs` calls of request() counted (each must launch `expect`) and
    timed, the peak, then one more timed and one traced (`profile_request`).
    Returns the launches of the counted calls, the output of the last and
    the number of calls."""
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    outs, times = [], []
    for i in range(runs):
        before = launch_counts()
        t0 = time.perf_counter()
        outs.append(request())
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        per = {k: n - before[k] for k, n in launch_counts().items()}
        if per != expect:
            raise AssertionError(f"one {label} request launched {per}, expected {expect}")
    launches = launch_counts()
    log(f"[phi] {label}: {runs} requests of {', '.join(f'{t:.1f}' for t in times)} ms (host "
        f"clock, ends in torch.cuda.synchronize; the first one cold), launches each {expect}, "
        f"torch.cuda.max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} "
        f"GiB ({card})")
    profile_request(policy, None, f"Phi-2 {label}", card, request=request, runs=1)
    return {"launches": launches, "out": outs[-1], "calls": runs + 2}


def phi_ar_parity(params, cfg, platform, card: str) -> None:
    """The cached decode's logits (`phi_prefill`, then `phi_decode_step` fed
    the generated tokens) against one no-cache `phi_model` forward over the
    prefix and the same tokens, cosine >= 0.999, argmax equal."""
    from openvla_oft_tpu_torch.models import phi as PH
    from openvla_oft_tpu_torch.models.prismatic import (autoregressive_layout,
                                                       predict_action_autoregressive)

    llm, dev = params["llm"], params["llm"]["embed"]["embedding"].device
    ids, mask, pixels = ar_inputs(cfg, dev)
    n = platform.action_dim
    with torch.inference_mode():
        tokens, logits = predict_action_autoregressive(params, cfg, platform, ids, mask, pixels,
                                                       n, return_logits=True)
        embeds, positions, key_valid, _ = autoregressive_layout(params, cfg, ids, mask, pixels)
        s = embeds.shape[1]
        steps = torch.arange(1, n, device=dev)[None]
        full = PH.phi_model(
            llm, cfg.llm, torch.cat([embeds, PH.embed_tokens(llm, tokens[:, :n - 1])
                                     .to(embeds.dtype)], dim=1),
            padding_mask=torch.cat([key_valid, torch.ones_like(steps, dtype=torch.bool)], 1),
            positions=torch.cat([positions, positions[:, -1:] + steps], dim=1))[:, s - 1:]
        teacher = PH.lm_logits(llm, full)
    cos = cosine(logits, teacher)
    same = bool(torch.equal(logits.argmax(-1), teacher.argmax(-1)))
    log(f"[phi-ar-parity] the cached decode's logits ({n} tokens: the prefill's last row and "
        f"{n - 1} steps, S = {s}) against the no-cache forward: cosine {cos:.6f}, max|d| "
        f"{(logits - teacher).abs().max().item():.4e}, argmax equal {same}; tokens "
        f"{tokens.tolist()[0]} ({card})")
    if not (cos >= 0.999 and same and torch.isfinite(logits).all()):
        raise AssertionError("Phi-2's cached decode disagrees with the full forward")


def phi_serving(card: str, rng, cfg, platform, params, heads) -> dict:
    """Phase 16 (a): the L1 head (vit_fused off, then on: K4 2 x 23 a
    request, the K4 path against the unfused one), the diffusion head (50
    DDIM steps through the full-prefill route: 50 predict_action_hidden
    calls, no prefix K/V), the discrete head and the AR decode at 1 image
    (7 tokens; the cached decode against the full forward). No K1 anywhere:
    the Phi LLM's attention is the dense path. Returns the launches."""
    from openvla_oft_tpu_torch import policy as P
    from openvla_oft_tpu_torch.bridge import tree_leaves
    from openvla_oft_tpu_torch.models.prismatic import predict_action_autoregressive
    from openvla_oft_tpu_torch.serving.deploy import placeholder_norm_stats, serving_params

    served = serving_params(dict(params))
    if served["llm"] is not params["llm"]:
        raise AssertionError("serving_params changed the Phi-2 tree: fuse_inference_weights "
                             "must return it unchanged")
    n_vit = sum(t.numel() for t in tree_leaves(params["vision_backbone"]))
    n_llm = sum(t.numel() for t in tree_leaves(params["llm"]))
    log(f"[phi] {PHI_IDS[0]} + {PHI_IDS[1]}: LLM {n_llm / 1e9:.3f} B parameters (lm_head "
        f"included), ViT {n_vit / 1e9:.3f} B, on the card "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB ({card})")

    def policy_of(head, **kw):
        tree = dict(served)
        if head != "discrete":
            tree.update(heads[head])
        return P.OpenVLAPolicy(cfg=cfg, platform=platform, params=tree, head=head,
                               prompt_bucket=48, norm_stats=placeholder_norm_stats(platform),
                               **kw)

    runs = {}
    l1 = policy_of("l1")
    obs = observation(l1, rng)
    frames = frames_of(l1, obs)
    k4 = 2 * sum(v.depth - 1 for v in cfg.vision_configs)
    for fused in (False, True):
        l1.vit_fused = fused
        out = phi_request(l1, lambda: l1.predict_action_from_frames(
            frames, obs["instruction"], proprio=obs["state"]),
            f"L1 vit_fused={fused}", no_launches(K4=k4 if fused else 0), card)
        if out["out"].shape != (platform.num_actions_chunk, platform.action_dim) or \
                not np.isfinite(out["out"]).all():
            raise AssertionError(f"bad Phi-2 L1 chunk {out['out']}")
        runs[f"phi L1 vit_fused={fused}"] = out["launches"]
    l1.vit_fused = False
    inputs = model_inputs(l1, obs)
    s = inputs[1].shape[1] + cfg.num_images_in_input * cfg.vision_configs[0].num_patches + 1 \
        + platform.chunk_len + 1
    hidden = {fused: actions_hidden(l1, inputs, vit_fused=fused) for fused in (True, False)}
    cos = cosine(hidden[True], hidden[False])
    log(f"[phi] S = {s}: actions_hidden cosine(K4 path, unfused path) = {cos:.6f} ({card})")
    if not cos >= PARITY_COSINE:
        raise AssertionError(f"Phi-2's K4 path disagrees with the unfused path: {cos}")
    del l1
    pixels, proprio = inputs[3][0], np.clip(obs["state"], -1.0, 1.0)

    diff = policy_of("diffusion", num_diffusion_steps=DIFFUSION_STEPS)
    calls = {"full": 0, "prefix": 0}
    full_fn, prefix_fn = P.predict_action_hidden, P.build_diffusion_prefix

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    with patched(P, "predict_action_hidden", count("full", full_fn)), \
            patched(P, "build_diffusion_prefix", count("prefix", prefix_fn)):
        out = phi_request(diff, lambda: diff.predict_action(pixels, obs["instruction"],
                                                             proprio=proprio),
                          f"diffusion ({DIFFUSION_STEPS} DDIM steps, full prefill)",
                          no_launches(), card)
    per_request = calls["full"] / out["calls"]
    log(f"[phi] diffusion: {calls['full']} predict_action_hidden calls in {out['calls']} "
        f"requests, "
        f"{calls['prefix']} prefix K/V builds (diffusion_prefix_kv={diff.diffusion_prefix_kv}, "
        f"split_kv={diff.split_kv})")
    if calls["prefix"] or per_request != DIFFUSION_STEPS or not np.isfinite(out["out"]).all():
        raise AssertionError(f"the Phi-2 diffusion chunk did not take the full-prefill route: "
                             f"{calls}")
    runs["phi diffusion"] = out["launches"]
    del diff

    disc = policy_of("discrete")
    out = phi_request(disc, lambda: disc.predict_action(pixels, obs["instruction"],
                                                         proprio=proprio),
                      "discrete", no_launches(), card)
    runs["phi discrete"] = out["launches"]
    del disc

    cfg1 = dataclasses.replace(cfg, num_images_in_input=1)
    ar_in = ar_inputs(cfg1, torch.device("cuda"))

    def ar():
        with torch.inference_mode():
            return predict_action_autoregressive(served, cfg1, platform, *ar_in,
                                                 num_new_tokens=platform.action_dim).cpu()

    out = phi_request(None, ar, f"AR decode, 1 image, {platform.action_dim} tokens",
                      no_launches(), card)
    runs["phi AR"] = out["launches"]
    phi_ar_parity(served, cfg1, platform, card)
    return runs


def phi_int4_check(card: str, rows) -> dict:
    """K5 against int4_matmul_ref at PHI_INT4_SHAPES, at each of `rows`
    (the int4 requests' rows), device times (L2 flushed) beside the plain
    version, torch.matmul on the dequantized bf16 weight and the bound."""
    from openvla_oft_tpu_torch.ops import int4_matmul as M
    from openvla_oft_tpu_torch.ops.quant import dequantize_int4, quantize_weight_int4

    dev = torch.device("cuda")
    flush = l2_flush_buffer(dev)
    results = {}
    for t in rows:
        for name, k, n in PHI_INT4_SHAPES:
            gen = torch.Generator(device=dev).manual_seed(t + k + n)
            x = torch.randn((t, k), generator=gen, device=dev).bfloat16()
            q = quantize_weight_int4(torch.randn((k, n), generator=gen, device=dev) * 0.02)
            packed, scales = q["kernel_q4"], q["scale_w4"]
            y = M.int4_matmul_fused(x, packed, scales)
            torch.cuda.synchronize()
            ref = M.int4_matmul_ref(x, packed, scales)
            err = (y - ref).abs().max().item()
            rel = err / ref.abs().max().item()
            w16 = dequantize_int4(packed, scales, torch.bfloat16)
            ms, how = device_ms(lambda: M.int4_matmul_fused(x, packed, scales), flush)
            lib, how_lib = device_ms(lambda: torch.matmul(x, w16), flush)
            plain = cuda_time_ms(lambda: M.int4_matmul_ref(x, packed, scales), flush=flush)
            b, by = bound(2 * t * k * n, nbytes(x, packed, scales, y), PEAK_BF16)
            group = k // scales.shape[0]
            log(f"[phi-int4] K5 {name} T={t}: K={k} N={n} group={group}, plan "
                f"{M._k5_plan(t, k, n, group)}: max|d| {err:.3e} (rel {rel:.3e}) against "
                f"int4_matmul_ref; {ms:.4f} ms ({how}), torch.matmul on the bf16 weight "
                f"{lib:.4f} ({how_lib}) (K5 / matmul {ms / lib:.2f}), plain {plain:.4f} (CUDA "
                f"events), bound {b:.4f} ({by}) (L2 flushed; {card})")
            if not (torch.isfinite(y).all() and rel <= INT4_K5_REL):
                raise AssertionError(f"K5 disagrees with int4_matmul_ref at Phi-2's {name} "
                                     f"T={t}: rel {rel}")
            results[f"{name} T={t}"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                                        "bound_ms": b, "bound_by": by, "library_ms": lib,
                                        "timing": how}
            del x, q, packed, scales, y, ref, w16
    del flush
    torch.cuda.empty_cache()
    return results


def phi_int4_serving(card: str, rng, cfg, platform, params, heads) -> tuple:
    """Phase 16 (a), int4: the L1 tree through `serving_params(load_in_4bit=
    True)` (every LLM linear int4, as the JAX loader quantizes Phi-2), one
    request at LIBERO's 2 images (more than FUSED_MAX_ROWS rows: every int4
    linear takes the dequant path, no K5) and one at 1 image (K5 on each of
    the 6 x 32 linears), the 1-image K5 path against the plain one, then K5
    at those rows (`phi_int4_check`). Returns (launches, K5's check)."""
    from openvla_oft_tpu_torch import policy as P
    from openvla_oft_tpu_torch.ops import int4_matmul as M
    from openvla_oft_tpu_torch.ops.quant import FUSED_MAX_ROWS
    from openvla_oft_tpu_torch.serving.deploy import placeholder_norm_stats, serving_params

    t0 = time.perf_counter()
    # quantize_tree_lowmem consumes the LLM's dicts: hand it a copy of them.
    tree = serving_params({**params, **heads["l1"], "llm": _detached(params["llm"])},
                          load_in_4bit=True)
    torch.cuda.synchronize()
    wq = tree["llm"]["layers"]["attn"]["wq"]
    if "kernel_q4" not in wq or "bias" not in wq or "kernel" not in tree["llm"]["lm_head"]:
        raise AssertionError(f"load_in_4bit left Phi-2's wq as {sorted(wq)}")
    log(f"[phi-int4] load_in_4bit tree built in {time.perf_counter() - t0:.1f} s, on the card "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB ({card})")
    per_request = sum(1 for group in tree["llm"]["layers"].values() for leaf in group.values()
                      if isinstance(leaf, dict) and "kernel_q4" in leaf) * cfg.llm.num_layers
    refs = {"n": 0}
    plain = M.int4_matmul_ref

    def counted_ref(*a, **k):
        refs["n"] += 1
        return plain(*a, **k)

    runs, rows, hidden = {}, [], {}
    for n_images in (2, 1):
        cfg_n = dataclasses.replace(cfg, num_images_in_input=n_images)
        policy = P.OpenVLAPolicy(cfg=cfg_n, platform=platform, params=tree, head="l1",
                                 prompt_bucket=48, norm_stats=placeholder_norm_stats(platform))
        obs = observation(policy, rng)
        inputs = model_inputs(policy, obs)
        s = inputs[1].shape[1] + n_images * cfg.vision_configs[0].num_patches + 1 \
            + platform.chunk_len + 1
        fused = s <= FUSED_MAX_ROWS
        frames = frames_of(policy, obs)
        refs["n"] = 0
        with patched(M, "int4_matmul_ref", counted_ref):
            out = phi_request(policy, lambda: policy.predict_action_from_frames(
                frames, obs["instruction"], proprio=obs["state"]),
                f"L1 int4 W4A16, {n_images} image(s), S = {s}",
                no_launches(K5=per_request if fused else 0), card)
        counted = refs["n"] / out["calls"]
        log(f"[phi-int4] {n_images} image(s), S = {s}: {per_request} int4 linears a request, "
            f"K5 {per_request if fused else 0}, the dequant path (int4_matmul_ref) {counted:g} "
            f"({'at most' if fused else 'more than'} FUSED_MAX_ROWS = {FUSED_MAX_ROWS} rows)")
        if out["out"].shape != (platform.num_actions_chunk, platform.action_dim) or \
                not np.isfinite(out["out"]).all() or counted != (0 if fused else per_request):
            raise AssertionError(f"bad Phi-2 int4 request at {n_images} image(s): "
                                 f"{out['out']}, {counted} dequant products")
        runs[f"phi L1 int4 {n_images} image(s)"] = out["launches"]
        rows.append(s)
        if fused:
            before = launch_counts()["K5"]
            hidden["K5"] = actions_hidden(policy, inputs)
            used = launch_counts()["K5"] - before
            with patched(M, "int4_matmul_fused", plain):
                hidden["plain"] = actions_hidden(policy, inputs)
            cos = cosine(hidden["K5"], hidden["plain"])
            log(f"[phi-int4] S = {s}: actions_hidden cosine(K5 path, plain path) = {cos:.6f}, "
                f"max|d| {(hidden['K5'] - hidden['plain']).abs().max().item():.4e}, K5 "
                f"launches {used} ({card})")
            if not (cos >= PARITY_COSINE and used == per_request
                    and torch.isfinite(hidden["K5"]).all()):
                raise AssertionError("Phi-2's K5 path disagrees with the plain path")
        del policy
    del tree
    gc.collect()
    torch.cuda.empty_cache()
    return runs, phi_int4_check(card, (*rows, 1))


def write_phi_checkpoint(cfg, params, platform, root: str, card: str) -> str:
    """Phase 16 (b): the tree in HF names (`export_phi`, the vision
    backbone and projector by `export_vision_tensors`), 2 GB shards, the
    config, a synthetic SentencePiece `tokenizer.model` of 51,200 pieces."""
    from openvla_oft_tpu_torch.serving.deploy import placeholder_norm_stats
    from openvla_oft_tpu_torch.utils.hf_import import export_phi, export_vision_tensors, hf_config
    from openvla_oft_tpu_torch.utils.safetensors_io import save_sharded

    path = os.path.join(root, "phi-2+3b")
    os.makedirs(path)
    t0 = time.perf_counter()
    tensors = {**export_phi(params["llm"], cfg.llm), **export_vision_tensors(cfg, params)}
    shards = save_sharded({k: v.contiguous() for k, v in tensors.items()}, path,
                          PHI_SHARD_BYTES)
    stats = {"libero_spatial_no_noops": placeholder_norm_stats(platform)["random"]}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config(cfg, stats), f)
    with open(os.path.join(path, "tokenizer.model"), "wb") as f:
        f.write(llama_like_tokenizer(PHI_TOKENIZER_PIECES))
    size = sum(os.path.getsize(p) for p in shards)
    log(f"[phi-checkpoint] {len(tensors)} tensors, {size / 1e9:.2f} GB in {len(shards)} shards, "
        f"written in {time.perf_counter() - t0:.1f} s (host clock), with config.json and a "
        f"{PHI_TOKENIZER_PIECES}-piece tokenizer.model ({card})")
    return path


def phi_generate(path: str, jpegs: list, root: str, card: str) -> dict:
    """Phase 16 (b): scripts/generate.py on the dir (its tokenizer.model,
    the Phi prompt builder): one prompt, 8 new tokens, no kernel launch."""
    import io

    from openvla_oft_tpu_torch.models import prismatic as PM
    from openvla_oft_tpu_torch.processing.prompting import get_prompt_builder
    from openvla_oft_tpu_torch.scripts import generate as GEN

    builder = type(get_prompt_builder(PHI_IDS[1])).__name__
    image = os.path.join(root, "generate.jpg")
    with open(image, "wb") as f:
        f.write(jpegs[-1][1])
    shapes = []
    decode = PM.predict_action_autoregressive

    def recorded(*a, **k):
        tokens = decode(*a, **k)
        shapes.append(tuple(tokens.shape))
        return tokens

    gc.collect()
    torch.cuda.empty_cache()
    reset_launch_counts()
    t0 = time.perf_counter()
    with patched(PM, "predict_action_autoregressive", recorded):
        answers = GEN.generate(GEN.GenerateConfig(model_path=path, image_path=image,
                                                  max_new_tokens=8, device="cuda"),
                               io.StringIO(PROMPT + "\n"))
    launches = launch_counts()
    log(f"[phi-generate] {PROMPT!r} ({builder}) -> {answers}; tokens {shapes}; "
        f"{time.perf_counter() - t0:.1f} s with the dir's load; launches {launches} ({card})")
    if builder != "PhiPromptBuilder" or len(answers) != 1 or shapes != [(1, 8)] \
            or launches != no_launches():
        raise AssertionError(f"generate.py on the Phi-2 dir answered {answers} ({shapes}, "
                             f"{builder}), launches {launches}")
    return launches


def phi_training(card: str, cfg, platform, params) -> dict:
    """Phase 16 (b): the checkpoint dir written and loaded bitwise, 3 LoRA
    L1 steps of the fine-tuning CLI from it at B = 8 (remat "all"; LoRA on
    wq/wk/wv/wo only, the frozen base bitwise the dir's tree), one step
    traced, `scripts/pretrain.py --stage align` 3 steps on it (phase 15's
    LLaVA JSON), `scripts/generate.py` on it. Returns the launches."""
    from openvla_oft_tpu_torch.bridge import tree_leaves
    from openvla_oft_tpu_torch.scripts import pretrain as PP
    from openvla_oft_tpu_torch.utils.hf_import import load_openvla_checkpoint

    runs = {}
    root = checkpoint_dir(16e9)
    try:
        path = write_phi_checkpoint(cfg, params, platform, root, card)
        t0 = time.perf_counter()
        _, loaded, _ = load_openvla_checkpoint(path, dtype=torch.bfloat16, device="cuda")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = trees_bitwise_equal(loaded, {k: params[k] for k in loaded})
        size = sum(t.numel() * t.element_size() for t in tree_leaves(loaded))
        log(f"[phi-checkpoint] loaded in {dt:.1f} s ({size / 1e9 / dt:.2f} GB/s), {n} leaves "
            f"bitwise equal to the in-memory tree ({card})")

        flags = TRAIN_FLAGS + ["--vla_path", path]
        state, runs["phi train"], info = train(card, 0, flags, label="phi-train")
        lora = state.trainables["lora"]
        targets = sorted(lora["llm"]["layers"]["attn"])
        frozen = trees_bitwise_equal(state.base_params["llm"],
                                     {k: loaded["llm"][k] for k in state.base_params["llm"]})
        frozen += trees_bitwise_equal(state.base_params["vision_backbone"],
                                      loaded["vision_backbone"])
        log(f"[phi-train] LoRA on the LLM's {', '.join(targets)} only ({sorted(lora['llm']['layers'])}"
            f" groups); {frozen} frozen leaves bitwise the dir's after 3 steps; step times "
            f"{', '.join(f'{t:.4f}' for t in info['step_times'])} s, peak "
            f"{info['peak'] / 2**30:.3f} GiB ({card})")
        if targets != ["wk", "wo", "wq", "wv"] or set(lora["llm"]["layers"]) != {"attn"}:
            raise AssertionError(f"Phi-2's LoRA targets are {lora['llm']['layers'].keys()}")
        profile_step(state, card, flags, "Phi-2 LoRA train_step at B=8")
        del state, lora, loaded
        gc.collect()
        torch.cuda.empty_cache()

        jpegs = golden_jpegs()
        js, images = llava_json(jpegs, root)
        pcfg = PP.PretrainConfig(model_id="phi-2+3b", stage="align", pretrained_checkpoint=path,
                                 llava_json=js, image_root=images, batch_size=FULL_BATCH,
                                 max_steps=FULL_STEPS, save_interval=FULL_STEPS,
                                 run_root_dir=Path(root), seq_bucket=PHI_PRETRAIN_BUCKET)
        log(f"[phi-pretrain-align] {LLAVA_RECORDS} records, seq_bucket {PHI_PRETRAIN_BUCKET}: "
            f"S = {PHI_PRETRAIN_BUCKET} text slots + {cfg.vision_configs[0].num_patches} "
            f"patches")
        out = full_stage(card, "phi-pretrain-align", PP.pretrain, pcfg, 0)
        runs["phi pretrain-align"] = out.pop("launches")
        del out
        runs["phi generate"] = phi_generate(path, jpegs, root, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return runs


def write_tfds_sets(frames: list, root: str, card: str) -> int:
    """Phase 16 (c): MIX_NAMES in TFDS's layout (`<name>/1.0.0/<name>-
    train.tfrecord-0000i-of-00002`) and raw LIBERO's features (image,
    wrist_image, an 8-dim state, gripper actions -1 / +1, one instruction
    a step), written by the port's TFRecord writer. Returns the steps."""
    from openvla_oft_tpu_torch.data.rlds import tfrecord

    rng = np.random.default_rng(16)
    steps = 0
    t0 = time.perf_counter()
    for s, name in enumerate(MIX_NAMES):
        records = []
        for e in range(EPISODES_PER_SET):
            t = int(rng.integers(40, 61))
            actions = rng.uniform(-0.5, 0.5, (t, 7))
            actions[:, -1] = np.where(rng.random(t) < 0.5, -1.0, 1.0)
            records.append(tfrecord.serialize_example({
                "steps/observation/image": ("bytes", [frames[(s + e + i) % len(frames)]
                                                      for i in range(t)]),
                "steps/observation/wrist_image": ("bytes", [frames[(e + 2 * i + 1) % len(frames)]
                                                            for i in range(t)]),
                "steps/observation/state": ("float", rng.standard_normal(t * 8)),
                "steps/action": ("float", actions.reshape(-1)),
                "steps/language_instruction": ("bytes", [f"{name} task {e % 4}".encode()] * t),
            }))
            steps += t
        d = os.path.join(root, name, "1.0.0")
        os.makedirs(d)
        for k in range(2):
            tfrecord.write_tfrecords(os.path.join(d, f"{name}-train.tfrecord-{k:05d}-of-00002"),
                                     records[k::2])
    log(f"[tfds] wrote {len(MIX_NAMES)} TFDS datasets ({', '.join(MIX_NAMES)}), "
        f"{EPISODES_PER_SET} episodes each, {steps} steps, 2 shards each, in "
        f"{time.perf_counter() - t0:.2f} s (host clock; {card}'s host)")
    return steps


def mixture_phase(card: str, n_layers: int) -> dict:
    """Phase 16 (c): the TFDS datasets converted (`convert_tfds_to_native`,
    the LIBERO standardization at conversion), the mixture at MIX_WEIGHTS
    alone (frames/s with augmentation over MIX_FRAMES frames, each member's
    share within MIX_SHARE_TOL of its weight), then 3 L1 LoRA steps of the
    fine-tuning CLI at random:7b, B = 8, fed by the mixture (its
    `training_data` replaced by one over `make_interleaved_iterator`): K1
    64, K2 32, K3 32 a step. Returns the run's launches."""
    from openvla_oft_tpu_torch.data.collator import PaddedCollatorForActionPrediction
    from openvla_oft_tpu_torch.data.datasets import RLDSBatchTransform
    from openvla_oft_tpu_torch.data.rlds.pipeline import make_interleaved_iterator
    from openvla_oft_tpu_torch.data.rlds.tfds_format import convert_tfds_to_native
    from openvla_oft_tpu_torch.processing.action_tokenizer import ActionTokenizer
    from openvla_oft_tpu_torch.processing.processor import PrismaticProcessor
    from openvla_oft_tpu_torch.training import finetune as FT

    frames = [d for n, d in golden_jpegs() if n.startswith("libero_")]
    root = tempfile.mkdtemp(prefix="chip_smoke_tfds_")
    try:
        tfds_root, native = os.path.join(root, "tfds"), os.path.join(root, "native")
        write_tfds_sets(frames, tfds_root, card)
        flags = MIX_FLAGS + ["--data_root_dir", native]
        platform = FT.platform_of(FT.parse_config(flags))
        for name in MIX_NAMES:
            t0 = time.perf_counter()
            n = convert_tfds_to_native(tfds_root, name, platform, os.path.join(native, name))
            with open(os.path.join(native, name, "native_format.json")) as f:
                marker = json.load(f)
            log(f"[tfds] {name}: {n} episodes converted to the native format in "
                f"{time.perf_counter() - t0:.2f} s, marker {marker}")
            if n != EPISODES_PER_SET or marker != {"standardized": True,
                                                   "transform": "libero_dataset_transform"}:
                raise AssertionError(f"the conversion of {name} gave {n} episodes, {marker}")

        t0 = time.perf_counter()
        it, stats = make_interleaved_iterator(native, list(MIX_NAMES), list(MIX_WEIGHTS),
                                              lambda b: b, platform,
                                              shuffle_buffer_size=MIX_SHUFFLE, image_aug=True,
                                              num_images=2)
        next(it)
        first = time.perf_counter() - t0
        t1 = time.perf_counter()
        names = [next(it)["dataset_name"] for _ in range(MIX_FRAMES)]
        rate = MIX_FRAMES / (time.perf_counter() - t1)
        del it
        shares = {n: names.count(n) / MIX_FRAMES for n in MIX_NAMES}
        log(f"[mixture] {dict(zip(MIX_NAMES, MIX_WEIGHTS))}: {rate:.1f} frames/s with "
            f"augmentation (2 images a frame, {MIX_FRAMES} frames, host clock), first frame "
            f"after {first:.2f} s (a {MIX_SHUFFLE}-frame buffer); shares {shares}; transitions "
            f"{ {n: s['num_transitions'] for n, s in stats.items()} } ({card}'s host)")
        for name, w in zip(MIX_NAMES, MIX_WEIGHTS):
            if abs(shares[name] - w) > MIX_SHARE_TOL:
                raise AssertionError(f"{name}'s share {shares[name]} is not within "
                                     f"{MIX_SHARE_TOL} of {w}")

        def mixture_data(cfg, model_cfg, platform, num_samples, train=True,
                         process=(0, 1)):       # one process: every shard
            transform = RLDSBatchTransform(PrismaticProcessor(model_cfg), ActionTokenizer(),
                                           platform)
            data, stats = make_interleaved_iterator(
                str(cfg.data_root_dir), list(MIX_NAMES), list(MIX_WEIGHTS), transform,
                platform, shuffle_buffer_size=cfg.shuffle_buffer_size,
                image_aug=cfg.image_aug, train=train, num_images=cfg.num_images_in_input)
            return data, PaddedCollatorForActionPrediction(
                pad_token_id=model_cfg.pad_token_id, max_length=cfg.seq_bucket or None), stats

        with patched(FT, "training_data", mixture_data):
            state, launches, info = train(card, n_layers, flags, label="train-mixture")
        log(f"[train-mixture] step times {', '.join(f'{t:.4f}' for t in info['step_times'])} s, "
            f"peak {info['peak'] / 2**30:.3f} GiB ({card})")
        del state
        gc.collect()
        torch.cuda.empty_cache()
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phi_phase(card: str, rng) -> tuple:
    """Phase 16: Phi-2 cut to SERVE_CUT_LAYERS layers (`cut_llm`), its
    mixture-fed flagship run at CUT_LAYERS. Returns each run's launches and
    K5's check at Phi-2's shapes."""
    from openvla_oft_tpu_torch.constants import LIBERO

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    module = sys.modules[__name__]
    with cut_llm(PHI_IDS[1], SERVE_CUT_LAYERS) as cut, \
            patched(module, "PHI_IDS", (PHI_IDS[0], cut)):
        cfg = phi_config()
        t0 = time.perf_counter()
        params, heads = phi_params(cfg, LIBERO)
        torch.cuda.synchronize()
        log(f"[phi] drawn on the card in {time.perf_counter() - t0:.1f} s ({cut})")
        runs = phi_serving(card, rng, cfg, LIBERO, params, heads)
        int4_runs, k5 = phi_int4_serving(card, rng, cfg, LIBERO, params, heads)
        runs.update(int4_runs)
        del heads
        runs.update(phi_training(card, cfg, LIBERO, params))
        del params
    gc.collect()
    torch.cuda.empty_cache()
    with cut_flagship():
        runs["train-mixture"] = mixture_phase(card, CUT_LAYERS)
    log(f"[phi] phase 16 took {time.perf_counter() - t_phase:.1f} s (host clock)")
    return runs, k5


# Phase 17: the robot eval clients, each through its own entry point, with
# scripted stand-in environments that replay frames and states drawn from
# the run's seeded generator. What a client builds itself (the WidowX
# client, `input()`) is patched from outside its module.
ALOHA_CAMS = ("cam_high", "cam_low", "cam_left_wrist", "cam_right_wrist")


class Timed:
    """A client's query function with the host time of each call, ms (its
    result is numpy on the host, so each call ends after the card's work)."""

    def __init__(self, fn):
        self.fn, self.ms = fn, []

    def __call__(self, *args, **kw):
        t0 = time.perf_counter()
        out = self.fn(*args, **kw)
        self.ms.append((time.perf_counter() - t0) * 1e3)
        return out


class LiberoStandIn:
    """LIBERO's OffScreenRenderEnv surface: seeded 256 x 256 camera pairs and
    robot states replayed in turn, never done. Logs each stepped action with
    the index of the observation it answered."""

    def __init__(self, rng, n: int = 3):
        self.obs = []
        for _ in range(n):
            q = rng.standard_normal(4)
            self.obs.append({
                "agentview_image": rng.integers(0, 256, (256, 256, 3), dtype=np.uint8),
                "robot0_eye_in_hand_image": rng.integers(0, 256, (256, 256, 3), dtype=np.uint8),
                "robot0_eef_pos": rng.uniform(-0.3, 0.3, 3), "robot0_eef_quat": q / np.linalg.norm(q),
                "robot0_gripper_qpos": rng.uniform(-0.04, 0.04, 2)})
        self.i, self.log = 0, []

    def reset(self):
        self.i, self.log = 0, []

    def get_observation(self):
        return self.obs[self.i]

    def step(self, action):
        self.log.append((self.i, np.asarray(action, np.float64)))
        self.i = (self.i + 1) % len(self.obs)
        return self.obs[self.i], 0.0, False, {}


class AlohaStandIn:
    """The real ALOHA env's surface (reset, get_qpos, get_observation, step):
    seeded 480 x 640 frames of the four cameras and 14-D joint states."""

    def __init__(self, rng, n: int = 3):
        self.frames = [{cam: rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
                        for cam in ALOHA_CAMS} for _ in range(n)]
        self.qpos = [rng.standard_normal(14) for _ in range(n)]
        self.stepped = []

    def reset(self):
        return None

    def get_qpos(self):
        return self.qpos[0]

    def get_observation(self, t: int = 0):
        import types

        n = len(self.frames)
        return types.SimpleNamespace(observation={"images": self.frames[t % n],
                                                  "qpos": self.qpos[t % n]})

    def step(self, action):
        self.stepped.append(np.asarray(action, np.float64))


class RobosuiteStandIn:
    """The UR5e task env's surface: seeded 200 x 360 front and eye-in-hand
    frames (the tasks' render size) and states, never done; logs each world
    action with the index of the observation it answered."""

    def __init__(self, rng, n: int = 3):
        self.obs = []
        for _ in range(n):
            q = rng.standard_normal(4)
            self.obs.append({
                "camera_front_image": rng.integers(0, 256, (200, 360, 3), dtype=np.uint8),
                "eye_in_hand_image": rng.integers(0, 256, (200, 360, 3), dtype=np.uint8),
                "eef_pos": rng.uniform(-0.3, 0.3, 3), "eef_quat": q / np.linalg.norm(q),
                "joint_pos": rng.uniform(-1.5, 1.5, 6)})
        self.i, self.log = 0, []

    def reset(self):
        self.i, self.log = 0, []
        return dict(self.obs[0])

    def step(self, action):
        self.log.append((self.i, np.asarray(action, np.float64)))
        self.i = (self.i + 1) % len(self.obs)
        return dict(self.obs[self.i]), 0.0, False, {}


class WidowXStandIn:
    """The `widowx_envs` client's surface that `eval_bridge` drives: seeded
    flat (3, 256, 256) images in [0, 1] and 7-D states."""

    def __init__(self, rng, n: int = 3):
        self.images = [rng.random(3 * 256 * 256) for _ in range(n)]
        self.states = [rng.standard_normal(7) for _ in range(n)]
        self.served, self.stepped = [], []

    def reset(self):
        return None

    def get_observation(self):
        i = len(self.served) % len(self.images)
        self.served.append(i)
        return {"image": self.images[i], "state": self.states[i]}

    def step_action(self, action):
        self.stepped.append(np.asarray(action, np.float64))


@contextlib.contextmanager
def hidden_module(name: str):
    """`import name` raises ImportError inside the block."""
    old = sys.modules.get(name, None)
    had = name in sys.modules
    sys.modules[name] = None
    try:
        yield
    finally:
        if had:
            sys.modules[name] = old
        else:
            del sys.modules[name]


def launches_per_query(policy) -> dict:
    """K1 and K4 launches of one query: K1 on every LLM layer but the first
    (its window layer), K4 on two projections of every ViT block but the
    last with `vit_fused`."""
    k4 = 2 * sum(v.depth - 1 for v in policy.cfg.vision_configs) if policy.vit_fused else 0
    return {"K1": policy.cfg.llm.num_layers - 1, "K4": k4}


def read_png(path: str) -> np.ndarray:
    """The uint8 (H, W, 3) frame of a PNG that `libero_utils.write_png`
    wrote (one IDAT, filter 0 on every row)."""
    import struct
    import zlib

    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n" or data[12:16] != b"IHDR":
        raise AssertionError(f"{path} is no PNG")
    w, h = struct.unpack(">II", data[16:24])
    start = data.index(b"IDAT") + 4
    rows = np.frombuffer(zlib.decompress(data[start:start + struct.unpack(
        ">I", data[start - 8:start - 4])[0]]), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise AssertionError(f"{path}: a row with a filter")
    return rows[:, 1:].reshape(h, w, 3)


def client_report(name: str, card: str, expect: dict, queries: int, launches: dict,
                  wall_s: float, query_ms: list, steps: int, n_checked: int) -> dict:
    """Logs and checks one client's run: launches = expect x queries."""
    want = {k: v * queries for k, v in expect.items()}
    got = {k: launches[k] for k in want}
    ms = np.asarray(query_ms)
    log(f"[clients] {name}: {steps} env steps, {queries} queries, launches {got} (expected "
        f"{want}); {n_checked} stepped actions bitwise equal to the direct path's; episode "
        f"{wall_s:.2f} s, query median {float(np.median(ms)):.2f} ms (min {ms.min():.2f}, max "
        f"{ms.max():.2f}; host clock, each ends with the actions on the host; {card})")
    if got != want:
        raise AssertionError(f"{name}: launches {got}, expected {want}")
    return {**launches, "queries": queries, "episode_s": wall_s,
            "query_median_ms": float(np.median(ms))}


def bitwise_equal(name: str, got, want) -> int:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape or not np.array_equal(got, want):
        d = float(np.abs(got - want).max()) if got.shape == want.shape else None
        raise AssertionError(f"{name}: the stepped actions {got.shape} differ from the direct "
                             f"path's {want.shape} (max|d| {d})")
    return len(got)


def quickstart_client(card: str, device: str, ckpt: str) -> dict:
    """(a) `scripts/quickstart.py::main` on the committed fixture: its two
    predicts, then the same observation through `get_vla_action`."""
    from openvla_oft_tpu_torch.scripts import quickstart as Q
    from openvla_oft_tpu_torch.serving import openvla_utils as PU

    if not Q.FIXTURE.exists():
        raise AssertionError(f"the committed fixture {Q.FIXTURE} is missing")
    built, get_vla = [], PU.get_vla

    def capture(cfg, *a, **kw):
        built.append((cfg, get_vla(cfg, *a, **kw)))
        return built[-1][1]

    timer = Timed(PU.get_vla_action)
    reset_launch_counts()
    t0 = time.perf_counter()
    with patched(PU, "get_vla", capture), patched(PU, "get_vla_action", timer):
        actions = Q.main(Q.QuickstartConfig(checkpoint=ckpt, device=device))
    wall = time.perf_counter() - t0
    launches = launch_counts()
    cfg, vla = built[0]
    obs = Q.load_observation(None)
    task = obs.pop("task_description")
    want = PU.get_vla_action(cfg, vla, PU.get_processor(cfg), obs, task)
    n = bitwise_equal("quickstart", np.stack(actions), np.stack(want))
    if not np.isfinite(np.stack(actions)).all() or np.stack(actions).shape != (8, 7):
        raise AssertionError("quickstart: bad action chunk")
    run = client_report("(a) quickstart, fixture observation", card, launches_per_query(vla),
                        len(timer.ms), launches, wall, timer.ms, 0, n)
    del vla, built
    return run


def libero_client(card: str, rng, device: str, ckpt: str) -> dict:
    """(b) One LIBERO spatial episode through `run_libero_eval.run_episode`
    (10 settle steps and 220 of the policy's, 28 queries of 8), its rollout
    written as PNG frames with imageio hidden, as on the card's machine."""
    from openvla_oft_tpu_torch.experiments.robot.libero import libero_utils as LU
    from openvla_oft_tpu_torch.experiments.robot.libero import run_libero_eval as L
    from openvla_oft_tpu_torch.serving import openvla_utils as PU

    cfg = L.GenerateConfig(pretrained_checkpoint=ckpt, task_suite_name="libero_spatial",
                           device=device)
    L.validate_config(cfg)
    model, processor, head, proprio, noisy = L.initialize_model(cfg)
    L.check_unnorm_key(cfg, model)
    resize = L.get_image_resize_size(cfg)
    env = LiberoStandIn(rng)
    task = "pick up the black bowl between the plate and the ramekin and place it on the plate"
    timer = Timed(L.get_action)
    reset_launch_counts()
    t0 = time.perf_counter()
    with patched(L, "get_action", timer):
        success, replay = L.run_episode(cfg, env, task, model, resize, processor, head, proprio,
                                        noisy)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    policy_steps = env.log[cfg.num_steps_wait:]
    if len(policy_steps) != L.TASK_MAX_STEPS["libero_spatial"] or len(replay) != len(policy_steps):
        raise AssertionError(f"LIBERO: {len(env.log)} steps taken (an episode error?)")
    n = 0
    for k in range(0, len(policy_steps), cfg.num_open_loop_steps):
        observation, _ = L.prepare_observation(env.obs[policy_steps[k][0]], resize)
        acts = PU.get_vla_action(cfg, model, processor, observation, task)
        chunk = policy_steps[k:k + cfg.num_open_loop_steps]
        n += bitwise_equal("LIBERO", [a for _, a in chunk],
                           [L.process_action(a, cfg.model_family) for a in acts[:len(chunk)]])
    with tempfile.TemporaryDirectory() as tmp, hidden_module("imageio"):
        path = LU.save_rollout_video(replay, 1, success, task, rollout_dir=tmp)
        pngs = sorted(Path(path).glob("*.png"))
        stride = max(len(replay) // 20, 1)
        if len(pngs) != len(replay[::stride]) or not all(
                np.array_equal(read_png(str(p)), replay[i * stride])
                for i, p in enumerate(pngs)):
            raise AssertionError("LIBERO: the rollout's PNG frames are not the replay's")
        log(f"[clients] (b) LIBERO rollout: {len(pngs)} PNG frames of {len(replay)} by the port's "
            f"writer (zlib + struct; imageio hidden), each read back equal to its frame")
    run = client_report("(b) LIBERO spatial episode", card, launches_per_query(model),
                        len(timer.ms), launches, wall, timer.ms, len(env.log), n)
    del model
    return run


def aloha_client(card: str, rng, device: str, build_policy) -> dict:
    """(c) One ALOHA episode through `run_aloha_eval.run_episode` against
    phase 5a's deployment served over /act by the deploy CLI's server
    (warmed up): 50 steps at 25 Hz, 2 queries of 25."""
    from openvla_oft_tpu_torch.experiments.robot.aloha import run_aloha_eval as A
    from openvla_oft_tpu_torch.serving.deploy import build_server, warmup

    policy = build_policy()
    server = build_server(policy)
    warmup(server, policy)
    port = free_port()
    server.run("127.0.0.1", port, background=True)
    endpoint = f"http://127.0.0.1:{port}/act"
    env = AlohaStandIn(rng)
    cfg = A.GenerateConfig(max_steps=50, device=device)
    task = "fold the towel"
    timer = Timed(A.get_action_from_server)
    answers = iter(["", "n"])
    try:
        reset_launch_counts()
        t0 = time.perf_counter()
        with patched(A, "get_action_from_server", timer), \
                patched(builtins, "input", lambda *a: next(answers)):
            stats, replay = A.run_episode(cfg, env, task, endpoint)
        wall = time.perf_counter() - t0
        launches = launch_counts()
        if stats["total_steps"] != cfg.max_steps or len(env.stepped) != cfg.max_steps:
            raise AssertionError(f"ALOHA: {stats} (an episode error?)")
        n = 0
        for t in range(0, cfg.max_steps, cfg.num_open_loop_steps):
            observation, *_ = A.prepare_observation(env.get_observation(t=t), 224, device)
            observation["instruction"] = task
            want = np.asarray(A.get_action_from_server(observation, endpoint))
            chunk = env.stepped[t:t + cfg.num_open_loop_steps]
            n += bitwise_equal("ALOHA", chunk, want[:len(chunk)])
    finally:
        server.shutdown()
    log(f"[clients] (c) ALOHA: {stats['model_query_time']:.3f} s of model queries in the "
        f"client's own count, episode {stats['episode_duration']:.2f} s (its 2 s settle and "
        f"25 Hz pacing included; {card})")
    run = client_report("(c) ALOHA episode over /act", card, launches_per_query(policy),
                        len(timer.ms), launches, wall, timer.ms, len(env.stepped), n)
    del policy
    return run


def robosuite_client(card: str, rng, device: str, ckpt: str) -> dict:
    """(d) One UR5e episode through `run_robosuite_eval.run_episode`: the
    200 x 360 front camera cropped and resized, 40 steps, 5 queries of 8."""
    from openvla_oft_tpu_torch.experiments.robot.robosuite import robosuite_utils as RU
    from openvla_oft_tpu_torch.experiments.robot.robosuite import run_robosuite_eval as R
    from openvla_oft_tpu_torch.serving import openvla_utils as PU

    cfg = R.GenerateConfig(pretrained_checkpoint=ckpt, max_steps=40, device=device)
    model = R.get_model(cfg)
    processor = R.get_processor(cfg)
    if model.platform.name != "ur5e":
        raise AssertionError(f"robosuite: platform {model.platform.name}")
    env = RobosuiteStandIn(rng)
    task = R.task_instruction(cfg, 0)
    timer = Timed(R.get_action)
    reset_launch_counts()
    t0 = time.perf_counter()
    with patched(R, "get_action", timer):
        success = R.run_episode(cfg, env, model, processor, None, None, task)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    if len(env.log) != cfg.max_steps:
        raise AssertionError(f"robosuite: {len(env.log)} steps taken (an episode error?)")
    n = 0
    for k in range(0, cfg.max_steps, cfg.num_open_loop_steps):
        obs = dict(env.obs[env.log[k][0]])
        obs["camera_front_image"] = RU.crop_front_image(obs["camera_front_image"], cfg.task_name)
        acts = PU.get_vla_action(cfg, model, processor, RU.prepare_observation(obs, device=device),
                                 task)
        chunk = env.log[k:k + cfg.num_open_loop_steps]
        n += bitwise_equal("robosuite", [a for _, a in chunk], [
            RU.convert_action_to_world(np.asarray(a), env.obs[i]["eef_pos"])[0]
            for (i, _), a in zip(chunk, acts)])
    run = client_report(f"(d) UR5e robosuite episode (success {success})", card,
                        launches_per_query(model), len(timer.ms), launches, wall, timer.ms,
                        len(env.log), n)
    del model
    return run


def bridge_client(card: str, rng, device: str, ckpt: str) -> dict:
    """(e) `run_bridgev2_eval.eval_bridge`, the discrete head: 1 episode of
    10 steps, each a query whose 5 actions go to the arm at 5 Hz."""
    from openvla_oft_tpu_torch.experiments.robot.bridge import run_bridgev2_eval as B
    from openvla_oft_tpu_torch.serving import openvla_utils as PU
    from openvla_oft_tpu_torch.serving.robot_utils import (invert_gripper_action,
                                                           normalize_gripper_action)

    cfg = B.GenerateConfig(pretrained_checkpoint=ckpt, max_episodes=1, max_steps=10,
                           device=device)
    client = WidowXStandIn(rng)
    task = "put the spoon on the towel"
    models, get_model = [], B.get_model

    def capture(c):
        models.append(get_model(c))
        return models[-1]

    timer = Timed(B.get_action)
    answers = iter([task, "n"])
    reset_launch_counts()
    t0 = time.perf_counter()
    with patched(B, "get_widowx_env", lambda c: client), patched(B, "get_model", capture), \
            patched(B, "get_action", timer), patched(builtins, "input", lambda *a: next(answers)):
        B.eval_bridge(cfg)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    model = models[0]
    if model.head != "discrete" or model.platform.name != "bridge":
        raise AssertionError(f"Bridge: head {model.head}, platform {model.platform.name}")
    if len(client.stepped) != cfg.max_steps * cfg.num_open_loop_steps:
        raise AssertionError(f"Bridge: {len(client.stepped)} actions stepped")
    processor = PU.get_processor(cfg)
    n = 0
    for q, i in enumerate(client.served):
        obs = B.prepare_observation({"image": client.images[i], "state": client.states[i]})
        acts = PU.get_vla_action(cfg, model, processor, obs, task)
        n += bitwise_equal("Bridge", client.stepped[5 * q:5 * q + 5], [
            invert_gripper_action(normalize_gripper_action(np.asarray(a))) for a in acts[:5]])
    run = client_report("(e) Bridge, discrete head", card, launches_per_query(model),
                        len(timer.ms), launches, wall, timer.ms, len(client.stepped), n)
    del model, models
    return run


def eval_clients_phase(card: str, rng, device: str = "cuda", ckpt: str = "random:7b",
                       build_aloha=None) -> dict:
    """Phase 17: the quickstart and the LIBERO, ALOHA, UR5e-robosuite and
    Bridge clients on `ckpt` (the flagship at full width), in that order.
    Returns each client's launches and times."""
    from openvla_oft_tpu_torch.serving.deploy import flagship_policy

    t_phase = time.perf_counter()
    build_aloha = build_aloha or (lambda: flagship_policy(device, seed=0, platform="aloha",
                                                           vit_fused=True))
    runs = {}
    for name, run in (("quickstart", lambda: quickstart_client(card, device, ckpt)),
                      ("libero", lambda: libero_client(card, rng, device, ckpt)),
                      ("aloha", lambda: aloha_client(card, rng, device, build_aloha)),
                      ("robosuite", lambda: robosuite_client(card, rng, device, ckpt)),
                      ("bridge", lambda: bridge_client(card, rng, device, ckpt))):
        runs[name] = run()
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[clients] phase 17 took {time.perf_counter() - t_phase:.1f} s (host clock; {card})")
    return runs


def _detached(node):
    if isinstance(node, dict):
        return {k: _detached(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_detached(v) for v in node]
    return node.detach()


# === Phase 18: multi-GPU execution on the one card (PR 23) ===
# (a) The fine-tuning CLI with --multihost on a one-rank NCCL group (every
# trainable and base leaf a DTensor on the (1, 1, 1) mesh) against the same
# CLI without it (phase 10's run), at CUT_LAYERS layers, full width, seed and batch;
# then flash_attention_tp (K1 forward, K2/K3 backward under local_map) on the
# one-rank tp mesh at the training shape, bitwise against the unsharded call.
# (b) tp = 2 serving of the flagship on the one card: two processes on cuda:0
# in a gloo group (NCCL refuses two ranks on one device: ncclInvalidUsage on
# every collective, measured on the H100 with NCCL 2.28.9), each with half of
# every tp-sharded leaf, K1 over 16 of the 32 heads; the actions and hidden
# states against the one-rank policy's; then flash_attention_tp forward and
# backward (K1, K2, K3 under local_map) on each rank's 16 heads at the
# training shape against flash_attention over all 32. Gloo's collectives
# stage CUDA tensors through the host, so the request times are the cost of
# this harness only.
TP_REQUESTS = 2


def one_rank_training(card: str, s_train: int, want: dict, plain: dict) -> dict:
    """Phase 18 (a), and (d) in the same one-rank NCCL group: the CLI on the
    mesh against phase 10's run without one (`want`, its `reference_run`;
    `plain`, its info). Returns the CLI runs' launches."""
    import torch.distributed as dist

    from openvla_oft_tpu_torch.bridge import tree_leaves

    t_phase = time.perf_counter()
    store = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    one_rank = ["--multihost", "True", "--coordinator_address", f"file://{store}/store",
                "--num_processes", "1", "--process_id", "0"]
    runs = {}
    try:
        with cut_flagship():
            state, runs["1-rank"], multi = train(card, CUT_LAYERS, flags=TRAIN_FLAGS + one_rank,
                                                 label="multigpu-1rank", keep_first=True)
            backend = dist.get_backend()
            sharded = sum(hasattr(t, "device_mesh") for t in tree_leaves(state.trainables))
            log(f"[multigpu-1rank] backend {backend}, {sharded} of "
                f"{len(tree_leaves(state.trainables))} trainable leaves DTensors ({card})")
            hold_to_reference("multigpu-1rank", state, multi, want, card)
            del state
            gc.collect()
            torch.cuda.empty_cache()
            t_plain = float(np.median(plain["step_times"][1:]))
            t_multi = float(np.median(multi["step_times"][1:]))
            log(f"[multigpu-1rank] step time, median of steps 1-2: {t_multi:.4f} s on the "
                f"one-rank mesh, {t_plain:.4f} s without in phase 10 (x{t_multi / t_plain:.3f}, "
                f"the DTensor "
                f"overhead; host clock, each step ends in torch.cuda.synchronize); peak "
                f"{multi['peak'] / 2**30:.3f} GiB against {plain['peak'] / 2**30:.3f} GiB "
                f"({card})")
            runs["tp-wrapper"] = tp_wrapper_check(card, s_train)
            log(f"[multigpu] phase 18 (a) took {time.perf_counter() - t_phase:.1f} s "
                f"(host clock)")
            t_d = time.perf_counter()
            # (d) QLoRA on the one-rank mesh against phase 14's runs without one.
            for name, flags in (("QLoRA int8", QLORA_INT8_FLAGS),
                                ("QLoRA int4 B=1", QLORA_INT4_FLAGS)):
                ref = QLORA_REFS[name]
                label = f"multigpu-{name.replace(' ', '-').lower()}"
                state, runs[f"1-rank {name}"], info = train(
                    card, CUT_LAYERS, flags=flags + one_rank, label=label,
                    expect_extra=ref["extra"], keep_first=True)
                hold_to_reference(label, state, info, ref, card)
                log(f"[{label}] step times {', '.join(f'{t:.4f}' for t in info['step_times'])}"
                    f" s on the one-rank mesh, peak {info['peak'] / 2**30:.3f} GiB; the "
                    f"quantized products a step {ref['extra']} as phase 14's ({card})")
                del state
                gc.collect()
                torch.cuda.empty_cache()
            log(f"[multigpu] phase 18 (d) took {time.perf_counter() - t_d:.1f} s (host clock)")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    return runs


def hold_to_reference(label: str, state, info, ref: dict, card: str) -> None:
    """A CLI run against `ref` (`reference_run`) on the same flags: losses
    and trainables bitwise equal, else the losses within TRAIN_LOSS_REL and
    each trainable group's update after step 0 within TRAIN_GRAD_COSINE."""
    from openvla_oft_tpu_torch.bridge import tree_leaves

    got = [t.detach().to_local() if hasattr(t, "to_local") else t.detach()
           for t in tree_leaves(state.trainables)]
    first = [t.to_local() if hasattr(t, "to_local") else t for t in info["first"]]
    want = ref["trainables"]
    equal = sum(int(torch.equal(a, b)) for a, b in zip(got, want))
    log(f"[{label}] losses {info['losses']} against {ref['losses']} without a mesh; "
        f"{equal} of {len(want)} trainable leaves bitwise equal after "
        f"{len(ref['losses'])} steps ({card})")
    if info["losses"] == ref["losses"] and equal == len(want):
        return
    rels = [abs(a - b) / abs(b) for a, b in zip(info["losses"], ref["losses"])]
    ok = all(np.isfinite(info["losses"])) and max(rels) <= TRAIN_LOSS_REL
    start = 0
    for group, n in ref["groups"].items():
        upd = [torch.cat([(x - f).float().flatten() for x, f in
                          zip(src[start:start + n], fst[start:start + n])])
               for src, fst in ((got, first), (want, ref["first"]))]
        cos = torch.nn.functional.cosine_similarity(upd[0], upd[1], dim=0).item()
        log(f"[{label}] {group}: cosine of the updates after step 0, with and without the "
            f"mesh = {cos:.6f}")
        ok = ok and cos >= TRAIN_GRAD_COSINE
        start += n
    log(f"[{label}] loss relative differences {rels} (bound {TRAIN_LOSS_REL})")
    if not ok:
        raise AssertionError(f"{label}: the one-rank mesh run disagrees with the run without it")


def tp_wrapper_check(card: str, s_train: int) -> dict:
    """K1, then K2 and K3, through `flash_attention_tp`'s local_map on the
    one-rank tp mesh of the group phase 18 (a) set up, at the training
    batch's shape; bitwise against `flash_attention`. Returns the launches."""
    from openvla_oft_tpu_torch.ops.flash_attention import flash_attention, flash_attention_tp
    from openvla_oft_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(1, 1, 1, device_type="cuda")
    q, k, v, do, key_valid, bidir = tp_attention_inputs(s_train)
    b = q.shape[0]
    out = {}
    for name in ("tp", "plain"):
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        before = launch_counts()
        if name == "tp":
            o = flash_attention_tp(*ins, mesh, key_valid=key_valid, bidir_mask=bidir)
            o = o.to_local()
        else:
            o = flash_attention(*ins, key_valid=key_valid, bidir_mask=bidir)
        grads = torch.autograd.grad(o, ins, do)
        torch.cuda.synchronize()
        out[name] = ((o.detach(),) + grads,
                     {key: n - before[key] for key, n in launch_counts().items()})
    (tp, used), (plain, _) = out["tp"], out["plain"]
    same = [torch.equal(a, b) for a, b in zip(tp, plain)]
    log(f"[multigpu-tp] flash_attention_tp on the one-rank mesh at B = {b}, S = {s_train}: "
        f"launches {used}; O, dq, dk, dv bitwise equal to flash_attention: {same} ({card})")
    if used["K1"] != 1 or used["K2"] != 1 or used["K3"] != 1 or not all(same):
        raise AssertionError("flash_attention_tp on one rank is not K1, K2, K3 as they are")
    return used


def tp_attention_inputs(s_train: int, device: str = "cuda") -> tuple:
    """q, k, v, dO (B = 8, S = s_train, 32 heads of 128, bf16, drawn from a
    generator seeded 18 on `device`, alike in every process), key_valid with
    7 i padded keys in row i, and a bidirectional block of 57."""
    gen = torch.Generator(device=device).manual_seed(18)
    b, h, d = 8, 32, 128
    q, k, v, do = (torch.randn((b, s_train, h, d), generator=gen, device=device,
                               dtype=torch.bfloat16) for _ in range(4))
    key_valid = torch.ones((b, s_train), dtype=torch.bool, device=device)
    for i in range(b):
        key_valid[i, s_train - 7 * i:] = False
    bidir = torch.zeros_like(key_valid)
    bidir[:, s_train - 120:s_train - 63] = True
    return q, k, v, do, key_valid, bidir


def tp_attention_check(mesh, s_train: int, device: str = "cuda") -> dict:
    """`flash_attention_tp` forward and backward on this rank's head shard
    of the tp mesh (K1, then K2 and K3, under local_map) at the training
    batch's shape, against `flash_attention` over every head on the same
    inputs: O, dq, dk and dv of the rank's heads. The inputs enter as
    DTensors Shard(2) of the rank's own heads, so no collective runs.
    Returns the tp call's launches and the errors."""
    from torch.distributed.tensor import DTensor, Shard

    from openvla_oft_tpu_torch.ops.flash_attention import (flash_attention,
                                                           flash_attention_tp, tp_mesh_of)

    tp = tp_mesh_of(mesh)
    q, k, v, do, key_valid, bidir = tp_attention_inputs(s_train, device)
    whole = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = flash_attention(*whole, key_valid=key_valid, bidir_mask=bidir)
    ref = (o.detach(),) + torch.autograd.grad(o, whole, do)
    n = q.shape[2] // tp.size()
    heads = slice(tp.get_local_rank() * n, (tp.get_local_rank() + 1) * n)
    own = [t[:, :, heads].clone().requires_grad_(True) for t in (q, k, v)]
    before = launch_counts()
    o = flash_attention_tp(*(DTensor.from_local(t, tp, [Shard(2)], run_check=False)
                             for t in own), mesh, key_valid=key_valid,
                           bidir_mask=bidir).to_local()
    got = (o.detach(),) + torch.autograd.grad(o, own, do[:, :, heads].contiguous())
    if device == "cuda":
        torch.cuda.synchronize()
    used = {key: c - before[key] for key, c in launch_counts().items()}
    refs = [r[:, :, heads] for r in ref]
    return {"launches": used, "heads": (heads.start, heads.stop), "shape": tuple(q.shape),
            "errs": {name: _rel_cos(g, r) for name, g, r in zip(("O", "dq", "dk", "dv"),
                                                                 got, refs)},
            "bitwise": [torch.equal(g, r) for g, r in zip(got, refs)]}


# Phase 18 (c): the quantized and K4 variants served at tp = 2, each built
# with flagship_policy's flags, (label, build flags, policy switches).
TP_VARIANTS = [("bf16 vit_fused", {}, {"vit_fused": True}),
               ("W4A16", {"load_in_4bit": True}, {}),
               ("W4A8", {"load_in_4bit": True}, {"int4_a8": True}),
               ("W8A8", {"load_in_8bit": True}, {})]
TP_VARIANT_REQUESTS = 1
# tp = 2's local shapes of the int4 products (T = 618, K, N, route): each
# rank's row block of wo and down, column block of wqkv and gate_up.
TP_INT4_LOCAL = [("down rows", 618, 5504, 4096), ("wo rows", 618, 2048, 4096),
                 ("wqkv columns", 618, 4096, 6144), ("gate_up columns", 618, 4096, 11008)]
# K4's column blocks at tp = 2 (LIBERO, 2 images: M = 2 x 261 DINOv2 rows,
# 2 x 256 SigLIP rows; D; the block's N; the activation).
TP_K4_LOCAL = [("DINOv2 qkv columns", 522, 1024, 1536, None),
               ("DINOv2 fc1 columns", 522, 1024, 2048, "gelu"),
               ("SigLIP qkv columns", 512, 1152, 1728, None),
               ("SigLIP fc1 columns", 512, 1152, 2152, "gelu_tanh")]


def tp_variant_expect(cfg, label: str) -> dict:
    """A tp = 2 request's launches a rank: K1 31 (16 of 32 heads); K4 98
    with vit_fused; K5 + K5s or K6 + K6s 4 a layer (the out_window layer too:
    its wqkv is tp-sharded, so it projects every row once over the rank's
    columns, where one rank slices q, k and v apart); the int8 products of
    phase 8b less the 2 column views."""
    n = cfg.llm.num_layers
    want = {"K1": n - 1, "K4": 0, "K5": 0, "K6": 0, "int8": 0}
    if label == "bf16 vit_fused":
        want["K4"] = 2 * sum(v.depth - 1 for v in cfg.vision_configs)
    elif label in ("W4A16", "W4A8"):
        want["K5" if label == "W4A16" else "K6"] = 4 * n
    elif label == "W8A8":
        want["int8"] = int8_per_request(cfg, True) - 2
    return want


def tp_local_kernels(dev) -> dict:
    """One K5 and one K6 launch at tp = 2's local down shape (T = 618,
    K = 5,504: each rank's 43 of 86 scale groups) against their plain
    versions: (max|d| / max|ref| of each, the plans)."""
    from openvla_oft_tpu_torch.ops import int4_matmul as M
    from openvla_oft_tpu_torch.ops.quant import quantize_weight_int4

    gen = torch.Generator(device=dev).manual_seed(24)
    x = torch.randn((618, 5504), generator=gen, device=dev).bfloat16()
    q = quantize_weight_int4(torch.randn((5504, 4096), generator=gen, device=dev) * 0.02)
    out = {}
    for name, fn, ref in (("K5", M.int4_matmul_fused, M.int4_matmul_ref),
                          ("K6", M.int4_matmul_fused_a8, M.int4_matmul_a8_ref)):
        y = fn(x, q["kernel_q4"], q["scale_w4"])
        r = ref(x, q["kernel_q4"], q["scale_w4"])
        out[name] = (y - r).abs().max().item() / r.abs().max().item()
    group = 5504 // q["scale_w4"].shape[0]
    out["plans"] = {"K5": M._k5_plan(618, 5504, 4096, group),
                    "K6": M._k6_plan(618, 5504, 4096, group)}
    return out


def tp_serving_rank(rank: int, store: str, obs: dict, s_train: int, out_q) -> None:
    """One rank of phase 18 (b) and (c), in its own process: the flagship
    policy on the tp = 2 mesh of a gloo group on cuda:0, TP_REQUESTS
    requests through `predict_action_from_frames`, then the action rows'
    hidden states; then each of TP_VARIANTS (the bf16 policy with vit_fused,
    the int4 one for W4A16 and W4A8, the int8 one), TP_VARIANT_REQUESTS
    requests and the hidden states each; one K5 and one K6 launch at the
    local down shape; then `tp_attention_check` on the rank's 16 heads."""
    import traceback

    try:
        import torch.distributed as dist

        from openvla_oft_tpu_torch.bridge import tree_leaves
        from openvla_oft_tpu_torch.models.prismatic import predict_action_hidden
        from openvla_oft_tpu_torch.ops.quant import int4_a8
        from openvla_oft_tpu_torch.ops.vit_fused import vit_fused
        from openvla_oft_tpu_torch.parallel.mesh import init_distributed, make_mesh
        from openvla_oft_tpu_torch.parallel.sharding import replicate, shard_params
        from openvla_oft_tpu_torch.serving.deploy import flagship_policy

        # the parent's cut of the flagship (SERVE_CUT_LAYERS), in this process too
        with cut_serving_flagship():
            torch.cuda.set_device(0)
            init_distributed("cuda", f"file://{store}", 2, rank, backend="gloo")
            mesh = make_mesh(1, 1, 2, device_type="cuda")

            def serve_variant(policy, n_requests):
                """The requests' answers, times, launches and collectives, and
                the action rows' hidden states under the policy's switches."""
                torch.cuda.reset_peak_memory_stats()
                reset_launch_counts()
                replicate.counts.update({k: 0 for k in replicate.counts})
                times, answers = [], []
                for _ in range(n_requests):
                    t0 = time.perf_counter()
                    answers.append(policy.predict_action_from_frames(
                        frames_of(policy, obs), obs["instruction"], np.asarray(obs["state"])))
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                launches = launch_counts()
                collectives = {k: v / n_requests for k, v in replicate.counts.items()}
                peak = torch.cuda.max_memory_allocated()
                _, ids, mask, pixels, proprio = model_inputs(policy, obs)
                params, ctx = policy._sharded()
                with ctx, int4_a8(policy.int4_a8), vit_fused(policy.vit_fused):
                    hidden = predict_action_hidden(params, policy.cfg, policy.platform, ids, mask,
                                                   pixels, proprio=proprio.clamp(-1, 1),
                                                   use_flash=True)
                return {"answers": answers, "times": times, "launches": launches, "peak": peak,
                        "collectives": collectives,
                        "hidden": hidden.actions_hidden.float().cpu().numpy(),
                        "weights": sum((t.to_local() if hasattr(t, "to_local") else t).nbytes
                                       for t in tree_leaves(policy.params))}

            t0 = time.perf_counter()
            policy = flagship_policy("cuda", seed=0, tp_mesh=mesh)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            held = torch.cuda.memory_allocated()
            res = serve_variant(policy, TP_REQUESTS)
            res.update(build_s=build_s, held=held,
                       local_heads=policy.cfg.llm.num_heads // mesh.size(2))
            variants = {}
            policy.vit_fused = True
            variants["bf16 vit_fused"] = serve_variant(policy, TP_VARIANT_REQUESTS)
            del policy
            gc.collect()
            torch.cuda.empty_cache()
            for build in ({"load_in_4bit": True}, {"load_in_8bit": True}):
                t0 = time.perf_counter()
                policy = flagship_policy("cuda", seed=0, tp_mesh=mesh, **build)
                torch.cuda.synchronize()
                built = {"build_s": time.perf_counter() - t0, "kept_whole": shard_params.kept_whole}
                for label, flags, switches in TP_VARIANTS:
                    if flags != build:
                        continue
                    policy.int4_a8 = switches.get("int4_a8", False)
                    variants[label] = {**serve_variant(policy, TP_VARIANT_REQUESTS), **built}
                del policy
                gc.collect()
                torch.cuda.empty_cache()
            res["variants"] = variants
            res["local_kernels"] = tp_local_kernels(torch.device("cuda"))
            res["attention"] = tp_attention_check(mesh, s_train)
            out_q.put((rank, res))
            dist.destroy_process_group()
    except BaseException:
        out_q.put((rank, {"error": traceback.format_exc()}))


def tp_references(policy, obs) -> dict:
    """Phase 18 (c)'s one-rank references: the actions_hidden of each of
    TP_VARIANTS on one rank, from the bf16 `policy` (with vit_fused) and the
    flagship rebuilt with each quantized build; the policies are freed."""
    from openvla_oft_tpu_torch.ops.quant import int4_a8
    from openvla_oft_tpu_torch.serving.deploy import flagship_policy

    inputs = model_inputs(policy, obs)
    refs = {"bf16 vit_fused": actions_hidden(policy, inputs, vit_fused=True).cpu()}
    for build in ({"load_in_4bit": True}, {"load_in_8bit": True}):
        quantized = flagship_policy("cuda", seed=0, **build)
        for label, flags, switches in TP_VARIANTS:
            if flags == build:
                with int4_a8(switches.get("int4_a8", False)):
                    refs[label] = actions_hidden(quantized, inputs).cpu()
        del quantized
        gc.collect()
        torch.cuda.empty_cache()
    return refs


def tp_serving(card: str, rng, s_train: int) -> tuple:
    """Phase 18 (b) and (c). Returns each rank's launches in the bf16 serve,
    in each variant's serve, and in its attention check."""
    import multiprocessing as mp
    import queue

    from openvla_oft_tpu_torch.serving.deploy import flagship_policy

    t_phase = time.perf_counter()
    policy = flagship_policy("cuda", seed=0)
    obs = observation(policy, rng)
    ref_actions = policy.predict_action_from_frames(frames_of(policy, obs), obs["instruction"],
                                                    np.asarray(obs["state"]))
    ref_hidden = actions_hidden(policy, model_inputs(policy, obs)).cpu()
    cfg = policy.cfg
    n_layers, n_heads = cfg.llm.num_layers, cfg.llm.num_heads
    t_refs = time.perf_counter()
    refs = tp_references(policy, obs)
    t_refs = time.perf_counter() - t_refs
    del policy
    gc.collect()
    torch.cuda.empty_cache()

    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    store = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    procs = [ctx.Process(target=tp_serving_rank,
                         args=(r, os.path.join(store, "store"), obs, s_train, out_q))
             for r in range(2)]
    results = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + 600
        while len(results) < 2 and time.monotonic() < deadline:
            try:
                rank, res = out_q.get(timeout=5)
                results[rank] = res
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(store, ignore_errors=True)
    errors = {r: res["error"] for r, res in results.items() if "error" in res}
    if len(results) < 2 or errors:
        raise AssertionError(f"phase 18 (b): ranks {sorted(results)} answered; exit codes "
                             f"{[p.exitcode for p in procs]}; errors {errors}")
    want = {"K1": TP_REQUESTS * (n_layers - 1), "K4": 0, "K5": 0, "K6": 0, "int8": 0}
    for rank, res in sorted(results.items()):
        cos = cosine(torch.from_numpy(res["hidden"]), ref_hidden)
        d_act = max(float(np.abs(a - ref_actions).max()) for a in res["answers"])
        log(f"[tp-serve] rank {rank}: tp = 2 on cuda:0 (gloo), K1 over {res['local_heads']} of "
            f"{n_heads} heads a launch; weights held {res['weights'] / 2**30:.3f} GiB, "
            f"allocated after the build {res['held'] / 2**30:.3f} GiB, peak over the "
            f"requests {res['peak'] / 2**30:.3f} GiB; launches over {TP_REQUESTS} requests "
            f"{res['launches']}; collectives a request: "
            f"{res['collectives']['all_gather']:.0f} all-gathers "
            f"({res['collectives']['all_gather_bytes'] / 2**20:.1f} MiB out), "
            f"{res['collectives']['all_reduce']:.0f} all-reduces "
            f"({res['collectives']['all_reduce_bytes'] / 2**20:.1f} MiB); "
            f"actions_hidden cosine against the one-rank policy "
            f"{cos:.6f}, max|d actions| {d_act:.4e}; request times "
            f"{', '.join(f'{t:.3f}' for t in res['times'])} s (host clock: the cost of this "
            f"harness, gloo staging every collective through the host, not a speed); "
            f"built in {res['build_s']:.1f} s ({card})")
        if cos < PARITY_COSINE or not all(np.isfinite(a).all() for a in res["answers"]):
            raise AssertionError(f"rank {rank}'s tp = 2 answer disagrees with one rank: "
                                 f"cosine {cos}")
        if any(res["launches"][k] != n for k, n in want.items()):
            raise AssertionError(f"rank {rank} launched {res['launches']}, expected {want}")
        for label, v in res["variants"].items():
            per = tp_variant_expect(cfg, label)
            expect = {k: TP_VARIANT_REQUESTS * n for k, n in per.items()}
            vcos = cosine(torch.from_numpy(v["hidden"]), refs[label])
            log(f"[tp-quant] rank {rank}, {label}: launches over {TP_VARIANT_REQUESTS} "
                f"requests {v['launches']} (expected {expect}); actions_hidden cosine against "
                f"the same variant on one rank {vcos:.6f} (bound {PARITY_COSINE}); weights "
                f"held {v['weights'] / 2**30:.3f} GiB, peak over the requests "
                f"{v['peak'] / 2**30:.3f} GiB; collectives a request "
                f"{v['collectives']['all_gather']:.0f} all-gathers "
                f"({v['collectives']['all_gather_bytes'] / 2**20:.1f} MiB), "
                f"{v['collectives']['all_reduce']:.0f} all-reduces "
                f"({v['collectives']['all_reduce_bytes'] / 2**20:.1f} MiB)"
                + (f"; built in {v['build_s']:.1f} s, kept whole over tp: "
                   f"{v['kept_whole'] or 'none'}" if "build_s" in v else "")
                + f"; request times {', '.join(f'{t:.3f}' for t in v['times'])} s (host "
                  f"clock, gloo) ({card})")
            if vcos < PARITY_COSINE or not all(np.isfinite(a).all() for a in v["answers"]):
                raise AssertionError(f"rank {rank}'s {label} answer at tp = 2 disagrees with "
                                     f"one rank: cosine {vcos}")
            if any(v["launches"][k] != n for k, n in expect.items()):
                raise AssertionError(f"rank {rank}'s {label} launched {v['launches']}, "
                                     f"expected {expect}")
        lk = res["local_kernels"]
        log(f"[tp-quant] rank {rank}: K5 and K6 at the local down shape (T = 618, K = 5,504, "
            f"N = 4,096, 43 groups) against their plain versions: K5 rel {lk['K5']:.3e} "
            f"(bound {INT4_K5_REL}), K6 rel {lk['K6']:.3e} (bound {INT4_K6_REL}); plans "
            f"(t_tile, splits, CTAs) K5 {lk['plans']['K5']}, K6 {lk['plans']['K6']} ({card})")
        if not (lk["K5"] <= INT4_K5_REL and lk["K6"] <= INT4_K6_REL):
            raise AssertionError(f"rank {rank}: K5/K6 at the local down shape disagree with "
                                 f"their plain versions")
        att = res["attention"]
        log(f"[tp-attn] rank {rank}: flash_attention_tp at tp = 2, B, S, H, D = "
            f"{att['shape']}, heads {att['heads'][0]}-{att['heads'][1] - 1} on this rank, "
            f"forward and backward under local_map: launches {att['launches']}; against "
            f"flash_attention over all heads: " + " ".join(
                f"{n} max|d|={e[0]:.3e} rel={e[1]:.3e} cos={e[2]:.6f}"
                for n, e in att["errs"].items())
            + f"; bitwise (O, dq, dk, dv): {att['bitwise']} (bounds rel {BWD_REL}, cosine "
              f"{BWD_COSINE}; {card})")
        if not all(e[1] <= BWD_REL and e[2] >= BWD_COSINE for e in att["errs"].values()):
            raise AssertionError(f"rank {rank}'s flash_attention_tp disagrees with "
                                 f"flash_attention")
        if any(att["launches"][key] != 1 for key in ("K1", "K2", "K3")):
            raise AssertionError(f"rank {rank}'s flash_attention_tp launched "
                                 f"{att['launches']}, expected K1, K2 and K3 once each")
    for label in ["bf16"] + list(results[0]["variants"]):
        a = results[0]["answers"] if label == "bf16" else results[0]["variants"][label]["answers"]
        b = results[1]["answers"] if label == "bf16" else results[1]["variants"][label]["answers"]
        if not all(np.array_equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"the two tp ranks answered differently ({label})")
    log(f"[tp-serve] phase 18 (b), (c) took {time.perf_counter() - t_phase:.1f} s (host clock; "
        f"the one-rank references of (c) {t_refs:.1f} s)")
    local = tp_local_shapes(card)
    return ({f"tp2 rank {r}": results[r]["launches"] for r in (0, 1)},
            {f"tp2 rank {r} {label}": v["launches"] for r in (0, 1)
             for label, v in results[r]["variants"].items()},
            {f"tp2 rank {r}": results[r]["attention"]["launches"] for r in (0, 1)},
            local)


def tp_local_shapes(card: str) -> dict:
    """K5 and K6 at tp = 2's local blocks of the int4 LLM (TP_INT4_LOCAL) and
    K4 at the ViTs' column blocks (TP_K4_LOCAL), alone on the card: device
    time (mean of 10, L2 flushed) beside the bound and the library call at
    the same local shape (torch.matmul on the bf16 weight, torch._int_mm on
    the int8 one, torch.matmul on K4's product), and the plain version's
    time by CUDA events; each checked against its plain version."""
    from openvla_oft_tpu_torch.ops import int4_matmul as M
    from openvla_oft_tpu_torch.ops import vit_fused as VF
    from openvla_oft_tpu_torch.ops.quant import _unpack_int4, dequantize_int4, quantize_weight_int4

    dev = torch.device("cuda")
    flush = l2_flush_buffer(dev)
    out = {}
    for name, t, k, n in TP_INT4_LOCAL:
        gen = torch.Generator(device=dev).manual_seed(t + k + n)
        x = torch.randn((t, k), generator=gen, device=dev).bfloat16()
        q = quantize_weight_int4(torch.randn((k, n), generator=gen, device=dev) * 0.02)
        packed, scales = q["kernel_q4"], q["scale_w4"]
        group = k // scales.shape[0]
        row = {}
        for label, fn, ref, peak in (("K5", M.int4_matmul_fused, M.int4_matmul_ref, PEAK_BF16),
                                     ("K6", M.int4_matmul_fused_a8, M.int4_matmul_a8_ref,
                                      PEAK_INT8)):
            y, r = fn(x, packed, scales), ref(x, packed, scales)
            rel = (y - r).abs().max().item() / r.abs().max().item()
            ms, how = device_ms(lambda: fn(x, packed, scales), flush)
            plain = cuda_time_ms(lambda: ref(x, packed, scales), flush=flush)
            b, by = bound(2 * t * k * n, nbytes(x, packed, scales, y), peak)
            row[label] = {"ms": ms, "how": how, "plain_ms": plain, "bound_ms": b,
                          "bound_by": by, "rel": rel,
                          "plan": (M._k5_plan if label == "K5" else M._k6_plan)(t, k, n, group)}
        w16 = dequantize_int4(packed, scales, torch.bfloat16)
        row["K5"]["library_ms"] = device_ms(lambda: torch.matmul(x, w16), flush)[0]
        x8, _ = M.quantize_act_rows(x)
        row["K6"]["library_ms"] = int_mm_times(x8, _unpack_int4(packed), flush)[1]
        for label in ("K5", "K6"):
            e = row[label]
            lib = "n/a" if e["library_ms"] is None else f"{e['library_ms']:.4f}"
            log(f"[tp-local] {label} at {name} (T = {t}, K = {k}, N = {n}, group {group}): "
                f"{e['ms']:.4f} ms ({e['how']}), plan {e['plan']}, bound {e['bound_ms']:.4f} "
                f"({e['bound_by']}; {e['bound_ms'] / e['ms']:.3f} of it), "
                f"{'torch.matmul' if label == 'K5' else 'torch._int_mm'} {lib}, plain "
                f"{e['plain_ms']:.4f} (events); rel {e['rel']:.3e} ({card})")
        if not (row["K5"]["rel"] <= INT4_K5_REL and row["K6"]["rel"] <= INT4_K6_REL):
            raise AssertionError(f"K5/K6 disagree with their plain versions at {name}")
        out[name] = row
        del x, q, packed, scales, w16, x8
    for name, m, d, n, act in TP_K4_LOCAL:
        gen = torch.Generator(device=dev).manual_seed(m + d + n)
        x = torch.randn((m, d), generator=gen, device=dev).bfloat16()
        w = (torch.randn((d, n), generator=gen, device=dev) * 0.02).bfloat16()
        bias = (torch.randn((n,), generator=gen, device=dev) * 0.02).bfloat16()
        y, r = VF.ln_matmul(x, w, bias, act=act), VF.ln_matmul_ref(x, w, bias, act=act)
        rel = (y.float() - r.float()).abs().max().item() / r.float().abs().max().item()
        ms, how = device_ms(lambda: VF.ln_matmul(x, w, bias, act=act), flush)
        plain = cuda_time_ms(lambda: VF.ln_matmul_ref(x, w, bias, act=act), flush=flush)
        lib = device_ms(lambda: torch.matmul(x, w), flush)[0]
        b, by = bound(2 * m * d * n, nbytes(x, w, bias, y), PEAK_BF16)
        log(f"[tp-local] K4 at {name} (M = {m}, D = {d}, N = {n}, act {act}): {ms:.4f} ms "
            f"({how}), plan {VF._k4_plan(m, d, n)}, bound {b:.4f} ({by}; {b / ms:.3f} of it), "
            f"torch.matmul on the product {lib:.4f}, plain {plain:.4f} (events); rel "
            f"{rel:.3e} ({card})")
        if rel > K4_REL:
            raise AssertionError(f"K4 disagrees with its plain version at {name}")
        out[name] = {"K4": {"ms": ms, "how": how, "plain_ms": plain, "bound_ms": b,
                            "bound_by": by, "library_ms": lib, "rel": rel}}
    del flush
    torch.cuda.empty_cache()
    return out


def tp_note(multigpu: dict, tp_serve: dict, tp_attention: dict, key: str) -> dict:
    """A kernel's phase 18 launches: in the one-rank mesh CLI (DTensor
    trainables, whose tp placements the one-rank mesh replicates, so no
    tp route; counted in its launches), through local_map on one rank and on
    each rank's 16 heads at tp = 2 in the wrapper checks (not counted), and
    per tp rank of the tp = 2 serve (counted; K1 only)."""
    note = {"one-rank mesh CLI (DTensor trainables, no tp route)": multigpu["1-rank"][key],
            "local_map check on one rank (not counted)": multigpu["tp-wrapper"][key]}
    note.update({f"{name} local_map check, 16 of 32 heads (not counted)": run[key]
                 for name, run in tp_attention.items()})
    if key == "K1":
        note.update({f"{name}, 16 of 32 heads": run["K1"] for name, run in tp_serve.items()})
    return note


# === Phase 19: the run tools ===
VERIFY_ITERATIONS = 5


def run_tools_phase(card: str, metrics_jsonl: str) -> dict:
    """`scripts/verify_openvla.py` at random:7b (zero_init), VERIFY_ITERATIONS
    calls of the staged predict_action, bf16 and then --quant int8, with the
    launches a call (the counts reset just before each, read just after);
    then `scripts/summarize_run.py` on phase 10's metrics JSONL. Returns the
    launches of each verify run."""
    from openvla_oft_tpu_torch.scripts import summarize_run, verify_openvla

    t_phase = time.perf_counter()
    runs = {}
    for quant in ("", "int8"):
        cfg = verify_openvla.VerifyConfig(pretrained_checkpoint="random:7b", zero_init=True,
                                          num_iterations=VERIFY_ITERATIONS, quant=quant,
                                          device="cuda")
        reset_launch_counts()
        stats = verify_openvla.verify(cfg)
        launches = launch_counts()
        label = quant or "bf16"
        runs[f"verify {label}"] = launches
        per_call = {k: v / VERIFY_ITERATIONS for k, v in launches.items() if v}
        log(f"[verify] {label}: p50 {stats['p50'] * 1e3:.2f} ms, p90 {stats['p90'] * 1e3:.2f} "
            f"ms, mean {stats['mean'] * 1e3:.2f} ms over calls 2-{VERIFY_ITERATIONS} (host "
            f"clock, the staged predict_action, its actions copied to the host); launches a "
            f"call {per_call} ({card})")
        n = 32
        want = {"K1": n - 1, "int8": (4 * (n - 1) + 6 if quant else 0)}
        if any(launches[k] != VERIFY_ITERATIONS * v for k, v in want.items()):
            raise AssertionError(f"verify {label} launched {launches}, expected {want} a call")
        gc.collect()
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_summary_") as tmp:
        path = os.path.join(tmp, "phase10-metrics.jsonl")
        with open(path, "w") as f:
            f.write(metrics_jsonl)
        summary = summarize_run.summarize(path)
    log(f"[summarize] phase 10's run: {json.dumps(summary)}")
    if summary["n_records"] < 1 or not np.isfinite(summary["last_window_loss"]):
        raise AssertionError(f"summarize_run on phase 10's metrics gave {summary}")
    log(f"[run-tools] phase 19 took {time.perf_counter() - t_phase:.1f} s (host clock)")
    return runs


PHASE_TIMES = {}


# === Phase 20: image files, the JPEG encoder, the data scripts, the round trip ===
IMAGE_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "goldens",
                            "image_modes.npz")
SYNTH_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "goldens",
                            "synthetic_rlds.npz")


def image_modes_check(card: str) -> dict:
    """Phase 20 (a): both JPEG decoders on every golden stream (ISLOW against
    PIL's pixels, IFAST against TF's), the PNG decoder on every golden PNG;
    the host library's time a 256 x 256 frame of the synthetic set under
    ISLOW and IFAST. Returns the golden."""
    from openvla_oft_tpu_torch.processing.jpeg_decode import decode_jpeg, decode_jpeg_plain
    from openvla_oft_tpu_torch.processing.png_decode import decode_png
    from openvla_oft_tpu_torch.scripts.time_jpeg_host import synthetic_frames

    with np.load(IMAGE_GOLDEN) as f:
        z = {k: f[k] for k in f.files}
    names = [str(n) for n in z["jpeg_names"]]
    for i, name in enumerate(names):
        data = z[f"jpeg_{i}"].tobytes()
        for label, decoder in (("host library", decode_jpeg), ("plain", decode_jpeg_plain)):
            for idct, key in (("islow", f"jpeg_pil_{i}"), ("ifast", f"jpeg_tf_{i}")):
                if key not in z:
                    continue
                got = decoder(data, idct=idct)
                if got.shape != z[key].shape or not np.array_equal(got, z[key]):
                    raise AssertionError(f"the {label} decoder ({idct}) differs from "
                                         f"{'PIL' if idct == 'islow' else 'TF'} on {name}")
    frames = synthetic_frames(32)
    ms = {}
    for idct in ("islow", "ifast"):
        decode_jpeg(frames[0], idct=idct)
        t0 = time.perf_counter()
        for _ in range(3):
            for data in frames:
                decode_jpeg(data, idct=idct)
        ms[idct] = (time.perf_counter() - t0) * 1e3 / (3 * len(frames))
    pngs = [str(n) for n in z["png_names"]]
    for i, name in enumerate(pngs):
        got = decode_png(z[f"png_{i}"].tobytes())
        if got.shape != z[f"png_pil_{i}"].shape or not np.array_equal(got, z[f"png_pil_{i}"]):
            raise AssertionError(f"the PNG decoder differs from PIL on {name}")
    n_tf = sum(f"jpeg_tf_{i}" in z for i in range(len(names)))
    log(f"[image-modes] JPEG decoders, host library and plain: {len(names)} golden streams "
        f"bitwise PIL's pixels under ISLOW and {n_tf} TF's under IFAST "
        f"({', '.join(names)}); the host library on 256 x 256 frames of the synthetic set "
        f"(4:2:0, quality 90, {np.mean([len(d) for d in frames]):.0f} B): "
        f"{ms['islow']:.3f} ms a frame (ISLOW), {ms['ifast']:.3f} ms (IFAST), mean over "
        f"{3 * len(frames)} decodes each, one thread (host clock, {card}'s host); "
        f"the PNG decoder on {len(pngs)} golden PNGs bitwise PIL's ({', '.join(pngs)})")
    return z


def generate_images(z: dict, root: str, card: str) -> dict:
    """Phase 20 (b): scripts/generate.py at random:7b on the golden's
    progressive JPEG and on its 16-bit RGBA PNG, one prompt each: 4 new
    tokens, K1 32 in each prefill and nothing else."""
    import io

    from openvla_oft_tpu_torch.scripts import generate as GEN

    names = {str(n): i for i, n in enumerate(z["jpeg_names"])}
    pngs = {str(n): i for i, n in enumerate(z["png_names"])}
    files = {"progressive.jpg": z[f"jpeg_{names['pil_progressive_420']}"],
             "rgba16.png": z[f"png_{pngs['type6_depth16']}"]}
    total = {}
    for name, data in files.items():
        path = os.path.join(root, name)
        with open(path, "wb") as f:
            f.write(data.tobytes())
        gc.collect()
        torch.cuda.empty_cache()
        reset_launch_counts()
        t0 = time.perf_counter()
        answers = GEN.generate(GEN.GenerateConfig(model_path="random:7b", image_path=path,
                                                  max_new_tokens=4, device="cuda"),
                               io.StringIO(PROMPT + "\n"))
        launches = launch_counts()
        want = {"K1": 32, "K2": 0, "K3": 0, "K4": 0, "K5": 0, "K6": 0, "probe": 0, "int8": 0}
        log(f"[generate-image] {name}: {PROMPT!r} -> {answers}; {time.perf_counter() - t0:.1f} "
            f"s with the 7B's build; launches {launches} ({card})")
        if len(answers) != 1 or len(answers[0].split()) != 4 or launches != want:
            raise AssertionError(f"generate.py on {name} answered {answers} with launches "
                                 f"{launches}, expected 4 tokens and {want}")
        total = {k: total.get(k, 0) + n for k, n in launches.items()}
    return total


SYNTH_FLAGS = TRAIN_FLAGS + ["--dataset_name", "libero_synth_l1", "--num_images_in_input", "1",
                             "--image_aug", "True", "--shuffle_buffer_size", "2000"]


def synthetic_set_phase(z: dict, card: str, n_layers: int) -> dict:
    """Phase 20 (c): make_synthetic_rlds at its defaults on this host (frames
    through the host encoder) held to the golden of the JAX script's set
    (`make_synthetic_rlds.compare_to_golden`: every frame and all but the
    floats bitwise, the actions within 1 ULP, as NumPy's float32 sine
    differs by that much between versions, the proprio their running sum);
    then the fine-tuning CLI on it, 3 L1 steps at the cut, K1 2 x n_layers,
    K2 and K3 n_layers a step. Removes the set. Returns the run's
    launches."""
    from openvla_oft_tpu_torch.scripts import make_synthetic_rlds as MS
    from openvla_oft_tpu_torch.training import finetune as FT

    root = tempfile.mkdtemp(prefix="chip_smoke_synth_")
    run_root = tempfile.mkdtemp(prefix="chip_smoke_runs_")
    try:
        t0 = time.perf_counter()
        set_dir = MS.main(["--out", root])
        t_write = time.perf_counter() - t0
        summary = MS.set_summary(set_dir)
        with np.load(SYNTH_GOLDEN) as f:
            golden = {k: f[k] for k in f.files}
        frames = int(summary["lengths"].sum())
        size = sum(os.path.getsize(os.path.join(set_dir, f)) for f in os.listdir(set_dir))
        log(f"[synthetic] make_synthetic_rlds at its defaults: {frames} frames of 256 x 256 "
            f"in {t_write:.1f} s, {frames / t_write:.1f} frames/s drawn, encoded (host "
            f"library) and written (host clock, {card}'s host), {size / 1e6:.1f} MB; frames' "
            f"SHA-256 {summary['frames_sha256']}, the rest's {summary['other_sha256']}, "
            f"against the golden of the JAX script's set ({golden['args']}, NumPy "
            f"{golden['numpy']}; here {np.__version__})")
        held = MS.compare_to_golden(summary, golden)
        log(f"[synthetic] every frame and all but the floats bitwise the golden's; "
            f"{held['actions_off_by_1_ulp']} of {held['actions']} actions 1 ULP off it, the "
            f"rest bitwise; the proprio the actions' running sum, bitwise")
        flags = SYNTH_FLAGS + ["--data_root_dir", root, "--run_root_dir", run_root]
        step_want = {"K1": 2 * n_layers, "K2": n_layers, "K3": n_layers, "K4": 0, "K5": 0,
                     "K6": 0, "probe": 0, "int8": 0}
        seen = {"prev": None}

        def on_step(step, metrics, state):
            counts = launch_counts()
            per_step = {k: counts[k] - seen["prev"][k] for k in counts}
            seen["prev"] = counts
            log(f"[train-synthetic] step {step}: loss={metrics['loss']:.6f} "
                f"grad_norm={metrics['grad_norm']:.6f} step_time={metrics['step_time']:.4f} s "
                f"(host clock) launches {per_step}")
            if not (np.isfinite(metrics["loss"]) and metrics["grad_norm"] > 0):
                raise AssertionError(f"bad training step {step}: {metrics}")
            if per_step != step_want:
                raise AssertionError(f"step {step} launched {per_step}, expected {step_want}")

        reset_launch_counts()
        seen["prev"] = launch_counts()
        t0 = time.perf_counter()
        out = FT.main(flags, on_step=on_step)
        launches = launch_counts()
        total = {k: 3 * n for k, n in step_want.items()}
        if out["final_step"] != 3 or launches != total:
            raise AssertionError(f"the synthetic-set run ended at {out} with launches "
                                 f"{launches}, expected {total}")
        log(f"[train-synthetic] 3 L1 steps on the synthetic set (1 image, image_aug) in "
            f"{time.perf_counter() - t0:.1f} s with the build; launches {launches} ({card})")
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(run_root, ignore_errors=True)


def fixture_check(card: str) -> None:
    """Phase 20 (d): make_quickstart_fixture's object against the committed
    pickle, leaf for leaf, bitwise."""
    import pickle

    from openvla_oft_tpu_torch.scripts import make_quickstart_fixture as QF

    committed = os.path.join(os.path.dirname(os.path.abspath(__file__)), "experiments", "robot",
                             "libero", "sample_libero_spatial_observation.pkl")
    with tempfile.TemporaryDirectory() as tmp:
        with open(QF.main(["--out", os.path.join(tmp, "obs.pkl")]), "rb") as f:
            got = pickle.load(f)
    with open(committed, "rb") as f:
        want = pickle.load(f)
    for key, value in want.items():
        same = (isinstance(value, np.ndarray) and value.dtype == got[key].dtype
                and value.shape == got[key].shape and value.tobytes() == got[key].tobytes()) \
            or (not isinstance(value, np.ndarray) and got[key] == value)
        if not same or got.keys() != want.keys():
            raise AssertionError(f"the fixture's {key!r} differs from the committed pickle's")
    log(f"[fixture] make_quickstart_fixture: {sorted(want)} bitwise equal to the committed "
        f"pickle ({card})")


def roundtrip_phase(card: str) -> dict:
    """Phase 20 (e): exp_roundtrip_7b at 32 layers on the card. Returns the
    launches (the two action chunks: K1 31 each)."""
    from openvla_oft_tpu_torch.scripts import exp_roundtrip_7b as RT

    gc.collect()
    torch.cuda.empty_cache()
    out_dir = checkpoint_dir(16 * 10**9)
    reset_launch_counts()
    with RssPeak() as rss:
        out = RT.run("7b", out=out_dir, device="cuda")
    launches = launch_counts()
    want = {"K1": 62, "K2": 0, "K3": 0, "K4": 0, "K5": 0, "K6": 0, "probe": 0, "int8": 0}
    log(f"[roundtrip] 32 layers: {out['bytes']:,} B written in {out['write_s']:.1f} s "
        f"({out['bytes'] / out['write_s'] / 1e9:.2f} GB/s, synced to disk), loaded onto the "
        f"card in {out['load_s']:.1f} s ({out['load_gbps']:.2f} GB/s; the files just written, "
        f"likely from the page cache), {out['leaf_bytes']:,} B of leaves bitwise equal to the "
        f"tree drawn again, the action chunk {tuple(out['chunk'].shape)} bitwise equal; host "
        f"resident set {rss.base / 2**30:.3f} GiB before, peak {rss.peak / 2**30:.3f} GiB "
        f"during; launches {launches} (host clock, {card})")
    if launches != want or not torch.isfinite(out["chunk"]).all():
        raise AssertionError(f"the round trip launched {launches}, expected {want}")
    return launches


def files_phase(card: str, n_layers: int) -> dict:
    """Phase 20: (a)-(e). Returns each run's launches."""
    z = phase("20 (a) image modes", image_modes_check, card)
    root = tempfile.mkdtemp(prefix="chip_smoke_images_")
    try:
        runs = {"generate": phase("20 (b) generate", generate_images, z, root, card)}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    with cut_flagship():
        runs["synthetic"] = phase("20 (c) synthetic set", synthetic_set_phase, z, card,
                                  n_layers)
    phase("20 (d) fixture", fixture_check, card)
    runs["roundtrip"] = phase("20 (e) round trip", roundtrip_phase, card)
    return runs


BENCH_REPO = os.path.dirname(os.path.abspath(__file__))
BENCH_K1 = 31            # the flagship's 32 layers but the out_window one
BENCH_INT4 = 130         # 4 linears in each of 31 layers and 6 in the window layer
BENCH_INT8_VISION = 199  # the two ViTs' 4 linears a block and the projector's 3
BENCH_CASES = [("bf16", {}, {"K1": BENCH_K1, "K4": 0, "K5": 0, "K6": 0, "int8": 0}),
               ("int4 W4A16", {"quant": "int4"},
                {"K1": BENCH_K1, "K4": 0, "K5": BENCH_INT4, "K6": 0, "int8": BENCH_INT8_VISION}),
               ("int4 W4A8", {"quant": "int4", "int4_a8": True},
                {"K1": BENCH_K1, "K4": 0, "K5": 0, "K6": BENCH_INT4,
                 "int8": BENCH_INT8_VISION})]
# Phase 21 (g): `python` for the launcher, which runs the fine-tuning CLI
# with random:7b's Llama cut to CUT_LAYERS (`cut_flagship`) and prints the
# run's kernel launches.
LAUNCHER_PYTHON = """import json, sys
sys.path.insert(0, {repo!r})
import chip_smoke
from openvla_oft_tpu_torch.training import finetune as FT
args = sys.argv[1:]
assert args[:2] == ["-m", "openvla_oft_tpu_torch.training.finetune"], args
chip_smoke.reset_launch_counts()
with chip_smoke.cut_flagship():
    FT.main(args[2:])
print("[launcher-launches] " + json.dumps(chip_smoke.launch_counts()), flush=True)
"""


# Phase 21 (a), (c), (b), (d), (f): the timed tools one after the other in
# one process of their own (one start-up instead of two), each section of
# stdout and stderr under a "=== <label>" line. The process imports them,
# then waits for the file named by its argument: the smoke's counted
# requests run while it starts, and none of its timed loops beside them.
TOOLS = [("bench --extra", "bench", ["--extra"]),
         ("int4", "bench", ["--quant", "int4"]),
         ("int4 W4A8", "bench", ["--quant", "int4", "--int4-a8"]),
         ("components", "bench_components", ["--flash", "--vit-fused"]),
         ("data", "bench_data", [])]
TOOLS_PROCESS = """import importlib, os, sys, time
tools = {tools!r}
mods = {{m: importlib.import_module("openvla_oft_tpu_torch.scripts." + m) for _, m, _ in tools}}
while not os.path.exists(sys.argv[1]):
    time.sleep(0.05)
for label, module, argv in tools:
    for stream in (sys.stdout, sys.stderr):
        print("=== " + label, file=stream, flush=True)
    t0 = time.perf_counter()
    mods[module].main(argv)
    print(f"# {{label}} took {{time.perf_counter() - t0:.1f}} s", file=sys.stderr, flush=True)
""".format(tools=TOOLS)


def tool_sections(text: str) -> dict:
    """{label: the lines after "=== label"} of the tools process's output."""
    sections, label = {}, None
    for ln in text.splitlines(keepends=True):
        if ln.startswith("=== "):
            label = ln[4:].strip()
            sections[label] = ""
        elif label is not None:
            sections[label] += ln
    return sections


def bench_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [BENCH_REPO, env.get("PYTHONPATH")]))
    return env


def run_tool(label: str, cmd: list, timeout: float, env=None) -> tuple:
    """cmd in its own process from the repo's root: (stdout, stderr); a
    non-zero exit fails the phase."""
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=BENCH_REPO, env=env or bench_env(), capture_output=True,
                       text=True, timeout=timeout)
    log(f"[bench] {label}: exit {r.returncode} in {time.perf_counter() - t0:.1f} s "
        f"(host clock, process start included)")
    if r.returncode != 0:
        log(r.stdout[-4000:])
        log(r.stderr[-8000:])
        raise AssertionError(f"{label} exited {r.returncode}")
    return r.stdout, r.stderr


def bench_requests(card: str) -> dict:
    """Phase 21 (a), (b): one request of the bench's timed call
    (`scripts/bench_entry.py::entry`, the zero tree at full width and depth)
    per config, counted; the bf16 one also traced (torch.profiler, K1's
    kernels by name). Returns each config's launches."""
    from openvla_oft_tpu_torch.scripts.bench_entry import entry

    runs = {}
    for label, kw, want in BENCH_CASES:
        t0 = time.perf_counter()
        fn, args = entry(device="cuda", **kw)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        fn(*args)
        torch.cuda.synchronize()
        reset_launch_counts()
        out = fn(*args)
        torch.cuda.synchronize()
        got = launch_counts()
        runs[label] = got
        if tuple(out.shape) != (1, 8, 7) or not torch.isfinite(out).all():
            raise AssertionError(f"bench {label}: actions {tuple(out.shape)} not finite")
        if any(got[k] != v for k, v in want.items()):
            raise AssertionError(f"bench {label}: launches {got}, expected {want}")
        note = ""
        if label == "bf16":
            kernels = profiled(lambda: fn(*args))
            n_k1 = sum(kernel_class(k.name) == "K1" for k in kernels)
            if kernels and n_k1 != BENCH_K1:
                raise AssertionError(f"bench bf16: torch.profiler counted {n_k1} K1 kernels")
            note = (f"; torch.profiler: {n_k1} K1 kernels of {len(kernels)}" if kernels
                    else "; torch.profiler recorded no device activity: not measured")
        log(f"[bench] {label} request of the bench's zero tree (built in {build_s:.1f} s, "
            f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB): launches {got}{note} "
            f"({card})")
        del fn, args, out
        gc.collect()
        torch.cuda.empty_cache()
    return runs


def bench_contract(stdout: str, stderr: str, labels: list) -> dict:
    """The bench's last stdout line (its only one), and a stderr line for
    each of `labels`."""
    lines = stdout.strip().splitlines()
    out = json.loads(lines[-1])
    if len(lines) != 1 or sorted(out) != ["metric", "unit", "value", "vs_baseline"]:
        raise AssertionError(f"bench stdout: {lines}")
    if out["metric"] != "action_chunk_latency" or out["unit"] != "s" or \
            not out["value"] > 0 or out["vs_baseline"] != round(0.109 / out["value"], 3):
        raise AssertionError(f"bench line: {out}")
    for label in labels:
        if not any(ln.startswith(f"# {label}:") for ln in stderr.splitlines()):
            raise AssertionError(f"bench: no '# {label}:' line in {stderr[-2000:]}")
    for ln in stderr.splitlines():
        if ln.startswith("# ") and "ms " in ln:
            log(f"[bench] {ln}")
    log(f"[bench] stdout: {json.dumps(out)}")
    return out


def launcher_run(card: str) -> dict:
    """Phase 21 (g): `scripts/finetune.sh` for 2 steps at random:7b, the
    Llama cut to CUT_LAYERS, with EXTRA_ARGS. Returns its launches."""
    n = CUT_LAYERS
    root = tempfile.mkdtemp(prefix="chip_smoke_launcher_")
    try:
        bindir = os.path.join(root, "bin")
        os.makedirs(bindir)
        shim = os.path.join(root, "cut_python.py")
        with open(shim, "w") as f:
            f.write(LAUNCHER_PYTHON.format(repo=BENCH_REPO))
        with open(os.path.join(bindir, "python"), "w") as f:
            f.write(f'#!/bin/bash\nexec "{sys.executable}" "{shim}" "$@"\n')
        os.chmod(os.path.join(bindir, "python"), 0o755)
        env = bench_env()
        env.update(PATH=bindir + os.pathsep + env.get("PATH", ""), DATA_ROOT_DIR="dummy",
                   EXTRA_ARGS="--device cuda --robot_platform libero --max_steps 2 "
                              "--save_freq 100 --merge_lora_during_training false "
                              "--wandb_log_freq 1")
        script = os.path.join(BENCH_REPO, "openvla_oft_tpu_torch", "scripts", "finetune.sh")
        stdout, _ = run_tool("finetune.sh (2 steps)", ["bash", script, "random:7b", "launcher",
                                                      "false", "0", os.path.join(root, "runs")],
                             600, env)
        steps = [ln for ln in stdout.splitlines() if ln.startswith("[step ")]
        for ln in steps + [ln for ln in stdout.splitlines() if ln.startswith("[finetune]")]:
            log(f"[launcher] {ln}")
        launches = json.loads(next(ln for ln in stdout.splitlines()
                                   if ln.startswith("[launcher-launches] ")).split(" ", 1)[1])
        want = {"K1": 4 * n, "K2": 2 * n, "K3": 2 * n, "K4": 0, "K5": 0, "K6": 0, "int8": 0}
        if "done: 2 micro-steps" not in stdout or any(launches[k] != v
                                                       for k, v in want.items()):
            raise AssertionError(f"finetune.sh: launches {launches}, expected {want}")
        log(f"[launcher] finetune.sh random:7b at {n} layers, B = 8, 2 steps: launches "
            f"{launches} ({card})")
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def tools_lines(stdout: str, stderr: str) -> tuple:
    """Phase 21 (a), (c) `bench --extra`; (b) `bench --quant int4` and
    `--quant int4 --int4-a8`; (d) `bench_components --flash --vit-fused`;
    (f) `bench_data`: their lines from the tools process, checked."""
    out, err = tool_sections(stdout), tool_sections(stderr)
    for ln in stderr.splitlines():
        if ln.startswith("# ") and ln.endswith(" s") and " took " in ln:
            log(f"[bench] {ln[2:]} (host clock, in the tools process)")
    headline = bench_contract(out["bench --extra"], err["bench --extra"], ["bf16", "int8"])
    extra = [ln for ln in err["bench --extra"].splitlines() if ln.startswith("# extra[")]
    for ln in extra:
        log(f"[bench] {ln}")
    if len(extra) != 4 or any("failed" in ln for ln in extra):
        raise AssertionError(f"bench --extra rows: {extra}")
    int4 = {label: bench_contract(out[label], err[label], [label])
            for label in ("int4", "int4 W4A8")}
    rows = {}
    for ln in out["components"].strip().splitlines():
        log(f"[bench-components] {ln}")
        label, ms, _ = ln.rsplit(None, 2)
        rows[label] = float(ms)
    if len(rows) != 11 or not all(ms > 0 for ms in rows.values()):
        raise AssertionError(f"bench_components rows: {rows}")
    for ln in out["data"].strip().splitlines():
        log(f"[bench-data] {ln}")
    line = next(ln for ln in out["data"].splitlines() if ln.startswith("pipeline["))
    fps = float(line.split("]:")[1].split()[0])
    if not fps > 0:
        raise AssertionError(f"bench_data: {line}")
    return headline, int4, rows, fps


def bench_deploy_clients(servers: dict) -> dict:
    """Phase 21 (e): `bench_deploy --no_server` against each running
    server {quant: (port, process, log path)}, which it stops after."""
    import io

    from openvla_oft_tpu_torch.scripts import bench_deploy

    outs = {}
    for quant, (port, proc, path) in servers.items():
        if proc.poll() is not None:
            raise AssertionError(f"the {quant} deploy server exited {proc.returncode}: "
                                 + Path(path).read_text()[-2000:])
        stdout = io.StringIO()
        with contextlib.redirect_stdout(stdout):
            summary = bench_deploy.main(["--no_server", "--port", str(port), "--model", "7b",
                                         "--quant", quant, "--n", "10",
                                         "--startup_timeout", "300"])
        proc.terminate()
        for ln in stdout.getvalue().strip().splitlines():
            log(f"[bench-deploy] {ln}")
        if summary["metric"] != "http_act_latency" or not summary["p50_ms"] > 0:
            raise AssertionError(f"bench_deploy {quant}: {summary}")
        outs[quant] = summary
    return outs


def bench_phase(card: str) -> dict:
    """Phase 21: the bench contract, its aids and the launchers. Returns
    the launches of the counted runs.

    What is not timed starts side by side: the tools process (it imports,
    then waits for the file `go`), bench_deploy's two servers and the
    launcher's run, while this process counts its requests. The HTTP
    clients run once the launcher is done, and the tools process's timed
    loops after the servers stop: each measurement has the card and the
    host to itself. The timed tools run in a process of their own: in this
    process, after the earlier phases' profiler windows, their rows took
    1.3-2.7 times as long."""
    from concurrent.futures import ThreadPoolExecutor

    from openvla_oft_tpu_torch.scripts import bench_deploy

    tmp = tempfile.mkdtemp(prefix="chip_smoke_bench_")
    go = os.path.join(tmp, "go")
    pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="launcher")
    outputs = [open(os.path.join(tmp, name), "w+") for name in ("stdout", "stderr")]
    t_tools = time.perf_counter()
    tools = subprocess.Popen([sys.executable, "-c", TOOLS_PROCESS, go], cwd=BENCH_REPO,
                             env=bench_env(), stdout=outputs[0], stderr=outputs[1], text=True)
    servers = {}
    try:
        def side_by_side():
            for quant in ("bf16", "int8"):
                args = bench_deploy.parse(["--model", "7b", "--quant", quant,
                                           "--port", str(free_port())])
                path = os.path.join(tmp, f"deploy_{quant}.log")
                with open(path, "w") as f:
                    servers[quant] = (args.port, subprocess.Popen(
                        bench_deploy.server_command(args), cwd=BENCH_REPO, env=bench_env(),
                        stdout=f, stderr=subprocess.STDOUT), path)
            launcher = pool.submit(launcher_run, card)
            runs = bench_requests(card)
            runs["launcher"] = launcher.result()
            return runs, bench_deploy_clients(servers)

        runs, http = phase("21 (a), (b), (e), (g) counted requests, bench_deploy, "
                           "finetune.sh", side_by_side)
        for _, proc, _ in servers.values():
            stop(proc)
        open(go, "w").close()

        def tools_run():
            rc = tools.wait(timeout=1500)
            for f in outputs:
                f.seek(0)
            stdout, stderr = (f.read() for f in outputs)
            log(f"[bench] the tools process (bench --extra, bench int4 and int4 W4A8, "
                f"bench_components, bench_data): exit {rc} in "
                f"{time.perf_counter() - t_tools:.1f} s from its start (host clock)")
            if rc != 0:
                log(stdout[-4000:])
                log(stderr[-8000:])
                raise AssertionError(f"the tools process exited {rc}")
            return tools_lines(stdout, stderr)

        headline, int4, rows, fps = phase("21 (a), (c), (b), (d), (f) bench --extra, bench "
                                          "int4, bench_components, bench_data", tools_run)
    finally:
        pool.shutdown()
        for proc in [tools] + [proc for _, proc, _ in servers.values()]:
            stop(proc)
        for f in outputs:
            f.close()
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[bench] headline {headline}, int4 {int4}, components {rows}, http "
        f"{http}, loader {fps:.1f} frames/s ({card})")
    return runs


def phase(name: str, fn, *args, **kw):
    """fn(*args, **kw), its host time logged and kept in PHASE_TIMES."""
    t0 = time.perf_counter()
    try:
        return fn(*args, **kw)
    finally:
        PHASE_TIMES[name] = time.perf_counter() - t0
        log(f"[phase-time] {name}: {PHASE_TIMES[name]:.1f} s (host clock)")


def tp_local_note(tp_local: dict, key: str) -> dict:
    """A kernel's times at tp = 2's local shapes (`tp_local_shapes`)."""
    return {name: {k: row[key][k] for k in ("ms", "bound_ms", "bound_by", "library_ms",
                                             "plain_ms")}
            for name, row in tp_local.items() if key in row}


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

    from concurrent.futures import ThreadPoolExecutor

    from openvla_oft_tpu_torch.scripts import exp_fwd_parts, exp_k4_parts

    t0 = time.perf_counter()
    pool = ThreadPoolExecutor(max_workers=2, thread_name_prefix="parts-build")
    parts = start_parts_builds(pool)
    lib_path = _build.build()
    log(f"[build] {lib_path.relative_to(_build.PKG_DIR.parent)} ready in "
        f"{time.perf_counter() - t0:.1f} s (K4's and K1's parts libraries building beside it)")
    log((lib_path.parent / "build.log").read_text().strip())
    wgmma = wgmma_build_report(lib_path)

    cfg, _, tcfg, batch = training_setup()
    s_train = training_length(cfg, batch, tcfg)
    log(f"[bwd] training layout: S = {s_train} (text bucket + "
        f"{cfg.num_images_in_input} x {cfg.vision_configs[0].num_patches} patches + proprio)")
    a_cfg, _, a_tcfg, a_batch = training_setup(OBJECTIVE_RUNS["aloha_film"])
    s_aloha = training_length(a_cfg, a_batch, a_tcfg)
    log(f"[bwd] ALOHA training layout: S = {s_aloha} (text bucket "
        f"{a_batch['input_ids'].shape[1]} + {a_cfg.num_images_in_input} x "
        f"{a_cfg.vision_configs[0].num_patches} patches + proprio), batch "
        f"{a_batch['input_ids'].shape[0]}")
    checks = phase("3 kernel check", kernel_check, card, s_train)
    tiny_launches = phase("3c auto", tiny_auto_request, card)
    k4 = phase("3 K4 check", ln_matmul_check, card)
    phase("3a K4 parts", k4_parts_phase, card, parts[exp_k4_parts])
    phase("3b K1 parts", k1_parts_phase, card, parts[exp_fwd_parts])
    pool.shutdown()
    t_serve = time.perf_counter()

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
    joint_bf16 = phase("5 joint ViT pair bf16", joint_vit_bf16, policy, observations[0], card)
    jpeg_check(card)
    staged_l1 = staged_serving(policy, card, rng,
                               {"K1": n_layers - 1, "K4": 0, "K5": 0, "K6": 0, "int8": 0})
    del policy
    gc.collect()
    torch.cuda.empty_cache()
    PHASE_TIMES["4-5 bf16 serving (with 8f's jpeg check and staged L1)"] = \
        time.perf_counter() - t_serve
    log(f"[phase-time] 4-5 bf16 serving: {time.perf_counter() - t_serve:.1f} s (host clock)")

    aloha = phase("5a ALOHA", aloha_serving, card, rng)
    aloha_k4 = aloha[True]["launches"]

    int4 = phase("6 int4 check", int4_check, card)
    int4_launches = phase("7-8 int4 serving", int4_serving, card, rng, observations[0],
                          bf16_hidden)
    gc.collect()
    torch.cuda.empty_cache()
    probe = phase("8a probe", probe_phase, card)
    int8_launches = phase("8b int8", int8_serving, card, rng, observations[0], bf16_hidden)
    with cut_serving_flagship():
        diffusion = phase("8c diffusion", diffusion_serving, card, rng)
        discrete = phase("8d discrete", discrete_serving, card, rng)
    checkpoint = phase("8e checkpoint", checkpoint_serving, card, rng)

    bwd = phase("9 backward check", backward_check, card, s_train, s_aloha)
    with cut_flagship():
        # Phase 10's run logs every step's metrics (--wandb_log_freq 1) for
        # phase 19, and is phase 18 (a)'s run without a mesh.
        t10 = time.perf_counter()
        state, train_launches, train_info = train(card, CUT_LAYERS,
                                                  TRAIN_FLAGS + ["--wandb_log_freq", "1"],
                                                  keep_first=True)
        plain_run = reference_run(state, train_info, {})
        PHASE_TIMES["10 training"] = time.perf_counter() - t10
        log(f"[phase-time] 10 training: {PHASE_TIMES['10 training']:.1f} s (host clock)")
        phase("11 step profile", profile_step, state, card)
        phase("12 training parity", training_parity, state, card)
        del state
        gc.collect()
        torch.cuda.empty_cache()
        objectives = phase("11b objectives", objectives_phase, card, CUT_LAYERS)
        episodes = phase("13 episodes", episode_phase, card, CUT_LAYERS,
                         train_info["step_times"])
        qlora = phase("14 (a)-(b) QLoRA", qlora_phase, card, CUT_LAYERS, train_info["peak"])
        remat = phase("14 (c) remat", remat_phase, card, CUT_LAYERS)
        full = phase("15 full training", full_training_phase, card, CUT_LAYERS)
    phase14 = [run for name, run in qlora.items() if name != "int4 times"] + list(remat.values())
    phi, phi_k5 = phase("16 Phi-2", phi_phase, card, rng)
    clients = phase("17 clients", eval_clients_phase, card, rng)
    multigpu = phase("18 (a), (d) one-rank mesh", one_rank_training, card, s_train,
                     plain_run, train_info)
    with cut_serving_flagship():
        tp_serve, tp_quant, tp_attention, tp_local = phase("18 (b), (c) tp = 2", tp_serving,
                                                           card, rng, s_train)
    run_tools = phase("19 run tools", run_tools_phase, card, train_info["metrics_jsonl"])
    phase("18 (e) 7B memory audit", audit_phase, card)
    files = files_phase(card, CUT_LAYERS)
    bench_runs = bench_phase(card)

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
    # Phase 18 (c)'s variants on both ranks, (d)'s QLoRA runs on the
    # one-rank mesh and phase 19's verify runs are main-path runs too.
    extra_runs = [*tp_quant.values(), *run_tools.values(),
                  *(run for name, run in multigpu.items() if name.startswith("1-rank QLoRA"))]
    k4_launches = (aloha_k4["K4"] + sum(run["K4"] for run in phi.values())
                   + sum(run["K4"] for run in clients.values())
                   + sum(run["K4"] for run in extra_runs))
    w4a16, w4a8 = int4_launches["W4A16"], int4_launches["W4A8"]
    k1_launches = (serve_launches["K1"] + staged_l1["K1"] + aloha[True]["launches"]["K1"]
                   + sum(row["launches"]["K1"] for row in joint_bf16.values())
                   + aloha[False]["launches"]["K1"] + w4a16["K1"] + w4a8["K1"]
                   + sum(run["K1"] for run in int8_launches.values())
                   + sum(run["K1"] for run in diffusion.values())
                   + sum(run["K1"] for run in discrete.values())
                   + sum(run["K1"] for run in checkpoint.values()) + train_launches["K1"]
                   + sum(run["K1"] for run in objectives.values()) + episodes["K1"]
                   + sum(run["K1"] for run in phase14)
                   + sum(run["K1"] for run in full.values())
                   + sum(run["K1"] for run in phi.values())
                   + sum(run["K1"] for run in clients.values())
                   + multigpu["1-rank"]["K1"]
                   + sum(run["K1"] for run in tp_serve.values())
                   + sum(run["K1"] for run in extra_runs)
                   + sum(run["K1"] for run in files.values())
                   + sum(run["K1"] for run in bench_runs.values()))
    # K2 and K3 launch in the training runs: phase 10, phase 11b's three,
    # the runs from phase 8e's checkpoint dir (11b (d), 14 (d), (e)), phase
    # 13's, 14's, 15's, 16's, 18 (a)'s and 18 (d)'s two, and 20 (c)'s.
    bwd_runs = [train_launches, checkpoint["checkpoint training"], *objectives.values(),
                episodes, *phase14, *full.values(), *phi.values(),
                *(run for name, run in multigpu.items() if name != "tp-wrapper"),
                *(checkpoint[k] for k in ("run-management", "resume", "preempt",
                                          "preempt-resume")), files["synthetic"],
                bench_runs["launcher"]]
    k2_launches = sum(run["K2"] for run in bwd_runs)
    k3_launches = sum(run["K3"] for run in bwd_runs)
    bwd_others = {n: {"ms_dq": c["ms_dq"], "ms_dkv": c["ms_dkv"], "library_ms": c["library_ms"],
                      "bound_dq_ms": c["bound_dq"][0], "bound_dkv_ms": c["bound_dkv"][0],
                      "timing": c["timing"]}
                  for n, c in bwd_cases.items() if n != "training"}
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
                                  for n, c in checks.items() if n != "libero_prefill"},
                     tp=tp_note(multigpu, tp_serve, tp_attention, "K1")),
        kernel_entry("flash_attention_dq", "flash_attention_bwd.cu",
                     "openvla_oft_tpu/ops/flash_attention.py:181", k2_launches,
                     max(c["dq_err"] for c in bwd_cases.values()), tr["ms_dq"],
                     tr["plain_dq"], *tr["bound_dq"], tr["library_ms"],
                     library_call="SDPA's backward with the boolean OFT mask (dq, dk, dv)",
                     plan=tr["plan"], hgmma=wgmma["K2"], timing=tr["timing"],
                     events_ms=tr["events_dq"], library_events_ms=tr["library_events_ms"],
                     other_cases=bwd_others, tp=tp_note(multigpu, tp_serve, tp_attention, "K2")),
        kernel_entry("flash_attention_dkv", "flash_attention_bwd.cu",
                     "openvla_oft_tpu/ops/flash_attention.py:207", k3_launches,
                     max(c["dkv_err"] for c in bwd_cases.values()), tr["ms_dkv"],
                     tr["plain_dkv"], *tr["bound_dkv"], tr["library_ms"],
                     library_call="SDPA's backward with the boolean OFT mask (dq, dk, dv)",
                     plan=tr["plan"], hgmma=wgmma["K3"], timing=tr["timing"],
                     events_ms=tr["events_dkv"], library_events_ms=tr["library_events_ms"],
                     stats_pass_ms=bwd["stats"]["ms"], other_cases=bwd_others,
                     tp=tp_note(multigpu, tp_serve, tp_attention, "K3")),
        kernel_entry("ln_matmul", "ln_matmul.cu", "openvla_oft_tpu/ops/vit_fused.py:47",
                     k4_launches, max(c["max_abs_err"] for c in k4.values()),
                     fc1["dev_ms"], fc1["plain_ms"], fc1["bound_ms"], fc1["bound_by"],
                     fc1["dev_lib"], library_call="torch.matmul on the product alone",
                     clip_336={name: {"ms": k4[name]["dev_ms"], "bound_ms": k4[name]["bound_ms"],
                                      "bound_by": k4[name]["bound_by"],
                                      "library_ms": k4[name]["dev_lib"],
                                      "plain_ms": k4[name]["plain_ms"]}
                               for name, *_ in K4_CLIP},
                     unfused_ms=fc1["unfused_ms"], plan=list(fc1["plan"]), hgmma=wgmma["K4"],
                     timing=fc1["timing"], events_ms=fc1["ms"],
                     library_events_ms=fc1["library_ms"],
                     tp2_local=tp_local_note(tp_local, "K4")),
        kernel_entry("int4_matmul", "int4_w4a16.cu", "openvla_oft_tpu/ops/int4_matmul.py:43",
                     w4a16["K5"] + diffusion["int4 W4A16"]["K5"]
                     + discrete["AR int4 W4A16"]["K5"] + checkpoint["checkpoint int4 W4A16"]["K5"]
                     + qlora["QLoRA int4 B=1"]["K5"] + sum(run["K5"] for run in phi.values())
                     + sum(run["K5"] for run in extra_runs)
                     + sum(run["K5"] for run in bench_runs.values()),
                     max([c["err5"] for c in int4.values()]
                         + [c["max_abs_err"] for c in phi_k5.values()]), wqkv["dev5"],
                     wqkv["plain5"], *wqkv["bound5"], wqkv["dev_lib5"],
                     also_replaces="openvla_oft_tpu/ops/int4_matmul.py:199",
                     plan=list(wqkv["plan5"]), hgmma=wgmma["K5"], timing=wqkv["timing"],
                     events_ms=wqkv["ms5"], library_events_ms=wqkv["lib5"], phi_2=phi_k5,
                     tp2_local=tp_local_note(tp_local, "K5")),
        kernel_entry("int4_matmul_a8", "int4_w4a8.cu", "openvla_oft_tpu/ops/int4_matmul.py:432",
                     w4a8["K6"] + sum(run["K6"] for run in extra_runs)
                     + sum(run["K6"] for run in bench_runs.values()),
                     max(c["err6"] for c in int4.values()), wqkv["dev6"],
                     wqkv["plain6"], *wqkv["bound6"], wqkv["dev_lib6"],
                     also_replaces="openvla_oft_tpu/ops/int4_matmul.py:527",
                     library_call="torch._int_mm on the unpacked int8 weight, no scales",
                     plan=list(wqkv["plan6"]), igmma=wgmma["K6"], timing=wqkv["timing6"],
                     events_ms=wqkv["ms6"], library_events_ms=wqkv["lib6"],
                     tp2_local=tp_local_note(tp_local, "K6")),
        kernel_entry("int4_probe", "int4_probe.cu", "vla_scripts/exp_int4_probe.py:53",
                     probe["launches"], probe["max_abs_err"], probe["ms"], probe["plain_ms"],
                     probe["bound_ms"], probe["bound_by"], probe["library_ms"],
                     library_call="torch.matmul on the dequantized bf16 weight",
                     hgmma=wgmma["probe"], timing="device time (torch.profiler)",
                     shapes_t112=probe["modes"])]
    log(f"[launches] bf16 serving run: {serve_launches}; staged L1 run (4 requests: 2, one "
        f"over /act and its in-process twin): {staged_l1}; ALOHA serving runs: vit_fused "
        f"{aloha_k4}, unfused {aloha[False]['launches']}; int4 serving runs: W4A16 {w4a16}, "
        f"W4A8 {w4a8}; probe run: {probe['launches']}; training run: {train_launches}; "
        f"TINY_LLAMA request under auto: {tiny_launches}")
    log(f"[int8] launches of the int8 serving runs (3 requests each): load_in_8bit "
        f"{int8_launches['dynamic']}, with static scales {int8_launches['static']}, "
        f"load_vision_in_8bit {int8_launches['vision']}; one counted request each with the "
        f"seeded per-backbone and joint int8 ViT pair: "
        f"{int8_launches['joint-vit per-backbone']}, {int8_launches['joint-vit joint']}")
    log(f"[joint-vit] one counted bf16 request each with the per-backbone and the joint "
        f"ViT pair: {joint_bf16['per-backbone']['launches']}, "
        f"{joint_bf16['joint']['launches']}")
    log(f"[diffusion] launches of the diffusion runs: bf16 (3 requests) "
        f"{diffusion['bf16']}, staged bf16 (4 requests) {diffusion['staged bf16']}, int4 "
        f"W4A16 (2 requests) {diffusion['int4 W4A16']}")
    log(f"[discrete] launches of the discrete runs: parallel bf16 (3 requests) "
        f"{discrete['parallel bf16']}, staged bf16 (4 requests) {discrete['staged bf16']}, AR bf16 (3 x 7 and 2 x 56 tokens) {discrete['AR bf16']}, "
        f"AR int4 W4A16 (2 x 7) {discrete['AR int4 W4A16']}, AR int8 (1 x 7) "
        f"{discrete['AR int8']}")
    log(f"[checkpoint] launches of the checkpoint runs: bf16 (3 requests) "
        f"{checkpoint['checkpoint bf16']}, int4 W4A16 (1 request) "
        f"{checkpoint['checkpoint int4 W4A16']}, fine-tuning from the dir (3 steps) "
        f"{checkpoint['checkpoint training']}")
    log(f"[objectives] launches of phase 11b's runs (3 steps each): " + ", ".join(
        f"{name} {run}" for name, run in objectives.items()))
    log(f"[episodes] launches of phase 13's run (4 steps and its validation): {episodes}")
    log(f"[qlora] launches of phase 14's QLoRA runs: " + ", ".join(
        f"{name} {run}" for name, run in qlora.items() if name != "int4 times"))
    log(f"[remat] launches of phase 14's remat runs (3 losses and backwards each): " + ", ".join(
        f"{name} {run}" for name, run in remat.items()))
    log(f"[run-management] launches of phase 14's runs from the dir: " + ", ".join(
        f"{name} {checkpoint[name]}" for name in ("run-management", "resume", "preempt",
                                                  "preempt-resume")))
    log(f"[full-train] launches of phase 15's runs (3 steps each; generate.py's one "
        f"prompt): " + ", ".join(
            f"{name} {run}" for name, run in full.items()))
    log(f"[phi] launches of phase 16's runs (Phi-2: 2 counted requests each, 3 training "
        f"steps, 3 pretrain steps, one generate prompt; the mixture-fed flagship, 3 steps): "
        + ", ".join(f"{name} {run}" for name, run in phi.items()))
    log(f"[clients] launches of phase 17's clients: " + ", ".join(
        f"{name} {run}" for name, run in clients.items()))
    log(f"[multigpu] launches of phase 18's runs (3 CLI steps each at {CUT_LAYERS} layers; "
        f"{TP_REQUESTS} tp = 2 requests a rank, {TP_VARIANT_REQUESTS} a variant): " + ", ".join(
            f"{name} {run}" for name, run in {**multigpu, **tp_serve, **tp_quant}.items())
        + "; the tp = 2 attention checks: " + ", ".join(
            f"{name} {run}" for name, run in tp_attention.items()))
    log(f"[run-tools] launches of phase 19's verify runs ({VERIFY_ITERATIONS} calls each): "
        + ", ".join(f"{name} {run}" for name, run in run_tools.items()))
    log(f"[files] launches of phase 20's runs (generate.py on 2 images, 3 steps on the "
        f"synthetic set, the round trip's 2 chunks): " + ", ".join(
            f"{name} {run}" for name, run in files.items()))
    log(f"[bench] launches of phase 21's runs (one counted request of the bench's tree a "
        f"config; the launcher's 2 steps at {CUT_LAYERS} layers): " + ", ".join(
            f"{name} {run}" for name, run in bench_runs.items()))
    log("[phase-time] all phases: " + ", ".join(f"{name} {t:.1f} s"
                                                for name, t in PHASE_TIMES.items())
        + f"; the run so far {time.perf_counter() - T_START:.1f} s (host clock)")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
