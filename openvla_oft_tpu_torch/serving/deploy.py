"""Serve a port policy over HTTP /act (the wire contract of `vla_scripts/deploy.py`).

`build_server(policy)` wraps `OpenVLAPolicy.predict_action_from_frames` as the
`predict(observation, instruction)` callable that `ActionServer` takes (the
port's copy of `openvla_oft_tpu/serving/server.py`). The observation carries
uint8 frames under "full_image" plus any "wrist*" keys, and the proprio state
under "state".

    python -m openvla_oft_tpu_torch.serving.deploy --random-weights --port 8777
    python -m openvla_oft_tpu_torch.serving.deploy --random-weights --load-in-4bit [--int4-a8]
    python -m openvla_oft_tpu_torch.serving.deploy --random-weights --load-in-8bit
    python -m openvla_oft_tpu_torch.serving.deploy --random-weights --load-vision-in-8bit
    python -m openvla_oft_tpu_torch.serving.deploy --random-weights --platform aloha [--vit-fused]

Loading a checkpoint is not ported yet, so the CLI serves the flagship model
(DINOv2+SigLIP, Llama-2-7B) with seeded random weights and placeholder
[-1, 1] statistics, at one of the reference's two deployments: LIBERO (2
images, an 8 x 7 chunk) or ALOHA (3 images with FiLM, a 25 x 14 chunk;
the reference's `vla_scripts/deploy.py` settings). `--load-in-4bit` packs
every LLM linear to int4 (the reference's bitsandbytes `load_in_4bit`);
`--int4-a8` serves it W4A8 instead of W4A16. `--load-in-8bit` serves the
LLM, the ViTs and the projector in int8 (`load_in_8bit`: int8 weights and
per-token int8 activations through `torch._int_mm`), `--load-vision-in-8bit`
only the ViTs and the projector; at most one of the three quant flags. `--vit-fused` runs the ViTs'
folded LN + qkv and LN + fc1 as one kernel K4 launch each. Before it binds,
the CLI runs one synthetic predict at the deployment's geometry (`warmup`,
as the reference does); `--no-warmup` skips it.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np

from openvla_oft_tpu_torch.serving.server import ActionServer, get_action_from_server

__all__ = ["CLIENT_FRAME_HW", "DEPLOYMENTS", "build_server", "flagship_policy",
           "get_action_from_server", "observation_frames", "placeholder_norm_stats",
           "synthetic_observation", "warmup"]


def observation_frames(observation: dict, num_images: int) -> np.ndarray:
    """(N, H, W, 3) uint8: "full_image", then the wrist cameras in key order."""
    images = [observation["full_image"]]
    if num_images > 1:
        images += [observation[k] for k in observation
                   if "wrist" in k or "camera_gripper_image" in k]
    if len(images) < num_images:
        raise ValueError(f"observation has {len(images)} images, the model takes "
                         f"{num_images}")
    return np.stack([np.asarray(im, np.uint8) for im in images[:num_images]])


# The raw frame size each deployment's client sends: LIBERO's 256 x 256
# renders, ALOHA's 224 x 224 camera frames (run_aloha_eval.py:76-86).
CLIENT_FRAME_HW = {"libero": (256, 256), "aloha": (224, 224)}


def synthetic_observation(policy) -> dict:
    """A zero observation at the policy's own geometry: its number of images
    at its platform's client frame size, and its proprio dim."""
    h, w = CLIENT_FRAME_HW.get(policy.platform.name, (256, 256))
    obs = {"full_image": np.zeros((h, w, 3), np.uint8)}
    for i in range(policy.cfg.num_images_in_input - 1):
        obs[f"wrist_image_{i}"] = np.zeros((h, w, 3), np.uint8)
    obs["state"] = np.zeros(policy.platform.proprio_dim, np.float32)
    obs["instruction"] = "do the task"
    return obs


def warmup(server: ActionServer, policy) -> float:
    """One synthetic predict at `policy`'s geometry through the server's
    /act callable, before the server binds (the reference's
    `OpenVLAServer._warmup`, `vla_scripts/deploy.py:102-121`), so that the
    first client request does not pay the cold path: kernel builds, library
    handles, allocator growth. Returns its seconds on the host clock."""
    obs = synthetic_observation(policy)
    t0 = time.perf_counter()
    server.predict(obs, obs["instruction"])
    return time.perf_counter() - t0


def build_server(policy, unnorm_key: Optional[str] = None) -> ActionServer:
    """An ActionServer whose /act runs `policy.predict_action_from_frames`."""
    num_images = policy.cfg.num_images_in_input

    def predict(observation: dict, instruction: str) -> np.ndarray:
        state = observation.get("state")
        return policy.predict_action_from_frames(
            observation_frames(observation, num_images), instruction,
            proprio=None if state is None else np.asarray(state, np.float32),
            unnorm_key=unnorm_key)

    return ActionServer(predict)


def placeholder_norm_stats(platform) -> dict:
    """[-1, 1] action and proprio statistics for a random-weight policy."""
    d, pd = platform.action_dim, platform.proprio_dim
    return {"random": {
        "action": {"q01": [-1.0] * d, "q99": [1.0] * d, "min": [-1.0] * d,
                   "max": [1.0] * d, "mask": [True] * (d - 1) + [False]},
        "proprio": {"q01": [-1.0] * pd, "q99": [1.0] * pd,
                    "min": [-1.0] * pd, "max": [1.0] * pd},
    }}


# The reference loader's quantization rule: kernels with d_in >= 1024.
QUANT_MIN_DIM = 1024


def serving_params(params: dict, load_in_4bit: bool = False, load_in_8bit: bool = False,
                   load_vision_in_8bit: bool = False) -> dict:
    """Fuse (and quantize) a param tree for serving, as the reference
    loader does (`experiments/robot/openvla_utils.py:181-194, 230-249`):
    wqkv/gate_up, and the ViT folds. Consumes `params`.

    - The LLM's RMSNorm scales fold into wqkv/gate_up only when neither
      `load_in_8bit` nor `load_in_4bit` is set (a fold would coarsen the
      quantization grids); the ViTs' LayerNorm affines fold only when neither
      8-bit flag is set (an int8 ViT keeps its norms, so K4's gate stays
      shut), their LayerScales always.
    - `load_in_8bit`: the LLM, the ViTs and the projector to int8 W8A8
      (`quantize_tree_lowmem`: every kernel with d_in >= QUANT_MIN_DIM, lm_head
      and the proprio projector excepted). The LLM is quantized before its
      projections are concatenated, which gives the same int8 tree bit for
      bit (each output column quantizes on its own) without a bf16 copy of
      wqkv and gate_up: the build's peak is the bf16 tree plus one int8 leaf
      and one layer's fp32 temporaries.
    - `load_vision_in_8bit`: the ViTs and the projector to int8, the LLM
      bf16 (with its folds).
    - `load_in_4bit`: every LLM linear with d_in >= QUANT_MIN_DIM packed to
      int4; the ViTs and the projector stay bf16.

    At most one of the three flags may be set (as in the reference's eval
    config, `experiments/robot/libero/run_libero_eval.py:137`).
    """
    from openvla_oft_tpu_torch.models.llama import fuse_inference_weights
    from openvla_oft_tpu_torch.models.vit import fuse_vit_inference_weights
    from openvla_oft_tpu_torch.ops.quant import quantize_tree_lowmem

    if load_in_4bit + load_in_8bit + load_vision_in_8bit > 1:
        raise ValueError("load_in_4bit, load_in_8bit and load_vision_in_8bit exclude "
                         "each other")
    vit_int8 = load_in_8bit or load_vision_in_8bit
    if load_in_8bit:
        params["llm"] = quantize_tree_lowmem(params["llm"], min_dim=QUANT_MIN_DIM, bits=8)
    params["llm"] = fuse_inference_weights(params["llm"],
                                           fold_norms=not (load_in_8bit or load_in_4bit))
    params["vision_backbone"] = {
        name: fuse_vit_inference_weights(v, fold_norms=not vit_int8)
        for name, v in params["vision_backbone"].items()}
    if load_in_4bit:
        params["llm"] = quantize_tree_lowmem(params["llm"], min_dim=QUANT_MIN_DIM, bits=4)
    if vit_int8:
        for mod in ("vision_backbone", "projector"):
            params[mod] = quantize_tree_lowmem(params[mod], min_dim=QUANT_MIN_DIM, bits=8)
    return params


# The reference's two deployments of the flagship model: (platform, images,
# FiLM). ALOHA is `vla_scripts/deploy.py:30-31` (use_film, 3 images).
DEPLOYMENTS = {"libero": ("libero", 2, False), "aloha": ("aloha", 3, True)}
# (vision backbone id, LLM id) of the flagship.
FLAGSHIP_IDS = ("dinosiglip-vit-so-224px", "llama2-7b-pure")


def flagship_policy(device, seed: int = 0, prompt_bucket: int = 48,
                    load_in_4bit: bool = False, int4_a8: bool = False,
                    platform: str = "libero", vit_fused: bool = False,
                    load_in_8bit: bool = False, load_vision_in_8bit: bool = False,
                    head: str = "l1", num_diffusion_steps: int = 50,
                    use_film: Optional[bool] = None):
    """The flagship serving policy with seeded random bf16 weights, fused for
    serving as the JAX bench does (wqkv/gate_up and ViT folds), at the
    `platform` deployment ("libero" or "aloha", `DEPLOYMENTS`). With
    `load_in_4bit` the LLM is int4 (`serving_params`), served W4A16, or W4A8
    with `int4_a8`; with `load_in_8bit` the LLM, the ViTs and the projector
    are int8 (W8A8), with `load_vision_in_8bit` the ViTs and the projector
    only; `vit_fused` runs the ViTs' folded LN + matmuls as kernel K4 (an
    int8 ViT has none). head "diffusion" gives the DDIM head with
    `num_diffusion_steps` steps (the prefix-KV loop, noise from a generator
    seeded with `seed`); its noise predictor and noisy-action projector stay
    bf16 under every quant flag, as `vla_scripts/bench_diffusion.py` keeps
    them. `use_film` overrides the deployment's FiLM setting."""
    import torch

    from openvla_oft_tpu_torch.bridge import init_params
    from openvla_oft_tpu_torch.config import OpenVLAConfig
    from openvla_oft_tpu_torch.constants import get_platform
    from openvla_oft_tpu_torch.policy import OpenVLAPolicy

    if int4_a8 and not load_in_4bit:
        raise ValueError("int4_a8 needs load_in_4bit")
    if platform not in DEPLOYMENTS:
        raise ValueError(f"platform must be one of {sorted(DEPLOYMENTS)}, got {platform!r}")
    name, n_images, film = DEPLOYMENTS[platform]
    use_film = film if use_film is None else use_film
    spec = get_platform(name)
    cfg = OpenVLAConfig(vision_backbone_id=FLAGSHIP_IDS[0], llm_backbone_id=FLAGSHIP_IDS[1],
                        num_images_in_input=n_images, use_film=use_film)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = serving_params(init_params(cfg, spec, gen, device=device, dtype=torch.bfloat16,
                                        head=head),
                            load_in_4bit=load_in_4bit, load_in_8bit=load_in_8bit,
                            load_vision_in_8bit=load_vision_in_8bit)
    return OpenVLAPolicy(cfg=cfg, platform=spec, params=params,
                         norm_stats=placeholder_norm_stats(spec), prompt_bucket=prompt_bucket,
                         int4_a8=int4_a8, vit_fused=vit_fused, head=head,
                         num_diffusion_steps=num_diffusion_steps,
                         generator=torch.Generator(device=device).manual_seed(seed)
                         if head == "diffusion" else None)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--random-weights", action="store_true",
                        help="serve seeded random weights (required: checkpoint "
                             "loading is not ported yet)")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8777)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--load-in-4bit", action="store_true",
                        help="pack every LLM linear to int4 (W4A16, kernel K5)")
    parser.add_argument("--int4-a8", action="store_true",
                        help="with --load-in-4bit: W4A8 (per-token int8 activations, "
                             "kernel K6)")
    parser.add_argument("--load-in-8bit", action="store_true",
                        help="the LLM, the ViTs and the projector in int8 (W8A8, "
                             "torch._int_mm)")
    parser.add_argument("--load-vision-in-8bit", action="store_true",
                        help="the ViTs and the projector in int8, the LLM in bf16")
    parser.add_argument("--platform", choices=sorted(DEPLOYMENTS), default="libero",
                        help="libero: 2 images, 8 x 7 chunk; aloha: 3 images, FiLM, "
                             "25 x 14 chunk")
    parser.add_argument("--vit-fused", action="store_true",
                        help="the ViTs' LN + qkv and LN + fc1 as one kernel K4 launch each")
    parser.add_argument("--no-warmup", action="store_true",
                        help="bind at once, without one synthetic predict first (the "
                             "reference's DeployConfig.warmup = False)")
    args = parser.parse_args(argv)
    if not args.random_weights:
        parser.error("checkpoint loading is not ported yet; pass --random-weights")
    if args.int4_a8 and not args.load_in_4bit:
        parser.error("--int4-a8 needs --load-in-4bit")
    if args.load_in_4bit + args.load_in_8bit + args.load_vision_in_8bit > 1:
        parser.error("at most one of --load-in-4bit, --load-in-8bit and "
                     "--load-vision-in-8bit")
    policy = flagship_policy(args.device, seed=args.seed, load_in_4bit=args.load_in_4bit,
                             int4_a8=args.int4_a8, platform=args.platform,
                             vit_fused=args.vit_fused, load_in_8bit=args.load_in_8bit,
                             load_vision_in_8bit=args.load_vision_in_8bit)
    server = build_server(policy)
    if not args.no_warmup:
        print(f"[deploy] warmup run: {warmup(server, policy):.1f}s")
    print(f"[deploy] serving /act on {args.host}:{args.port}")
    server.run(args.host, args.port)


if __name__ == "__main__":
    main()
