"""Serve a policy over HTTP /act (the port of `vla_scripts/deploy.py`).

    python -m openvla_oft_tpu_torch.serving.deploy --pretrained-checkpoint DIR \
        --unnorm-key KEY --num-images-in-input 2 [--device-preprocess]
    python -m openvla_oft_tpu_torch.serving.deploy --random-weights --port 8777
    python -m openvla_oft_tpu_torch.serving.deploy --random-weights --load-in-4bit [--int4-a8]
    python -m openvla_oft_tpu_torch.serving.deploy --random-weights --load-in-8bit
    python -m openvla_oft_tpu_torch.serving.deploy --random-weights --load-vision-in-8bit
    python -m openvla_oft_tpu_torch.serving.deploy --random-weights --platform aloha [--vit-fused]

The flags are the fields of `DeployConfig` (`utils/cli.py::parse_args`:
`--name value`, a bare `--name` for a true bool, `--no-name` for a false
one): the reference's `DeployConfig` fields and the port's own.

`--pretrained-checkpoint DIR` serves an HF-format checkpoint dir through
`OpenVLAServer` (the reference's): `serving/openvla_utils.py::get_vla`
loads it onto `--device` (cuda by default) in bf16, fused and quantized
(`--load-in-8bit`, `--load-in-4bit` or `--load-vision-in-8bit`), with its
tokenizer and statistics, and the per-module `action_head--*.pt`,
`proprio_projector--*.pt` (and `noisy_action_projector--*.pt`) files beside
it; `--unnorm-key` must name one of its statistics. `/act` runs
`get_vla_action`: by default the staged path of the reference's eval
conditioning (the JPEG round trip, resize and crop on the device), for the
L1, diffusion (`--no-use-l1-regression --use-diffusion`) and discrete
(`--no-use-l1-regression`) heads; with `--device-preprocess`, the L1 head
takes the one-pass path (no JPEG round trip).

`--random-weights` serves the flagship model (DINOv2+SigLIP, Llama-2-7B)
with seeded random weights and placeholder [-1, 1] statistics, at one of
the reference's two deployments (`--platform`): LIBERO (2 images, an 8 x 7
chunk) or ALOHA (3 images with FiLM, a 25 x 14 chunk). `--load-in-4bit`
packs every LLM linear to int4 (the reference's bitsandbytes
`load_in_4bit`); `--int4-a8` serves it W4A8 instead of W4A16.
`--load-in-8bit` serves the LLM, the ViTs and the projector in int8 (int8
weights and per-token int8 activations through `torch._int_mm`),
`--load-vision-in-8bit` only the ViTs and the projector; at most one of
the three quant flags. `--vit-fused` runs the ViTs' folded LN + qkv and
LN + fc1 as one kernel K4 launch each. Before it binds, the CLI runs one
synthetic predict at the deployment's geometry (`warmup`, as the reference
does); `--no-warmup` skips it.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

from openvla_oft_tpu_torch.serving.server import ActionServer, get_action_from_server

__all__ = ["CLIENT_FRAME_HW", "DEPLOYMENTS", "DeployConfig", "OpenVLAServer", "build_server",
           "flagship_policy", "get_action_from_server", "observation_frames",
           "placeholder_norm_stats", "synthetic_observation", "warmup"]


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


def synthetic_observation(policy, hw: Optional[Tuple[int, int]] = None) -> dict:
    """A zero observation at the policy's own geometry: its number of images
    at frames of `hw` (None: its platform's client frame size), and its
    proprio dim."""
    h, w = hw or CLIENT_FRAME_HW.get(policy.platform.name, (256, 256))
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
                   load_vision_in_8bit: bool = False, joint_vit: bool = False,
                   joint_vit_int8: bool = False, vision_configs=None) -> dict:
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
      int4, lm_head excepted; the ViTs and the projector stay bf16.

    - `joint_vit` (a bf16 vision) or `joint_vit_int8` (an int8 one): the
      ViT pair as one joint tree (`models/vit_joint.py`; `vision_configs`,
      the two backbones' configs, must be given), as the JAX loader builds it
      (`experiments/robot/openvla_utils.py:205-220`): never under
      `load_in_4bit`, nor for a tree with FiLM projectors, nor for one
      backbone. int8 builds it from the unfolded trees and quantizes the
      joint tree after the build (`quantize_joint_vit`), in place of the
      per-backbone quantization. The build's peak is the per-backbone tree
      beside the joint one.

    At most one of the three quantization flags may be set (as in the
    reference's eval config, `experiments/robot/libero/run_libero_eval.py:137`).
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
    joint = (joint_vit_int8 if vit_int8 else joint_vit) and not load_in_4bit \
        and "film" not in params and len(params["vision_backbone"]) == 2
    if joint:
        from openvla_oft_tpu_torch.models.vit_joint import joint_vision

        if vision_configs is None:
            raise ValueError("the joint ViT pair needs the backbones' vision_configs")
        params["vision_backbone"] = joint_vision(params["vision_backbone"], vision_configs,
                                                 vit_int8)
    if load_in_4bit:
        params["llm"] = quantize_tree_lowmem(params["llm"], min_dim=QUANT_MIN_DIM, bits=4)
    if vit_int8:
        for mod in ("projector",) if joint else ("vision_backbone", "projector"):
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
                    use_film: Optional[bool] = None, num_images: Optional[int] = None,
                    tp_mesh=None):
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
    them. head "discrete" gives the lm_head (D, vocab), which stays bf16
    under every quant flag, and no action head. `use_film` and `num_images`
    override the deployment's FiLM setting and image count (base OpenVLA
    takes one image; the param tree does not depend on the count).
    `tp_mesh`: serve tp-sharded on that mesh (`OpenVLAPolicy.tp_mesh`)."""
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
    n_images = n_images if num_images is None else num_images
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
                         if head == "diffusion" else None, tp_mesh=tp_mesh)


@dataclasses.dataclass
class DeployConfig:
    """The reference's `DeployConfig` (`vla_scripts/deploy.py:18-57`) and the
    port's own fields (from `device` on)."""

    host: str = "0.0.0.0"
    port: int = 8777

    model_family: str = "openvla"
    pretrained_checkpoint: Union[str, Path] = ""

    use_l1_regression: bool = True
    use_diffusion: bool = False
    num_diffusion_steps: int = 50
    use_film: bool = False
    num_images_in_input: int = 3
    use_proprio: bool = True

    center_crop: bool = True
    # The L1 head: preprocess, normalize the proprio and un-normalize in one
    # pass (predict_action_from_frames; no JPEG round trip).
    device_preprocess: bool = False
    num_open_loop_steps: int = 25

    unnorm_key: Union[str, Path] = ""
    use_relative_actions: bool = False

    load_in_8bit: bool = False
    load_in_4bit: bool = False

    # One synthetic predict at the serving geometry before the server binds,
    # so that the first client request does not pay the cold path.
    warmup: bool = True
    # The raw frame size (H, W) of the warm-up observation: what clients send.
    warmup_image_hw: Tuple[int, int] = (256, 256)

    seed: int = 0

    # The port's own fields.
    device: str = "cuda"
    # Serve the flagship with seeded random weights (no checkpoint), at the
    # `platform` deployment of DEPLOYMENTS.
    random_weights: bool = False
    platform: str = "libero"
    load_vision_in_8bit: bool = False
    int4_a8: bool = False           # with load_in_4bit: W4A8 (kernel K6) instead of W4A16
    vit_fused: bool = False         # the ViTs' LN + qkv / LN + fc1 as one K4 launch each
    num_diffusion_steps_inference: Optional[int] = None
    # The switches the JAX loader reads from the environment.
    allow_fake_tokenizer: bool = False
    hf_tokenizer: bool = False
    zero_init: bool = False
    fake_norm_stats: bool = False


class OpenVLAServer:
    """The reference's `OpenVLAServer` (`vla_scripts/deploy.py:60-140`) on the
    port: `get_vla` and the per-module files of `cfg.pretrained_checkpoint`,
    served by `ActionServer`, whose /act runs `get_vla_action`."""

    def __init__(self, cfg: DeployConfig):
        from openvla_oft_tpu_torch.serving.openvla_utils import (get_action_head,
                                                                 get_noisy_action_projector,
                                                                 get_processor,
                                                                 get_proprio_projector,
                                                                 get_vla, get_vla_action)

        self.cfg = cfg
        self.vla = get_vla(cfg)
        llm_dim = self.vla.cfg.llm_dim
        self.proprio_projector = self.action_head = self.noisy_action_projector = None
        # A module missing from the directory may already be in the
        # checkpoint's tree (a random: one).
        if cfg.use_proprio:
            self.proprio_projector = _optional(get_proprio_projector, cfg, llm_dim,
                                               self.vla.platform.proprio_dim)
        if cfg.use_l1_regression or cfg.use_diffusion:
            self.action_head = _optional(get_action_head, cfg, llm_dim)
        if self.vla.head == "diffusion":
            self.noisy_action_projector = _optional(get_noisy_action_projector, cfg, llm_dim)
        if self.vla.norm_stats:
            # At startup, as the reference (deploy.py:92-95): a wrong key
            # would otherwise fail every /act request.
            if not cfg.unnorm_key:
                raise ValueError("unnorm_key must be set when the checkpoint carries "
                                 f"norm_stats (one of {sorted(self.vla.norm_stats)})")
            if str(cfg.unnorm_key) not in self.vla.norm_stats:
                raise ValueError(f"Action un-norm key {cfg.unnorm_key} not found in "
                                 f"norm_stats {sorted(self.vla.norm_stats)}")
        self.processor = get_processor(cfg)
        self._get_vla_action = get_vla_action
        print(f"[deploy] platform={self.vla.platform.name} head={self.vla.head} "
              f"proprio_dim={self.vla.platform.proprio_dim} "
              f"norm_stats={list(self.vla.norm_stats or {})}")
        self._server = ActionServer(self.predict)
        self.warmup_seconds = self._warmup() if cfg.warmup else None

    def _warmup(self) -> float:
        """One synthetic predict at `warmup_image_hw`, before the server binds."""
        obs = synthetic_observation(self.vla, tuple(self.cfg.warmup_image_hw))
        t0 = time.perf_counter()
        self.predict(obs, obs["instruction"])
        seconds = time.perf_counter() - t0
        print(f"[deploy] warmup run: {seconds:.1f}s")
        return seconds

    def predict(self, observation: dict, instruction: str) -> np.ndarray:
        return np.stack(self._get_vla_action(
            self.cfg, self.vla, self.processor, observation, instruction,
            action_head=self.action_head, proprio_projector=self.proprio_projector,
            noisy_action_projector=self.noisy_action_projector, use_film=self.cfg.use_film))

    def run(self, host: Optional[str] = None, port: Optional[int] = None,
            background: bool = False):
        return self._server.run(host or self.cfg.host, port or self.cfg.port,
                                background=background)

    def shutdown(self) -> None:
        self._server.shutdown()


def _optional(load, *args):
    try:
        return load(*args)
    except FileNotFoundError:
        return None


def _check(cfg: DeployConfig) -> None:
    """Refuse flags that exclude each other: the message on stderr, exit 2."""
    error = None
    if cfg.int4_a8 and not cfg.load_in_4bit:
        error = "--int4-a8 needs --load-in-4bit"
    elif cfg.load_in_4bit + cfg.load_in_8bit + cfg.load_vision_in_8bit > 1:
        error = "at most one of --load-in-4bit, --load-in-8bit and --load-vision-in-8bit"
    elif cfg.random_weights == bool(str(cfg.pretrained_checkpoint)):
        error = "pass exactly one of --pretrained-checkpoint DIR and --random-weights"
    elif cfg.random_weights and cfg.platform not in DEPLOYMENTS:
        error = f"--platform must be one of {sorted(DEPLOYMENTS)}, got {cfg.platform!r}"
    if error:
        print(f"deploy: error: {error}", file=sys.stderr)
        raise SystemExit(2)


def main(argv=None) -> None:
    from openvla_oft_tpu_torch.utils.cli import parse_args

    cfg = parse_args(DeployConfig, argv)
    _check(cfg)
    if cfg.random_weights:
        policy = flagship_policy(cfg.device, seed=cfg.seed, load_in_4bit=cfg.load_in_4bit,
                                 int4_a8=cfg.int4_a8, platform=cfg.platform,
                                 vit_fused=cfg.vit_fused, load_in_8bit=cfg.load_in_8bit,
                                 load_vision_in_8bit=cfg.load_vision_in_8bit)
        server = build_server(policy)
        if cfg.warmup:
            print(f"[deploy] warmup run: {warmup(server, policy):.1f}s")
    else:
        server = OpenVLAServer(cfg)
    print(f"[deploy] serving /act on {cfg.host}:{cfg.port}")
    server.run(cfg.host, cfg.port)


if __name__ == "__main__":
    main()
