"""The OpenVLA eval and serving API on the port.

The port's copy of `experiments/robot/openvla_utils.py` (the reference's
`get_vla` :253, `get_processor` :380, `get_proprio_projector` :393,
`get_noisy_action_projector` :437, `get_action_head` :463, `get_vla_action`
:711). `get_vla` loads an HF-format checkpoint dir (or draws `random:`
weights) into an `OpenVLAPolicy` on the card, fused and quantized for
serving by `serving/deploy.py::serving_params`; the `get_*` loaders import
the reference's per-module `{name}--{step}_checkpoint.pt` files;
`get_vla_action` prepares one observation (the staged path: JPEG round
trip, lanczos3 resize, 0.9 crop and the processor transform, on the
policy's device; or, with `device_preprocess` and the L1 head, the one-pass
`predict_action_from_frames`) and returns the open-loop slice of the action
chunk.

Every switch is a field of the config the caller passes (`device`,
`zero_init`, `fake_norm_stats`, `allow_fake_tokenizer`, `hf_tokenizer`,
`int4_a8`, `vit_fused`, `joint_vit`, ...), never the environment. The
checkpoint must be a local directory: nothing is downloaded.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from openvla_oft_tpu_torch.constants import (NormalizationType, PlatformSpec,
                                             detect_robot_platform)
from openvla_oft_tpu_torch.data.transforms import normalize as _normalize_stats
from openvla_oft_tpu_torch.policy import OpenVLAPolicy
from openvla_oft_tpu_torch.processing.image_processing import prepare_images_for_policy
from openvla_oft_tpu_torch.processing.processor import (FakeLlamaTokenizer,
                                                        PrismaticProcessor, load_tokenizer)
from openvla_oft_tpu_torch.training.checkpoint import (find_checkpoint_file,
                                                       import_action_head_pt,
                                                       import_film_vision_backbone_pt,
                                                       import_projector_pt)

TOKENIZER_FILES = ("tokenizer.json", "tokenizer.model", "tokenizer_config.json")


def model_is_on_hf_hub(model_path: str) -> bool:
    """Reference `model_is_on_hf_hub` (openvla_utils.py:49-53): True when the
    path is a hub id rather than a local directory."""
    return not os.path.isdir(str(model_path))


def _device(cfg: Any) -> torch.device:
    return torch.device(getattr(cfg, "device", "cuda"))


def _platform_from_cfg(cfg: Any) -> PlatformSpec:
    hint = " ".join(str(getattr(cfg, k, "")) for k in
                    ("pretrained_checkpoint", "task_suite_name", "unnorm_key", "dataset_name"))
    return detect_robot_platform(hint or "libero")


def _head_of(cfg: Any) -> str:
    """The action head a config asks for: "l1" (`use_l1_regression`, the
    default), "diffusion" (`use_diffusion`) or "discrete"."""
    if getattr(cfg, "use_l1_regression", True):
        return "l1"
    return "diffusion" if getattr(cfg, "use_diffusion", False) else "discrete"


def _local_dir(ckpt: str) -> str:
    """A checkpoint that is a local directory, else FileNotFoundError."""
    if ckpt.startswith("random:"):
        raise FileNotFoundError(f"{ckpt!r} draws random weights and has no module files")
    if model_is_on_hf_hub(ckpt):
        raise FileNotFoundError(f"{ckpt!r} is not a local checkpoint directory: the port "
                                "downloads nothing from the hub; pass a local directory")
    return ckpt


def random_model_config(ckpt: str, num_images: int, use_film: bool):
    """The model of a `random:` checkpoint: `random:tiny` the TINY configs
    (registered as "tiny-dual" / "tiny-llama"), anything else the flagship."""
    from openvla_oft_tpu_torch import config as C

    if ckpt == "random:tiny":
        C._VISION_REGISTRY.setdefault("tiny-dual", (C.TINY_DINOV2, C.TINY_SIGLIP))
        C._LLM_REGISTRY.setdefault("tiny-llama", C.TINY_LLAMA)
        return C.OpenVLAConfig(vision_backbone_id="tiny-dual", llm_backbone_id="tiny-llama",
                               num_images_in_input=num_images, use_film=use_film)
    return C.OpenVLAConfig(num_images_in_input=num_images, use_film=use_film)


def _zeros(spec, device, dtype):
    from openvla_oft_tpu_torch.bridge import Init

    if isinstance(spec, Init):
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if isinstance(spec, dict):
        return {k: _zeros(v, device, dtype) for k, v in spec.items()}
    return [_zeros(v, device, dtype) for v in spec]


def get_vla(cfg: Any, dtype: torch.dtype = torch.bfloat16) -> OpenVLAPolicy:
    """The policy of `cfg.pretrained_checkpoint` on `cfg.device`, its tree in
    `dtype` (reference openvla_utils.py:253-377): a local checkpoint dir
    (with FiLM from its `vision_backbone--*.pt` under `use_film`), or
    `random:` weights drawn from seed 0 (zeros with `zero_init`, [-1, 1]
    statistics with `fake_norm_stats`); then the serving fusions and
    quantization of `serving/deploy.py::serving_params` (`load_in_8bit`,
    `load_in_4bit` or `load_vision_in_8bit`; `joint_vit` / `joint_vit_int8`,
    the ViT pair as one joint program), the checkpoint's tokenizer
    (`allow_fake_tokenizer`, `hf_tokenizer`), and the policy's switches
    (`int4_a8`, `vit_fused`, the diffusion steps, and `tp_mesh`: serve
    tp-sharded on that mesh, quantized trees included)."""
    from openvla_oft_tpu_torch.bridge import init_params, param_spec
    from openvla_oft_tpu_torch.serving.deploy import placeholder_norm_stats, serving_params
    from openvla_oft_tpu_torch.utils.hf_import import load_openvla_checkpoint

    device = _device(cfg)
    platform = _platform_from_cfg(cfg)
    head = _head_of(cfg)
    ckpt = str(cfg.pretrained_checkpoint)
    n_images = getattr(cfg, "num_images_in_input", 1)
    use_film = getattr(cfg, "use_film", False)
    norm_stats = None
    if ckpt.startswith("random:"):
        model_cfg = random_model_config(ckpt, n_images, use_film)
        if getattr(cfg, "zero_init", False):
            # Latency aid: the shapes as zeros, no random draw.
            params = _zeros(param_spec(model_cfg, platform, head), device, dtype)
        else:
            params = init_params(model_cfg, platform,
                                 torch.Generator(device=device).manual_seed(0),
                                 device=device, dtype=dtype, head=head)
        if getattr(cfg, "fake_norm_stats", False):
            norm_stats = {f"{platform.name}_bench": placeholder_norm_stats(platform)["random"]}
    else:
        model_cfg, params, norm_stats = load_openvla_checkpoint(_local_dir(ckpt), dtype=dtype,
                                                                device=device, head=head)
        model_cfg = dataclasses.replace(model_cfg, num_images_in_input=n_images,
                                        use_film=use_film)
        if use_film:
            # The fine-tune saves the whole FiLMed vision backbone as
            # `vision_backbone--{step}_checkpoint.pt` (reference
            # `_apply_film_to_vla`, openvla_utils.py:311-349); a FiLM policy
            # without it raises rather than serve the un-FiLMed backbone.
            params["vision_backbone"], params["film"] = import_film_vision_backbone_pt(
                find_checkpoint_file(ckpt, "vision_backbone"), model_cfg, dtype=dtype,
                device=device)
    params = serving_params(params, load_in_4bit=getattr(cfg, "load_in_4bit", False),
                            load_in_8bit=getattr(cfg, "load_in_8bit", False),
                            load_vision_in_8bit=getattr(cfg, "load_vision_in_8bit", False),
                            joint_vit=getattr(cfg, "joint_vit", False),
                            joint_vit_int8=getattr(cfg, "joint_vit_int8", False),
                            vision_configs=model_cfg.vision_configs)
    return OpenVLAPolicy(
        cfg=model_cfg, platform=platform, params=params, norm_stats=norm_stats, head=head,
        tokenizer=_try_tokenizer(ckpt, allow_fake=getattr(cfg, "allow_fake_tokenizer", False),
                                 hf=getattr(cfg, "hf_tokenizer", False)),
        int4_a8=getattr(cfg, "int4_a8", False), vit_fused=getattr(cfg, "vit_fused", False),
        num_diffusion_steps=getattr(cfg, "num_diffusion_steps", 50),
        num_diffusion_steps_inference=getattr(cfg, "num_diffusion_steps_inference", None),
        tp_mesh=getattr(cfg, "tp_mesh", None))


def _try_tokenizer(ckpt: str, allow_fake: bool = False, hf: bool = False):
    """The checkpoint's Llama tokenizer, loudly: a checkpoint without
    tokenizer files raises rather than fall back to the stand-in, which
    would give plausible but wrong actions. The stand-in serves `random:`
    checkpoints, and others only with `allow_fake` (tests, benchmarks)."""
    if os.path.isdir(ckpt) and any(os.path.exists(os.path.join(ckpt, f))
                                   for f in TOKENIZER_FILES):
        return load_tokenizer(ckpt, hf=hf)
    if ckpt.startswith("random:") or allow_fake:
        return FakeLlamaTokenizer()
    raise FileNotFoundError(f"No tokenizer files ({' / '.join(TOKENIZER_FILES)}) in {ckpt!r}. "
                            "A checkpoint must include the Llama tokenizer; "
                            "allow_fake_tokenizer=True takes the deterministic stand-in "
                            "(tests and benchmarks only).")


def get_processor(cfg: Any) -> PrismaticProcessor:
    """Reference openvla_utils.py:380-390."""
    from openvla_oft_tpu_torch.config import OpenVLAConfig

    ckpt = str(cfg.pretrained_checkpoint)
    if ckpt.startswith("random:"):
        model_cfg = random_model_config(ckpt, getattr(cfg, "num_images_in_input", 1),
                                        getattr(cfg, "use_film", False))
    else:
        model_cfg, _ = OpenVLAConfig.from_json_file(os.path.join(_local_dir(ckpt),
                                                                 "config.json"))
    return PrismaticProcessor(model_cfg, _try_tokenizer(
        ckpt, allow_fake=getattr(cfg, "allow_fake_tokenizer", False),
        hf=getattr(cfg, "hf_tokenizer", False)))


def get_action_head(cfg: Any, llm_dim: int = 4096):
    """The L1 or diffusion head's `action_head--*.pt` on `cfg.device`, in its
    stored dtype (reference openvla_utils.py:463-513)."""
    path = find_checkpoint_file(_local_dir(str(cfg.pretrained_checkpoint)), "action_head")
    return import_action_head_pt(path, head="l1" if getattr(cfg, "use_l1_regression", True)
                                 else "diffusion", device=_device(cfg))


def get_proprio_projector(cfg: Any, llm_dim: int = 4096, proprio_dim: int = 8):
    """Reference openvla_utils.py:393-434."""
    path = find_checkpoint_file(_local_dir(str(cfg.pretrained_checkpoint)),
                                "proprio_projector")
    return import_projector_pt(path, kind="proprio", device=_device(cfg))


def get_noisy_action_projector(cfg: Any, llm_dim: int = 4096):
    """Reference openvla_utils.py:437-460."""
    path = find_checkpoint_file(_local_dir(str(cfg.pretrained_checkpoint)),
                                "noisy_action_projector")
    return import_projector_pt(path, kind="noisy_action", device=_device(cfg))


def normalize_proprio(proprio: np.ndarray, norm_stats: Dict[str, Any],
                      norm_type: Optional[NormalizationType] = None) -> np.ndarray:
    """Reference openvla_utils.py:645-675, clipped to [-1, 1]."""
    out = _normalize_stats(proprio, norm_stats, norm_type or NormalizationType.BOUNDS_Q99)
    return np.clip(out, -1.0, 1.0)


def check_image_format(image: np.ndarray) -> None:
    """Reference openvla_utils.py:625-642."""
    if not isinstance(image, np.ndarray):
        raise TypeError("image must be a numpy array")
    if image.dtype != np.uint8:
        raise ValueError(f"expected a uint8 image, got {image.dtype}")
    if image.ndim != 3 or image.shape[-1] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {image.shape}")


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree.to(device)


def get_vla_action(cfg: Any, vla: OpenVLAPolicy, processor: Any, obs: Dict[str, Any],
                   task_label: str, action_head=None, proprio_projector=None,
                   noisy_action_projector=None, use_film: bool = False) -> List[np.ndarray]:
    """One observation -> the first `num_open_loop_steps` actions of the
    chunk (reference openvla_utils.py:711-796). Modules loaded on their own
    (`get_action_head`, ...) go into the policy's tree first.

    `device_preprocess` with the L1 head: the raw frames go through
    `predict_action_from_frames` (resize, crop, normalize, proprio
    normalization and un-normalization on the device; no JPEG round trip).
    Otherwise, for every head, the staged path the reference's eval
    conditioning takes: `prepare_images_for_policy` on the policy's device
    (the JPEG round trip at quality 95, TF's libjpeg bit for bit, then the
    resize and crop), the proprio normalized on the host (written back into
    `obs["state"]`, as the reference does), then `predict_action`."""
    all_images = [obs["full_image"]]
    if getattr(cfg, "num_images_in_input", 1) > 1:
        all_images.extend([obs[k] for k in obs.keys()
                           if "wrist" in k or "camera_gripper_image" in k])
    for im in all_images:
        check_image_format(im)
    for key, module in (("action_head", action_head), ("proprio_projector", proprio_projector),
                        ("noisy_action_projector", noisy_action_projector)):
        if module is not None:
            vla.params[key] = _to_device(module, vla.device)
    unnorm_key = getattr(cfg, "unnorm_key", None) or None
    use_proprio = getattr(cfg, "use_proprio", False)

    if getattr(cfg, "device_preprocess", False) and vla.head == "l1":
        frames = np.stack([np.asarray(im, np.uint8) for im in all_images])
        actions = vla.predict_action_from_frames(
            frames, task_label,
            proprio=np.asarray(obs["state"], np.float32) if use_proprio else None,
            unnorm_key=unnorm_key, center_crop=getattr(cfg, "center_crop", True))
    else:
        pixels = prepare_images_for_policy(all_images, vla.cfg,
                                           center_crop=getattr(cfg, "center_crop", True),
                                           device=vla.device)
        proprio = None
        if use_proprio:
            proprio = np.asarray(obs["state"], np.float32)
            if vla.norm_stats:
                # A policy without statistics (random: weights) takes the
                # proprio raw, as its actions stay normalized.
                key = unnorm_key or next(iter(vla.norm_stats))
                proprio = normalize_proprio(proprio, vla.norm_stats[key]["proprio"],
                                            vla.platform.norm_type)
            obs["state"] = proprio
        actions = vla.predict_action(pixels, task_label, proprio=proprio,
                                     unnorm_key=unnorm_key)
    n = min(len(actions), getattr(cfg, "num_open_loop_steps", len(actions)))
    return [actions[i] for i in range(n)]
