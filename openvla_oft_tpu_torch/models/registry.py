"""The pretrained-model registry and its `load` / `load_vla` API (the port's copy
of `openvla_oft_tpu/models/registry.py`, reference
`prismatic/models/{registry,load}.py`: `available_models`, `load` :52,
`load_vla` :122, the MODEL_REGISTRY of released VLMs and VLAs).

The entries map model ids to their architectures and hub repos. `load` and
`load_vla` read LOCAL checkpoint dirs only: a path, or `cache_dir/<name>`;
anything else raises `FileNotFoundError` naming the entry's hub repo, as
`serving/openvla_utils.py` refuses a hub id. The JAX package's hub hook
(`_hub_download`) is not carried over: nothing is downloaded (ROADMAP item
18).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import torch

from openvla_oft_tpu_torch.constants import PlatformSpec, detect_robot_platform


@dataclasses.dataclass(frozen=True)
class ModelEntry:
    model_id: str
    hub_repo: str
    description: str
    vision_backbone_id: str = "dinosiglip-vit-so-224px"
    llm_backbone_id: str = "llama2-7b-pure"
    image_resize_strategy: str = "resize-naive"
    is_vla: bool = False
    head: Optional[str] = None      # "l1" | "diffusion" | "discrete" (VLAs)
    platform: Optional[str] = None  # constants.PLATFORMS key


MODEL_REGISTRY: Dict[str, ModelEntry] = {}


def register_model(entry: ModelEntry) -> ModelEntry:
    MODEL_REGISTRY[entry.model_id] = entry
    return entry


# The 49 released Prismatic VLMs (reference `prismatic/models/registry.py`
# MODEL_REGISTRY; architectures resolved from `prismatic/conf/models.py`'s
# dataclass hierarchy). These are metadata rows — the actual architecture is
# read from each checkpoint's config.json at load time; the ids documented
# here let `available_models()` / `get_model_description()` and the hub
# resolver behave like the reference's.
_PRISMATIC_HUB = "TRI-ML/prismatic-vlms"
for _id, _vb, _llm, _resize, _desc in [
    # -- LLaVA v1.5 reproductions + training-stage ablations --
    ("reproduction-llava-v15+7b", "clip-vit-l-336px", "vicuna-v15-7b",
     "letterbox", "LLaVA v1.5 reproduction (CLIP 336px, Vicuna-7B)"),
    ("reproduction-llava-v15+13b", "clip-vit-l-336px", "vicuna-v15-13b",
     "letterbox", "LLaVA v1.5 reproduction, Vicuna-13B"),
    ("one-stage+7b", "clip-vit-l-336px", "vicuna-v15-7b", "letterbox",
     "single-stage training ablation (no align stage)"),
    ("one-stage+13b", "clip-vit-l-336px", "vicuna-v15-13b", "letterbox",
     "single-stage training ablation, 13B"),
    ("full-ft-multi-stage+7b", "clip-vit-l-336px", "vicuna-v15-7b",
     "letterbox", "full fine-tune (unfrozen backbone), multi-stage"),
    ("full-ft-one-stage+7b", "clip-vit-l-336px", "vicuna-v15-7b",
     "letterbox", "full fine-tune (unfrozen backbone), single-stage"),
    # -- vision-backbone ablations --
    ("in1k-224px+7b", "in1k-vit-l", "vicuna-v15-7b", "letterbox",
     "ImageNet-1K ViT-L backbone ablation"),
    ("dinov2-224px+7b", "dinov2-vit-l", "vicuna-v15-7b", "letterbox",
     "DINOv2 ViT-L backbone ablation"),
    ("clip-224px+7b", "clip-vit-l", "vicuna-v15-7b", "letterbox",
     "CLIP ViT-L 224px backbone ablation"),
    ("siglip-224px+7b", "siglip-vit-so400m", "vicuna-v15-7b", "letterbox",
     "SigLIP so400m 224px backbone ablation"),
    # -- resize-strategy ablations --
    ("clip-336px-resize-crop+7b", "clip-vit-l-336px", "vicuna-v15-7b",
     "resize-crop", "CLIP 336px, resize-crop strategy"),
    ("clip-336px-resize-naive+7b", "clip-vit-l-336px", "vicuna-v15-7b",
     "resize-naive", "CLIP 336px, naive resize"),
    ("siglip-384px-letterbox+7b", "siglip-vit-so400m-384px", "vicuna-v15-7b",
     "letterbox", "SigLIP 384px, letterbox padding"),
    ("siglip-384px-resize-crop+7b", "siglip-vit-so400m-384px",
     "vicuna-v15-7b", "resize-crop", "SigLIP 384px, resize-crop"),
    ("siglip-384px-resize-naive+7b", "siglip-vit-so400m-384px",
     "vicuna-v15-7b", "resize-naive", "SigLIP 384px, naive resize"),
    # -- fused dual-backbone ablations --
    ("dinoclip-336px-letterbox+7b", "dinoclip-vit-l-336px", "vicuna-v15-7b",
     "letterbox", "DINOv2+CLIP fused backbone, letterbox"),
    ("dinoclip-336px-resize-naive+7b", "dinoclip-vit-l-336px",
     "vicuna-v15-7b", "resize-naive", "DINOv2+CLIP fused, naive resize"),
    ("dinosiglip-384px-letterbox+7b", "dinosiglip-vit-so-384px",
     "vicuna-v15-7b", "letterbox", "DINOv2+SigLIP fused, letterbox"),
    ("dinosiglip-384px-resize-naive+7b", "dinosiglip-vit-so-384px",
     "vicuna-v15-7b", "resize-naive", "DINOv2+SigLIP fused, naive resize"),
    # -- LLM-backbone ablations --
    ("llama2+7b", "clip-vit-l-336px", "llama2-7b-pure", "letterbox",
     "Llama-2-7B base LLM ablation"),
    ("llama2+13b", "clip-vit-l-336px", "llama2-13b-pure", "letterbox",
     "Llama-2-13B base LLM ablation"),
    ("llama2-chat+7b", "clip-vit-l-336px", "llama2-7b-chat", "letterbox",
     "Llama-2-7B chat LLM ablation"),
    ("llama2-chat+13b", "clip-vit-l-336px", "llama2-13b-chat", "letterbox",
     "Llama-2-13B chat LLM ablation"),
    ("mistral-v0.1+7b", "clip-vit-l-336px", "mistral-v0.1-7b-pure",
     "letterbox", "Mistral v0.1 base LLM ablation"),
    ("mistral-instruct-v0.1+7b", "clip-vit-l-336px",
     "mistral-v0.1-7b-instruct", "letterbox",
     "Mistral v0.1 instruct LLM ablation"),
    ("phi-2+3b", "clip-vit-l-336px", "phi-2-3b", "letterbox",
     "Phi-2 3B LLM ablation"),
    # -- co-training / data ablations --
    ("vicuna-no-cotraining+7b", "clip-vit-l-336px", "vicuna-v15-7b",
     "letterbox", "no language-only co-training, Vicuna"),
    ("llama2-no-cotraining+7b", "clip-vit-l-336px", "llama2-7b-pure",
     "letterbox", "no language-only co-training, Llama-2"),
    ("train-1.25-epochs+7b", "clip-vit-l-336px", "vicuna-v15-7b",
     "letterbox", "1.25-epoch training-duration ablation"),
    ("train-1.5-epochs+7b", "clip-vit-l-336px", "vicuna-v15-7b",
     "letterbox", "1.5-epoch training-duration ablation"),
    ("train-2-epochs+7b", "clip-vit-l-336px", "vicuna-v15-7b", "letterbox",
     "2-epoch training-duration ablation"),
    ("train-3-epochs+7b", "clip-vit-l-336px", "vicuna-v15-7b", "letterbox",
     "3-epoch training-duration ablation"),
    ("llava-lvis4v+7b", "clip-vit-l-336px", "vicuna-v15-7b", "letterbox",
     "+LVIS-Instruct-4V data ablation"),
    ("llava-lrv+7b", "clip-vit-l-336px", "vicuna-v15-7b", "letterbox",
     "+LRV-Instruct data ablation"),
    ("llava-lvis4v-lrv+7b", "clip-vit-l-336px", "vicuna-v15-7b", "letterbox",
     "+LVIS-4V +LRV data ablation"),
    # -- Prism models (controlled = LLaVA data only) --
    ("prism-clip-controlled+7b", "clip-vit-l-336px", "llama2-7b-pure",
     "resize-naive", "Prism CLIP 7B, controlled data"),
    ("prism-clip-controlled+13b", "clip-vit-l-336px", "llama2-13b-pure",
     "resize-naive", "Prism CLIP 13B, controlled data"),
    ("prism-clip+7b", "clip-vit-l-336px", "llama2-7b-pure", "resize-naive",
     "Prism CLIP 7B"),
    ("prism-clip+13b", "clip-vit-l-336px", "llama2-13b-pure",
     "resize-naive", "Prism CLIP 13B"),
    ("prism-siglip-controlled+7b", "siglip-vit-so400m-384px",
     "llama2-7b-pure", "resize-naive", "Prism SigLIP 7B, controlled data"),
    ("prism-siglip-controlled+13b", "siglip-vit-so400m-384px",
     "llama2-13b-pure", "resize-naive", "Prism SigLIP 13B, controlled data"),
    ("prism-siglip+7b", "siglip-vit-so400m-384px", "llama2-7b-pure",
     "resize-naive", "Prism SigLIP 7B"),
    # NOTE: the reference's conf (models.py Exp_13B_Prism_SigLIP) really
    # does point prism-siglip+13b at the CLIP backbone — kept verbatim.
    ("prism-siglip+13b", "clip-vit-l-336px", "llama2-13b-pure",
     "resize-naive", "Prism SigLIP 13B (reference conf maps it to CLIP)"),
    ("prism-dinosiglip-controlled+7b", "dinosiglip-vit-so-384px",
     "llama2-7b-pure", "resize-naive",
     "Prism DINOv2+SigLIP 7B, controlled data"),
    ("prism-dinosiglip-controlled+13b", "dinosiglip-vit-so-384px",
     "llama2-13b-pure", "resize-naive",
     "Prism DINOv2+SigLIP 13B, controlled data"),
    ("prism-dinosiglip+7b", "dinosiglip-vit-so-384px", "llama2-7b-pure",
     "resize-naive", "Prism DINOv2+SigLIP 7B"),
    ("prism-dinosiglip+13b", "dinosiglip-vit-so-384px", "llama2-13b-pure",
     "resize-naive", "Prism DINOv2+SigLIP 13B"),
    ("prism-dinosiglip-224px-controlled+7b", "dinosiglip-vit-so-224px",
     "llama2-7b-pure", "resize-naive",
     "Prism DINOv2+SigLIP 224px, controlled data (OpenVLA base VLM arch)"),
    ("prism-dinosiglip-224px+7b", "dinosiglip-vit-so-224px",
     "llama2-7b-pure", "resize-naive",
     "Prism DINOv2+SigLIP 224px (the OpenVLA base VLM)"),
]:
    register_model(ModelEntry(_id, _PRISMATIC_HUB, _desc,
                              vision_backbone_id=_vb, llm_backbone_id=_llm,
                              image_resize_strategy=_resize))

# Released OpenVLA / OpenVLA-OFT VLA checkpoints (LIBERO.md:41-45).
for _id, _repo, _desc, _vla, _head, _plat in [
    ("openvla-7b", "openvla/openvla-7b",
     "Base OpenVLA 7B (discrete autoregressive actions)",
     True, "discrete", "bridge"),
    ("openvla-7b-oft-finetuned-libero-spatial",
     "moojink/openvla-7b-oft-finetuned-libero-spatial",
     "OFT LIBERO-Spatial: L1 head, 2 images, proprio", True, "l1", "libero"),
    ("openvla-7b-oft-finetuned-libero-object",
     "moojink/openvla-7b-oft-finetuned-libero-object",
     "OFT LIBERO-Object", True, "l1", "libero"),
    ("openvla-7b-oft-finetuned-libero-goal",
     "moojink/openvla-7b-oft-finetuned-libero-goal",
     "OFT LIBERO-Goal (50K-step checkpoint)", True, "l1", "libero"),
    ("openvla-7b-oft-finetuned-libero-10",
     "moojink/openvla-7b-oft-finetuned-libero-10",
     "OFT LIBERO-10", True, "l1", "libero"),
]:
    register_model(ModelEntry(_id, _repo, _desc, is_vla=_vla, head=_head,
                              platform=_plat))


def available_models() -> Tuple[str, ...]:
    """Reference `available_models` / `available_model_names`."""
    return tuple(sorted(MODEL_REGISTRY))


def get_model_description(model_id: str) -> str:
    return MODEL_REGISTRY[model_id].description


def resolve_checkpoint_dir(model_id_or_path: str, cache_dir: Optional[str] = None) -> str:
    """A local checkpoint dir: the path itself, or `cache_dir/<last part of
    the id>`. Otherwise FileNotFoundError, naming the hub repo of a
    registered id."""
    if os.path.isdir(model_id_or_path):
        return model_id_or_path
    if cache_dir:
        candidate = os.path.join(cache_dir, model_id_or_path.split("/")[-1])
        if os.path.isdir(candidate):
            return candidate
    entry = MODEL_REGISTRY.get(model_id_or_path)
    hint = f" (hub repo: {entry.hub_repo})" if entry else ""
    raise FileNotFoundError(
        f"Checkpoint for {model_id_or_path!r} not found locally{hint}: the port "
        "downloads nothing; copy the checkpoint dir to this machine and pass its "
        "path (or set cache_dir).")


def load(model_id_or_path: str, cache_dir: Optional[str] = None,
         dtype: Optional[torch.dtype] = None, device="cuda"):
    """A Prismatic VLM from a local checkpoint dir (reference load.py:52-121):
    (OpenVLAConfig, params, norm_stats), the tree in `dtype` (None: as
    stored) on `device`."""
    from openvla_oft_tpu_torch.utils.hf_import import load_openvla_checkpoint

    return load_openvla_checkpoint(resolve_checkpoint_dir(model_id_or_path, cache_dir),
                                   dtype=dtype, device=device)


def load_vla(model_id_or_path: str, cache_dir: Optional[str] = None,
             platform: Optional[PlatformSpec] = None, dtype: Optional[torch.dtype] = None,
             head: Optional[str] = None, device="cuda"):
    """The port's `OpenVLAPolicy` of a local checkpoint dir (reference
    load.py:122-226). Registered ids carry their head and platform (the
    base openvla-7b is a discrete, bridge-style policy); explicit arguments
    override."""
    from openvla_oft_tpu_torch.constants import PLATFORMS
    from openvla_oft_tpu_torch.policy import OpenVLAPolicy

    entry = MODEL_REGISTRY.get(model_id_or_path)
    if entry is not None and not entry.is_vla:
        raise ValueError(f"{model_id_or_path!r} is a Prismatic VLM, not a VLA: use load() "
                         "for (config, params, norm_stats)")
    cfg, params, norm_stats = load(model_id_or_path, cache_dir, dtype=dtype, device=device)
    if platform is None:
        platform = PLATFORMS[entry.platform] if entry and entry.platform \
            else detect_robot_platform(model_id_or_path)
    head = head or (entry.head if entry else None) or "l1"
    return OpenVLAPolicy(cfg=cfg, platform=platform, params=params, norm_stats=norm_stats,
                         head=head)
