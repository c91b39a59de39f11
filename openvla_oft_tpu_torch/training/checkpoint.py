"""Training checkpoints as torch state dicts, and the reference's per-module `.pt` files.

The counterpart of `openvla_oft_tpu/training/checkpoint.py`: where the JAX
package writes Orbax steps, the port writes one `torch.save` file per
gradient step, `{ckpt_dir}/{step:06d}.pt`, holding the trainables and the
optimizer's state dict. The importers of the reference's per-module fine-tune
files `{name}--{step}_checkpoint.pt` (action heads, projectors, the FiLMed
vision backbone) are ported; the `.pt` exporters and the merged-model export
are not (ROADMAP queue 1, item 14b). A checkpoint holds every trainable group
the run has (LoRA, the action head, the proprio and noisy-action projectors,
FiLM).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional, Tuple

import torch

from openvla_oft_tpu_torch.models.vision_backbone import featurizer_names
from openvla_oft_tpu_torch.utils.weights import (dict_getter, port_fc_mlp, port_mlp_resnet,
                                                 port_timm_vit, strip_ddp_prefix)

Params = Dict[str, Any]

_STEP_FILE = re.compile(r"^(\d{6,})\.pt$")


def checkpoint_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"{step:06d}.pt")


def save_checkpoint(ckpt_dir: str, step: int, state: Dict[str, Any]) -> str:
    """Write `state` (e.g. {"trainables": ..., "optimizer": ...}) for `step`.
    The file appears under its final name only once complete."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = checkpoint_path(ckpt_dir, step)
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(ckpt_dir)) if m]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: Optional[int] = None,
                       map_location=None) -> Dict[str, Any]:
    """Read the state saved for `step` (the latest one when None)."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    return torch.load(checkpoint_path(ckpt_dir, step), map_location=map_location,
                      weights_only=True)


# === The reference's per-module `.pt` files ===
def load_module_pt(path: str) -> Dict[str, torch.Tensor]:
    """A `{name}--{step}_checkpoint.pt` state dict on the CPU, its DDP prefix
    stripped (reference loading at openvla_utils.py:201-250)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return strip_ddp_prefix(sd)


def find_checkpoint_file(pretrained_dir: str, file_pattern: str) -> str:
    """Reference `find_checkpoint_file` (openvla_utils.py:436-460): the one
    file in the dir whose name contains `file_pattern`."""
    matches = [f for f in os.listdir(pretrained_dir) if file_pattern in f
               and os.path.isfile(os.path.join(pretrained_dir, f))]
    if len(matches) != 1:
        raise FileNotFoundError(f"expected exactly 1 '{file_pattern}' checkpoint in "
                                f"{pretrained_dir}, found {len(matches)}")
    return os.path.join(pretrained_dir, matches[0])


def import_action_head_pt(path: str, head: str = "l1", dtype: Optional[torch.dtype] = None,
                          device="cpu") -> Params:
    """An L1 or diffusion action-head `.pt` -> the tree (in `dtype`, None:
    as stored)."""
    get = dict_getter(load_module_pt(path))
    if head == "l1":
        return {"model": port_mlp_resnet(get, "model.", dtype=dtype, device=device)}
    if head == "diffusion":
        return {"noise_predictor": port_mlp_resnet(get, "noise_predictor.mlp_resnet.",
                                                   dtype=dtype, device=device)}
    raise ValueError(f"head must be 'l1' or 'diffusion', got {head!r}")


def import_projector_pt(path: str, kind: str = "proprio", dtype: Optional[torch.dtype] = None,
                        device="cpu") -> Params:
    """A proprio or noisy-action projector `.pt` (fc1, fc2) -> the tree."""
    if kind not in ("proprio", "noisy_action"):
        raise ValueError(f"kind must be 'proprio' or 'noisy_action', got {kind!r}")
    return port_fc_mlp(dict_getter(load_module_pt(path)), ("fc1", "fc2"), dtype=dtype,
                       device=device)


def import_film_vision_backbone_pt(path: str, cfg, dtype: Optional[torch.dtype] = torch.float32,
                                   device="cpu") -> Tuple[Params, Params]:
    """A reference `vision_backbone--{step}_checkpoint.pt` saved from
    `FiLMedPrismaticVisionBackbone` (openvla_utils.py:311-349 loads it) ->
    (vision_backbone params, film params). The timm parameters live under
    `vision_backbone.<featurizer>.blocks.{i}.block.*`, the FiLM projectors
    under `...blocks.{i}.{scale,shift}.*`; linears wrapped by peft LoRA
    (`<module>.base_layer.weight` with `lora_A` / `lora_B.default.weight`,
    the reference applies LoRA before the FiLM wrap, finetune.py:862-884)
    are merged, W + min(r, 16) / r * B @ A in fp32. cfg: OpenVLAConfig."""
    get = dict_getter(load_module_pt(path))
    backbone: Params = {}
    film: Params = {}
    for name, vcfg in zip(featurizer_names(cfg), cfg.vision_configs):
        prefix = f"vision_backbone.{name}."

        def resolve(cand: str) -> torch.Tensor:
            try:
                return get(cand)
            except KeyError:
                pass
            if cand.endswith(".weight"):
                stem = cand[: -len(".weight")]
                w = get(f"{stem}.base_layer.weight").float()
                try:
                    a = get(f"{stem}.lora_A.default.weight").float()
                    b = get(f"{stem}.lora_B.default.weight").float()
                    r = a.shape[0]
                    w = w + (min(r, 16) / r) * (b @ a)
                except KeyError:
                    pass
                return w
            if cand.endswith(".bias"):
                return get(f"{cand[: -len('.bias')]}.base_layer.bias")
            raise KeyError(cand)

        def film_get(key: str, _prefix=prefix) -> torch.Tensor:
            if key.startswith(_prefix + "blocks."):
                idx, sub = key[len(_prefix + "blocks."):].split(".", 1)
                try:
                    return resolve(f"{_prefix}blocks.{idx}.block.{sub}")
                except KeyError:
                    pass                      # the plain (un-FiLM-wrapped) layout
            return resolve(key)

        backbone[name] = port_timm_vit(film_get, vcfg, prefix=prefix, dtype=dtype,
                                       device=device)
        film[name] = {
            proj: {"kernel": torch.stack([get(f"{prefix}blocks.{i}.{proj}.weight").T
                                          for i in range(vcfg.depth)]).to(device, dtype),
                   "bias": torch.stack([get(f"{prefix}blocks.{i}.{proj}.bias")
                                        for i in range(vcfg.depth)]).to(device, dtype)}
            for proj in ("scale", "shift")}
    return backbone, film
