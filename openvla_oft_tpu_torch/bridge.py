"""Parameters: the JAX param pytree as torch tensors, and random init on the device.

`params_from_numpy` converts a JAX pytree (nested dicts and lists of arrays)
leaf for leaf, keeping the JAX layout: (in, out) kernels, layers stacked
(L, ...). `init_params` draws the tree `openvla_oft_tpu.policy.
init_openvla_params(..., head=head, with_lm_head=False, head_dtype=dtype)`
builds for head "l1" or "diffusion", with the same shapes and scales,
directly on the device from a `torch.Generator` (the numbers differ from
JAX's: the generators differ).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from openvla_oft_tpu_torch.config import OpenVLAConfig, PhiConfig, ViTConfig
from openvla_oft_tpu_torch.constants import PlatformSpec

Params = Dict[str, Any]


def _to_tensor(leaf, device, dtype) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":   # ml_dtypes bfloat16: reinterpret the bits
        t = torch.from_numpy(arr.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))   # a writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


# Leaves that keep their own dtype under `params_from_numpy(dtype=...)`.
_OWN_DTYPE = frozenset({"scale_w", "scale_x", "scale_w4"})


def params_from_numpy(tree, device="cpu", dtype: Optional[torch.dtype] = None):
    """JAX pytree (arrays or numpy) -> the same tree of torch tensors.

    dtype: cast floating leaves to it (None keeps each leaf's dtype). The
    quantization scales ("scale_w", "scale_x", "scale_w4") keep their own
    dtype (fp32), as the JAX package keeps them; int8 leaves are never cast.
    """
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, None if k in _OWN_DTYPE else dtype)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device, dtype) for v in tree)
    return _to_tensor(tree, device, dtype)


def index_layer(tree: Params, i: int) -> Params:
    """Layer i of a stacked (L, ...) param tree; every leaf is a view."""
    return {name: index_layer(v, i) if isinstance(v, dict) else v[i]
            for name, v in tree.items()}


class Init(NamedTuple):
    """One parameter: shape, and how it is drawn (normal * scale, or a constant)."""
    shape: tuple
    scale: float = 0.0          # std of the normal draw; 0 = constant fill
    fill: float = 0.0


def _linear(d_in: int, d_out: int) -> Params:
    """ops/layers.py::init_linear: 0.02 * normal kernel, zero bias."""
    return {"kernel": Init((d_in, d_out), 0.02), "bias": Init((d_out,))}


def _layer_norm(dim: int) -> Params:
    return {"scale": Init((dim,), fill=1.0), "bias": Init((dim,))}


def _vit_spec(cfg: ViTConfig) -> Params:
    """models/vit.py::init_vit_params."""
    d, L = cfg.width, cfg.depth
    patch_dim = cfg.patch_size * cfg.patch_size * 3
    n_pos = cfg.num_patches if cfg.pos_embed_patches_only \
        else cfg.num_patches + cfg.num_prefix_tokens
    p: Params = {
        "patch_embed": {"kernel": Init((patch_dim, d), patch_dim ** -0.5),
                        "bias": Init((d,))},
        "pos_embed": Init((n_pos, d), d ** -0.5),
        "layers": {
            "norm1": {"scale": Init((L, d), fill=1.0), "bias": Init((L, d))},
            "norm2": {"scale": Init((L, d), fill=1.0), "bias": Init((L, d))},
            "attn": {
                "qkv": {"kernel": Init((L, d, 3 * d), d ** -0.5),
                        "bias": Init((L, 3 * d))},
                "proj": {"kernel": Init((L, d, d), d ** -0.5), "bias": Init((L, d))},
            },
            "mlp": {
                "fc1": {"kernel": Init((L, d, cfg.mlp_dim), d ** -0.5),
                        "bias": Init((L, cfg.mlp_dim))},
                "fc2": {"kernel": Init((L, cfg.mlp_dim, d), cfg.mlp_dim ** -0.5),
                        "bias": Init((L, d))},
            },
        },
    }
    if cfg.num_cls_tokens:
        p["cls_token"] = Init((cfg.num_cls_tokens, d))
    if cfg.num_reg_tokens:
        p["reg_token"] = Init((cfg.num_reg_tokens, d))
    if cfg.use_pre_norm:
        p["norm_pre"] = _layer_norm(d)
    if cfg.use_layer_scale:
        p["layers"]["ls1"] = {"scale_factor": Init((L, d), fill=1e-5)}
        p["layers"]["ls2"] = {"scale_factor": Init((L, d), fill=1e-5)}
    return p


def _film_spec(cfg: ViTConfig, llm_dim: int) -> Params:
    """models/vit.py::init_film_params: per-block FiLM scale and shift
    projectors, (L, llm_dim, width) kernels and zero (L, width) biases."""
    L, d = cfg.depth, cfg.width
    return {name: {"kernel": Init((L, llm_dim, d), llm_dim ** -0.5), "bias": Init((L, d))}
            for name in ("scale", "shift")}


def _mlp_resnet(d_in: int, hidden: int, d_out: int) -> Params:
    """models/action_heads.py::init_mlp_resnet, 2 blocks."""
    return {"ln_in": _layer_norm(d_in), "fc_in": _linear(d_in, hidden),
            "blocks": [{"ln": _layer_norm(hidden), "fc": _linear(hidden, hidden)}
                       for _ in range(2)],
            "ln_out": _layer_norm(hidden), "fc_out": _linear(hidden, d_out)}


HEADS = ("l1", "diffusion")


def param_spec(cfg: OpenVLAConfig, platform: PlatformSpec, head: str = "l1") -> Params:
    """The tree of `Init` leaves for a serving model without lm_head (with
    the FiLM projectors when `cfg.use_film`). head "l1": the L1 MLPResNet
    under action_head["model"]; "diffusion": the noise predictor under
    action_head["noise_predictor"] and the noisy-action projector (JAX
    `init_diffusion_head`, `init_noisy_action_projector`)."""
    if head == "discrete":
        raise NotImplementedError("head='discrete' is not ported yet (ROADMAP queue 1, "
                                  "item 12)")
    if head not in HEADS:
        raise ValueError(f"head must be one of {HEADS}, got {head!r}")
    llm = cfg.llm
    if isinstance(llm, PhiConfig):
        raise NotImplementedError("Phi-2 is not ported yet (ROADMAP queue 1, item 16)")
    h, kv, d = llm.num_heads, llm.num_kv_heads, llm.hidden_size
    hd, inter, L = llm.head_dim, llm.intermediate_size, llm.num_layers
    names = ("featurizer", "fused_featurizer")[: len(cfg.vision_configs)]
    vision_dim, llm_dim = cfg.vision_dim, cfg.llm_dim
    if cfg.use_fused_vision_backbone:
        projector = {"fc1": _linear(vision_dim, 4 * vision_dim),
                     "fc2": _linear(4 * vision_dim, llm_dim),
                     "fc3": _linear(llm_dim, llm_dim)}
    else:
        projector = {"fc1": _linear(vision_dim, llm_dim),
                     "fc2": _linear(llm_dim, llm_dim)}
    head_in = llm_dim * platform.action_dim
    spec: Params = {
        "llm": {
            "embed": {"embedding": Init((llm.vocab_size, d), d ** -0.5)},
            "layers": {
                "attn": {
                    "wq": {"kernel": Init((L, d, h * hd), d ** -0.5)},
                    "wk": {"kernel": Init((L, d, kv * hd), d ** -0.5)},
                    "wv": {"kernel": Init((L, d, kv * hd), d ** -0.5)},
                    "wo": {"kernel": Init((L, h * hd, d), (h * hd) ** -0.5)},
                },
                "mlp": {
                    "gate": {"kernel": Init((L, d, inter), d ** -0.5)},
                    "up": {"kernel": Init((L, d, inter), d ** -0.5)},
                    "down": {"kernel": Init((L, inter, d), inter ** -0.5)},
                },
                "attn_norm": {"scale": Init((L, d), fill=1.0)},
                "mlp_norm": {"scale": Init((L, d), fill=1.0)},
            },
            "final_norm": {"scale": Init((d,), fill=1.0)},
        },
        "vision_backbone": {name: _vit_spec(v)
                            for name, v in zip(names, cfg.vision_configs)},
        "projector": projector,
        "proprio_projector": {"fc1": _linear(platform.proprio_dim, llm_dim),
                              "fc2": _linear(llm_dim, llm_dim)},
    }
    trunk = _mlp_resnet(head_in, llm_dim, platform.action_dim)
    if head == "l1":
        spec["action_head"] = {"model": trunk}
    else:
        spec["action_head"] = {"noise_predictor": trunk}
        spec["noisy_action_projector"] = {"fc1": _linear(1, llm_dim),
                                          "fc2": _linear(llm_dim, llm_dim)}
    if cfg.use_film:
        spec["film"] = {name: _film_spec(v, llm_dim)
                        for name, v in zip(names, cfg.vision_configs)}
    return spec


def _draw(init: Init, generator: torch.Generator, device, dtype) -> torch.Tensor:
    out = torch.full(init.shape, init.fill, dtype=dtype, device=device)
    if init.scale == 0.0:
        return out
    # Draw in fp32 one leading slice at a time (one layer of a stacked
    # kernel), scale, then cast, so the fp32 temporary stays one layer large.
    rows = out if out.ndim == 3 else out[None]
    for row in rows:
        row.copy_(torch.randn(row.shape, generator=generator, device=device,
                              dtype=torch.float32) * init.scale)
    return out


def materialize(spec, generator: torch.Generator, device, dtype):
    if isinstance(spec, Init):
        return _draw(spec, generator, device, dtype)
    if isinstance(spec, dict):
        return {k: materialize(v, generator, device, dtype) for k, v in spec.items()}
    return [materialize(v, generator, device, dtype) for v in spec]


_HEAD_KEYS = ("projector", "proprio_projector", "action_head", "film",
              "noisy_action_projector")


def init_params(cfg: OpenVLAConfig, platform: PlatformSpec,
                generator: torch.Generator, device="cpu",
                dtype: torch.dtype = torch.bfloat16,
                head_dtype: Optional[torch.dtype] = None, head: str = "l1") -> Params:
    """Random params for `head` ("l1" or "diffusion", `param_spec`) drawn on
    `device` (the generator must live there too): the structure, shapes and
    scales of the JAX init, in the unfused layout (serving fuses afterwards;
    training keeps it).

    head_dtype: dtype of the projector, proprio projector, action head,
    noisy-action projector and FiLM projectors (the JAX init's
    `head_dtype`, fp32 for training); None = `dtype`.
    """
    head_dtype = dtype if head_dtype is None else head_dtype
    return {k: materialize(v, generator, device,
                           head_dtype if k in _HEAD_KEYS else dtype)
            for k, v in param_spec(cfg, platform, head).items()}


def split_base_trainables(params: Params, lora_generator: torch.Generator,
                          lora_rank: int = 32, use_proprio: bool = True):
    """(frozen base, trainables), the split of `vla_scripts/finetune.py`:
    the base is the LLM, the vision backbone and the projector; trainables
    are LoRA factors over the base's linears (`training/lora.py::init_lora`,
    drawn from `lora_generator`), the action head and, with `use_proprio`,
    the proprio projector. The base is set to requires_grad=False and the
    trainables to True, in place."""
    from openvla_oft_tpu_torch.training.lora import init_lora

    base = {k: params[k] for k in ("llm", "vision_backbone", "projector")}
    trainables = {"lora": init_lora(lora_generator, base, rank=lora_rank)}
    for k in ("action_head", "proprio_projector"):
        if k in params and (k != "proprio_projector" or use_proprio):
            trainables[k] = params[k]
    for t in tree_leaves(base):
        t.requires_grad_(False)
    for t in tree_leaves(trainables):
        t.requires_grad_(True)
    return base, trainables


def tree_leaves(tree) -> list:
    """The tensors of a nested dict/list tree, in insertion order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]
