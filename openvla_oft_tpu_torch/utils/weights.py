"""Weight porting: reference checkpoints (HF safetensors, torch `.pt`) -> the port's tree.

The port's copy of `openvla_oft_tpu/utils/weights.py`. It covers the
reference's checkpoint families: HF-format OpenVLA checkpoints
(`vision_backbone.featurizer.*` timm ViTs, `projector.*`,
`language_model.model.*` HF Llama or Phi-2 tensors) and the per-module fine-tune
files `{name}--{step}_checkpoint.pt` (DDP "module." prefixes stripped).

Every porter takes a getter `get(name) -> torch.Tensor` (a
`utils/safetensors_io.SafetensorsIndex`, or `dict_getter` over a state dict)
and writes the reference layout: (in, out) kernels, per-layer tensors
stacked on a new leading axis (L, ...). Each leaf is allocated once in the
target `dtype` on the target `device`, and each layer's tensor is copied
into it one at a time: moved to the device as stored (one contiguous
copy), then transposed and cast there. A loader thus holds one tensor on
the host at a time, and the host does no strided transposes.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from openvla_oft_tpu_torch.config import LlamaConfig, ViTConfig

Params = Dict[str, Any]
Getter = Callable[[str], torch.Tensor]


def as_tensor(x) -> torch.Tensor:
    """A torch tensor of a state-dict value (torch or numpy)."""
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


def _copy_into(dst: torch.Tensor, src, transpose: bool) -> torch.Tensor:
    """`src` into `dst`: moved to `dst`'s device as stored, then transposed
    (if asked) and cast there."""
    src = as_tensor(src).to(dst.device)
    return dst.copy_(src.T if transpose else src)


def _leaf(t, dtype, device, transpose: bool = False) -> torch.Tensor:
    """One tensor in `dtype` (None: its own) on `device`, transposed if asked."""
    t = as_tensor(t)
    shape = t.shape[::-1] if transpose else t.shape
    return _copy_into(torch.empty(shape, dtype=dtype or t.dtype, device=device), t, transpose)


def _stacked(get: Getter, names, dtype, device, transpose: bool) -> torch.Tensor:
    """The tensors `names` stacked on a new leading axis, each transposed
    if asked, one at a time into the destination leaf."""
    first = as_tensor(get(names[0]))
    shape = first.shape[::-1] if transpose else first.shape
    out = torch.empty((len(names),) + tuple(shape), dtype=dtype or first.dtype, device=device)
    _copy_into(out[0], first, transpose)
    del first
    for i, name in enumerate(names[1:], 1):
        _copy_into(out[i], get(name), transpose)
    return out


def strip_ddp_prefix(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Remove a leading 'module.' from DDP-wrapped checkpoints
    (reference `remove_ddp_in_checkpoint`, finetune.py:134-156)."""
    return {re.sub(r"^module\.", "", k): v for k, v in state_dict.items()}


# === Llama (HF `LlamaForCausalLM` names -> stacked layer tree) ===
def port_hf_llama(get: Getter, cfg: LlamaConfig, prefix: str = "",
                  dtype: Optional[torch.dtype] = torch.float32, device="cpu",
                  lm_head: Optional[bool] = None) -> Params:
    """HF Llama tensors under `prefix` -> the stacked tree. HF stores Linear
    weights (out, in); the tree keeps (in, out).

    lm_head: None loads it where the checkpoint has it (the JAX version's
    rule); True requires it and raises, naming the key, where it is missing
    (the discrete head and the AR decode read it); False leaves it out (the
    L1 and diffusion heads never read it)."""
    L = cfg.num_layers

    def stack(fmt: str, transpose: bool = True) -> torch.Tensor:
        return _stacked(get, [prefix + fmt.format(i=i) for i in range(L)], dtype, device,
                        transpose)

    out = {
        "embed": {"embedding": _leaf(get(prefix + "model.embed_tokens.weight"), dtype,
                                     device)},
        "layers": {
            "attn": {
                "wq": {"kernel": stack("model.layers.{i}.self_attn.q_proj.weight")},
                "wk": {"kernel": stack("model.layers.{i}.self_attn.k_proj.weight")},
                "wv": {"kernel": stack("model.layers.{i}.self_attn.v_proj.weight")},
                "wo": {"kernel": stack("model.layers.{i}.self_attn.o_proj.weight")},
            },
            "mlp": {
                "gate": {"kernel": stack("model.layers.{i}.mlp.gate_proj.weight")},
                "up": {"kernel": stack("model.layers.{i}.mlp.up_proj.weight")},
                "down": {"kernel": stack("model.layers.{i}.mlp.down_proj.weight")},
            },
            "attn_norm": {"scale": stack("model.layers.{i}.input_layernorm.weight",
                                         transpose=False)},
            "mlp_norm": {"scale": stack("model.layers.{i}.post_attention_layernorm.weight",
                                        transpose=False)},
        },
        "final_norm": {"scale": _leaf(get(prefix + "model.norm.weight"), dtype, device)},
    }
    if lm_head is False:
        return out
    key = prefix + "lm_head.weight"
    try:
        w = get(key)
    except KeyError:
        if lm_head:
            raise KeyError(f"the checkpoint has no {key!r}: the discrete head and the "
                           "autoregressive decode read the lm_head") from None
        return out
    out["lm_head"] = {"kernel": _leaf(w, dtype, device, transpose=True)}
    return out


# === Phi-2 (HF `PhiForCausalLM` names -> stacked layer tree) ===
def port_hf_phi(get: Getter, cfg, prefix: str = "",
                dtype: Optional[torch.dtype] = torch.float32, device="cpu",
                lm_head: Optional[bool] = None) -> Params:
    """HF Phi-2 tensors under `prefix` -> the stacked tree (JAX
    `port_hf_phi`): Linear weights (out, in) -> kernels (in, out); biases,
    LayerNorm scales and biases as stored. Every projection, each LayerNorm
    and the lm_head carry a bias. lm_head as in `port_hf_llama`."""
    L = cfg.num_layers

    def stack(fmt: str, transpose: bool) -> torch.Tensor:
        return _stacked(get, [prefix + fmt.format(i=i) for i in range(L)], dtype, device,
                        transpose)

    def wb(name: str) -> Params:
        return {"kernel": stack(f"model.layers.{{i}}.{name}.weight", True),
                "bias": stack(f"model.layers.{{i}}.{name}.bias", False)}

    out = {
        "embed": {"embedding": _leaf(get(prefix + "model.embed_tokens.weight"), dtype,
                                     device)},
        "layers": {
            "attn": {"wq": wb("self_attn.q_proj"), "wk": wb("self_attn.k_proj"),
                     "wv": wb("self_attn.v_proj"), "wo": wb("self_attn.dense")},
            "mlp": {"fc1": wb("mlp.fc1"), "fc2": wb("mlp.fc2")},
            "ln": {"scale": stack("model.layers.{i}.input_layernorm.weight", False),
                   "bias": stack("model.layers.{i}.input_layernorm.bias", False)},
        },
        "final_norm": {
            "scale": _leaf(get(prefix + "model.final_layernorm.weight"), dtype, device),
            "bias": _leaf(get(prefix + "model.final_layernorm.bias"), dtype, device)},
    }
    if lm_head is False:
        return out
    key = prefix + "lm_head.weight"
    try:
        w = get(key)
    except KeyError:
        if lm_head:
            raise KeyError(f"the checkpoint has no {key!r}: the discrete head and the "
                           "autoregressive decode read the lm_head") from None
        return out
    out["lm_head"] = {"kernel": _leaf(w, dtype, device, transpose=True),
                      "bias": _leaf(get(prefix + "lm_head.bias"), dtype, device)}
    return out


# === timm ViT -> stacked tree ===
def port_timm_patch_embed(conv_weight: torch.Tensor) -> torch.Tensor:
    """timm conv (D, 3, p, p) -> the patchify matmul kernel (p*p*3, D):
    `patchify` flattens each patch in (dy, dx, c) order."""
    conv_weight = as_tensor(conv_weight)
    return conv_weight.permute(2, 3, 1, 0).reshape(-1, conv_weight.shape[0])


def port_timm_vit(get: Getter, cfg: ViTConfig, prefix: str = "",
                  dtype: Optional[torch.dtype] = torch.float32, device="cpu") -> Params:
    L = cfg.depth

    def g(name: str) -> torch.Tensor:
        return as_tensor(get(prefix + name))

    def stack(fmt: str, transpose: bool = False) -> torch.Tensor:
        return _stacked(get, [prefix + fmt.format(i=i) for i in range(L)], dtype, device,
                        transpose)

    def wb(name: str) -> Params:
        return {"kernel": stack(f"blocks.{{i}}.{name}.weight", transpose=True),
                "bias": stack(f"blocks.{{i}}.{name}.bias")}

    p: Params = {
        "patch_embed": {
            "kernel": _leaf(port_timm_patch_embed(g("patch_embed.proj.weight")), dtype, device),
            "bias": _leaf(g("patch_embed.proj.bias"), dtype, device),
        },
        "pos_embed": _leaf(g("pos_embed")[0], dtype, device),   # (1, N, D) -> (N, D)
        "layers": {
            "norm1": {"scale": stack("blocks.{i}.norm1.weight"),
                      "bias": stack("blocks.{i}.norm1.bias")},
            "norm2": {"scale": stack("blocks.{i}.norm2.weight"),
                      "bias": stack("blocks.{i}.norm2.bias")},
            "attn": {"qkv": wb("attn.qkv"), "proj": wb("attn.proj")},
            "mlp": {"fc1": wb("mlp.fc1"), "fc2": wb("mlp.fc2")},
        },
    }
    if cfg.num_cls_tokens:
        p["cls_token"] = _leaf(g("cls_token")[0], dtype, device)   # (1, 1, D) -> (1, D)
    if cfg.num_reg_tokens:
        p["reg_token"] = _leaf(g("reg_token")[0], dtype, device)
    if cfg.use_pre_norm:
        p["norm_pre"] = {"scale": _leaf(g("norm_pre.weight"), dtype, device),
                         "bias": _leaf(g("norm_pre.bias"), dtype, device)}
    if cfg.use_layer_scale:
        # The reference renames timm `gamma` -> `scale_factor`
        # (modeling_prismatic.py:53-63); HF checkpoints store `scale_factor`.
        def ls(new: str, old: str) -> torch.Tensor:
            try:
                return stack(new)
            except KeyError:
                return stack(old)

        p["layers"]["ls1"] = {"scale_factor": ls("blocks.{i}.ls1.scale_factor",
                                                 "blocks.{i}.ls1.gamma")}
        p["layers"]["ls2"] = {"scale_factor": ls("blocks.{i}.ls2.scale_factor",
                                                 "blocks.{i}.ls2.gamma")}
    return p


# === MLP-style modules with fcN naming (projectors, heads) ===
def port_linear(get: Getter, name: str, dtype=torch.float32, device="cpu") -> Params:
    p = {"kernel": _leaf(get(f"{name}.weight"), dtype, device, transpose=True)}
    try:
        p["bias"] = _leaf(get(f"{name}.bias"), dtype, device)
    except KeyError:
        pass
    return p


def port_layer_norm(get: Getter, name: str, dtype=torch.float32, device="cpu") -> Params:
    return {"scale": _leaf(get(f"{name}.weight"), dtype, device),
            "bias": _leaf(get(f"{name}.bias"), dtype, device)}


def port_fc_mlp(get: Getter, names, prefix: str = "", dtype=torch.float32,
                device="cpu") -> Params:
    """{fc1, fc2, ...} style modules (the vision, proprio and noisy-action projectors)."""
    return {n: port_linear(get, prefix + n, dtype, device) for n in names}


def port_mlp_resnet(get: Getter, prefix: str, num_blocks: int = 2, dtype=torch.float32,
                    device="cpu") -> Params:
    """Reference MLPResNet (action_heads.py:60-82) param names: layer_norm1,
    fc1, mlp_resnet_blocks.{i}.ffn.{0,1}, layer_norm2, fc2."""
    return {
        "ln_in": port_layer_norm(get, prefix + "layer_norm1", dtype, device),
        "fc_in": port_linear(get, prefix + "fc1", dtype, device),
        "blocks": [
            {"ln": port_layer_norm(get, f"{prefix}mlp_resnet_blocks.{i}.ffn.0", dtype, device),
             "fc": port_linear(get, f"{prefix}mlp_resnet_blocks.{i}.ffn.1", dtype, device)}
            for i in range(num_blocks)
        ],
        "ln_out": port_layer_norm(get, prefix + "layer_norm2", dtype, device),
        "fc_out": port_linear(get, prefix + "fc2", dtype, device),
    }


def dict_getter(state_dict: Mapping[str, Any]) -> Getter:
    def get(name: str) -> torch.Tensor:
        if name not in state_dict:
            raise KeyError(name)
        return as_tensor(state_dict[name])

    return get
