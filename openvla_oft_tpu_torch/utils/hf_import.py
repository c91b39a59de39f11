"""Load and export whole OpenVLA checkpoints in the reference's HF format.

The port's copy of `openvla_oft_tpu/utils/hf_import.py`. A checkpoint
directory holds `config.json` (with `norm_stats`), `model*.safetensors`
shards (and their `model.safetensors.index.json` when sharded) with the
names
    vision_backbone.featurizer.*            (timm DINOv2, primary)
    vision_backbone.fused_featurizer.*      (timm SigLIP)
    projector.fc{1,2,3}.*
    language_model.model.* / language_model.lm_head.weight
plus `dataset_statistics.json` and the tokenizer files.

`load_openvla_checkpoint` reads it leaf by leaf: each tensor is read in its
stored dtype from a mapping of its bytes (`utils/safetensors_io.py`; the
`safetensors` package is not needed), moved to the target device as
stored, transposed and cast there into its place in a leaf allocated once
in the target dtype, and dropped before the next is read. The host then
holds one tensor at a time, never the tree (the JAX version builds the
whole tree in fp32 numpy first).
`export_openvla_checkpoint` writes the inverse, in the tree's own dtype.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from openvla_oft_tpu_torch.config import OpenVLAConfig, PhiConfig
from openvla_oft_tpu_torch.models.vision_backbone import featurizer_names
from openvla_oft_tpu_torch.utils.safetensors_io import (SafetensorsIndex, save_file,
                                                       save_sharded)
from openvla_oft_tpu_torch.utils.weights import (port_fc_mlp, port_hf_llama, port_hf_phi,
                                                 port_timm_vit)

Params = Dict[str, Any]


def _read_norm_stats(ckpt_dir: str, from_config: Optional[dict]) -> Optional[dict]:
    """The checkpoint's statistics: config.json's `norm_stats`, else its
    `dataset_statistics.json` sidecar, else None."""
    if from_config:
        return from_config
    path = os.path.join(ckpt_dir, "dataset_statistics.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return from_config


def load_openvla_checkpoint(ckpt_dir: str, dtype: Optional[torch.dtype] = torch.float32,
                            device="cpu", head: Optional[str] = None
                            ) -> Tuple[OpenVLAConfig, Params, Optional[dict]]:
    """(config, params, norm_stats) from a reference checkpoint dir: the LLM,
    the projector and the vision backbone, in `dtype` (None: each tensor's
    stored dtype) on `device`.

    head: "discrete" requires the lm_head (a KeyError names the missing
    key); "l1" and "diffusion" leave it out; None loads it where present
    (the JAX version's rule)."""
    cfg, norm_stats = OpenVLAConfig.from_json_file(os.path.join(ckpt_dir, "config.json"))
    get = SafetensorsIndex(ckpt_dir)
    port_llm = port_hf_phi if isinstance(cfg.llm, PhiConfig) else port_hf_llama
    llm = port_llm(get, cfg.llm, prefix="language_model.", dtype=dtype, device=device,
                   lm_head={"discrete": True, "l1": False, "diffusion": False,
                            None: None}[head])
    params: Params = {
        "llm": llm,
        "projector": port_fc_mlp(get, ("fc1", "fc2", "fc3") if cfg.use_fused_vision_backbone
                                 else ("fc1", "fc2"), prefix="projector.", dtype=dtype,
                                 device=device),
        "vision_backbone": {
            name: port_timm_vit(get, vcfg, prefix=f"vision_backbone.{name}.", dtype=dtype,
                                device=device)
            for name, vcfg in zip(featurizer_names(cfg), cfg.vision_configs)},
    }
    return cfg, params, _read_norm_stats(ckpt_dir, norm_stats)


# === Export (the inverse port) ===
def _per_layer(out: dict, prefix: str, fmt_map: dict, n: int) -> None:
    for fmt, (arr, transpose) in fmt_map.items():
        for i in range(n):
            out[prefix + fmt.format(i=i)] = arr[i].T if transpose else arr[i]


def export_llama(params: Params, cfg, prefix: str = "language_model.") -> Dict[str, torch.Tensor]:
    """The HF Llama names -> tensors (views of the tree: (out, in) weights)."""
    lay = params["layers"]
    out: Dict[str, torch.Tensor] = {
        prefix + "model.embed_tokens.weight": params["embed"]["embedding"],
        prefix + "model.norm.weight": params["final_norm"]["scale"],
    }
    if "lm_head" in params:
        out[prefix + "lm_head.weight"] = params["lm_head"]["kernel"].T
    _per_layer(out, prefix, {
        "model.layers.{i}.self_attn.q_proj.weight": (lay["attn"]["wq"]["kernel"], True),
        "model.layers.{i}.self_attn.k_proj.weight": (lay["attn"]["wk"]["kernel"], True),
        "model.layers.{i}.self_attn.v_proj.weight": (lay["attn"]["wv"]["kernel"], True),
        "model.layers.{i}.self_attn.o_proj.weight": (lay["attn"]["wo"]["kernel"], True),
        "model.layers.{i}.mlp.gate_proj.weight": (lay["mlp"]["gate"]["kernel"], True),
        "model.layers.{i}.mlp.up_proj.weight": (lay["mlp"]["up"]["kernel"], True),
        "model.layers.{i}.mlp.down_proj.weight": (lay["mlp"]["down"]["kernel"], True),
        "model.layers.{i}.input_layernorm.weight": (lay["attn_norm"]["scale"], False),
        "model.layers.{i}.post_attention_layernorm.weight": (lay["mlp_norm"]["scale"], False),
    }, cfg.num_layers)
    return out


def export_phi(params: Params, cfg, prefix: str = "language_model.") -> Dict[str, torch.Tensor]:
    """The HF `PhiForCausalLM` names -> tensors (views of the tree: (out,
    in) weights), the inverse of `utils/weights.py::port_hf_phi`. Not part
    of `export_tensors`: the JAX exporter writes Llama names only."""
    lay = params["layers"]
    out: Dict[str, torch.Tensor] = {
        prefix + "model.embed_tokens.weight": params["embed"]["embedding"],
        prefix + "model.final_layernorm.weight": params["final_norm"]["scale"],
        prefix + "model.final_layernorm.bias": params["final_norm"]["bias"],
        prefix + "lm_head.weight": params["lm_head"]["kernel"].T,
        prefix + "lm_head.bias": params["lm_head"]["bias"],
    }
    fmt_map = {"model.layers.{i}.input_layernorm.weight": (lay["ln"]["scale"], False),
               "model.layers.{i}.input_layernorm.bias": (lay["ln"]["bias"], False)}
    for (group, name), hf in {("attn", "wq"): "self_attn.q_proj",
                              ("attn", "wk"): "self_attn.k_proj",
                              ("attn", "wv"): "self_attn.v_proj",
                              ("attn", "wo"): "self_attn.dense",
                              ("mlp", "fc1"): "mlp.fc1", ("mlp", "fc2"): "mlp.fc2"}.items():
        fmt_map[f"model.layers.{{i}}.{hf}.weight"] = (lay[group][name]["kernel"], True)
        fmt_map[f"model.layers.{{i}}.{hf}.bias"] = (lay[group][name]["bias"], False)
    _per_layer(out, prefix, fmt_map, cfg.num_layers)
    return out


def export_tensors(cfg: OpenVLAConfig, params: Params) -> Dict[str, torch.Tensor]:
    """Every tensor of the checkpoint, by its reference name (views of the
    tree). The LLM is written by the Llama exporter, as in the JAX version."""
    return {**export_llama(params["llm"], cfg.llm), **export_vision_tensors(cfg, params)}


def export_vision_tensors(cfg: OpenVLAConfig, params: Params) -> Dict[str, torch.Tensor]:
    """The vision backbone's and the projector's tensors by their reference
    names (views of the tree)."""
    tensors: Dict[str, torch.Tensor] = {}
    for name, vcfg in zip(featurizer_names(cfg), cfg.vision_configs):
        vp = params["vision_backbone"][name]
        pre = f"vision_backbone.{name}."
        k = vp["patch_embed"]["kernel"]                              # (p*p*3, D)
        tensors[pre + "patch_embed.proj.weight"] = \
            k.reshape(vcfg.patch_size, vcfg.patch_size, 3, k.shape[1]).permute(3, 2, 0, 1)
        tensors[pre + "patch_embed.proj.bias"] = vp["patch_embed"]["bias"]
        tensors[pre + "pos_embed"] = vp["pos_embed"][None]
        for tok in ("cls_token", "reg_token"):
            if tok in vp:
                tensors[pre + tok] = vp[tok][None]
        if "norm_pre" in vp:
            tensors[pre + "norm_pre.weight"] = vp["norm_pre"]["scale"]
            tensors[pre + "norm_pre.bias"] = vp["norm_pre"]["bias"]
        lay = vp["layers"]
        fmt_map = {
            "blocks.{i}.norm1.weight": (lay["norm1"]["scale"], False),
            "blocks.{i}.norm1.bias": (lay["norm1"]["bias"], False),
            "blocks.{i}.norm2.weight": (lay["norm2"]["scale"], False),
            "blocks.{i}.norm2.bias": (lay["norm2"]["bias"], False),
        }
        for mod, sub in (("attn", "qkv"), ("attn", "proj"), ("mlp", "fc1"), ("mlp", "fc2")):
            fmt_map[f"blocks.{{i}}.{mod}.{sub}.weight"] = (lay[mod][sub]["kernel"], True)
            fmt_map[f"blocks.{{i}}.{mod}.{sub}.bias"] = (lay[mod][sub]["bias"], False)
        if "ls1" in lay:
            fmt_map["blocks.{i}.ls1.scale_factor"] = (lay["ls1"]["scale_factor"], False)
            fmt_map["blocks.{i}.ls2.scale_factor"] = (lay["ls2"]["scale_factor"], False)
        _per_layer(tensors, pre, fmt_map, vcfg.depth)
    for fc, p in params["projector"].items():
        tensors[f"projector.{fc}.weight"] = p["kernel"].T
        tensors[f"projector.{fc}.bias"] = p["bias"]
    return tensors


def hf_config(cfg: OpenVLAConfig, norm_stats: Optional[dict] = None) -> dict:
    """The checkpoint's config.json: the reference's fields, the statistics,
    and the architecture payloads (`tpu_vision_configs`, `tpu_llm_config`)
    that let a fresh process load an id it has not registered."""
    return {
        "model_type": "openvla",
        "vision_backbone_id": cfg.vision_backbone_id,
        "llm_backbone_id": cfg.llm_backbone_id,
        "image_resize_strategy": cfg.image_resize_strategy,
        "llm_max_length": cfg.llm_max_length,
        "pad_token_id": cfg.pad_token_id,
        "pad_to_multiple_of": cfg.pad_to_multiple_of,
        "n_action_bins": cfg.n_action_bins,
        "norm_stats": norm_stats or {},
        "tpu_vision_configs": [dataclasses.asdict(v) for v in cfg.vision_configs],
        "tpu_llm_config": dataclasses.asdict(cfg.llm),
    }


def export_openvla_checkpoint(cfg: OpenVLAConfig, params: Params, out_dir: str,
                              norm_stats: Optional[dict] = None,
                              extras_from: Optional[str] = None,
                              max_shard_bytes: Optional[int] = None) -> str:
    """Write a reference-format checkpoint dir (safetensors + config.json)
    from the tree in its own dtype, one tensor on the host at a time.

    extras_from: a source checkpoint dir whose tensors this exporter does
    not produce (the featurizers' final `norm.*`, SigLIP's `attn_pool.*`:
    parameters after the tap the forward never reads) are copied through,
    so a reference -> port -> reference round trip keeps every key.
    max_shard_bytes: write `model-0000i-of-0000n.safetensors` shards of at
    most this size and their index instead of one `model.safetensors`."""
    os.makedirs(out_dir, exist_ok=True)
    tensors = export_tensors(cfg, params)
    if extras_from is not None:
        src = SafetensorsIndex(extras_from)
        for name in src.keys():
            if name not in tensors:
                tensors[name] = src(name)
    if max_shard_bytes is None:
        save_file(tensors, os.path.join(out_dir, "model.safetensors"))
    else:
        save_sharded(tensors, out_dir, max_shard_bytes)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(hf_config(cfg, norm_stats), f, indent=2)
    return out_dir
