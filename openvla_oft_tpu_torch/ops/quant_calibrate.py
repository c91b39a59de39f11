"""Quantization calibration: int8/int4 accuracy against bf16, and static
activation scales for the int8 LLM.

Port of `openvla_oft_tpu/ops/quant_calibrate.py`:
1. `weight_quant_errors`: the relative Frobenius error of dequant(quant(W))
   against W for every kernel that would quantize, one value per layer;
2. `calibrate`: that, the drift of the ViT features, the projector output
   and the action-slot hidden states between the float and the quantized
   model on the same inputs, and the L1 delta of the predicted
   (normalized) actions, judged against two floors: the reference's
   discrete-token bin half-width (1/255) and the converged training L1
   (about 6e-3 on LIBERO-Spatial);
3. `attach_static_act_scales`: per-layer `scale_x` leaves from the
   calibration forward's activation absmaxes (the static W8A8 path of
   `ops/quant.py::int8_linear`); `attach_placeholder_act_scales` attaches
   uniform ones without a forward, for timing only;
4. `random_observations`: synthetic calibration inputs at the serving
   geometry.

`openvla_oft_tpu_torch/scripts/calibrate_quant.py` is the CLI.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from openvla_oft_tpu_torch.config import OpenVLAConfig
from openvla_oft_tpu_torch.constants import PlatformSpec
from openvla_oft_tpu_torch.ops.quant import (
    _div,
    _is_quantizable,
    _quantize_leaf,
    dequantize_int4,
    quantize_tree,
    quantize_tree_lowmem,
    quantize_weight,
)

# The floors the end-to-end action delta is judged against.
DISCRETE_BIN_HALF_WIDTH = (2.0 / 255.0) / 2.0   # the reference's action tokenizer
TRAIN_L1_FLOOR = 6e-3                           # LIBERO.md:119 plateau


def _rel_err(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def _one_layer_err(w: torch.Tensor, bits: int) -> float:
    """Relative Frobenius error of dequant(quant(w)) - w for one (in, out)
    kernel, on w's device."""
    wf = w.float()
    if bits == 8:
        q = quantize_weight(wf)
        deq = q["kernel"].float() * q["scale_w"][None, :]
    else:
        q = _quantize_leaf(wf)
        deq = dequantize_int4(q["kernel_q4"], q["scale_w4"])
    return (torch.linalg.norm(deq - wf) / (torch.linalg.norm(wf) + 1e-12)).item()


def weight_quant_errors(params: Dict[str, Any], min_dim: int = 1024,
                        bits: int = 8) -> Dict[str, List[float]]:
    """{path: [error of layer 0, ...]} for every kernel that `quantize_tree`
    would quantize (a stacked kernel gives one value per layer, so outlier
    layers show), computed one layer at a time on the kernels' device."""
    out: Dict[str, List[float]] = {}

    def visit(node, path):
        if isinstance(node, dict):
            if _is_quantizable(node, min_dim, bits):
                k = node["kernel"]
                layers = [k] if k.ndim == 2 else list(k.reshape(-1, *k.shape[-2:]))
                out[path] = [_one_layer_err(layer, bits) for layer in layers]
                return
            for key, v in node.items():
                visit(v, f"{path}/{key}" if path else key)

    visit(params, "")
    return out


def _stages(p: Dict[str, Any], cfg: OpenVLAConfig, platform: PlatformSpec,
            obs: Dict[str, torch.Tensor]) -> tuple:
    """(ViT features, projector output, actions_hidden, normalized actions)
    of one observation, each as a float64 numpy array."""
    from openvla_oft_tpu_torch.models.action_heads import l1_head_predict
    from openvla_oft_tpu_torch.models.prismatic import predict_action_hidden
    from openvla_oft_tpu_torch.models.projector import vision_projector
    from openvla_oft_tpu_torch.models.vision_backbone import vision_backbone_forward

    dtype = p["llm"]["embed"]["embedding"].dtype
    with torch.inference_mode():
        feats = vision_backbone_forward(p["vision_backbone"], cfg, obs["pixels"].to(dtype))
        proj = vision_projector(p["projector"], feats)
        hidden = predict_action_hidden(p, cfg, platform, input_ids=obs["input_ids"],
                                       prompt_mask=obs["prompt_mask"], pixels=obs["pixels"],
                                       proprio=obs.get("proprio")).actions_hidden
        actions = l1_head_predict(p["action_head"], hidden.float(), platform)
    return tuple(t.double().cpu().numpy() for t in (feats, proj, hidden, actions))


def calibrate(cfg: OpenVLAConfig, platform: PlatformSpec, params: Dict[str, Any],
              observations: Sequence[Dict[str, torch.Tensor]], bits: int = 8,
              min_dim: int = 1024,
              quant_modules: Sequence[str] = ("llm", "vision_backbone", "projector"),
              low_memory: bool = False,
              weight_errors: bool = True) -> Dict[str, Any]:
    """The calibration report of a float param tree (L1 head, unfused LLM):
    weight errors, stage-wise activation errors and the action L1 delta of
    the `quant_modules` quantized at `bits` against the float model on the
    same `observations` (`random_observations`' dicts).

    The quantized LLM is the serving layout: wqkv/gate_up concatenated after
    quantizing, without the norm folds (each output column quantizes on its
    own, so this is the tree that fuse-then-quantize gives). The weight
    errors and the float model's outputs are taken on the unfused float tree
    first. low_memory: quantize in place (`quantize_tree_lowmem`), so float
    and quantized trees never coexist; CONSUMES `params`.
    """
    from openvla_oft_tpu_torch.models.llama import fuse_inference_weights

    base = dict(params)
    w_err = {}
    if weight_errors:
        for mod in quant_modules:
            if mod in base:
                for path, errs in weight_quant_errors(base[mod], min_dim=min_dim,
                                                      bits=bits).items():
                    w_err[f"{mod}/{path}"] = errs

    refs = [_stages(base, cfg, platform, obs) for obs in observations]
    quantize = quantize_tree_lowmem if low_memory else quantize_tree
    qparams = dict(base)
    for mod in quant_modules:
        if mod in qparams:
            qparams[mod] = quantize(qparams[mod], min_dim=min_dim, bits=bits)
    if "llm" in quant_modules and "layers" in qparams.get("llm", {}):
        qparams["llm"] = fuse_inference_weights(qparams["llm"], fold_norms=False)

    feat_err, proj_err, hidden_err, deltas = [], [], [], []
    for obs, (f0, p0, h0, a0) in zip(observations, refs):
        f1, p1, h1, a1 = _stages(qparams, cfg, platform, obs)
        feat_err.append(_rel_err(f1, f0))
        proj_err.append(_rel_err(p1, p0))
        hidden_err.append(_rel_err(h1, h0))
        deltas.append(np.abs(a1 - a0))
    deltas = np.stack(deltas)

    flat_w = sorted(((k, i, e) for k, errs in w_err.items() for i, e in enumerate(errs)),
                    key=lambda t: -t[2])
    report = {
        "bits": bits,
        "n_observations": len(observations),
        "weight_error": {
            "max": flat_w[0][2] if flat_w else 0.0,
            "mean": float(np.mean([e for _, _, e in flat_w])) if flat_w else 0.0,
            "worst_layers": [{"param": k, "layer": i, "rel_err": round(e, 5)}
                             for k, i, e in flat_w[:8]],
        },
        "activation_rel_error": {
            "vit_features": float(np.mean(feat_err)),
            "projector": float(np.mean(proj_err)),
            "action_hidden": float(np.mean(hidden_err)),
        },
        "action_l1": {
            "mean": float(deltas.mean()),
            "max": float(deltas.max()),
            "p99": float(np.percentile(deltas, 99)),
        },
        "floors": {
            "discrete_bin_half_width": DISCRETE_BIN_HALF_WIDTH,
            "train_l1_floor": TRAIN_L1_FLOOR,
        },
    }
    report["verdict"] = {
        "below_discrete_floor": report["action_l1"]["mean"] < DISCRETE_BIN_HALF_WIDTH,
        "below_train_floor": report["action_l1"]["mean"] < TRAIN_L1_FLOOR,
    }
    return report


def attach_static_act_scales(params: Dict[str, Any], cfg: OpenVLAConfig,
                             platform: PlatformSpec,
                             observations: Sequence[Dict[str, torch.Tensor]],
                             margin: float = 1.0) -> Dict[str, Any]:
    """Static per-layer activation scales for the int8 LLM: the serving
    forward (`predict_action_hidden`'s layout, on the dense path) in absmax
    collection mode over the observations, the elementwise max across them,
    and scale_x = margin * absmax / 127 as an (L,) fp32 leaf beside every
    int8 kernel of `params["llm"]["layers"]`. Each layer view
    (`bridge.index_layer`) then holds the 0-d scalar that switches
    `int8_linear` to the static path. Call after quantizing and fusing, so
    the collected keys match the serving layout (wqkv/gate_up or
    wq/wk/wv/gate/up). Returns a new params dict (the llm layer dicts
    rebuilt, tensors shared)."""
    from openvla_oft_tpu_torch.models.prismatic import predict_action_hidden

    agg = None
    with torch.inference_mode():
        for obs in observations:
            _, stats = predict_action_hidden(
                params, cfg, platform, input_ids=obs["input_ids"],
                prompt_mask=obs["prompt_mask"], pixels=obs["pixels"],
                proprio=obs.get("proprio"), collect_act_stats=True)
            agg = stats if agg is None else {
                g: {k: torch.maximum(agg[g][k], v) for k, v in gs.items()}
                for g, gs in stats.items()}

    layers = {k: (dict(v) if isinstance(v, dict) else v)
              for k, v in params["llm"]["layers"].items()}
    attached = []
    for group, group_stats in agg.items():
        for key, absmax in group_stats.items():
            node = layers.get(group, {}).get(key)
            if not isinstance(node, dict) or node.get("kernel") is None \
                    or node["kernel"].dtype != torch.int8:
                continue
            layers[group][key] = {**node, "scale_x": _div(margin * absmax.float(), 127.0)}
            attached.append(f"{group}/{key}")
    if not attached:
        raise ValueError("no int8 kernels found to attach static scales to")
    return {**params, "llm": {**params["llm"], "layers": layers}}


def attach_placeholder_act_scales(llm_params: Dict[str, Any],
                                  value: float = 0.05) -> Dict[str, Any]:
    """Uniform (L,) "scale_x" leaves beside every int8 kernel of an LLM tree,
    without a calibration forward. The static path's cost does not depend on
    the values, so this times it; serving needs `attach_static_act_scales`."""
    layers = {}
    n = 0
    for group, node in llm_params["layers"].items():
        if not isinstance(node, dict):
            layers[group] = node
            continue
        new_group = {}
        for key, leaf in node.items():
            if isinstance(leaf, dict) and "kernel" in leaf and leaf["kernel"].dtype == torch.int8:
                k = leaf["kernel"]
                shape = (k.shape[0],) if k.ndim == 3 else ()
                new_group[key] = {**leaf, "scale_x": torch.full(shape, value,
                                                                 dtype=torch.float32,
                                                                 device=k.device)}
                n += 1
            else:
                new_group[key] = leaf
        layers[group] = new_group
    if not n:
        raise ValueError("no int8 kernels found")
    return {**llm_params, "layers": layers}


def random_observations(cfg: OpenVLAConfig, platform: PlatformSpec, n: int = 4,
                        seed: int = 0, prompt_bucket: int = 48,
                        device="cuda") -> List[Dict[str, torch.Tensor]]:
    """Synthetic calibration inputs at the serving geometry, from numpy's
    generator (the JAX version's draws): a left-padded prompt of 16 to
    bucket - 2 tokens ending in 29871, bf16 pixels (1, N, n_backbones, H, W,
    3) of std 0.5 and an fp32 proprio state, on `device`."""
    rng = np.random.default_rng(seed)
    size = cfg.vision_configs[0].image_size
    nb = len(cfg.vision_configs)
    obs = []
    for _ in range(n):
        ln = int(rng.integers(16, prompt_bucket - 1))
        ids = np.zeros((1, prompt_bucket), np.int32)
        ids[0, -ln:] = rng.integers(3, 30000, ln)
        ids[0, -ln] = 1
        ids[0, -1] = 29871
        mask = np.zeros((1, prompt_bucket), np.int32)
        mask[0, -ln:] = 1
        pixels = rng.standard_normal((1, cfg.num_images_in_input, nb, size, size, 3)) * 0.5
        proprio = rng.standard_normal((1, platform.proprio_dim))
        obs.append({
            "input_ids": torch.from_numpy(ids).to(device),
            "prompt_mask": torch.from_numpy(mask).to(device),
            "pixels": torch.from_numpy(pixels).to(device=device, dtype=torch.bfloat16),
            "proprio": torch.from_numpy(proprio).to(device=device, dtype=torch.float32),
        })
    return obs
