"""LoRA as auxiliary parameter trees.

Port of `openvla_oft_tpu/training/lora.py` (reference: peft wrapping at
`vla-scripts/finetune.py:862-871` — r=32, alpha=min(r,16), gaussian init,
target_modules="all-linear"). The factors live in their own tree mirroring
the matched base kernels; `inject_lora` attaches them for merge-free
evaluation by `ops/layers.py::linear`, so the frozen base is never copied.

"all-linear" = every Linear kernel of the LLM blocks, both ViTs' blocks and
the vision projector, so gradients flow through the vision towers too.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Tuple

import torch

Params = Dict[str, Any]

# Kernels targeted by "all-linear" on the wrapped VLA.
DEFAULT_TARGETS = (
    r"llm/layers/attn/(wq|wk|wv|wo)/kernel$",
    r"llm/layers/mlp/(gate|up|down)/kernel$",
    r"vision_backbone/.*/layers/attn/(qkv|proj)/kernel$",
    r"vision_backbone/.*/layers/mlp/(fc1|fc2)/kernel$",
    r"projector/fc\d/kernel$",
)


def _leaves_with_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_paths(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_paths(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, tree


def init_lora(generator: torch.Generator, params: Params, rank: int = 32,
              targets: Tuple[str, ...] = DEFAULT_TARGETS,
              dtype: torch.dtype = torch.float32, device=None) -> Params:
    """Build {path: {"a", "b"}} factors for every matched kernel, on
    `device` (None: the generator's; "meta" gives the shapes alone).

    Gaussian init (peft `init_lora_weights="gaussian"`): A ~ N(0, 1)/r,
    B = 0. Kernels (L, in, out) give A (L, r, in), rank-major as in the JAX
    version, and B (L, r, out).
    """
    device = generator.device if device is None else torch.device(device)
    lora: Params = {}
    for path, leaf in _leaves_with_paths(params):
        if not any(re.search(t, path) for t in targets):
            continue
        *lead, d_in, d_out = leaf.shape
        a = torch.randn((*lead, rank, d_in), generator=generator, device=device,
                        dtype=torch.float32) / rank
        b = torch.zeros((*lead, rank, d_out), dtype=torch.float32, device=device)
        node = lora
        parts = path.split("/")[:-1]   # drop "kernel"
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = {"a": a.to(dtype), "b": b.to(dtype)}
    return lora


def _is_factor_pair(node) -> bool:
    return isinstance(node, dict) and set(node) == {"a", "b"}


def _moved(node, device):
    """The tree with its tensors on `device` (None: left where they are)."""
    if isinstance(node, dict):
        return {k: _moved(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [_moved(v, device) for v in node]
    return node if device is None else node.to(device)


def _merge_kernel(w: torch.Tensor, a: torch.Tensor, b: torch.Tensor, scale: float,
                  out_device) -> torch.Tensor:
    """W + scale * A^T B for one kernel, one stacked layer at a time: the
    fp32 temporaries stay one layer large. Computed on W's device, written
    into a tensor on `out_device` in W's dtype."""
    out = torch.empty(w.shape, dtype=w.dtype, device=out_device or w.device)
    a, b = a.to(w.device), b.to(w.device)
    flat_w, flat_out = w.reshape(-1, *w.shape[-2:]), out.view(-1, *w.shape[-2:])
    flat_a, flat_b = a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:])
    for i in range(flat_w.shape[0]):
        delta = torch.einsum("ri,ro->io", flat_a[i].float(), flat_b[i].float()) * scale
        flat_out[i] = (flat_w[i].float() + delta).to(w.dtype)
    return out


def apply_lora(params: Params, lora: Params, rank: int = 32,
               alpha: float = 16.0, out_device=None) -> Params:
    """Return params with W := W + (alpha/r) * A^T B at every LoRA site
    (computed in fp32 on W's device, cast to W's dtype), leaf by leaf and
    one stacked layer at a time, so no second fp32 tree is ever held.
    out_device: where the merged tree is built (None: beside each leaf; the
    fine-tuning CLI's export passes "cpu", so the card holds one merged
    leaf at a time); leaves without LoRA are moved there too."""
    scale = alpha / rank

    def merge(base_node, lora_node):
        if _is_factor_pair(lora_node):
            out = _moved(base_node, out_device)
            out["kernel"] = _merge_kernel(base_node["kernel"], lora_node["a"],
                                          lora_node["b"], scale, out_device)
            return out
        out = {k: (merge(v, lora_node[k]) if k in lora_node else _moved(v, out_device))
               for k, v in base_node.items()}
        return out

    return {k: (merge(v, lora[k]) if k in lora else _moved(v, out_device))
            for k, v in params.items()}


def inject_lora(params: Params, lora: Params, rank: int = 32,
                alpha: float = 16.0) -> Params:
    """Attach LoRA factors into the matched param dicts for merge-free
    evaluation: `linear()` computes y = xW + (x @ (A*scale)^T) @ B when a
    node carries "lora_a"/"lora_b". No merged weight is materialized."""
    scale = alpha / rank

    def attach(base_node, lora_node):
        if _is_factor_pair(lora_node):
            return {**base_node, "lora_a": lora_node["a"] * scale,
                    "lora_b": lora_node["b"]}
        out = dict(base_node)
        for k, v in lora_node.items():
            out[k] = attach(base_node[k], v)
        return out

    merged = dict(params)
    for k, v in lora.items():
        merged[k] = attach(params[k], v)
    return merged


def migrate_lora_layout(lora: Params, rank: int) -> Params:
    """Transpose pre-rank-major A factors (..., d_in, r) into the current
    (..., r, d_in) layout; a no-op on current-layout trees. The old layout
    has `rank` on the trailing axis but not the second-to-last."""

    def walk(node):
        if isinstance(node, dict):
            if _is_factor_pair(node):
                a = node["a"]
                if a.ndim >= 2 and a.shape[-1] == rank and a.shape[-2] != rank:
                    return {"a": a.transpose(-1, -2), "b": node["b"]}
                return node
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(lora)


def merge_lora_into_params(params: Params, lora: Params, rank: int = 32,
                           alpha: float = 16.0, out_device=None) -> Params:
    """Offline merge (reference `merge_lora_weights_and_save.py:33-73`),
    accepting both the rank-major and the pre-flip (in, r) A layouts; leaf
    by leaf as `apply_lora`, the merged tree on `out_device`."""
    return apply_lora(params, migrate_lora_layout(lora, rank), rank, alpha, out_device)
