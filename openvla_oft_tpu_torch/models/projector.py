"""Projector MLPs: vision -> LLM and proprio -> LLM.

Port of `openvla_oft_tpu/models/projector.py::vision_projector` and
`proprio_projector`.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from openvla_oft_tpu_torch.ops.layers import gelu, gelu_erf_fast, linear

Params = Dict[str, Any]


def vision_projector(p: Params, patches: torch.Tensor,
                     fast_gelu: bool = False) -> torch.Tensor:
    """(B, N, vision_dim) -> (B, N, llm_dim); fused form fc1-fc2-fc3."""
    act = gelu_erf_fast if fast_gelu else gelu
    x = linear(p["fc2"], act(linear(p["fc1"], patches)))
    if "fc3" in p:
        x = linear(p["fc3"], act(x))
    return x


def proprio_projector(p: Params, proprio: torch.Tensor) -> torch.Tensor:
    """(B, proprio_dim) -> (B, llm_dim)."""
    return linear(p["fc2"], gelu(linear(p["fc1"], proprio)))
