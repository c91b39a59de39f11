"""The L1 regression action head.

Port of `openvla_oft_tpu/models/action_heads.py::mlp_resnet`,
`_regroup_hidden` and `l1_head_predict`: LayerNorm -> Linear -> ReLU ->
2 pre-LN residual blocks -> LayerNorm -> Linear, over hidden states regrouped
per time step.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from openvla_oft_tpu_torch.constants import PlatformSpec
from openvla_oft_tpu_torch.ops.layers import layer_norm, linear

Params = Dict[str, Any]


def mlp_resnet(p: Params, x: torch.Tensor) -> torch.Tensor:
    x = torch.relu(linear(p["fc_in"], layer_norm(p["ln_in"], x, eps=1e-5)))
    for blk in p["blocks"]:
        x = x + torch.relu(linear(blk["fc"], layer_norm(blk["ln"], x, eps=1e-5)))
    return linear(p["fc_out"], layer_norm(p["ln_out"], x, eps=1e-5))


def _regroup_hidden(actions_hidden: torch.Tensor,
                    platform: PlatformSpec) -> torch.Tensor:
    """(B, chunk*dim, D) -> (B, chunk, dim*D)."""
    return actions_hidden.reshape(actions_hidden.shape[0],
                                  platform.num_actions_chunk, -1)


def l1_head_predict(p: Params, actions_hidden: torch.Tensor,
                    platform: PlatformSpec) -> torch.Tensor:
    """(B, chunk*dim, llm_dim) -> normalized actions (B, chunk, dim)."""
    return mlp_resnet(p["model"], _regroup_hidden(actions_hidden, platform))
