"""The continuous action heads: L1 regression and DDIM diffusion.

Port of `openvla_oft_tpu/models/action_heads.py::mlp_resnet`,
`_regroup_hidden`, `l1_head_predict`, `sinusoidal_time_encoding`,
`diffusion_scheduler`, `diffusion_predict_noise` and the training-side
`diffusion_sample_noisy_actions`: LayerNorm -> Linear -> ReLU -> 2 pre-LN
residual blocks -> LayerNorm -> Linear, over hidden states regrouped per
time step.

Random draws come from an explicit `torch.Generator` on the actions'
device, never the global RNG, through `draw_noise` and `draw_timesteps`.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence

import torch

from openvla_oft_tpu_torch.constants import PlatformSpec
from openvla_oft_tpu_torch.ops.ddim import DDIMScheduler
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


def sinusoidal_time_encoding(timesteps: torch.Tensor, dim: int) -> torch.Tensor:
    """(B,) -> (B, dim) fp32; the reference's exponent spacing
    (-log(10000)/(half-1) * arange(half), a Python float times an fp32
    arange, as in the JAX version)."""
    half = dim // 2
    exponent = torch.arange(half, dtype=torch.float32, device=timesteps.device) \
        * (-math.log(10000.0) / (half - 1))
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)


def diffusion_scheduler(num_diffusion_steps: int = 100, device="cpu") -> DDIMScheduler:
    return DDIMScheduler(num_train_timesteps=num_diffusion_steps, device=device)


def diffusion_predict_noise(p: Params, actions_hidden: torch.Tensor,
                            platform: PlatformSpec) -> torch.Tensor:
    """(B, chunk*dim, llm_dim) -> predicted noise (B, chunk, dim)."""
    return mlp_resnet(p["noise_predictor"], _regroup_hidden(actions_hidden, platform))


def draw_noise(generator: torch.Generator, shape: Sequence[int], device) -> torch.Tensor:
    """Standard normal draws of `shape` in fp32 on `device` from `generator`."""
    return torch.randn(tuple(shape), generator=generator, device=device, dtype=torch.float32)


def draw_timesteps(generator: torch.Generator, batch: int, num_diffusion_steps: int,
                   device) -> torch.Tensor:
    """(batch,) int64 timesteps drawn uniformly from [0, num_diffusion_steps)."""
    return torch.randint(0, num_diffusion_steps, (batch,), generator=generator, device=device)


def diffusion_sample_noisy_actions(p: Params, generator: torch.Generator,
                                   gt_actions: torch.Tensor, platform: PlatformSpec,
                                   llm_dim: int = 4096,
                                   num_diffusion_steps: int = 100) -> Dict[str, torch.Tensor]:
    """Training-side forward diffusion (reference action_heads.py:166-196):
    noise (B, chunk, dim) drawn in fp32 and cast to the actions' dtype, a
    timestep per example, the noisy actions `DDIMScheduler.add_noise` gives
    and the timesteps' sinusoidal embeddings (B, 1, llm_dim). `p` (the head's
    params) is unused, as in the JAX version."""
    del p
    b, device = gt_actions.shape[0], gt_actions.device
    noise = draw_noise(generator, (b, platform.num_actions_chunk, platform.action_dim),
                       device).to(gt_actions.dtype)
    timesteps = draw_timesteps(generator, b, num_diffusion_steps, device)
    sched = diffusion_scheduler(num_diffusion_steps, device=device)
    noisy = sched.add_noise(gt_actions, noise, timesteps)
    t_emb = sinusoidal_time_encoding(timesteps, llm_dim).to(gt_actions.dtype)
    return {"noise": noise, "noisy_actions": noisy,
            "diffusion_timestep_embeddings": t_emb[:, None, :]}
