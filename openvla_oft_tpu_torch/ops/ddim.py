"""DDIM scheduler (squaredcos_cap_v2 betas) on torch tensors.

Port of `openvla_oft_tpu/ops/ddim.py`, the repository's replacement for the
reference's `diffusers.DDIMScheduler(num_train_timesteps=T,
beta_schedule="squaredcos_cap_v2")` (`prismatic/models/action_heads.py:
8,163`): epsilon prediction, clip_sample=True (range 1.0),
set_alpha_to_one=True, steps_offset=0, eta=0.

The tables are built in float64 numpy, then kept as one fp32 tensor on the
scheduler's `device`, made when the scheduler is built (the policy builds
one per policy). `step` takes the timestep as a Python int, as the policy's
denoising loop walks `timesteps(n)` on the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch


def _squaredcos_cap_v2_betas(num_train_timesteps: int, max_beta: float = 0.999) -> np.ndarray:
    """Diffusers `betas_for_alpha_bar` with alpha_bar(t) = cos((t+0.008)/1.008 * pi/2)^2."""

    def alpha_bar(t: float) -> float:
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

    return np.asarray([min(1 - alpha_bar((i + 1) / num_train_timesteps)
                           / alpha_bar(i / num_train_timesteps), max_beta)
                       for i in range(num_train_timesteps)], dtype=np.float64)


@dataclasses.dataclass
class DDIMScheduler:
    num_train_timesteps: int = 100
    clip_sample: bool = True
    clip_sample_range: float = 1.0
    set_alpha_to_one: bool = True
    device: Any = "cpu"
    # alphas_cumprod as fp32 on `device`, and the final alpha beside it.
    ac: torch.Tensor = dataclasses.field(init=False, repr=False, compare=False)
    final_ac: torch.Tensor = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self):
        self.device = torch.device(self.device)
        self.ac = torch.tensor(self.alphas_cumprod, dtype=torch.float32, device=self.device)
        self.final_ac = torch.tensor(self.final_alpha_cumprod, dtype=torch.float32,
                                     device=self.device)

    @property
    def alphas_cumprod(self) -> np.ndarray:
        return np.cumprod(1.0 - _squaredcos_cap_v2_betas(self.num_train_timesteps))

    @property
    def final_alpha_cumprod(self) -> float:
        return 1.0 if self.set_alpha_to_one else float(self.alphas_cumprod[0])

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        """Descending inference timesteps (diffusers "leading" spacing, offset 0)."""
        step_ratio = self.num_train_timesteps // num_inference_steps
        ts = (np.arange(num_inference_steps) * step_ratio).round()[::-1].copy()
        return ts.astype(np.int64)

    def add_noise(self, sample: torch.Tensor, noise: torch.Tensor,
                  t: torch.Tensor) -> torch.Tensor:
        """Forward diffusion: sqrt(a_t) x0 + sqrt(1-a_t) eps. t: (B,) int."""
        a_t = self.ac[t.long()]
        a_t = a_t.reshape(a_t.shape + (1,) * (sample.ndim - a_t.ndim))
        return (torch.sqrt(a_t) * sample.float()
                + torch.sqrt(1.0 - a_t) * noise.float()).to(sample.dtype)

    def step(self, model_output: torch.Tensor, t: int, sample: torch.Tensor,
             num_inference_steps: int) -> torch.Tensor:
        """One deterministic DDIM (eta=0) reverse step x_t -> x_{t_prev}; t is
        a value that `timesteps` gave."""
        t = int(t)
        prev_t = t - self.num_train_timesteps // num_inference_steps
        a_t = self.ac[t]
        a_prev = self.ac[prev_t] if prev_t >= 0 else self.final_ac
        x = sample.float()
        eps = model_output.float()
        x0 = (x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
        if self.clip_sample:
            x0 = torch.clamp(x0, -self.clip_sample_range, self.clip_sample_range)
        # As diffusers does for prediction_type="epsilon", eps stays the model
        # output: it is not re-derived from the clipped x0.
        prev = torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps
        return prev.to(sample.dtype)
