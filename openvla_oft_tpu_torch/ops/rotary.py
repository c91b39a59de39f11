"""Rotary position embeddings in HF Llama's half-rotation layout.

Port of `openvla_oft_tpu/ops/rotary.py`: fp32 sin/cos, applied in fp32, cast
back to the input dtype.
"""

from __future__ import annotations

import torch


def rope_sin_cos(positions: torch.Tensor, head_dim: int, theta: float) -> tuple:
    """positions (..., S) int -> (sin, cos), each (..., S, head_dim) fp32."""
    half = head_dim // 2
    freq_exponents = torch.arange(half, dtype=torch.float32,
                                  device=positions.device) / half
    inv_freq = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                      device=positions.device), -freq_exponents)
    angles = positions[..., None].float() * inv_freq
    angles = torch.cat([angles, angles], dim=-1)
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x (..., S, n_heads, head_dim); sin/cos (..., S, head_dim)."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    out = x.float() * cos[..., None, :] + rotated.float() * sin[..., None, :]
    return out.to(x.dtype)
