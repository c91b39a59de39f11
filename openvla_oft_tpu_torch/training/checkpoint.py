"""Training checkpoints as torch state dicts.

The minimal counterpart of `openvla_oft_tpu/training/checkpoint.py`: where
the JAX package writes Orbax steps, the port writes one `torch.save` file
per gradient step, `{ckpt_dir}/{step:06d}.pt`, holding the trainables and
the optimizer's state dict. The reference-format `.pt` exports and the
merged-model export are not ported (ROADMAP queue 1, item 14).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

import torch

_STEP_FILE = re.compile(r"^(\d{6,})\.pt$")


def checkpoint_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"{step:06d}.pt")


def save_checkpoint(ckpt_dir: str, step: int, state: Dict[str, Any]) -> str:
    """Write `state` (e.g. {"trainables": ..., "optimizer": ...}) for `step`.
    The file appears under its final name only once complete."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = checkpoint_path(ckpt_dir, step)
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(ckpt_dir)) if m]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: Optional[int] = None,
                       map_location=None) -> Dict[str, Any]:
    """Read the state saved for `step` (the latest one when None)."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    return torch.load(checkpoint_path(ckpt_dir, step), map_location=map_location,
                      weights_only=True)
