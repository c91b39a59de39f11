"""The robot-eval dispatcher on the port.

The port's copy of `experiments/robot/robot_utils.py` (reference
`set_seed_everywhere` :38, `get_model` :54, `get_image_resize_size` :77,
`get_action` :99, the gripper conventions :149-199): the eval clients call
these for every model family, and the "openvla" family goes to the port's
`get_vla` and `get_vla_action`.
"""

from __future__ import annotations

import random
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from openvla_oft_tpu_torch.serving.openvla_utils import get_vla, get_vla_action

DATE_FORMAT = "%Y_%m_%d"
OPENVLA_IMAGE_SIZE = 224


def set_seed_everywhere(seed: int) -> None:
    """Seed numpy, `random` and torch (every CUDA device included), as the
    reference's robot_utils.py:38-51 does."""
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)


def get_model(cfg: Any, wrap_diffusion_policy_for_droid: bool = False):
    """The policy of `cfg.model_family` (reference robot_utils.py:54-74)."""
    if cfg.model_family == "openvla":
        return get_vla(cfg)
    raise ValueError(f"Unsupported model family: {cfg.model_family}")


def get_image_resize_size(cfg: Any) -> int:
    """Reference robot_utils.py:77-96."""
    if cfg.model_family == "openvla":
        return OPENVLA_IMAGE_SIZE
    raise ValueError(f"Unsupported model family: {cfg.model_family}")


def get_action(cfg: Any, model, obs: Dict[str, Any], task_label: str,
               processor: Optional[Any] = None, action_head=None, proprio_projector=None,
               noisy_action_projector=None, use_film: bool = False
               ) -> Union[List[np.ndarray], np.ndarray]:
    """One observation -> the open-loop actions (reference
    robot_utils.py:99-147)."""
    if cfg.model_family == "openvla":
        return get_vla_action(cfg=cfg, vla=model, processor=processor, obs=obs,
                              task_label=task_label, action_head=action_head,
                              proprio_projector=proprio_projector,
                              noisy_action_projector=noisy_action_projector, use_film=use_film)
    raise ValueError(f"Unsupported model family: {cfg.model_family}")


def normalize_gripper_action(action: np.ndarray, binarize: bool = True) -> np.ndarray:
    """The last dim from [0, 1] to [-1, +1], then its sign with `binarize`
    (reference robot_utils.py:149-177)."""
    normalized = action.copy()
    normalized[..., -1] = 2 * (normalized[..., -1] - 0.0) / (1.0 - 0.0) - 1
    if binarize:
        normalized[..., -1] = np.sign(normalized[..., -1])
    return normalized


def invert_gripper_action(action: np.ndarray) -> np.ndarray:
    """The gripper's sign flipped (reference robot_utils.py:180-199)."""
    inverted = action.copy()
    inverted[..., -1] *= -1.0
    return inverted
