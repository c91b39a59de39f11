"""ALOHA evaluation utilities on the port (reference
`experiments/robot/aloha/aloha_utils.py`).

Image extraction from the ALOHA observation dict, the training-matched
resize, and rollout-video helpers; the real-robot env (ROS + interbotix) is
imported only inside `make_real_env`.
"""

from __future__ import annotations

import os
from typing import Any, Tuple

import numpy as np
import torch

from openvla_oft_tpu_torch.processing.image_processing import resize_lanczos3
from openvla_oft_tpu_torch.processing.jpeg import jpeg_roundtrip


def get_aloha_image(obs: Any) -> np.ndarray:
    """High (third-person) camera frame."""
    return np.asarray(obs.observation["images"]["cam_high"])


def get_aloha_wrist_images(obs: Any) -> Tuple[np.ndarray, np.ndarray]:
    """Left + right wrist camera frames."""
    images = obs.observation["images"]
    return (np.asarray(images["cam_left_wrist"]),
            np.asarray(images["cam_right_wrist"]))


def resize_image_for_policy(img: np.ndarray, resize_size: int,
                            device: str = "cuda") -> np.ndarray:
    """The training-matched conditioning (reference openvla_utils.py:516-539):
    the JPEG round trip at quality 95 (TF's codec, bit for bit), the lanczos3
    resize to `resize_size`, then round and clip to uint8, on `device`."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    x = jpeg_roundtrip(torch.from_numpy(np.ascontiguousarray(img)).to(device)[None])
    x = torch.clamp(torch.round(resize_lanczos3(x.float(), resize_size)), 0, 255)
    return x[0].to(torch.uint8).cpu().numpy()


def make_real_env(*args, **kwargs):
    """Construct the real ALOHA env (ROS + interbotix). Import-gated: the
    original ALOHA repo's `real_env.make_real_env` must be on sys.path
    (reference experiments/robot/aloha/real_env.py:18-165)."""
    try:
        from aloha.real_env import make_real_env as _make  # type: ignore
    except ImportError as e:
        raise ImportError(
            "The ALOHA real-robot environment requires the original ALOHA "
            "repo (ROS + interbotix) on sys.path; see ALOHA.md in the "
            "reference for setup.") from e
    return _make(*args, **kwargs)


def save_rollout_video(images, idx: int, success: bool, task_description: str,
                       suffix: str = "", rollout_dir: str = "./rollouts"):
    """MP4 writer mirroring the reference's aloha_utils helper; None where
    imageio is missing."""
    os.makedirs(rollout_dir, exist_ok=True)
    tag = "success" if success else "failure"
    safe = "".join(c if c.isalnum() else "_" for c in task_description[:40])
    path = os.path.join(rollout_dir, f"episode={idx}--{tag}--{safe}{suffix}.mp4")
    try:
        import imageio

        try:
            w = imageio.get_writer(path, fps=25)
        except Exception:
            # no ffmpeg backend: pure-python GIF fallback
            path = path[:-4] + ".gif"
            w = imageio.get_writer(path, duration=40)
        with w:
            for img in images:
                w.append_data(np.asarray(img))
    except ImportError:
        path = None
    return path
