"""LIBERO evaluation utilities (reference
`experiments/robot/libero/libero_utils.py:18-100`).

The LIBERO simulator package is an optional dependency: everything that
touches it imports it inside the function, while the observation processing
and the rollout writers work without it. Where `imageio` is missing (as on
the card's machine), a rollout is written as PNG frames by `write_png`,
which needs only the standard library.
"""

from __future__ import annotations

import math
import os
import struct
import zlib
from typing import Any, Dict

import numpy as np


def get_libero_env(task: Any, model_family: str = "openvla", resolution: int = 256):
    """Build the OffScreenRenderEnv for a LIBERO task (reference :18-26)."""
    from libero.libero import get_libero_path
    from libero.libero.envs import OffScreenRenderEnv

    task_description = task.language
    task_bddl_file = os.path.join(get_libero_path("bddl_files"), task.problem_folder,
                                  task.bddl_file)
    env_args = {"bddl_file_name": task_bddl_file, "camera_heights": resolution,
                "camera_widths": resolution}
    env = OffScreenRenderEnv(**env_args)
    env.seed(0)
    return env, task_description


def get_libero_dummy_action(model_family: str = "openvla"):
    """No-op action for the settle period (reference :29-31)."""
    return [0, 0, 0, 0, 0, 0, -1]


def get_libero_image(obs: Dict[str, Any]) -> np.ndarray:
    """Third-person camera image, flipped upright (reference :34-39)."""
    img = obs["agentview_image"]
    return img[::-1, ::-1]


def get_libero_wrist_image(obs: Dict[str, Any]) -> np.ndarray:
    """Wrist camera image, flipped upright (reference :42-47)."""
    img = obs["robot0_eye_in_hand_image"]
    return img[::-1, ::-1]


def quat2axisangle(quat: np.ndarray) -> np.ndarray:
    """Quaternion (x, y, z, w) -> axis-angle (reference :63-86, from
    robosuite transform_utils)."""
    quat = np.asarray(quat, np.float64)
    if quat[3] > 1.0:
        quat[3] = 1.0
    elif quat[3] < -1.0:
        quat[3] = -1.0
    den = np.sqrt(1.0 - quat[3] * quat[3])
    if math.isclose(den, 0.0):
        return np.zeros(3)
    return (quat[:3] * 2.0 * math.acos(quat[3])) / den


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray) -> None:
    """One uint8 (H, W, 3) RGB frame as an 8-bit truecolor PNG: the
    signature, IHDR, one IDAT of the zlib-compressed scanlines (each behind
    filter byte 0) and IEND."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[-1] != 3:
        raise ValueError(f"expected a uint8 (H, W, 3) frame, got {image.dtype} {image.shape}")
    h, w, _ = image.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), image.reshape(h, 3 * w)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
                + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _png_chunk(b"IEND", b""))


def save_rollout_video(rollout_images, idx, success, task_description, log_file=None,
                       rollout_dir: str = "./rollouts"):
    """Write an MP4 of one episode (reference :47-60); without imageio, about
    20 of its frames as PNGs in a directory of the same name."""
    os.makedirs(rollout_dir, exist_ok=True)
    tag = "success" if success else "failure"
    safe_task = "".join(c if c.isalnum() else "_" for c in task_description[:40])
    path = os.path.join(rollout_dir, f"episode={idx}--{tag}--{safe_task}.mp4")
    try:
        import imageio
    except ImportError:
        imageio = None
    if imageio is not None:
        try:
            writer = imageio.get_writer(path, fps=30)
        except Exception:
            # no ffmpeg backend on this host: pure-python GIF fallback
            path = path[:-4] + ".gif"
            writer = imageio.get_writer(path, duration=33)
        with writer:
            for img in rollout_images:
                writer.append_data(img)
    else:
        path = path.replace(".mp4", "")
        os.makedirs(path, exist_ok=True)
        for i, img in enumerate(rollout_images[:: max(len(rollout_images) // 20, 1)]):
            write_png(os.path.join(path, f"{i:04d}.png"), np.asarray(img))
    if log_file is not None:
        log_file.write(f"Saved rollout video at path {path}\n")
    return path
