"""BridgeData V2 evaluation utilities on the port (reference
`experiments/robot/bridge/bridgev2_utils.py`).

Env construction is import-gated on the external `widowx_envs` package;
rollout video/data saving and the Octo-style JPEG-roundtrip resize are
dependency-light and usable everywhere. The resize takes no TF: the port's
JPEG round trip (TF's codec, bit for bit) and lanczos3 resize.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from openvla_oft_tpu_torch.processing.image_processing import resize
from openvla_oft_tpu_torch.processing.jpeg import jpeg_roundtrip

DATE_TIME = time.strftime("%Y_%m_%d-%H_%M_%S")


def get_widowx_env_params(cfg) -> dict:
    """Default WidowX env params with the eval config's overrides."""
    from widowx_envs.widowx_env_service import WidowXConfigs

    env_params = WidowXConfigs.DefaultEnvParams.copy()
    env_params["override_workspace_boundaries"] = cfg.bounds
    env_params["camera_topics"] = cfg.camera_topics
    env_params["return_full_image"] = True
    return env_params


def get_widowx_env(cfg, model=None):
    """Connect to the WidowX controller server and wrap it as WidowXGym."""
    from widowx_envs.widowx_env_service import WidowXClient

    from openvla_oft_tpu_torch.experiments.robot.bridge.widowx_env import WidowXGym

    env_params = get_widowx_env_params(cfg)
    env_params["start_state"] = list(
        np.concatenate([cfg.init_ee_pos, cfg.init_ee_quat]))
    widowx_client = WidowXClient(host=cfg.host_ip, port=cfg.port)
    widowx_client.init(env_params)
    return WidowXGym(widowx_client, cfg=cfg, blocking=cfg.blocking)


def get_next_task_label(task_label: str) -> str:
    """Prompt for the next task (blank repeats the previous one)."""
    if task_label == "":
        user_input = ""
        while user_input == "":
            user_input = input("Enter the task name: ")
        task_label = user_input
    else:
        user_input = input("Enter the task name (or leave blank to repeat "
                           "the previous task): ")
        if user_input:
            task_label = user_input
    print(f"Task: {task_label}")
    return task_label


def save_rollout_video(rollout_images, idx: int,
                       out_dir: str = "./rollouts") -> str:
    """MP4 replay of an episode at 5 fps."""
    import imageio

    os.makedirs(out_dir, exist_ok=True)
    mp4_path = os.path.join(out_dir, f"rollout-{DATE_TIME}-{idx + 1}.mp4")
    try:
        writer = imageio.get_writer(mp4_path, fps=5)
    except Exception:
        # no ffmpeg backend — pure-python GIF fallback
        mp4_path = mp4_path[:-4] + ".gif"
        writer = imageio.get_writer(mp4_path, duration=200)
    for img in rollout_images:
        writer.append_data(img)
    writer.close()
    print(f"Saved rollout MP4 at path {mp4_path}")
    return mp4_path


def save_rollout_data(rollout_orig_images, rollout_images, rollout_states,
                      rollout_actions, idx: int,
                      out_dir: str = "./rollouts") -> str:
    """npz bundle of an episode: original + preprocessed images, proprio,
    predicted actions."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"rollout-{DATE_TIME}-{idx + 1}.npz")
    np.savez(path,
             orig_images=np.array(rollout_orig_images),
             images=np.array(rollout_images),
             states=np.array(rollout_states),
             actions=np.array(rollout_actions))
    print(f"Saved rollout data at path {path}")
    return path


def resize_image(img: np.ndarray, resize_size: tuple, device: str = "cuda") -> np.ndarray:
    """JPEG encode/decode + lanczos3 resize — the exact Octo/RLDS training
    preprocessing, reproduced at eval time so inputs stay in-distribution
    (reference bridgev2_utils.py:101-116): what `tf.image.encode_jpeg` (quality
    95), `tf.io.decode_image`, `tf.image.resize(..., "lanczos3",
    antialias=True)`, round and clip give, on `device`."""
    assert isinstance(resize_size, tuple)
    x = jpeg_roundtrip(torch.from_numpy(np.ascontiguousarray(img)).to(device)[None], 95)
    x = torch.clamp(torch.round(resize(x.float(), *resize_size, "lanczos3")), 0, 255)
    return x[0].to(torch.uint8).cpu().numpy()


def get_preprocessed_image(obs: dict, resize_size, device: str = "cuda") -> np.ndarray:
    if isinstance(resize_size, int):
        resize_size = (resize_size, resize_size)
    obs["full_image"] = resize_image(obs["full_image"], resize_size, device)
    return obs["full_image"]


def refresh_obs(obs: dict, env) -> dict:
    new_obs = env.get_observation()
    for key in ("full_image", "image_primary", "proprio"):
        obs[key] = new_obs[key]
    return obs
