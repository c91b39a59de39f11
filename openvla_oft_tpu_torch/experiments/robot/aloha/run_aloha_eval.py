"""ALOHA real-robot client-server evaluation on the port (reference
`experiments/robot/aloha/run_aloha_eval.py`).

Queries the `/act` HTTP server at 25 Hz (STEP_DURATION = 1/25 s), executes
predicted chunks open-loop (optionally as relative joint deltas), records
per-episode model-query time, and takes success from operator y/n input.
The robot env comes from the original ALOHA repo (ROS + interbotix); the
client itself has no robot dependencies and works against the port's deploy
server (`python -m openvla_oft_tpu_torch.serving.deploy`) *or* the
unmodified reference server. The frames are resized on `cfg.device`.

    python -m openvla_oft_tpu_torch.experiments.robot.aloha.run_aloha_eval \
        --vla_server_url <server host> --task_description "fold the towel"
"""

from __future__ import annotations

import dataclasses
import logging
import os
import socket
import time
from collections import deque
from pathlib import Path
from typing import Union

import numpy as np

from openvla_oft_tpu_torch.experiments.robot.aloha.aloha_utils import (
    get_aloha_image,
    get_aloha_wrist_images,
    make_real_env,
    resize_image_for_policy,
    save_rollout_video,
)
from openvla_oft_tpu_torch.serving.server import get_action_from_server

logger = logging.getLogger(__name__)

STEP_DURATION_IN_SEC = 1.0 / 25.0  # 25 Hz control (reference :150-151)


@dataclasses.dataclass
class GenerateConfig:
    # fmt: off
    model_family: str = "openvla"
    pretrained_checkpoint: Union[str, Path] = ""

    center_crop: bool = True
    num_open_loop_steps: int = 25
    use_relative_actions: bool = False

    vla_server_url: str = "localhost"

    max_steps: int = 1500
    num_rollouts_planned: int = 10
    task_description: str = ""

    local_log_dir: str = "./experiments/logs"
    save_videos: bool = True
    seed: int = 7
    device: str = "cuda"                # where the frames are resized ("cpu" in the tests)
    # fmt: on


def get_server_endpoint(cfg: GenerateConfig) -> str:
    ip_address = socket.gethostbyname(cfg.vla_server_url)
    return f"http://{ip_address}:8777/act"


def log_message(message: str, log_file=None):
    print(message)
    if log_file:
        log_file.write(message + "\n")
        log_file.flush()


def prepare_observation(obs, resize_size: int, device: str = "cuda"):
    """Reference run_aloha_eval.py:119-138."""
    img = get_aloha_image(obs)
    left_wrist, right_wrist = get_aloha_wrist_images(obs)
    img_r = resize_image_for_policy(img, resize_size, device)
    left_r = resize_image_for_policy(left_wrist, resize_size, device)
    right_r = resize_image_for_policy(right_wrist, resize_size, device)
    observation = {
        "full_image": img_r,
        "left_wrist_image": left_r,
        "right_wrist_image": right_r,
        "state": np.asarray(obs.observation["qpos"]),
    }
    return observation, img_r, left_r, right_r


def run_episode(cfg: GenerateConfig, env, task_description: str,
                server_endpoint: str, resize_size: int = 224, log_file=None):
    """One 25 Hz episode (reference :141-260)."""
    env.reset()
    action_queue: deque = deque(maxlen=cfg.num_open_loop_steps)
    t = 0
    replay_images = []

    log_message("Prepare the scene, and then press Enter to begin...", log_file)
    input()
    env.reset()
    time.sleep(2)
    curr_state = np.asarray(env.get_qpos())

    episode_start = time.time()
    total_model_query_time = 0.0
    try:
        while t < cfg.max_steps:
            step_start = time.time()
            obs = env.get_observation(t=t)
            replay_images.append(obs.observation["images"]["cam_high"])

            if len(action_queue) == 0:
                observation, *_ = prepare_observation(obs, resize_size, cfg.device)
                observation["instruction"] = task_description
                q0 = time.time()
                actions = get_action_from_server(observation, server_endpoint)
                total_model_query_time += time.time() - q0
                action_queue.extend(np.asarray(actions)[: cfg.num_open_loop_steps])

            action = np.asarray(action_queue.popleft())
            if cfg.use_relative_actions:
                target_state = curr_state + action
                env.step(target_state.tolist())
                curr_state = target_state
            else:
                env.step(action.tolist())
            t += 1

            elapsed = time.time() - step_start
            if elapsed < STEP_DURATION_IN_SEC:
                time.sleep(STEP_DURATION_IN_SEC - elapsed)
    except KeyboardInterrupt:
        log_message("Caught KeyboardInterrupt: terminating episode early.",
                    log_file)
    except Exception as e:
        # reference run_aloha_eval.py:235-239: a transient server/robot error
        # ends THIS episode (operator still records success) instead of
        # aborting the whole real-robot session
        log_message(f"Episode error: {e}", log_file)

    user_input = input("Success? Enter 'y' or 'n': ")
    success = user_input.lower() == "y"
    stats = {
        "success": success,
        "total_steps": t,
        "model_query_time": total_model_query_time,
        "episode_duration": time.time() - episode_start,
    }
    return stats, replay_images


def eval_aloha(cfg: GenerateConfig) -> float:
    os.makedirs(cfg.local_log_dir, exist_ok=True)
    log_file = open(os.path.join(
        cfg.local_log_dir, f"ALOHA-{int(time.time())}.txt"), "w")
    endpoint = get_server_endpoint(cfg)
    env = make_real_env(init_node=True)
    successes = 0
    for ep in range(cfg.num_rollouts_planned):
        stats, replay = run_episode(cfg, env, cfg.task_description, endpoint,
                                    log_file=log_file)
        successes += int(stats["success"])
        if cfg.save_videos:
            save_rollout_video(replay, ep, stats["success"],
                               cfg.task_description)
        log_message(f"episode {ep}: {stats}", log_file)
    rate = successes / max(cfg.num_rollouts_planned, 1)
    log_message(f"success rate: {rate:.2%}", log_file)
    log_file.close()
    return rate


if __name__ == "__main__":
    from openvla_oft_tpu_torch.utils.cli import parse_args

    eval_aloha(parse_args(GenerateConfig))
