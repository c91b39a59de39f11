"""LIBERO benchmark evaluation on the port (reference
`experiments/robot/libero/run_libero_eval.py:81-535`).

Reproduces the reference protocol: per-suite max episode steps, 50 trials per
task, a 10-step settle wait, open-loop execution of the predicted action
chunk through an action queue, success from the env's `done`, rollout videos,
and a run-ID-stamped local log. The policy runs on `cfg.device` (the card
unless the caller asks for the CPU). Requires the LIBERO simulator package,
imported where the suite is built.

    python -m openvla_oft_tpu_torch.experiments.robot.libero.run_libero_eval \
        --pretrained_checkpoint /path/to/ckpt --task_suite_name libero_spatial
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from collections import deque
from pathlib import Path
from typing import Optional, Union

import numpy as np

from openvla_oft_tpu_torch.experiments.robot.libero.libero_utils import (
    get_libero_dummy_action,
    get_libero_env,
    get_libero_image,
    get_libero_wrist_image,
    quat2axisangle,
    save_rollout_video,
)
from openvla_oft_tpu_torch.serving.openvla_utils import (
    get_action_head,
    get_processor,
    get_proprio_projector,
    get_noisy_action_projector,
)
from openvla_oft_tpu_torch.serving.robot_utils import (
    get_action,
    get_image_resize_size,
    get_model,
    invert_gripper_action,
    normalize_gripper_action,
    set_seed_everywhere,
)

logger = logging.getLogger(__name__)

# Per-suite episode-step limits (reference run_libero_eval.py:54-69).
TASK_MAX_STEPS = {
    "libero_spatial": 220,
    "libero_object": 280,
    "libero_goal": 300,
    "libero_10": 520,
    "libero_90": 400,
}
NUM_ACTIONS_CHUNK = 8


@dataclasses.dataclass
class GenerateConfig:
    # fmt: off
    model_family: str = "openvla"
    pretrained_checkpoint: Union[str, Path] = ""

    use_l1_regression: bool = True
    use_diffusion: bool = False
    num_diffusion_steps_inference: int = 50
    use_film: bool = False
    num_images_in_input: int = 2
    use_proprio: bool = True

    center_crop: bool = True
    # Preprocessing and un-normalization in one pass on the device
    # (policy.predict_action_from_frames; L1 head only, no JPEG round trip)
    device_preprocess: bool = False
    num_open_loop_steps: int = NUM_ACTIONS_CHUNK
    unnorm_key: Union[str, Path] = ""

    load_in_8bit: bool = False
    load_in_4bit: bool = False

    task_suite_name: str = "libero_spatial"
    num_steps_wait: int = 10
    num_trials_per_task: int = 50
    initial_states_path: str = "DEFAULT"
    env_img_res: int = 256

    run_id_note: Optional[str] = None
    local_log_dir: str = "./experiments/logs"

    use_wandb: bool = False
    wandb_entity: str = "your-wandb-entity"
    wandb_project: str = "your-wandb-project"

    seed: int = 7
    device: str = "cuda"                # where the policy runs ("cpu" in the tests)
    # fmt: on


DATE_TIME = time.strftime("%Y_%m_%d-%H_%M_%S")


def check_unnorm_key(cfg: GenerateConfig, model) -> None:
    """Resolve the action-unnorm key against the checkpoint's norm_stats
    (reference run_libero_eval.py:177-190): default to the task suite name,
    fall back to its `_no_noops` variant, and fail loudly when absent."""
    if model.norm_stats is None:
        return  # random-init smoke checkpoints carry no stats
    unnorm_key = str(cfg.unnorm_key) or cfg.task_suite_name
    if unnorm_key not in model.norm_stats \
            and f"{unnorm_key}_no_noops" in model.norm_stats:
        unnorm_key = f"{unnorm_key}_no_noops"
    assert unnorm_key in model.norm_stats, \
        f"Action un-norm key {unnorm_key} not found in VLA `norm_stats`!"
    cfg.unnorm_key = unnorm_key


def load_initial_states(cfg: GenerateConfig, task_suite, task_id: int):
    """Default suite states + the optional custom-states JSON
    (reference run_libero_eval.py:225-238)."""
    initial_states = task_suite.get_task_init_states(task_id)
    if cfg.initial_states_path != "DEFAULT":
        with open(cfg.initial_states_path) as f:
            all_initial_states = json.load(f)
        return initial_states, all_initial_states
    return initial_states, None


def validate_config(cfg: GenerateConfig) -> None:
    """Reference run_libero_eval.py:131-141."""
    assert cfg.pretrained_checkpoint, "pretrained_checkpoint must not be empty!"
    if "image_aug" in str(cfg.pretrained_checkpoint):
        assert cfg.center_crop, \
            "Expecting center_crop=True because model was trained with image augmentations!"
    assert not (cfg.load_in_8bit and cfg.load_in_4bit), \
        "Cannot use both 8-bit and 4-bit quantization!"


def initialize_model(cfg: GenerateConfig):
    """Reference run_libero_eval.py:144-174."""
    model = get_model(cfg)
    processor = get_processor(cfg)
    action_head = None
    if cfg.use_l1_regression or cfg.use_diffusion:
        try:
            action_head = get_action_head(cfg, model.cfg.llm_dim)
        except (AssertionError, FileNotFoundError):
            pass
    proprio_projector = None
    if cfg.use_proprio:
        try:
            proprio_projector = get_proprio_projector(
                cfg, model.cfg.llm_dim, model.platform.proprio_dim)
        except (AssertionError, FileNotFoundError):
            pass
    noisy_action_projector = None
    if cfg.use_diffusion:
        try:
            noisy_action_projector = get_noisy_action_projector(
                cfg, model.cfg.llm_dim)
        except (AssertionError, FileNotFoundError):
            pass
    return model, processor, action_head, proprio_projector, noisy_action_projector


def prepare_observation(obs, resize_size: int):
    """Reference run_libero_eval.py:241-260."""
    img = get_libero_image(obs)
    wrist_img = get_libero_wrist_image(obs)
    observation = {
        "full_image": img,
        "wrist_image": wrist_img,
        "state": np.concatenate(
            (obs["robot0_eef_pos"], quat2axisangle(obs["robot0_eef_quat"]),
             obs["robot0_gripper_qpos"])),
    }
    return observation, img


def process_action(action: np.ndarray, model_family: str) -> np.ndarray:
    """Gripper conventions (reference run_libero_eval.py:263-273)."""
    action = normalize_gripper_action(action, binarize=True)
    if model_family == "openvla":
        action = invert_gripper_action(action)
    return action


def run_episode(cfg, env, task_description, model, resize_size, processor,
                action_head, proprio_projector, noisy_action_projector,
                initial_state=None, log_file=None):
    """Reference run_libero_eval.py:276-357."""
    env.reset()
    if initial_state is not None:
        obs = env.set_init_state(initial_state)
    else:
        obs = env.get_observation()

    t = 0
    replay_images = []
    max_steps = TASK_MAX_STEPS[cfg.task_suite_name]
    action_queue: deque = deque(maxlen=cfg.num_open_loop_steps)
    success = False
    # One episode's failure must not kill a multi-hour eval: the reference
    # wraps the step loop and counts the episode as a failure
    # (run_libero_eval.py:313-356).
    try:
        while t < max_steps + cfg.num_steps_wait:
            if t < cfg.num_steps_wait:
                obs, _, done, _ = env.step(
                    get_libero_dummy_action(cfg.model_family))
                t += 1
                continue
            observation, img = prepare_observation(obs, resize_size)
            replay_images.append(img)
            if len(action_queue) == 0:
                actions = get_action(
                    cfg, model, observation, task_description,
                    processor=processor, action_head=action_head,
                    proprio_projector=proprio_projector,
                    noisy_action_projector=noisy_action_projector,
                    use_film=cfg.use_film)
                action_queue.extend(actions)
            action = action_queue.popleft()
            action = process_action(action, cfg.model_family)
            obs, _, done, _ = env.step(action.tolist())
            if done:
                success = True
                break
            t += 1
    except Exception as e:
        msg = f"Episode error: {e}"
        print(msg)
        if log_file:
            log_file.write(msg + "\n")
    return success, replay_images


def run_task(cfg, task_suite, task_id, model, resize_size, processor,
             action_head, proprio_projector, noisy_action_projector,
             total_episodes, total_successes, log_file=None):
    """Reference run_libero_eval.py:360-456."""
    task = task_suite.get_task(task_id)
    initial_states, all_initial_states = load_initial_states(cfg, task_suite,
                                                             task_id)
    env, task_description = get_libero_env(task, cfg.model_family,
                                           resolution=cfg.env_img_res)
    task_episodes, task_successes = 0, 0
    for episode_idx in range(cfg.num_trials_per_task):
        if all_initial_states is not None:
            # custom-states protocol (reference run_libero_eval.py:388-404):
            # skip episodes whose expert demo failed
            task_key = task_description.replace(" ", "_")
            ep = all_initial_states[task_key][f"demo_{episode_idx}"]
            if not ep["success"]:
                msg = (f"Skipping task {task_id} episode {episode_idx} due "
                       f"to failed expert demo!")
                print(msg)
                if log_file:
                    log_file.write(msg + "\n")
                continue
            initial_state = np.array(ep["initial_state"])
        else:
            initial_state = initial_states[episode_idx]
        success, replay_images = run_episode(
            cfg, env, task_description, model, resize_size, processor,
            action_head, proprio_projector, noisy_action_projector,
            initial_state=initial_state, log_file=log_file)
        task_episodes += 1
        total_episodes += 1
        if success:
            task_successes += 1
            total_successes += 1
        save_rollout_video(replay_images, total_episodes, success,
                           task_description, log_file=log_file)
        msg = (f"# episodes completed so far: {total_episodes} "
               f"# successes: {total_successes} "
               f"({total_successes / max(total_episodes, 1) * 100:.1f}%)")
        print(msg)
        if log_file:
            log_file.write(msg + "\n")
    env.close()
    return total_episodes, total_successes, task_episodes, task_successes


def eval_libero(cfg: GenerateConfig) -> float:
    """Reference run_libero_eval.py:459-531. Returns overall success rate."""
    validate_config(cfg)
    set_seed_everywhere(cfg.seed)
    model, processor, action_head, proprio_projector, noisy_action_projector = \
        initialize_model(cfg)
    check_unnorm_key(cfg, model)
    resize_size = get_image_resize_size(cfg)

    from libero.libero import benchmark

    benchmark_dict = benchmark.get_benchmark_dict()
    task_suite = benchmark_dict[cfg.task_suite_name]()
    num_tasks = task_suite.n_tasks

    os.makedirs(cfg.local_log_dir, exist_ok=True)
    # timestamped run id (reference :196) so reruns never overwrite logs
    run_id = f"EVAL-{cfg.task_suite_name}-{cfg.model_family}-{DATE_TIME}" \
             f"-seed{cfg.seed}"
    if cfg.run_id_note:
        run_id += f"--{cfg.run_id_note}"
    log_file = open(os.path.join(cfg.local_log_dir, run_id + ".txt"), "w")
    wandb_run = None
    if cfg.use_wandb:
        import wandb

        wandb_run = wandb.init(entity=cfg.wandb_entity,
                               project=cfg.wandb_project, name=run_id)

    total_episodes, total_successes = 0, 0
    for task_id in range(num_tasks):
        total_episodes, total_successes, task_episodes, task_successes = run_task(
            cfg, task_suite, task_id, model, resize_size, processor,
            action_head, proprio_projector, noisy_action_projector,
            total_episodes, total_successes, log_file)
        print(f"Task {task_id} success rate: "
              f"{task_successes / max(task_episodes, 1):.2%}")
    rate = total_successes / max(total_episodes, 1)
    print(f"Overall success rate: {rate:.2%}")
    log_file.write(f"Overall success rate: {rate:.2%}\n")
    log_file.close()
    if wandb_run is not None:
        wandb_run.log({"success_rate/total": rate,
                       "num_episodes/total": total_episodes})
        wandb_run.finish()
    return rate


if __name__ == "__main__":
    from openvla_oft_tpu_torch.utils.cli import parse_args

    eval_libero(parse_args(GenerateConfig))
