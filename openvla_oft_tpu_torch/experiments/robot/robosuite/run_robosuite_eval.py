"""UR5e robosuite pick-place evaluation on the port (fork-added reference
`experiments/robot/robosuite/run_robosuite_eval.py:44-57+`).

16 task variations per suite; per-episode success from the reach/pick/place
predicates in robosuite_utils. Requires robosuite + mujoco (import-gated).
The policy (UR5e: proprio 6, 8-step chunks) runs on `cfg.device`.

    python -m openvla_oft_tpu_torch.experiments.robot.robosuite.run_robosuite_eval \
        --pretrained_checkpoint /path/to/ckpt --controller_path osc_pose.json
"""

from __future__ import annotations

import dataclasses
from collections import deque
from pathlib import Path
from typing import Optional, Union

import numpy as np

from openvla_oft_tpu_torch.experiments.robot.robosuite.robosuite_utils import (
    build_env_context,
    check_pick,
    check_reach,
    convert_action_to_world,
    crop_front_image,
    prepare_observation,
)
from openvla_oft_tpu_torch.serving.openvla_utils import (get_action_head, get_processor,
                                                         get_proprio_projector)
from openvla_oft_tpu_torch.serving.robot_utils import get_action, get_model


@dataclasses.dataclass
class GenerateConfig:
    # fmt: off
    model_family: str = "openvla"
    pretrained_checkpoint: Union[str, Path] = ""

    use_l1_regression: bool = True
    use_diffusion: bool = False
    use_film: bool = False
    num_images_in_input: int = 2
    use_proprio: bool = True
    center_crop: bool = True
    num_open_loop_steps: int = 8
    unnorm_key: str = "ur5e_pick_place"

    env_name: str = "ur5e_pick_place"
    task_suite_name: str = "ur5e_pick_place"   # 'abs_pose' in the name ->
                                               # absolute-position actions
    task_name: str = "pick_place"
    object_set: int = 2
    controller_path: str = ""
    num_variations: int = 16
    num_trials_per_variation: int = 10
    max_steps: int = 400
    seed: int = 7
    local_log_dir: str = "./experiments/logs"
    device: str = "cuda"                # where the policy runs ("cpu" in the tests)
    # fmt: on


def task_instruction(cfg: GenerateConfig, variation: int) -> str:
    """Language instruction from the fork's command.json (the text the
    policy was trained on — reference conditions on TASK_COMMAND, not a
    synthetic phrase)."""
    from openvla_oft_tpu_torch.experiments.robot.robosuite.collect_data.collect_task import (
        TASK_COMMAND, _command_key)

    key = _command_key(cfg.task_name, cfg.object_set)
    return TASK_COMMAND[key][str(variation)]


def _target_object_pos(obs) -> Optional[np.ndarray]:
    """Per-object keys, reference test/pick_place.py:148-150: the env exposes
    '{name}_pos' per object and 'target-object' as an index into obj_names."""
    names = ["greenbox", "yellowbox", "bluebox", "redbox"]
    tid = obs.get("target-object")
    if tid is None:
        return None
    name = names[int(tid)] if int(tid) < len(names) else None
    return np.asarray(obs[f"{name}_pos"]) if name and f"{name}_pos" in obs \
        else None


def run_episode(cfg, env, model, processor, action_head, proprio_projector,
                task_description: str):
    """Reference protocol (test/pick_place.py:60-160): actions are converted
    to OSC world space (delta->world pos, euler->negated axis-angle,
    binarized gripper), gripper_closed is tracked from the executed command,
    SUCCESS comes from the env reward, and a sim exception fails only this
    episode. The geometry predicates remain as auxiliary diagnostics."""
    obs = env.reset()
    action_queue: deque = deque(maxlen=cfg.num_open_loop_steps)
    tasks = {"success": False, "reached": False, "picked": False}
    gripper_closed = 0.0
    start_z = None
    abs_pose = "abs_pose" in cfg.task_suite_name
    try:
        for t in range(cfg.max_steps):
            obs["camera_front_image"] = crop_front_image(
                np.asarray(obs["camera_front_image"]), cfg.task_name)
            observation = prepare_observation(obs, gripper_closed=gripper_closed,
                                              device=cfg.device)
            if len(action_queue) == 0:
                actions = get_action(
                    cfg, model, observation, task_description,
                    processor=processor, action_head=action_head,
                    proprio_projector=proprio_projector,
                    use_film=cfg.use_film)
                action_queue.extend(actions)
            action = action_queue.popleft()
            world_action, gripper_closed = convert_action_to_world(
                np.asarray(action), np.asarray(obs.get("eef_pos",
                                                       np.zeros(3))),
                abs_pose=abs_pose)
            obs, reward, done, info = env.step(world_action)
            tasks["success"] = bool(tasks["success"] or reward == 1)
            obj_pos = _target_object_pos(obs)
            if obj_pos is not None:
                if start_z is None:
                    start_z = obj_pos[2]
                eef = np.asarray(obs.get("eef_pos", np.zeros(3)))
                tasks["reached"] = check_reach(0.03, obj_pos - eef,
                                               tasks["reached"])
                tasks["picked"] = check_pick(0.05, obj_pos[2], start_z,
                                             tasks["reached"],
                                             tasks["picked"])
            if done or tasks["success"]:
                break
    except Exception as e:  # sim fault costs one episode, not the run
        print(f"Episode error: {e}")
        tasks["success"] = False
    return tasks["success"]


def eval_robosuite(cfg: GenerateConfig) -> float:
    model = get_model(cfg)
    processor = get_processor(cfg)
    action_head = proprio_projector = None
    try:
        action_head = get_action_head(cfg, model.cfg.llm_dim)
        proprio_projector = get_proprio_projector(cfg, model.cfg.llm_dim,
                                                  model.platform.proprio_dim)
    except (AssertionError, FileNotFoundError):
        pass

    successes = episodes = 0
    for variation in range(cfg.num_variations):
        env = build_env_context(cfg.env_name, cfg.controller_path, variation,
                                cfg.seed)
        for _ in range(cfg.num_trials_per_variation):
            ok = run_episode(cfg, env, model, processor, action_head,
                             proprio_projector,
                             task_instruction(cfg, variation))
            successes += int(ok)
            episodes += 1
    rate = successes / max(episodes, 1)
    print(f"robosuite success rate: {rate:.2%}")
    return rate


if __name__ == "__main__":
    from openvla_oft_tpu_torch.utils.cli import parse_args

    eval_robosuite(parse_args(GenerateConfig))
