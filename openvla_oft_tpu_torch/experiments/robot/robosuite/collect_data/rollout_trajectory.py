"""Replay collected expert trajectories through the simulator to validate a
dataset, on the port (reference
`experiments/robot/robosuite/tasks/collect_data/rollout_trajectory.py`).

Walks `--task_path/task_*/traj*.pkl`, re-creates each episode's environment,
restores the mujoco state, and steps the recorded actions through the
reference's normalize -> discretize(256 bins) -> denormalize round trip —
the same quantization the VLA training data undergoes — so a dataset that
replays successfully here will tokenize losslessly.

The normalization helpers are also importable for tests; the simulator stack
is an external dependency (import-gated), as in collect_task.py.

    python -m openvla_oft_tpu_torch.experiments.robot.robosuite.collect_data.rollout_trajectory \
        --task_path data/pick_place_ur5e --task_name pick_place
"""

from __future__ import annotations

import argparse
import glob
import os
import pickle

import numpy as np

# Action ranges of the fork's OSC_POSE controller
# (reference rollout_trajectory.py:52-58).
NORMALIZATION_RANGES = np.array([
    [-0.35, 0.25],
    [-0.30, 0.30],
    [0.60, 1.20],
    [-3.14, 3.14911766],
    [-3.14911766, 3.14911766],
    [-3.14911766, 3.14911766],
])


def normalize_action(action: np.ndarray, n_action_bin: int,
                     action_ranges: np.ndarray) -> np.ndarray:
    """[-1, 1]-normalize the pose dims (gripper dim passes through), then
    snap to the discrete bin grid (reference rollout_trajectory.py:88-96)."""
    half = n_action_bin // 2
    norm = np.asarray(action, np.float64).copy()
    norm[:-1] = (2 * (norm[:-1] - action_ranges[:, 0])
                 / (action_ranges[:, 1] - action_ranges[:, 0])) - 1
    return (norm * half).astype(np.int32).astype(np.float32) / half


def denormalize_action(norm_action: np.ndarray,
                       action_ranges: np.ndarray) -> np.ndarray:
    action = np.clip(np.asarray(norm_action, np.float64).copy(), -1, 1)
    for d in range(action_ranges.shape[0]):
        action[d] = (0.5 * (action[d] + 1)
                     * (action_ranges[d, 1] - action_ranges[d, 0])
                     ) + action_ranges[d, 0]
    return action


def quantize_roundtrip(action: np.ndarray,
                       n_action_bin: int = 256) -> np.ndarray:
    """normalize -> bin -> denormalize: the replayed action."""
    return denormalize_action(
        normalize_action(action, n_action_bin, NORMALIZATION_RANGES),
        NORMALIZATION_RANGES)


def init_env_from_traj(env, traj, task_name: str) -> None:
    """Place the scene objects where the recorded trajectory had them
    (reference rollout_trajectory.py:106-129). Without this, a replay starts
    from a fresh random layout and the recorded actions diverge immediately."""
    import numpy as np

    if task_name == "pick_place":
        for obj_name in env.object_to_id:
            obj = env.objects[env.object_to_id[obj_name]]
            pos = traj.get(3)["obs"][f"{obj_name}_pos"]
            quat = traj.get(3)["obs"][f"{obj_name}_quat"]
            env.sim.data.set_joint_qpos(obj.joints[0],
                                        np.concatenate([pos, quat]))
    elif task_name == "nut_assembly":
        for obj_name in env.env.nut_to_id:
            obj_id = env.env.nut_to_id[obj_name]
            obj = env.env.nuts[obj_id]
            key = "round-nut" if obj_id == 0 else f"round-nut-{obj_id + 1}"
            pos = traj.get(1)["obs"][f"{key}_pos"]
            quat = traj.get(1)["obs"][f"{key}_quat"]
            env.sim.data.set_joint_qpos(obj.joints[0],
                                        np.concatenate([pos, quat]))


def replay_file(path: str, env_fn, controller_config, task_name: str,
                env_type: str, object_set: int = 2,
                init_env_fn=init_env_from_traj) -> int:
    """Replay one traj*.pkl; returns the number of steps executed."""
    with open(path, "rb") as f:
        sample = pickle.load(f)
    traj = sample["traj"]
    env = env_fn(env_type, controller_type=controller_config, renderer=False,
                 camera_obs=True, task=sample.get("task_id", 0),
                 render_camera="camera_front", object_set=object_set,
                 ret_env=True)
    from robosuite.utils import RandomizationError

    while True:
        try:
            env.reset()
            break
        except RandomizationError:
            continue
    # xml round trip puts the sim in a deterministic restorable state, then
    # the initializer moves objects to the trajectory's recorded poses
    mj_state = env.sim.get_state().flatten()
    env.reset_from_xml_string(env.model.get_xml())
    env.sim.reset()
    env.sim.set_state_from_flattened(mj_state)
    env.sim.forward()
    if init_env_fn is not None:
        init_env_fn(env, traj, task_name)

    steps = 0
    for t in range(sample["len"]):
        step = traj.get(t)
        if t == 0:
            continue
        env.step(quantize_roundtrip(step["action"]))
        steps += 1
    del env
    return steps


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--task_path", default="/")
    p.add_argument("--task_name", default="pick_place")
    p.add_argument("--object_set", default=2, type=int)
    args = p.parse_args()

    from openvla_oft_tpu_torch.experiments.robot.robosuite.collect_data.collect_task import (
        TASK_ENV_MAP, _resolve_expert)
    from robosuite import load_controller_config

    env_fn = _resolve_expert(args.task_name)
    controller_config = load_controller_config(default_controller="OSC_POSE")
    env_type = TASK_ENV_MAP[args.task_name]["ur5e"]

    for task_dir in sorted(glob.glob(os.path.join(args.task_path, "task_*"))):
        for trj in sorted(glob.glob(os.path.join(task_dir, "traj*.pkl"))):
            n = replay_file(trj, env_fn, controller_config, args.task_name,
                            env_type, args.object_set)
            print(f"{trj}: replayed {n} steps")


if __name__ == "__main__":
    main()
