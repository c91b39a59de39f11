"""Expert-trajectory collection for the robosuite multi-task benchmark, on
the port (reference
`experiments/robot/robosuite/tasks/collect_data/collect_task.py`).

Drives the fork's scripted expert controllers to roll out demonstrations and
writes them in the exact on-disk protocol the downstream dataloaders expect:

    save_dir/info.json
    save_dir/task_00/traj000.pkl   # {traj, len, env_type, command, task_id}
    save_dir/task_00/traj001.pkl
    ...

The seed schedule (base 263237945, per-group strides) reproduces the
reference's deterministic environment sampling, so datasets collected here
are interchangeable with upstream ones.

The simulator stack (`robosuite` + the fork's 14.4k-LoC
`multi_task_robosuite_env` package with its expert controllers) is an
external dependency exactly as in the reference — install it next to this
repo; imports are gated with a clear error. `command.json` (the per-subtask
language instructions) is carried verbatim: it is training data, not code.

Redesigns vs the reference: no torch/CUDA dependency (GPU-indexed rendering
becomes `--render_device`), a pure function core (`save_rollout`) that takes
the env builder as an argument (testable without mujoco), and failed expert
rollouts retry with a bounded budget instead of a single silent retry.

    python -m openvla_oft_tpu_torch.experiments.robot.robosuite.collect_data.collect_task \
        data/pick_place_ur5e --task_name pick_place --robot ur5e --N 16
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import pickle
import random
from multiprocessing import Pool, cpu_count
from typing import Callable, Dict, List, Optional, Sequence

_HERE = os.path.dirname(os.path.abspath(__file__))

SEED_BASE = 263237945          # reference seed schedule (collect_task.py:178)
ENV_CHOICE_SEED = 385008283
ROBOT_NAMES = ("panda", "sawyer", "ur5e")

# (task -> subtask count / env names per robot / object set). The env builder
# (`env_fn`) is resolved lazily from the external expert-controller package.
TASK_ENV_MAP: Dict[str, Dict] = {
    "pick_place": {
        "n_task": 16, "object_set": 2, "expert": "expert_pick_place",
        "panda": "Panda_PickPlaceDistractor",
        "sawyer": "Sawyer_PickPlaceDistractor",
        "ur5e": "UR5e_PickPlaceDistractor",
    },
    "nut_assembly": {
        "n_task": 9, "object_set": 1, "expert": "expert_nut_assembly",
        "panda": "Panda_NutAssemblyDistractor",
        "sawyer": "Sawyer_NutAssemblyDistractor",
        "ur5e": "UR5e_NutAssemblyDistractor",
    },
    "block_stacking": {
        "n_task": 6, "object_set": 1, "expert": "expert_block_stacking",
        "panda": "Panda_BlockStacking",
        "sawyer": "Sawyer_BlockStacking",
        "ur5e": "UR5e_BlockStacking",
    },
    "press_button": {
        "n_task": 6, "object_set": 1, "expert": "expert_button",
        "panda": "Panda_Button",
        "sawyer": "Sawyer_Button",
        "ur5e": "UR5e_Button",
    },
}

with open(os.path.join(_HERE, "command.json")) as _f:
    TASK_COMMAND = json.load(_f)


def _resolve_expert(task_name: str) -> Callable:
    """Import the fork's scripted expert for `task_name` (external package)."""
    module = TASK_ENV_MAP[task_name]["expert"]
    try:
        import importlib

        mod = importlib.import_module(
            f"multi_task_robosuite_env.controllers.controllers.{module}")
        return mod.get_expert_trajectory
    except ImportError as e:
        raise ImportError(
            "Expert data collection needs the external robosuite task "
            "package (multi_task_robosuite_env) + robosuite, as in the "
            "reference setup (experiments/robot/robosuite/README). "
            f"Missing: {e}") from e


def _controller_config(ctrl_config: str):
    from robosuite import load_controller_config

    if ctrl_config in ("IK_POSE", "OSC_POSE"):
        return load_controller_config(default_controller=ctrl_config)
    return load_controller_config(custom_fpath=ctrl_config)


def _command_key(task_name: str, object_set: int) -> str:
    """The command.json entry of a task: pick-place's object set 2 (the
    green, yellow, blue and red boxes) is "pick_place", set 1 (milk, bread,
    cereal, can) "pick_place_set_1". The JAX copy maps set 2 to
    "pick_place_set_2", which command.json lacks."""
    if task_name == "pick_place":
        return "pick_place" if object_set == 2 else f"pick_place_set_{object_set}"
    return task_name


def make_seed_schedule(n: int, n_tasks: int, per_task_group: int,
                       random_seed: bool = False,
                       n_env: Optional[int] = None) -> List[Optional[int]]:
    """The reference's deterministic seed schedule (collect_task.py:175-185)."""
    if random_seed:
        return [None] * n
    if n_env:
        envs = [SEED_BASE + i for i in range(n_env)]
        rng = random.Random(ENV_CHOICE_SEED)
        return [int(rng.choice(envs)) for _ in range(n)]
    return [SEED_BASE + (i // (n_tasks * per_task_group)) * per_task_group
            + i % per_task_group for i in range(n)]


def save_rollout(
    indices,
    task_name: str,
    env_type: str,
    env_func: Callable,
    save_dir: str,
    n_tasks: int,
    seeds: Optional[Sequence[Optional[int]]] = None,
    env_seed: bool = False,
    camera_obs: bool = True,
    n_per_group: int = 1,
    ctrl_config: str = "IK_POSE",
    renderer: bool = False,
    render_device: int = 0,
    object_set: int = 1,
    color: bool = False,
    shape: bool = False,
    max_retries: int = 3,
    controller_loader: Callable = _controller_config,
) -> List[str]:
    """Roll out expert trajectories for trajectory indices `indices` and
    write them under save_dir/task_XX/trajNNN.pkl. Returns written paths."""
    if isinstance(indices, int):
        indices = [indices]
    command_key = _command_key(task_name, object_set)
    written = []
    for n in indices:
        task = int((n % (n_tasks * n_per_group)) // n_per_group)
        seed = None if seeds is None else seeds[n]
        ep_env_seed = (seeds[n - n % n_per_group]
                       if seeds is not None and env_seed else None)
        config = controller_loader(ctrl_config)
        kwargs = dict(controller_type=config, renderer=renderer,
                      camera_obs=camera_obs, task=task, seed=seed,
                      env_seed=ep_env_seed, gpu_id=render_device)
        if color or shape:
            assert "BlockStacking" in env_type, env_type
            kwargs.update(color=color, shape=shape)
        else:
            kwargs.update(render_camera="camera_front", object_set=object_set)

        traj = env_func(env_type, **kwargs)
        retries = 0
        while len(traj) < 5 and retries < max_retries:  # expert failed; retry
            retries += 1
            traj = env_func(env_type, **kwargs)

        group = n // (n_tasks * n_per_group)
        traj_idx = n % n_per_group + n_per_group * group
        task_dir = os.path.join(save_dir, f"task_{task:02d}")
        os.makedirs(task_dir, exist_ok=True)
        path = os.path.join(task_dir, f"traj{traj_idx:03d}.pkl")
        with open(path, "wb") as f:
            pickle.dump({
                "traj": traj,
                "len": len(traj),
                "env_type": env_type,
                "command": TASK_COMMAND[command_key][str(task)],
                "task_id": task,
            }, f)
        written.append(path)
        del traj
    return written


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("save_dir")
    p.add_argument("--task_name", "-tsk", default="nut_assembly",
                   choices=sorted(TASK_ENV_MAP))
    p.add_argument("--robot", "-ro", default="panda", choices=ROBOT_NAMES)
    p.add_argument("--N", default=10, type=int)
    p.add_argument("--per_task_group", default=100, type=int)
    p.add_argument("--n_tasks", default=12, type=int)
    p.add_argument("--num_workers", default=cpu_count(), type=int)
    p.add_argument("--ctrl_config", default="IK_POSE")
    p.add_argument("--object_set", default=1, type=int)
    p.add_argument("--collect_cam", action="store_true")
    p.add_argument("--renderer", action="store_true")
    p.add_argument("--random_seed", action="store_true")
    p.add_argument("--n_env", default=None, type=int)
    p.add_argument("--give_env_seed", action="store_true")
    p.add_argument("--render_device", default=0, type=int)
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--color", action="store_true")
    p.add_argument("--shape", action="store_true")
    args = p.parse_args(argv)

    assert args.num_workers > 0
    assert args.task_name in args.save_dir and args.robot in args.save_dir, (
        "save_dir must name the task and robot (reference convention), got "
        f"{args.save_dir!r}")
    if os.path.isdir(args.save_dir) and os.listdir(args.save_dir):
        assert args.overwrite, \
            f"{args.save_dir} is non-empty; pass --overwrite to add to it"
    os.makedirs(args.save_dir, exist_ok=True)

    if args.task_name == "pick_place":
        TASK_ENV_MAP["pick_place"]["object_set"] = args.object_set
    spec = TASK_ENV_MAP[args.task_name]
    env_name = spec[args.robot]
    env_fn = _resolve_expert(args.task_name)
    seeds = make_seed_schedule(args.N, args.n_tasks, args.per_task_group,
                               args.random_seed, args.n_env)

    with open(os.path.join(args.save_dir, "info.json"), "w") as f:
        json.dump({"robot": args.robot, "task": args.task_name,
                   "env_type": env_name, "n_tasks": args.n_tasks,
                   "task_group_size": args.per_task_group}, f)

    worker = functools.partial(
        save_rollout, task_name=args.task_name, env_type=env_name,
        env_func=env_fn, save_dir=args.save_dir, n_tasks=args.n_tasks,
        seeds=seeds, env_seed=args.give_env_seed,
        camera_obs=args.collect_cam, n_per_group=args.per_task_group,
        ctrl_config=args.ctrl_config, renderer=args.renderer,
        render_device=args.render_device, object_set=spec["object_set"],
        color=args.color, shape=args.shape)
    if args.num_workers == 1:
        worker(list(range(args.N)))
    else:
        assert not args.renderer, "GUI rendering is single-worker only"
        with Pool(args.num_workers) as pool:
            pool.map(worker, range(args.N))


if __name__ == "__main__":
    main()
