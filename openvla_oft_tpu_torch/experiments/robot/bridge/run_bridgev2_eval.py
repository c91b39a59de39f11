"""Bridge V2 WidowX real-robot evaluation client on the port (reference
`experiments/robot/bridge/run_bridgev2_eval.py`).

Drives a WidowX arm through the `widowx_envs` interface (import-gated);
observation prep + action conventions work standalone. The policy (the
discrete head by default, 1 image, 5-step chunks) runs on `cfg.device`.

    python -m openvla_oft_tpu_torch.experiments.robot.bridge.run_bridgev2_eval \
        --pretrained_checkpoint /path/to/ckpt --host_ip <robot host>
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Union

import numpy as np

from openvla_oft_tpu_torch.serving.openvla_utils import get_action_head, get_processor
from openvla_oft_tpu_torch.serving.robot_utils import (
    get_action,
    get_model,
    invert_gripper_action,
    normalize_gripper_action,
)


@dataclasses.dataclass
class GenerateConfig:
    # fmt: off
    model_family: str = "openvla"
    pretrained_checkpoint: Union[str, Path] = ""
    use_l1_regression: bool = False
    use_diffusion: bool = False
    use_film: bool = False
    num_images_in_input: int = 1
    use_proprio: bool = False
    center_crop: bool = True
    num_open_loop_steps: int = 5
    unnorm_key: str = "bridge_orig"

    host_ip: str = "localhost"
    port: int = 5556
    max_episodes: int = 50
    max_steps: int = 60
    control_frequency: float = 5.0
    seed: int = 7
    device: str = "cuda"                # where the policy runs ("cpu" in the tests)
    # fmt: on


def get_widowx_env(cfg: GenerateConfig):
    """WidowX env via `widowx_envs` (reference bridgev2_utils.py)."""
    try:
        from widowx_envs.widowx_env_service import WidowXClient, WidowXConfigs
    except ImportError as e:
        raise ImportError(
            "Bridge evaluation requires the `widowx_envs` package from the "
            "BridgeData V2 repo.") from e
    client = WidowXClient(host=cfg.host_ip, port=cfg.port)
    client.init(WidowXConfigs.DefaultEnvParams, image_size=256)
    return client


def prepare_observation(raw_obs) -> dict:
    img = np.asarray(raw_obs["image"]).reshape(3, 256, 256).transpose(1, 2, 0)
    img = (img * 255).astype(np.uint8)
    return {"full_image": img, "state": np.asarray(raw_obs.get("state", []))}


def eval_bridge(cfg: GenerateConfig) -> float:
    model = get_model(cfg)
    processor = get_processor(cfg)
    action_head = None
    if cfg.use_l1_regression or cfg.use_diffusion:
        try:
            action_head = get_action_head(cfg, model.cfg.llm_dim)
        except (AssertionError, FileNotFoundError):
            pass
    env = get_widowx_env(cfg)
    step_duration = 1.0 / cfg.control_frequency

    successes = 0
    for ep in range(cfg.max_episodes):
        task = input("Enter task instruction (or 'quit'): ")
        if task.strip().lower() == "quit":
            break
        env.reset()
        for t in range(cfg.max_steps):
            t0 = time.time()
            raw = env.get_observation()
            if raw is None:
                continue
            obs = prepare_observation(raw)
            actions = get_action(cfg, model, obs, task, processor=processor,
                                 action_head=action_head)
            for action in actions[: cfg.num_open_loop_steps]:
                action = invert_gripper_action(
                    normalize_gripper_action(np.asarray(action)))
                env.step_action(action)
                elapsed = time.time() - t0
                if elapsed < step_duration:
                    time.sleep(step_duration - elapsed)
                t0 = time.time()
        ok = input("Success? y/n: ").lower() == "y"
        successes += int(ok)
    rate = successes / max(ep + 1, 1)
    print(f"bridge success rate: {rate:.2%}")
    return rate


if __name__ == "__main__":
    from openvla_oft_tpu_torch.utils.cli import parse_args

    eval_bridge(parse_args(GenerateConfig))
