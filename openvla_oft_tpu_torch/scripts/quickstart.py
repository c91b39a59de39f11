"""Quickstart: load an OpenVLA-OFT checkpoint and predict one action chunk
on the port (reference README.md:24-69 flow; the port's copy of
`examples/quickstart.py`).

Reads the committed observation
`experiments/robot/libero/sample_libero_spatial_observation.pkl` where the
checkout has it (or the one `--observation` names), else a synthetic
LIBERO-style observation. Without a real checkpoint pass `--checkpoint
random:7b` to drive the full path with random weights. The policy runs on
the card unless `--device cpu` is given.

    python -m openvla_oft_tpu_torch.scripts.quickstart \\
        --checkpoint /path/to/libero-spatial-ckpt \\
        [--observation sample_libero_spatial_observation.pkl] [--device cuda]
"""

from __future__ import annotations

import dataclasses
import pickle
import time
from pathlib import Path
from typing import Optional

import numpy as np


@dataclasses.dataclass
class QuickstartConfig:
    checkpoint: str = "random:tiny"
    observation: Optional[str] = None     # reference-format .pkl
    unnorm_key: str = ""
    num_images_in_input: int = 2
    center_crop: bool = True
    device: str = "cuda"                  # where the policy runs ("cpu" in the tests)


FIXTURE = (Path(__file__).resolve().parents[2] / "experiments" / "robot" / "libero"
           / "sample_libero_spatial_observation.pkl")


def load_observation(path: Optional[str]) -> dict:
    if path is None and FIXTURE.exists():
        # the checkout's recorded-format fixture (same schema as the
        # reference's sample_libero_spatial_observation.pkl, README.md:55-69)
        path = str(FIXTURE)
    if path:
        with open(path, "rb") as f:
            obs = pickle.load(f)
        # reference fixture: {full_image, wrist_image, state, task_description}
        return obs
    rng = np.random.default_rng(0)
    return {
        "full_image": (rng.random((224, 224, 3)) * 255).astype(np.uint8),
        "wrist_image": (rng.random((224, 224, 3)) * 255).astype(np.uint8),
        "state": rng.random(8).astype(np.float64),
        "task_description":
            "pick up the black bowl between the plate and the ramekin and "
            "place it on the plate",
    }


def main(cfg: QuickstartConfig):
    from openvla_oft_tpu_torch.serving.openvla_utils import (get_processor, get_vla,
                                                             get_vla_action)

    obs = load_observation(cfg.observation)
    task = obs.pop("task_description")

    class _Cfg:
        pretrained_checkpoint = cfg.checkpoint
        num_images_in_input = cfg.num_images_in_input
        center_crop = cfg.center_crop
        use_l1_regression = True
        use_diffusion = False
        use_film = False
        use_proprio = False
        unnorm_key = cfg.unnorm_key or None
        num_open_loop_steps = 8
        device = cfg.device

    vla = get_vla(_Cfg)
    processor = get_processor(_Cfg)
    t0 = time.time()
    actions = get_vla_action(_Cfg, vla, processor, obs, task)
    print(f"first predict: {time.time() - t0:.2f}s")
    t0 = time.time()
    actions = get_vla_action(_Cfg, vla, processor, obs, task)
    print(f"warm predict: {time.time() - t0:.3f}s")
    print(f"instruction: {task!r}")
    print(f"action chunk ({len(actions)} steps x {actions[0].shape[0]}-D):")
    for i, a in enumerate(actions):
        print(f"  t+{i}: {np.array2string(a, precision=3, suppress_small=True)}")
    return actions


if __name__ == "__main__":
    from openvla_oft_tpu_torch.utils.cli import parse_args

    main(parse_args(QuickstartConfig))
