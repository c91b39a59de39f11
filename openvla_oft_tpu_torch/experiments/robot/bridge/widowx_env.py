"""WidowX gym environment for BridgeData V2 evaluation on the port (reference
`experiments/robot/bridge/widowx_env.py`, which derives from the public Octo
eval env).

The hardware dependency (`widowx_envs`, through the client handed in) stays
outside; the pure observation conversions (`convert_obs`, `null_obs`,
`state_to_eep`) are importable and tested off-robot. `state_to_eep` builds
its quaternions with numpy (no `pyquaternion`).
"""

from __future__ import annotations

import time
from typing import Dict, Tuple

import numpy as np

# Gripper pointing ~15 degrees off the standard orientation — the fixed
# start-pose rotation block (reference widowx_env.py:133-141).
START_ROTATION = np.array([
    [0.267, 0.000, 0.963],
    [0.000, 1.000, 0.000],
    [-0.963, 0.000, 0.267],
])


def _quat_from_axis_angle(axis, angle: float) -> np.ndarray:
    """(w, x, y, z) of a rotation by `angle` about the unit `axis`."""
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    return np.concatenate([[np.cos(angle / 2.0)], np.sin(angle / 2.0) * axis])


def _quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Hamilton product of (w, x, y, z) quaternions."""
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                     w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


def _quat_to_matrix(q: np.ndarray) -> np.ndarray:
    w, x, y, z = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def state_to_eep(xyz_coor, zangle: float) -> np.ndarray:
    """(xyz, z-rotation) -> 4x4 end-effector pose (bridge_data_robot
    `widowx_controller.py` convention): the default rotation turned by
    `zangle` about z, as pyquaternion's `Quaternion(axis=z, angle=zangle) *
    Quaternion(matrix=default_rotation)` gives it."""
    assert len(xyz_coor) == 3
    # default_rotation [[0, 0, 1], [0, 1, 0], [-1, 0, 0]] is 90 degrees about y
    default_quat = _quat_from_axis_angle([0.0, 1.0, 0.0], np.pi / 2)
    new_pose = np.eye(4)
    new_pose[:3, -1] = xyz_coor
    new_quat = _quat_mul(_quat_from_axis_angle([0.0, 0.0, 1.0], zangle), default_quat)
    new_pose[:3, :3] = _quat_to_matrix(new_quat)
    return new_pose


def start_transform(xyz) -> np.ndarray:
    """4x4 start pose at `xyz` with the fixed 15-degree-tilt orientation."""
    t = np.eye(4)
    t[:3, :3] = START_ROTATION
    t[:3, 3] = np.asarray(xyz, np.float64)
    return t


def wait_for_obs(widowx_client):
    obs = widowx_client.get_observation()
    while obs is None:
        print("Waiting for observations...")
        obs = widowx_client.get_observation()
        time.sleep(1)
    return obs


def convert_obs(obs: Dict, im_size: int) -> Dict:
    """Raw controller obs -> policy obs: CHW float image back to HWC uint8,
    proprio as the 7-D bridge layout (xyz+rpy, gripper).

    Documented divergence: the reference's widowx_env.py:46 pads to Octo's
    8-D layout ("to match RLDS training") while its OWN bridge RLDS config
    (`state_obs_keys=["EEF_state","gripper_state"]`) and BRIDGE_CONSTANTS
    PROPRIO_DIM are 7 — proprio-conditioned bridge eval would break upstream.
    Here everything agrees on 7 (constants.BRIDGE, oxe configs, this env)."""
    image_obs = (obs["image"].reshape(3, im_size, im_size).transpose(1, 2, 0)
                 * 255).astype(np.uint8)
    proprio = np.concatenate([obs["state"][:6], obs["state"][-1:]])
    return {"image_primary": image_obs, "full_image": obs["full_image"],
            "proprio": proprio}


def null_obs(img_size: int) -> Dict:
    return {"image_primary": np.zeros((img_size, img_size, 3), np.uint8),
            "proprio": np.zeros((7,), np.float64)}


class WidowXGym:
    """Gym-style env over a `WidowXClient` (reference widowx_env.py:62-160).

    Implemented without subclassing gym.Env so the module stays importable
    when gym is absent; the step/reset API is gymnasium-style
    (obs, reward, done, truncated, info).
    """

    def __init__(self, widowx_client, cfg, im_size: int = 256,
                 blocking: bool = True):
        self.widowx_client = widowx_client
        self.im_size = im_size
        self.blocking = blocking
        self.cfg = cfg

    def step(self, action) -> Tuple[Dict, float, bool, bool, Dict]:
        self.widowx_client.step_action(action, blocking=self.blocking)
        raw_obs = self.widowx_client.get_observation()
        truncated = False
        if raw_obs is None:
            # lost connection with the controller server mid-episode
            truncated = True
            obs = null_obs(self.im_size)
        else:
            obs = convert_obs(raw_obs, self.im_size)
        return obs, 0, False, truncated, {}

    def reset(self, seed=None, options=None) -> Tuple[Dict, Dict]:
        self.widowx_client.reset()
        self.move_to_start_state()
        obs = convert_obs(wait_for_obs(self.widowx_client), self.im_size)
        return obs, {}

    def get_observation(self) -> Dict:
        return convert_obs(wait_for_obs(self.widowx_client), self.im_size)

    def move_to_start_state(self):
        successful = False
        while not successful:
            try:
                init_x, init_y, init_z = self.cfg.init_ee_pos
                vals = []
                for name, default in (("x", init_x), ("y", init_y),
                                      ("z", init_z)):
                    v = input(f"Enter {name} value of gripper starting "
                              f"position (leave empty for default == "
                              f"{default}): ")
                    vals.append(float(v) if v else default)
                # Blocking move is essential: the controller re-reads qpos
                # right after the call returns (reference widowx_env.py:144-148).
                self.widowx_client.move(start_transform(vals), duration=0.8,
                                        blocking=True)
                successful = True
            except Exception as e:  # retry on user typos / transient errors
                print(e)
