"""DROID episode transforms + R6 rotation math (NumPy).

The port's copy of `openvla_oft_tpu/data/rlds/oxe/droid_utils.py`, the reference
`prismatic/vla/datasets/rlds/oxe/utils/droid_utils.py` (which leans on
tensorflow_graphics): base-frame and wrist-frame action encodings, the R6
(first-two-rows-of-R) rotation representation, and the zero-action chunk
filter. Euler conventions follow tensorflow_graphics: `euler = [x, y, z]`
angles with R = Rz(z) @ Ry(y) @ Rx(x).

These run on the host as NumPy in the episode stage of the pipeline
(data/rlds/pipeline.py), so no TF dependency is needed here.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

# DROID q01/q99 action statistics used by the zero-action filter (reference
# droid_utils.py:151-178 — the filter compares against "normalized zero").
DROID_Q01 = np.asarray([-0.7776297926902771, -0.5803514122962952,
                        -0.5795090794563293, -0.6464047729969025,
                        -0.7041108310222626, -0.8895104378461838])
DROID_Q99 = np.asarray([0.7597932070493698, 0.5726242214441299,
                        0.7351000607013702, 0.6705610305070877,
                        0.6464948207139969, 0.8897542208433151])


def euler_to_rmat(euler: np.ndarray) -> np.ndarray:
    """(..., 3) [x, y, z] angles -> (..., 3, 3) with R = Rz @ Ry @ Rx."""
    x, y, z = euler[..., 0], euler[..., 1], euler[..., 2]
    cx, sx = np.cos(x), np.sin(x)
    cy, sy = np.cos(y), np.sin(y)
    cz, sz = np.cos(z), np.sin(z)
    r = np.empty(euler.shape[:-1] + (3, 3), np.float64)
    r[..., 0, 0] = cz * cy
    r[..., 0, 1] = cz * sy * sx - sz * cx
    r[..., 0, 2] = cz * sy * cx + sz * sx
    r[..., 1, 0] = sz * cy
    r[..., 1, 1] = sz * sy * sx + cz * cx
    r[..., 1, 2] = sz * sy * cx - cz * sx
    r[..., 2, 0] = -sy
    r[..., 2, 1] = cy * sx
    r[..., 2, 2] = cy * cx
    return r


def rmat_to_euler(rmat: np.ndarray) -> np.ndarray:
    """Inverse of `euler_to_rmat` (gimbal-lock-naive, like tfg)."""
    sy = -rmat[..., 2, 0]
    y = np.arcsin(np.clip(sy, -1.0, 1.0))
    x = np.arctan2(rmat[..., 2, 1], rmat[..., 2, 2])
    z = np.arctan2(rmat[..., 1, 0], rmat[..., 0, 0])
    return np.stack([x, y, z], axis=-1)


def quat_to_euler(quat: np.ndarray) -> np.ndarray:
    """tfg-convention quaternion [x, y, z, w] -> [x, y, z] Euler angles
    (reference transforms use tfg.euler.from_quaternion)."""
    qx, qy, qz, qw = quat[..., 0], quat[..., 1], quat[..., 2], quat[..., 3]
    x = np.arctan2(2 * (qw * qx + qy * qz), 1 - 2 * (qx * qx + qy * qy))
    y = np.arcsin(np.clip(2 * (qw * qy - qz * qx), -1.0, 1.0))
    z = np.arctan2(2 * (qw * qz + qx * qy), 1 - 2 * (qy * qy + qz * qz))
    return np.stack([x, y, z], axis=-1)


def invert_rmat(rmat: np.ndarray) -> np.ndarray:
    return np.swapaxes(rmat, -1, -2)


def rotmat_to_rot6d(rmat: np.ndarray) -> np.ndarray:
    """R6 representation: first two ROWS of R, flattened
    (droid_utils.py:21-33)."""
    return np.concatenate([rmat[..., 0, :], rmat[..., 1, :]], axis=-1)


def velocity_act_to_wrist_frame(velocity: np.ndarray,
                                wrist_in_robot_frame: np.ndarray) -> np.ndarray:
    """6-D base-frame velocity -> 9-D wrist-frame (3 translation + R6)
    (droid_utils.py:36-56): dT_w = R^-1 dT_b; dR_w = R^-1 dR_b R."""
    r_frame = euler_to_rmat(wrist_in_robot_frame[:, 3:6])
    r_inv = invert_rmat(r_frame)
    vel_t = np.einsum("tij,tj->ti", r_inv, velocity[:, :3])
    dr = euler_to_rmat(velocity[:, 3:6])
    dr = r_inv @ dr @ r_frame
    return np.concatenate([vel_t, rotmat_to_rot6d(dr)],
                          axis=-1).astype(np.float32)


def rand_swap_exterior_images(img1, img2, rng=None):
    """Randomly swap the two exterior views (droid_utils.py:59-63) so
    single-exterior training sees both cameras."""
    rng = rng or np.random.default_rng()
    return (img1, img2) if rng.random() > 0.5 else (img2, img1)


def droid_baseact_transform(traj: Dict, rng=None) -> Dict:
    """DROID actions in the robot *base* frame (droid_utils.py:66-94)."""
    vel = np.asarray(traj["action_dict"]["cartesian_velocity"])
    grip = np.asarray(traj["action_dict"]["gripper_position"])
    traj["action"] = np.concatenate(
        [vel[:, :3], vel[:, 3:6], 1 - grip], axis=-1).astype(np.float32)
    obs = traj["observation"]
    obs["exterior_image_1_left"], obs["exterior_image_2_left"] = (
        rand_swap_exterior_images(obs["exterior_image_1_left"],
                                  obs["exterior_image_2_left"], rng))
    obs["proprio"] = np.concatenate(
        [np.asarray(obs["cartesian_position"]),
         np.asarray(obs["gripper_position"])], axis=-1).astype(np.float32)
    return traj


def droid_wristact_transform(traj: Dict, rng=None) -> Dict:
    """DROID actions in the robot *wrist* frame, R6 rotation
    (droid_utils.py:97-124)."""
    wrist_act = velocity_act_to_wrist_frame(
        np.asarray(traj["action_dict"]["cartesian_velocity"]),
        np.asarray(traj["observation"]["cartesian_position"]))
    grip = np.asarray(traj["action_dict"]["gripper_position"])
    traj["action"] = np.concatenate([wrist_act, grip],
                                    axis=-1).astype(np.float32)
    obs = traj["observation"]
    obs["exterior_image_1_left"], obs["exterior_image_2_left"] = (
        rand_swap_exterior_images(obs["exterior_image_1_left"],
                                  obs["exterior_image_2_left"], rng))
    obs["proprio"] = np.concatenate(
        [np.asarray(obs["cartesian_position"]),
         np.asarray(obs["gripper_position"])], axis=-1).astype(np.float32)
    return traj


def droid_finetuning_transform(traj: Dict) -> Dict:
    """DROID fine-tuning sets: base-frame actions, no camera swap
    (droid_utils.py:127-148)."""
    vel = np.asarray(traj["action_dict"]["cartesian_velocity"])
    grip = np.asarray(traj["action_dict"]["gripper_position"])
    traj["action"] = np.concatenate(
        [vel[:, :3], vel[:, 3:6], 1 - grip], axis=-1).astype(np.float32)
    obs = traj["observation"]
    obs["proprio"] = np.concatenate(
        [np.asarray(obs["cartesian_position"]),
         np.asarray(obs["gripper_position"])], axis=-1).astype(np.float32)
    return traj


def zero_action_filter(traj: Dict) -> bool:
    """Keep chunks whose (normalized) arm action is not identically zero
    (droid_utils.py:151-178). Applied after normalization, so compare with
    the normalized zero point."""
    norm_zero = 2 * (0 - DROID_Q01) / (DROID_Q99 - DROID_Q01 + 1e-8) - 1
    return bool(np.any(
        np.abs(np.asarray(traj["action"])[:, :6] - norm_zero) > 1e-5))
