"""ALOHA platform constants + gripper conversion helpers on the port (reference
`experiments/robot/aloha/constants.py`).

Pure data/functions — no hardware imports — so the conversions are unit-
testable off-robot. The dataset root comes from $ALOHA_DATA_DIR instead of
the reference's hard-coded lab path.
"""

from __future__ import annotations

import os

DATA_DIR = os.environ.get("ALOHA_DATA_DIR", os.path.expanduser("~/data/aloha1"))

_CAMS3 = ["cam_high", "cam_left_wrist", "cam_right_wrist"]
_CAMS4 = ["cam_high", "cam_low", "cam_left_wrist", "cam_right_wrist"]

# (dataset_dir, num_episodes, episode_len, camera_names) per task — the
# fine-tuning tasks of the OFT ALOHA experiments (reference constants.py:4-58).
TASK_CONFIGS = {
    "fold_shorts": dict(dataset_dir=f"{DATA_DIR}/fold_shorts",
                        num_episodes=20, episode_len=1000, camera_names=_CAMS3),
    "fold_shirt": dict(dataset_dir=f"{DATA_DIR}/fold_shirt",
                       num_episodes=30, episode_len=1250, camera_names=_CAMS3),
    "scoop_raisins_into_bowl": dict(
        dataset_dir=f"{DATA_DIR}/scoop_raisins_into_bowl",
        num_episodes=15, episode_len=900, camera_names=_CAMS3),
    "scoop_almonds_and_green_M&Ms_into_bowl": dict(
        dataset_dir=f"{DATA_DIR}/scoop_almonds_and_green_M&Ms_into_bowl",
        num_episodes=15, episode_len=900, camera_names=_CAMS3),
    "scoop_pretzels_into_bowl": dict(
        dataset_dir=f"{DATA_DIR}/scoop_pretzels_into_bowl",
        num_episodes=15, episode_len=900, camera_names=_CAMS3),
    "put_red_pepper_into_pot": dict(
        dataset_dir=f"{DATA_DIR}/put_red_pepper_into_pot",
        num_episodes=100, episode_len=400, camera_names=_CAMS4),
    "put_yellow_corn_into_pot": dict(
        dataset_dir=f"{DATA_DIR}/put_yellow_corn_into_pot",
        num_episodes=100, episode_len=400, camera_names=_CAMS4),
    "put_green_pepper_into_pot": dict(
        dataset_dir=f"{DATA_DIR}/put_green_pepper_into_pot",
        num_episodes=100, episode_len=400, camera_names=_CAMS4),
}

# Fixed hardware constants (ALOHA 1; reference constants.py:60-77)
DT = 0.04                       # 25 Hz control loop
JOINT_NAMES = ["waist", "shoulder", "elbow", "forearm_roll", "wrist_angle",
               "wrist_rotate"]
START_ARM_POSE = [0, -0.96, 1.16, 0, -0.3, 0, 0.02239, -0.02239,
                  0, -0.96, 1.16, 0, -0.3, 0, 0.02239, -0.02239]

MASTER_GRIPPER_POSITION_OPEN = 0.02417
MASTER_GRIPPER_POSITION_CLOSE = 0.01244
PUPPET_GRIPPER_POSITION_OPEN = 0.05800
PUPPET_GRIPPER_POSITION_CLOSE = 0.01844

MASTER_GRIPPER_JOINT_OPEN = 0.3083      # ALOHA 1 (ALOHA 2: -0.8)
MASTER_GRIPPER_JOINT_CLOSE = -0.6842    # ALOHA 1 (ALOHA 2: -1.65)
PUPPET_GRIPPER_JOINT_OPEN = 1.4910
PUPPET_GRIPPER_JOINT_CLOSE = -0.6213


def _normalize(x, close, open_):
    return (x - close) / (open_ - close)


def _unnormalize(x, close, open_):
    return x * (open_ - close) + close


def master_gripper_position_normalize(x):
    return _normalize(x, MASTER_GRIPPER_POSITION_CLOSE,
                      MASTER_GRIPPER_POSITION_OPEN)


def puppet_gripper_position_normalize(x):
    return _normalize(x, PUPPET_GRIPPER_POSITION_CLOSE,
                      PUPPET_GRIPPER_POSITION_OPEN)


def master_gripper_position_unnormalize(x):
    return _unnormalize(x, MASTER_GRIPPER_POSITION_CLOSE,
                        MASTER_GRIPPER_POSITION_OPEN)


def puppet_gripper_position_unnormalize(x):
    return _unnormalize(x, PUPPET_GRIPPER_POSITION_CLOSE,
                        PUPPET_GRIPPER_POSITION_OPEN)


def master2puppet_position(x):
    return puppet_gripper_position_unnormalize(
        master_gripper_position_normalize(x))


def master_gripper_joint_normalize(x):
    return _normalize(x, MASTER_GRIPPER_JOINT_CLOSE, MASTER_GRIPPER_JOINT_OPEN)


def puppet_gripper_joint_normalize(x):
    return _normalize(x, PUPPET_GRIPPER_JOINT_CLOSE, PUPPET_GRIPPER_JOINT_OPEN)


def master_gripper_joint_unnormalize(x):
    return _unnormalize(x, MASTER_GRIPPER_JOINT_CLOSE,
                        MASTER_GRIPPER_JOINT_OPEN)


def puppet_gripper_joint_unnormalize(x):
    return _unnormalize(x, PUPPET_GRIPPER_JOINT_CLOSE,
                        PUPPET_GRIPPER_JOINT_OPEN)


def master2puppet_joint(x):
    return puppet_gripper_joint_unnormalize(master_gripper_joint_normalize(x))


def master_gripper_velocity_normalize(x):
    return x / (MASTER_GRIPPER_POSITION_OPEN - MASTER_GRIPPER_POSITION_CLOSE)


def puppet_gripper_velocity_normalize(x):
    return x / (PUPPET_GRIPPER_POSITION_OPEN - PUPPET_GRIPPER_POSITION_CLOSE)


def master_pos2joint(x):
    return master_gripper_position_normalize(x) * (
        MASTER_GRIPPER_JOINT_OPEN - MASTER_GRIPPER_JOINT_CLOSE
    ) + MASTER_GRIPPER_JOINT_CLOSE


def master_joint2pos(x):
    return master_gripper_position_unnormalize(
        master_gripper_joint_normalize(x))


def puppet_pos2joint(x):
    return puppet_gripper_position_normalize(x) * (
        PUPPET_GRIPPER_JOINT_OPEN - PUPPET_GRIPPER_JOINT_CLOSE
    ) + PUPPET_GRIPPER_JOINT_CLOSE


def puppet_joint2pos(x):
    return puppet_gripper_position_unnormalize(
        puppet_gripper_joint_normalize(x))


# Reference-style aliases (upper-snake lambda names used across upstream code)
MASTER_GRIPPER_POSITION_NORMALIZE_FN = master_gripper_position_normalize
PUPPET_GRIPPER_POSITION_NORMALIZE_FN = puppet_gripper_position_normalize
MASTER_GRIPPER_POSITION_UNNORMALIZE_FN = master_gripper_position_unnormalize
PUPPET_GRIPPER_POSITION_UNNORMALIZE_FN = puppet_gripper_position_unnormalize
MASTER2PUPPET_POSITION_FN = master2puppet_position
MASTER_GRIPPER_JOINT_NORMALIZE_FN = master_gripper_joint_normalize
PUPPET_GRIPPER_JOINT_NORMALIZE_FN = puppet_gripper_joint_normalize
MASTER_GRIPPER_JOINT_UNNORMALIZE_FN = master_gripper_joint_unnormalize
PUPPET_GRIPPER_JOINT_UNNORMALIZE_FN = puppet_gripper_joint_unnormalize
MASTER2PUPPET_JOINT_FN = master2puppet_joint
MASTER_GRIPPER_VELOCITY_NORMALIZE_FN = master_gripper_velocity_normalize
PUPPET_GRIPPER_VELOCITY_NORMALIZE_FN = puppet_gripper_velocity_normalize
MASTER_POS2JOINT = master_pos2joint
MASTER_JOINT2POS = master_joint2pos
PUPPET_POS2JOINT = puppet_pos2joint
PUPPET_JOINT2POS = puppet_joint2pos
