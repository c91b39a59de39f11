"""Real bi-manual ALOHA environment on the port (reference
`experiments/robot/aloha/real_env.py`).

Action space (14-D): [left qpos (6), left gripper normalized (1),
right qpos (6), right gripper normalized (1)]. Observations: qpos/qvel/
effort + the four camera images, wrapped as `dm_env.TimeStep`s at 25 Hz.

Hardware deps (interbotix SDK, ROS, dm_env) import inside the constructor —
the module itself imports off-robot, and `split_action` is pure/tested.
"""

from __future__ import annotations

import collections
import time
from typing import Tuple

import numpy as np

from openvla_oft_tpu_torch.experiments.robot.aloha.constants import (
    DT,
    PUPPET_GRIPPER_JOINT_CLOSE,
    PUPPET_GRIPPER_JOINT_OPEN,
    START_ARM_POSE,
    master_gripper_joint_normalize,
    puppet_gripper_joint_unnormalize,
    puppet_gripper_position_normalize,
    puppet_gripper_velocity_normalize,
)
from openvla_oft_tpu_torch.experiments.robot.aloha.robot_utils import (
    ImageRecorder,
    Recorder,
    move_arms,
    move_grippers,
    setup_puppet_bot,
)


def split_action(action: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """14-D bi-manual action -> (left 7-D, right 7-D)."""
    action = np.asarray(action)
    half = len(action) // 2
    return action[:half], action[half:]


class RealEnv:
    """See module docstring; mirrors reference real_env.py:18-149."""

    def __init__(self, init_node: bool, setup_robots: bool = True):
        from interbotix_xs_modules.arm import InterbotixManipulatorXS
        from interbotix_xs_msgs.msg import JointSingleCommand

        self.puppet_bot_left = InterbotixManipulatorXS(
            robot_model="vx300s", group_name="arm", gripper_name="gripper",
            robot_name="puppet_left", init_node=init_node)
        self.puppet_bot_right = InterbotixManipulatorXS(
            robot_model="vx300s", group_name="arm", gripper_name="gripper",
            robot_name="puppet_right", init_node=False)
        if setup_robots:
            self.setup_robots()
        self.recorder_left = Recorder("left", init_node=False)
        self.recorder_right = Recorder("right", init_node=False)
        self.image_recorder = ImageRecorder(init_node=False)
        self.gripper_command = JointSingleCommand(name="gripper")

    def setup_robots(self):
        setup_puppet_bot(self.puppet_bot_left)
        setup_puppet_bot(self.puppet_bot_right)

    def get_qpos(self):
        l, r = self.recorder_left.qpos, self.recorder_right.qpos
        return np.concatenate(
            [l[:6], [puppet_gripper_position_normalize(l[7])],
             r[:6], [puppet_gripper_position_normalize(r[7])]])

    def get_qvel(self):
        l, r = self.recorder_left.qvel, self.recorder_right.qvel
        return np.concatenate(
            [l[:6], [puppet_gripper_velocity_normalize(l[7])],
             r[:6], [puppet_gripper_velocity_normalize(r[7])]])

    def get_effort(self):
        return np.concatenate([self.recorder_left.effort[:7],
                               self.recorder_right.effort[:7]])

    def get_images(self):
        return self.image_recorder.get_images()

    def set_gripper_pose(self, left_normalized: float,
                         right_normalized: float):
        for bot, x in ((self.puppet_bot_left, left_normalized),
                       (self.puppet_bot_right, right_normalized)):
            self.gripper_command.cmd = puppet_gripper_joint_unnormalize(x)
            bot.gripper.core.pub_single.publish(self.gripper_command)

    def _reset_joints(self):
        reset_position = START_ARM_POSE[:6]
        move_arms([self.puppet_bot_left, self.puppet_bot_right],
                  [reset_position, reset_position], move_time=1)

    def _reset_gripper(self):
        """Open then close in position mode (reference real_env.py:100-103)."""
        bots = [self.puppet_bot_left, self.puppet_bot_right]
        move_grippers(bots, [PUPPET_GRIPPER_JOINT_OPEN] * 2, move_time=0.5)
        move_grippers(bots, [PUPPET_GRIPPER_JOINT_CLOSE] * 2, move_time=1)

    def _get_obs(self):
        obs = collections.OrderedDict()
        obs["qpos"] = self.get_qpos()
        obs["qvel"] = self.get_qvel()
        obs["effort"] = self.get_effort()
        obs["images"] = self.get_images()
        return obs

    def get_reward(self):
        return 0

    def get_observation(self, t: int = 0):
        import dm_env

        return dm_env.TimeStep(
            step_type=dm_env.StepType.FIRST if t == 0 else dm_env.StepType.MID,
            reward=self.get_reward(), discount=None,
            observation=self._get_obs())

    def reset(self, fake: bool = False):
        import dm_env

        if not fake:
            self.puppet_bot_left.dxl.robot_reboot_motors("single", "gripper", True)
            self.puppet_bot_right.dxl.robot_reboot_motors("single", "gripper", True)
            self._reset_joints()
            self._reset_gripper()
        return dm_env.TimeStep(step_type=dm_env.StepType.FIRST,
                               reward=self.get_reward(), discount=None,
                               observation=self._get_obs())

    def step(self, action):
        import dm_env

        left, right = split_action(action)
        self.puppet_bot_left.arm.set_joint_positions(left[:6], blocking=False)
        self.puppet_bot_right.arm.set_joint_positions(right[:6], blocking=False)
        self.set_gripper_pose(left[-1], right[-1])
        time.sleep(DT)
        return dm_env.TimeStep(step_type=dm_env.StepType.MID,
                               reward=self.get_reward(), discount=None,
                               observation=self._get_obs())


def get_action(master_bot_left, master_bot_right) -> np.ndarray:
    """Read the 14-D teleop action off the master arms (normalized grippers)."""
    action = np.zeros(14)
    action[:6] = master_bot_left.dxl.joint_states.position[:6]
    action[7:13] = master_bot_right.dxl.joint_states.position[:6]
    action[6] = master_gripper_joint_normalize(
        master_bot_left.dxl.joint_states.position[6])
    action[13] = master_gripper_joint_normalize(
        master_bot_right.dxl.joint_states.position[6])
    return action


def make_real_env(init_node: bool, setup_robots: bool = True) -> RealEnv:
    return RealEnv(init_node, setup_robots=setup_robots)
