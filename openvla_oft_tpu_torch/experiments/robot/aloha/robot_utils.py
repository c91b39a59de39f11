"""ALOHA hardware recorders + arm motion helpers on the port (reference
`experiments/robot/aloha/robot_utils.py`).

ROS (`rospy`, `cv_bridge`, `sensor_msgs`) and interbotix are runtime
dependencies of the physical rig only — imported inside constructors, so
this module imports cleanly off-robot. Motion commands interpolate
joint targets over `move_time` at the 25 Hz loop (`constants.DT`), exactly
the reference protocol; the interpolation math is factored out pure
(`interpolate_trajectory`) and unit-tested.
"""

from __future__ import annotations

import time
from typing import List, Sequence

import numpy as np

from openvla_oft_tpu_torch.experiments.robot.aloha.constants import DT

CAMERA_NAMES = ("cam_high", "cam_low", "cam_left_wrist", "cam_right_wrist")


class ImageRecorder:
    """Subscribes to the four usb-cam topics and keeps the latest frame per
    camera (one generic callback; the reference unrolls four)."""

    def __init__(self, init_node: bool = True, is_debug: bool = False):
        from collections import deque

        import rospy
        from cv_bridge import CvBridge
        from sensor_msgs.msg import Image

        self.is_debug = is_debug
        self.bridge = CvBridge()
        self.camera_names = list(CAMERA_NAMES)
        if init_node:
            rospy.init_node("image_recorder", anonymous=True)
        for cam in self.camera_names:
            setattr(self, f"{cam}_image", None)
            setattr(self, f"{cam}_secs", None)
            setattr(self, f"{cam}_nsecs", None)
            if is_debug:
                setattr(self, f"{cam}_timestamps", deque(maxlen=50))
            rospy.Subscriber(f"/usb_{cam}/image_raw", Image,
                             self._make_cb(cam))
        time.sleep(0.5)  # let the first frames arrive

    def _make_cb(self, cam: str):
        def cb(data):
            setattr(self, f"{cam}_image",
                    self.bridge.imgmsg_to_cv2(data,
                                              desired_encoding="passthrough"))
            setattr(self, f"{cam}_secs", data.header.stamp.secs)
            setattr(self, f"{cam}_nsecs", data.header.stamp.nsecs)
            if self.is_debug:
                getattr(self, f"{cam}_timestamps").append(
                    data.header.stamp.secs + data.header.stamp.nsecs * 1e-9)

        return cb

    def get_images(self):
        return {cam: getattr(self, f"{cam}_image")
                for cam in self.camera_names}

    def print_diagnostics(self):
        for cam in self.camera_names:
            ts = list(getattr(self, f"{cam}_timestamps", []))
            if len(ts) > 1:
                freq = 1 / np.mean(np.diff(np.asarray(ts)))
                print(f"{cam} {freq:.2f} Hz")


class Recorder:
    """Joint-state recorder for one arm side ('left'/'right')."""

    def __init__(self, side: str, init_node: bool = True,
                 is_debug: bool = False):
        from collections import deque

        import rospy
        from interbotix_xs_msgs.msg import JointGroupCommand, JointSingleCommand
        from sensor_msgs.msg import JointState

        self.secs = self.nsecs = None
        self.qpos = self.qvel = self.effort = None
        self.arm_command = self.gripper_command = None
        self.is_debug = is_debug
        if init_node:
            rospy.init_node("recorder", anonymous=True)
        rospy.Subscriber(f"/puppet_{side}/joint_states", JointState,
                         self._state_cb)
        rospy.Subscriber(f"/puppet_{side}/commands/joint_group",
                         JointGroupCommand, self._arm_cmd_cb)
        rospy.Subscriber(f"/puppet_{side}/commands/joint_single",
                         JointSingleCommand, self._gripper_cmd_cb)
        if is_debug:
            self.joint_timestamps = deque(maxlen=50)
            self.arm_command_timestamps = deque(maxlen=50)
            self.gripper_command_timestamps = deque(maxlen=50)
        time.sleep(0.1)

    def _state_cb(self, data):
        self.qpos = data.position
        self.qvel = data.velocity
        self.effort = data.effort
        self.secs = data.header.stamp.secs
        self.nsecs = data.header.stamp.nsecs
        if self.is_debug:
            self.joint_timestamps.append(time.time())

    def _arm_cmd_cb(self, data):
        self.arm_command = data.cmd
        if self.is_debug:
            self.arm_command_timestamps.append(time.time())

    def _gripper_cmd_cb(self, data):
        self.gripper_command = data.cmd
        if self.is_debug:
            self.gripper_command_timestamps.append(time.time())


def get_arm_joint_positions(bot):
    return bot.arm.core.joint_states.position[:6]


def get_arm_gripper_positions(bot):
    return bot.gripper.core.joint_states.position[6]


def interpolate_trajectory(current: Sequence[Sequence[float]],
                           target: Sequence[Sequence[float]],
                           num_steps: int) -> np.ndarray:
    """(num_steps, n_bots, dof) linear interpolation from current to target —
    the motion profile move_arms/move_grippers execute at 25 Hz."""
    cur = np.asarray(current, np.float64)
    tgt = np.asarray(target, np.float64)
    return np.linspace(cur, tgt, num_steps)


def move_arms(bot_list: List, target_pose_list: List, move_time: float = 1.0
              ) -> None:
    num_steps = int(move_time / DT)
    curr = [get_arm_joint_positions(bot) for bot in bot_list]
    traj = interpolate_trajectory(curr, target_pose_list, num_steps)
    for step in traj:
        for bot, pose in zip(bot_list, step):
            bot.arm.set_joint_positions(pose, blocking=False)
        time.sleep(DT)


def move_grippers(bot_list: List, target_pose_list: Sequence[float],
                  move_time: float) -> None:
    from interbotix_xs_msgs.msg import JointSingleCommand

    gripper_command = JointSingleCommand(name="gripper")
    num_steps = int(move_time / DT)
    curr = [[get_arm_gripper_positions(bot)] for bot in bot_list]
    traj = interpolate_trajectory(curr, [[t] for t in target_pose_list],
                                  num_steps)
    for step in traj:
        for bot, (pose,) in zip(bot_list, step):
            gripper_command.cmd = pose
            bot.gripper.core.pub_single.publish(gripper_command)
        time.sleep(DT)


def setup_puppet_bot(bot):
    bot.dxl.robot_reboot_motors("single", "gripper", True)
    bot.dxl.robot_set_operating_modes("group", "arm", "position")
    bot.dxl.robot_set_operating_modes("single", "gripper", "current_based_position")
    torque_on(bot)


def setup_master_bot(bot):
    bot.dxl.robot_set_operating_modes("group", "arm", "pwm")
    bot.dxl.robot_set_operating_modes("single", "gripper", "current_based_position")
    torque_off(bot)


def set_standard_pid_gains(bot):
    bot.dxl.robot_set_motor_registers("group", "arm", "Position_P_Gain", 800)
    bot.dxl.robot_set_motor_registers("group", "arm", "Position_I_Gain", 0)


def set_low_pid_gains(bot):
    bot.dxl.robot_set_motor_registers("group", "arm", "Position_P_Gain", 100)
    bot.dxl.robot_set_motor_registers("group", "arm", "Position_I_Gain", 0)


def torque_off(bot):
    bot.dxl.robot_torque_enable("group", "arm", False)
    bot.dxl.robot_torque_enable("single", "gripper", False)


def torque_on(bot):
    bot.dxl.robot_torque_enable("group", "arm", True)
    bot.dxl.robot_torque_enable("single", "gripper", True)
