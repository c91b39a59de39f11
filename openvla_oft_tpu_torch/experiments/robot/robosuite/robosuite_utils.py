"""UR5e robosuite evaluation utilities on the port (fork-added reference
`experiments/robot/robosuite/robosuite_utils.py:99-286`).

Success predicates (reach / pick / place-in-bin / on-peg) are pure geometry
and implemented standalone; env construction needs robosuite + mujoco and the
fork's multi-task env package, and is import-gated. The front camera's crop
and bilinear resize is PIL's `Image.resize(..., BILINEAR)` bit for bit, in
numpy (`bilinear_resize`); the policy resize runs on the given device.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np

from openvla_oft_tpu_torch.experiments.robot.aloha.aloha_utils import resize_image_for_policy

# Per-task front-camera crop [top, bottom, left, right] applied before the
# policy resize (reference robosuite_utils.py:28-33) — the training data was
# cropped the same way, so skipping it feeds out-of-distribution pixels.
TASK_CROP = {
    "pick_place": [20, 25, 80, 75],
    "nut_assembly": [20, 25, 80, 75],
    "stack_block": [20, 25, 80, 75],
    "press_button": [10, 10, 70, 70],
}

# gripper-frame correction applied to the eef orientation
# (reference robosuite_utils.py:230-233)
R_EE_TO_GRIPPER = np.array([[0.0, -1.0, 0.0],
                            [1.0, 0.0, 0.0],
                            [0.0, 0.0, 1.0]])


# --- rotation helpers (robosuite T.* conventions: quats are xyzw, euler is
# static-frame 'sxyz' as in transforms3d) ---
def quat2mat(q: np.ndarray) -> np.ndarray:
    x, y, z, w = np.asarray(q, np.float64)
    n = x * x + y * y + z * z + w * w
    if n < 1e-12:
        return np.eye(3)
    s = 2.0 / n
    xs, ys, zs = x * s, y * s, z * s
    wx, wy, wz = w * xs, w * ys, w * zs
    xx, xy, xz = x * xs, x * ys, x * zs
    yy, yz, zz = y * ys, y * zs, z * zs
    return np.array([
        [1.0 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1.0 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1.0 - (xx + yy)],
    ])


def mat2quat(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, np.float64)
    t = np.trace(m)
    if t > 0:
        r = np.sqrt(1.0 + t)
        w = 0.5 * r
        x = (m[2, 1] - m[1, 2]) / (2.0 * r)
        y = (m[0, 2] - m[2, 0]) / (2.0 * r)
        z = (m[1, 0] - m[0, 1]) / (2.0 * r)
    else:
        i = int(np.argmax(np.diag(m)))
        j, k = (i + 1) % 3, (i + 2) % 3
        r = np.sqrt(1.0 + m[i, i] - m[j, j] - m[k, k])
        vals = np.zeros(3)
        vals[i] = 0.5 * r
        vals[j] = (m[j, i] + m[i, j]) / (2.0 * r)
        vals[k] = (m[k, i] + m[i, k]) / (2.0 * r)
        w = (m[k, j] - m[j, k]) / (2.0 * r)
        x, y, z = vals
    return np.array([x, y, z, w])


def euler2mat(euler: np.ndarray) -> np.ndarray:
    """Static-frame xyz: M = Rz(az) @ Ry(ay) @ Rx(ax)."""
    ax, ay, az = np.asarray(euler, np.float64)
    cx, sx = np.cos(ax), np.sin(ax)
    cy, sy = np.cos(ay), np.sin(ay)
    cz, sz = np.cos(az), np.sin(az)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rz @ ry @ rx


def mat2euler(m: np.ndarray) -> np.ndarray:
    """Inverse of euler2mat (static-frame xyz)."""
    m = np.asarray(m, np.float64)
    sy = np.hypot(m[0, 0], m[1, 0])
    if sy > 1e-8:
        ax = np.arctan2(m[2, 1], m[2, 2])
        ay = np.arctan2(-m[2, 0], sy)
        az = np.arctan2(m[1, 0], m[0, 0])
    else:
        ax = np.arctan2(-m[1, 2], m[1, 1])
        ay = np.arctan2(-m[2, 0], sy)
        az = 0.0
    return np.array([ax, ay, az])


def quat2axisangle(q: np.ndarray) -> np.ndarray:
    x, y, z, w = np.asarray(q, np.float64)
    w = np.clip(w, -1.0, 1.0)
    den = np.sqrt(1.0 - w * w)
    if den < 1e-9:
        return np.zeros(3)
    return np.array([x, y, z]) * (2.0 * np.arccos(w)) / den


# Pillow's 8-bit resampling (libImaging/Resample.c): coefficients in
# fixed point with 32 - 8 - 2 fractional bits.
_PIL_PRECISION_BITS = 22


@functools.lru_cache(maxsize=32)
def _pil_bilinear_coeffs(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) int64 weights of Pillow's BILINEAR filter over the
    whole input (`precompute_coeffs` with the box (0, in_size), then
    `normalize_coeffs_8bpc`): the triangle of support 1, scaled by the
    downscale factor; each row's window from the rounded center -/+ support,
    its weights normalized to sum 1 in double, then rounded half away from
    zero to 22-bit fixed point."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ss = 1.0 / filterscale
    out = np.zeros((out_size, in_size), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        w = [max(1.0 - abs((x - center + 0.5) * ss), 0.0) for x in range(xmin, xmax)]
        total = 0.0
        for v in w:                  # summed in order, as the C loop does
            total += v
        if total != 0.0:
            w = [v / total for v in w]
        out[xx, xmin:xmax] = [int(v * (1 << _PIL_PRECISION_BITS) + (0.5 if v >= 0 else -0.5))
                              for v in w]
    out.setflags(write=False)
    return out


def _pil_pass(coeffs: np.ndarray, x: np.ndarray, axis: int) -> np.ndarray:
    """One 8-bit pass along `axis`: sum the weighted uint8 samples from a
    rounding offset of half an LSB, shift out the fraction, clip to [0, 255].
    The sums run as a float64 product: every term and partial sum is an
    integer below 2^53, so it is exact in any order."""
    acc = np.tensordot(coeffs.astype(np.float64), x.astype(np.float64), axes=([1], [axis]))
    acc = np.moveaxis(acc, 0, axis).astype(np.int64) + (1 << (_PIL_PRECISION_BITS - 1))
    return np.clip(acc >> _PIL_PRECISION_BITS, 0, 255).astype(np.uint8)


def bilinear_resize(image: np.ndarray, width: int, height: int) -> np.ndarray:
    """uint8 (H, W, C) -> uint8 (height, width, C), bitwise what PIL's
    `Image.fromarray(image).resize((width, height), Image.BILINEAR)` gives:
    the horizontal pass first (into uint8), then the vertical one, each
    skipped where that side keeps its size."""
    image = np.asarray(image, np.uint8)
    h, w = image.shape[:2]
    if w != width:
        image = _pil_pass(_pil_bilinear_coeffs(w, width), image, axis=1)
    if h != height:
        image = _pil_pass(_pil_bilinear_coeffs(h, height), image, axis=0)
    return image


def crop_front_image(image: np.ndarray, task_name: str = "pick_place",
                     out_size: int = 224) -> np.ndarray:
    """TASK_CROP crop + bilinear resize (reference get_action_robosuite,
    robosuite_utils.py:253-268), PIL's BILINEAR bit for bit."""
    top, bottom, left, right = TASK_CROP[task_name]
    h, w = image.shape[:2]
    cropped = image[top:h - bottom, left:w - right]
    return bilinear_resize(cropped, out_size, out_size)


def convert_action_to_world(action: np.ndarray, eef_pos: np.ndarray,
                            abs_pose: bool = False
                            ) -> Tuple[np.ndarray, float]:
    """Policy action -> OSC world-space command + binarized gripper state
    (reference test/pick_place.py:95-115): position = eef + delta (or
    absolute), orientation = axis-angle of euler2mat(-rpy), gripper = +1 when
    action[6] >= 0.97 else -1. Returns (world_action, gripper_closed_bit)."""
    action = np.asarray(action, np.float64)
    world = np.zeros(7)
    world[0:3] = action[0:3] if abs_pose else np.asarray(eef_pos) + action[0:3]
    world[3:6] = quat2axisangle(mat2quat(euler2mat(-action[3:6])))
    closed = 1.0 if action[6] >= 0.97 else 0.0
    world[6] = 1.0 if closed else -1.0
    return world, closed


def check_reach(threshold: float, obj_distance: np.ndarray,
                current_reach: bool) -> bool:
    """Reached when within `threshold` of the object (reference :168-172)."""
    return bool(current_reach or np.linalg.norm(obj_distance) < threshold)


def check_pick(threshold: float, obj_z: float, start_z: float, reached: bool,
               picked: bool) -> bool:
    """Picked when the object rose `threshold` above its start height after a
    reach (reference :163-166)."""
    return bool(picked or (reached and obj_z - start_z > threshold))


def check_bin(threshold: float, bin_pos: np.ndarray, obj_pos: np.ndarray,
              current_bin: bool) -> bool:
    """Placed when the object is inside the 16 cm bin footprint and within
    10 cm above the bin floor (reference :175-192)."""
    half = 0.16 / 2
    in_x = bin_pos[0] - half < obj_pos[0] < bin_pos[0] + half
    in_y = bin_pos[1] - half < obj_pos[1] < bin_pos[1] + half
    in_z = bin_pos[2] < obj_pos[2] < bin_pos[2] + 0.1
    return bool(current_bin or (in_x and in_y and in_z))


def check_peg(peg_pos: np.ndarray, obj_pos: np.ndarray,
              current_peg: bool) -> bool:
    """On-peg within 3 cm laterally and below the peg top (reference :195-207)."""
    res = (abs(obj_pos[0] - peg_pos[0]) < 0.03
           and abs(obj_pos[1] - peg_pos[1]) < 0.03
           and obj_pos[2] < 0.860 + 0.05)
    return bool(res or current_peg)


def prepare_observation(obs: Dict, resize_size: int = 224, gripper_closed: float = 0.0,
                        device: str = "cuda") -> Dict:
    """Reference layout (robosuite_utils.py:209-249): JPEG-roundtrip lanczos
    resize for both cameras on `device` (eye-in-hand horizontally flipped),
    proprio `eef_pose` = [eef_pos, mat2euler(R_ee_to_gripper @
    quat2mat(eef_quat))], `state` = joint positions, plus the tracked
    gripper_closed bit."""
    img = np.asarray(obs["camera_front_image"])
    wrist = np.asarray(obs["eye_in_hand_image"])[:, ::-1]  # horizontal flip
    eef_pose = np.zeros(6)
    if "eef_pos" in obs:
        eef_pose[0:3] = np.asarray(obs["eef_pos"])
        eef_pose[3:6] = mat2euler(
            R_EE_TO_GRIPPER @ quat2mat(np.asarray(obs["eef_quat"])))
    return {
        "full_image": resize_image_for_policy(img, resize_size, device),
        "wrist_image": resize_image_for_policy(wrist, resize_size, device),
        "camera_gripper_image": resize_image_for_policy(wrist, resize_size, device),
        "state": np.asarray(obs.get("joint_pos", np.zeros(6))),
        "eef_pose": eef_pose,
        "gripper_closed": gripper_closed,
    }


# Default OSC-pose controller parameters (the env's task-space action
# interface): delta-pose commands in [-1, 1], fixed impedance kp=150,
# uncoupled pos/ori — the values the reference ships as
# `multi_task_robosuite_env/controllers/config/osc_pose.json` and loads via
# `load_controller_config(custom_fpath=...)` (reference robosuite_utils.py:100-102).
# Kept in-repo so an empty `controller_path` works out of the box.
OSC_POSE_CONTROLLER = {
    "type": "OSC_POSE",
    "input_max": 1,
    "input_min": -1,
    "output_max": [1, 1, 1, 1, 1, 1],
    "output_min": [-1, -1, -1, -1, -1, -1],
    "kp": 150,
    "damping_ratio": 1,
    "impedance_mode": "fixed",
    "kp_limits": [0, 300],
    "damping_ratio_limits": [0, 10],
    "position_limits": None,
    "orientation_limits": None,
    "uncouple_pos_ori": True,
    "control_delta": True,
    "interpolation": None,
    "ramp_ratio": 0.2,
}

# Task registry (reference TASK_MAP, robosuite_utils.py:67-97): expert-env
# factory name inside the external `multi_task_robosuite_env` package, UR5e /
# Panda env ids, variation counts, render size, object set.
ROBOSUITE_TASK_MAP = {
    "pick_place": {
        "num_variations": 16,
        "num_variations_per_object": 4,
        "expert_module": "expert_pick_place",
        "agent-teacher": ("UR5e_PickPlaceDistractor", "Panda_PickPlaceDistractor"),
        "render_hw": (200, 360),
        "object_set": 2,
    },
    "nut_assembly": {
        "num_variations": 9,
        "expert_module": "expert_nut_assembly",
        "agent-teacher": ("UR5e_NutAssemblyDistractor", "Panda_NutAssemblyDistractor"),
        "render_hw": (200, 360),
        "object_set": 1,
    },
    "stack_block": {
        "num_variations": 6,
        "expert_module": "expert_block_stacking",
        "agent-teacher": ("UR5e_BlockStacking", "Panda_BlockStacking"),
        "render_hw": (200, 360),
        "object_set": 1,
    },
    "button": {
        "num_variations": 6,
        "expert_module": "expert_button",
        "agent-teacher": ("UR5e_Button", "Panda_Button"),
        "render_hw": (200, 360),
        "object_set": 1,
    },
}

# The sim-env package is an EXTERNAL pinned dependency (~14k LoC of mujoco
# task/controller/XML assets, not rebuilt here): install the reference fork's
# `experiments/robot/robosuite/tasks` tree as `multi_task_robosuite_env`
# (pip install -e, from ciccio42/openvla-oft @ main) next to robosuite==1.4
# + mujoco. See docs/ROADMAP.md.
MULTI_TASK_ENV_PACKAGE = "multi_task_robosuite_env"


def build_env_context(env_name: str, controller_path: str, variation: int,
                      seed: int, gpu_id: int = -1):
    """Construct the UR5e task env (reference `build_env_context`,
    robosuite_utils.py:99-120): load the OSC-pose controller config, resolve
    the task's expert-env factory from the external
    `multi_task_robosuite_env` package, and build the agent env."""
    import importlib
    import json

    try:
        from robosuite import load_controller_config
    except ImportError as e:
        raise ImportError(
            "robosuite evaluation requires the robosuite + mujoco packages "
            f"and the pinned {MULTI_TASK_ENV_PACKAGE} assets "
            "(see docs/ROADMAP.md).") from e

    if controller_path:
        controller = load_controller_config(custom_fpath=controller_path)
    else:  # in-repo defaults, identical to the fork's osc_pose.json
        import os
        import tempfile

        with tempfile.NamedTemporaryFile("w", suffix=".json",
                                         delete=False) as f:
            json.dump(OSC_POSE_CONTROLLER, f)
        try:
            controller = load_controller_config(custom_fpath=f.name)
        finally:
            os.unlink(f.name)

    # 'ur5e_pick_place[_abs_pose]' style names map onto the base task entry.
    base = next((k for k in ROBOSUITE_TASK_MAP if k in env_name), None)
    assert base is not None, f"Got unsupported task {env_name}"
    task = ROBOSUITE_TASK_MAP[base]

    mod = importlib.import_module(
        f"{MULTI_TASK_ENV_PACKAGE}.controllers.controllers."
        f"{task['expert_module']}")
    env_fn = mod.get_expert_trajectory
    agent_name, _teacher = task["agent-teacher"]
    return env_fn(agent_name, controller_type=controller, task=variation,
                  ret_env=True, seed=seed, gpu_id=gpu_id,
                  object_set=task["object_set"])
