"""Per-dataset standardization transforms for Open-X Embodiment (NumPy).

The port's copy of `openvla_oft_tpu/data/rlds/oxe/transforms.py` (reference
`prismatic/vla/datasets/rlds/oxe/transforms.py:30-943`)
with identical semantics: each transform takes a *batched* trajectory dict
(leading time dimension) and rewrites it to the standard layout

    {"observation": {<image keys>, <state keys>},
     "action": (T, 7|8|14) float32,
     "language_instruction": (T,) or scalar bytes/str}

The reference writes these as TF graph functions; here they are eager NumPy
(the pipeline, data/rlds/pipeline.py, standardizes each parsed episode on
the host).
"""

from __future__ import annotations

import zlib
from typing import Any, Dict

import numpy as np

from openvla_oft_tpu_torch.data.rlds.oxe.droid_utils import (  # noqa: F401
    droid_baseact_transform,
    droid_finetuning_transform,
    droid_wristact_transform,
    quat_to_euler,
)
from openvla_oft_tpu_torch.data.transforms import (
    binarize_gripper_actions,
    invert_gripper_actions,
    rel2abs_gripper_actions,
)


# === helpers ===
def _f32(*parts) -> np.ndarray:
    """Column-concatenate action parts as float32."""
    return np.concatenate([np.asarray(p, np.float32) for p in parts], axis=-1)


def _obs(traj: Dict) -> Dict:
    return traj["observation"]


def _lang_from_obs(traj: Dict) -> None:
    traj["language_instruction"] = _obs(traj)["natural_language_instruction"]


def _grip_inv_clip(g) -> np.ndarray:
    """clip to [0, 1] then flip so +1 = open, 0 = close."""
    return invert_gripper_actions(np.clip(np.asarray(g, np.float32), 0, 1))


def _grip_rel2abs(g) -> np.ndarray:
    return rel2abs_gripper_actions(np.asarray(g, np.float32))[:, None]


def _zeros(a, cols: int) -> np.ndarray:
    return np.zeros((np.asarray(a).shape[0], cols), np.float32)


def _truncate_first(traj: Dict) -> Dict:
    """Drop the first timestep everywhere except traj_metadata
    (bridge transforms — the first Bridge V2 action is all-zero)."""
    def rec(d):
        return {k: (v if k == "traj_metadata" else
                    rec(v) if isinstance(v, dict) else v[1:])
                for k, v in d.items()}

    return rec(traj)


def relabel_bridge_actions(traj: Dict) -> Dict:
    """Relabel arm actions as reached-state deltas; drop the last (no-action)
    step (reference data_utils.py:157-164)."""
    state = np.asarray(_obs(traj)["state"])
    movement = state[1:, :6] - state[:-1, :6]

    def rec(d):
        return {k: (rec(v) if isinstance(v, dict) else v[:-1])
                for k, v in d.items()}

    out = rec(traj)
    out["action"] = _f32(movement, np.asarray(traj["action"])[:-1, -1:])
    return out


# === MIVIA / fork-added UR5e (transforms.py:30-35) ===
def ur5e_pick_place_dataset_transform(traj: Dict) -> Dict:
    # unconditional, like the reference (transforms.py:32): a ur5e episode
    # without traj_metadata must fail loudly, not train on empty instructions
    traj["language_instruction"] = \
        traj["traj_metadata"]["language_instruction"]
    return traj


# === Bridge (transforms.py:37-92) ===
def bridge_oxe_dataset_transform(traj: Dict) -> Dict:
    traj = _truncate_first(traj)
    a = traj["action"]
    traj["action"] = _f32(a["world_vector"], a["rotation_delta"],
                          np.asarray(a["open_gripper"],
                                     np.float32)[:, None])
    _lang_from_obs(traj)
    traj = relabel_bridge_actions(traj)
    state = np.asarray(_obs(traj)["state"])
    _obs(traj)["EEF_state"] = state[:, :6]
    _obs(traj)["gripper_state"] = state[:, -1:]
    return traj


def bridge_orig_dataset_transform(traj: Dict) -> Dict:
    traj = _truncate_first(traj)
    a = np.asarray(traj["action"])
    traj["action"] = _f32(a[:, :6],
                          binarize_gripper_actions(a[:, -1])[:, None])
    traj = relabel_bridge_actions(traj)
    state = np.asarray(_obs(traj)["state"])
    _obs(traj)["EEF_state"] = state[:, :6]
    _obs(traj)["gripper_state"] = state[:, -1:]
    return traj


def ppgm_dataset_transform(traj: Dict) -> Dict:
    a = np.asarray(traj["action"])
    traj["action"] = _f32(a[:, :6],
                          binarize_gripper_actions(a[:, -1])[:, None])
    _obs(traj)["EEF_state"] = \
        np.asarray(_obs(traj)["cartesian_position"])[:, :6]
    _obs(traj)["gripper_state"] = \
        np.asarray(_obs(traj)["gripper_position"])[:, -1:]
    return traj


# === RT-X core (transforms.py:108-302) ===
def rt1_dataset_transform(traj: Dict) -> Dict:
    a = traj["action"]
    grip = _grip_rel2abs(np.asarray(a["gripper_closedness_action"])[:, 0])
    traj["action"] = _f32(a["world_vector"], a["rotation_delta"], grip)
    _lang_from_obs(traj)
    return traj


def kuka_dataset_transform(traj: Dict) -> Dict:
    a = traj["action"]
    grip = _grip_rel2abs(np.asarray(a["gripper_closedness_action"])[:, 0])
    traj["action"] = _f32(a["world_vector"], a["rotation_delta"], grip)
    # ZLIB-compressed proprio blobs -> float32 (transforms.py:138-147)
    obs = _obs(traj)
    obs["clip_function_input/base_pose_tool_reached"] = np.stack([
        np.frombuffer(zlib.decompress(v), np.float32).reshape(7)
        for v in obs["clip_function_input/base_pose_tool_reached"]])
    obs["gripper_closed"] = np.stack([
        np.frombuffer(zlib.decompress(v), np.float32).reshape(1)
        for v in obs["gripper_closed"]])
    _lang_from_obs(traj)
    return traj


def taco_play_dataset_transform(traj: Dict) -> Dict:
    obs = _obs(traj)
    robot_obs = np.asarray(obs["robot_obs"])
    obs["state_eef"] = robot_obs[:, :6]
    obs["state_gripper"] = robot_obs[:, 7:8]
    a = np.asarray(traj["action"]["rel_actions_world"], np.float32)
    traj["action"] = _f32(a[:, :6], np.clip(a[:, -1:], 0, 1))
    _lang_from_obs(traj)
    return traj


def jaco_play_dataset_transform(traj: Dict) -> Dict:
    obs = _obs(traj)
    eef = np.asarray(obs["end_effector_cartesian_pos"])
    obs["state_eef"] = eef[:, :6]
    obs["state_gripper"] = eef[:, -1:]
    a = traj["action"]
    grip = _grip_rel2abs(np.asarray(a["gripper_closedness_action"])[:, 0])
    wv = np.asarray(a["world_vector"], np.float32)
    traj["action"] = _f32(wv, np.zeros_like(wv), grip)
    _lang_from_obs(traj)
    return traj


def berkeley_cable_routing_dataset_transform(traj: Dict) -> Dict:
    a = traj["action"]
    wv = np.asarray(a["world_vector"], np.float32)
    traj["action"] = _f32(wv, a["rotation_delta"], np.zeros_like(wv[:, :1]))
    _lang_from_obs(traj)
    return traj


def roboturk_dataset_transform(traj: Dict) -> Dict:
    a = traj["action"]
    grip = _grip_inv_clip(a["gripper_closedness_action"])
    traj["action"] = _f32(a["world_vector"], a["rotation_delta"], grip)
    _lang_from_obs(traj)
    return traj


def nyu_door_opening_dataset_transform(traj: Dict) -> Dict:
    a = traj["action"]
    grip = _grip_rel2abs(np.asarray(a["gripper_closedness_action"])[:, 0])
    traj["action"] = _f32(a["world_vector"], a["rotation_delta"], grip)
    _lang_from_obs(traj)
    return traj


def viola_dataset_transform(traj: Dict) -> Dict:
    a = traj["action"]
    grip = _grip_inv_clip(
        np.asarray(a["gripper_closedness_action"])[:, None])
    traj["action"] = _f32(a["world_vector"], a["rotation_delta"], grip)
    _lang_from_obs(traj)
    return traj


def berkeley_autolab_ur5_dataset_transform(traj: Dict) -> Dict:
    obs = _obs(traj)
    obs["state"] = np.asarray(obs["robot_state"])[:, 6:14]
    obs["depth"] = obs.pop("image_with_depth")
    a = traj["action"]
    grip = _grip_rel2abs(np.asarray(a["gripper_closedness_action"]))
    traj["action"] = _f32(a["world_vector"], a["rotation_delta"], grip)
    _lang_from_obs(traj)
    return traj


def toto_dataset_transform(traj: Dict) -> Dict:
    a = traj["action"]
    traj["action"] = _f32(a["world_vector"], a["rotation_delta"],
                          np.asarray(a["open_gripper"],
                                     np.float32)[:, None])
    _lang_from_obs(traj)
    return traj


def language_table_dataset_transform(traj: Dict) -> Dict:
    a = np.asarray(traj["action"], np.float32)  # (T, 2) planar
    traj["action"] = _f32(a, np.zeros_like(a), np.zeros_like(a),
                          np.ones_like(a[:, :1]))  # gripper defaults open
    # instructions stored as padded unicode codepoints (transforms.py:317-321)
    instr = np.asarray(_obs(traj)["instruction"])
    traj["language_instruction"] = np.asarray([
        "".join(chr(c) for c in row[:np.argmax(row == 0)] if c)
        if (row == 0).any() else "".join(chr(c) for c in row)
        for row in instr])
    return traj


def pusht_dataset_transform(traj: Dict) -> Dict:
    a = traj["action"]
    traj["action"] = _f32(a["world_vector"], a["rotation_delta"],
                          np.asarray(a["gripper_closedness_action"],
                                     np.float32)[:, None])
    _lang_from_obs(traj)
    return traj


# === Externally converted members (transforms.py:338-817) ===
def stanford_kuka_multimodal_dataset_transform(traj: Dict) -> Dict:
    obs = _obs(traj)
    obs["depth_image"] = np.asarray(obs["depth_image"])[..., 0]
    a = np.asarray(traj["action"])
    traj["action"] = _f32(a[:, :3], _zeros(a, 3), a[:, -1:])
    return traj


def nyu_rot_dataset_transform(traj: Dict) -> Dict:
    obs = _obs(traj)
    state = np.asarray(obs["state"])
    obs["EEF_state"] = state[..., :6]
    obs["gripper_state"] = state[..., -1:]
    traj["action"] = np.asarray(traj["action"], np.float32)[..., :7]
    return traj


def stanford_hydra_dataset_transform(traj: Dict) -> Dict:
    a = np.asarray(traj["action"])
    traj["action"] = _f32(a[:, :6], invert_gripper_actions(a[:, -1:]))
    obs = _obs(traj)
    state = np.asarray(obs["state"])
    obs["EEF_state"] = np.concatenate([state[:, :3], state[:, 7:10]], axis=-1)
    obs["gripper_state"] = state[:, -3:-2]
    return traj


def austin_buds_dataset_transform(traj: Dict) -> Dict:
    a = np.asarray(traj["action"])
    traj["action"] = _f32(a[:, :6], _grip_inv_clip(a[:, -1:]))
    _obs(traj)["state"] = np.asarray(_obs(traj)["state"])[:, :8]
    return traj


def nyu_franka_play_dataset_transform(traj: Dict) -> Dict:
    obs = _obs(traj)
    obs["depth"] = np.asarray(obs["depth"])[..., 0].astype(np.float32)
    obs["depth_additional_view"] = np.asarray(
        obs["depth_additional_view"])[..., 0].astype(np.float32)
    obs["eef_state"] = np.asarray(obs["state"])[:, -6:]
    a = np.asarray(traj["action"], np.float32)
    traj["action"] = _f32(a[:, -8:-2], np.clip(a[:, -2:-1], 0, 1))
    return traj


def maniskill_dataset_transform(traj: Dict) -> Dict:
    _obs(traj)["gripper_state"] = \
        np.asarray(_obs(traj)["state"])[..., 7:8]
    return traj


def furniture_bench_dataset_transform(traj: Dict) -> Dict:
    obs = _obs(traj)
    state = np.asarray(obs["state"])
    obs["state"] = np.concatenate([state[:, :7], state[:, -1:]], axis=-1)
    a = np.asarray(traj["action"])
    traj["action"] = _f32(a[:, :3], quat_to_euler(a[:, 3:7]),
                          _grip_inv_clip(a[:, -1:]))
    return traj


def cmu_franka_exploration_dataset_transform(traj: Dict) -> Dict:
    traj["action"] = np.asarray(traj["action"], np.float32)[..., :-1]
    return traj


def ucsd_kitchen_dataset_transform(traj: Dict) -> Dict:
    _obs(traj)["joint_state"] = np.asarray(_obs(traj)["state"])[:, :7]
    traj["action"] = np.asarray(traj["action"], np.float32)[..., :-1]
    return traj


def ucsd_pick_place_dataset_transform(traj: Dict) -> Dict:
    obs = _obs(traj)
    state = np.asarray(obs["state"])
    obs["EEF_state"] = state[:, :6]
    obs["gripper_state"] = state[:, -1:]
    a = np.asarray(traj["action"])
    traj["action"] = _f32(a[:, :3], _zeros(a, 3), a[:, -1:])
    return traj


def austin_sailor_dataset_transform(traj: Dict) -> Dict:
    a = np.asarray(traj["action"])
    traj["action"] = _f32(a[:, :6], _grip_inv_clip(a[:, -1:]))
    return traj


def austin_sirius_dataset_transform(traj: Dict) -> Dict:
    a = np.asarray(traj["action"])
    traj["action"] = _f32(a[:, :6], _grip_inv_clip(a[:, -1:]))
    return traj


def bc_z_dataset_transform(traj: Dict) -> Dict:
    a = traj["action"]
    traj["action"] = _f32(
        np.asarray(a["future/xyz_residual"])[:, :3],
        np.asarray(a["future/axis_angle_residual"])[:, :3],
        invert_gripper_actions(
            np.asarray(a["future/target_close"], np.float32)[:, :1]))
    _lang_from_obs(traj)
    return traj


def tokyo_pr2_opening_fridge_dataset_transform(traj: Dict) -> Dict:
    obs = _obs(traj)
    state = np.asarray(obs["state"])
    obs["EEF_state"] = state[:, :6]
    obs["gripper_state"] = state[:, -1:]
    traj["action"] = np.asarray(traj["action"], np.float32)[..., :-1]
    return traj


def tokyo_pr2_tabletop_manipulation_dataset_transform(traj: Dict) -> Dict:
    return tokyo_pr2_opening_fridge_dataset_transform(traj)


def utokyo_xarm_pick_place_dataset_transform(traj: Dict) -> Dict:
    return traj


def utokyo_xarm_bimanual_dataset_transform(traj: Dict) -> Dict:
    traj["action"] = np.asarray(traj["action"], np.float32)[..., -7:]
    return traj


def robo_net_dataset_transform(traj: Dict) -> Dict:
    obs = _obs(traj)
    state = np.asarray(obs["state"])
    obs["EEF_state"] = np.concatenate(
        [state[:, :4], np.zeros_like(state[:, :2])], axis=-1)
    obs["gripper_state"] = state[:, -1:]
    a = np.asarray(traj["action"])
    traj["action"] = _f32(a[:, :4], _zeros(a, 2), a[:, -1:])
    return traj


def berkeley_mvp_dataset_transform(traj: Dict) -> Dict:
    return traj


def berkeley_rpt_dataset_transform(traj: Dict) -> Dict:
    return traj


def kaist_nonprehensible_dataset_transform(traj: Dict) -> Dict:
    _obs(traj)["state"] = np.asarray(_obs(traj)["state"])[:, -7:]
    a = np.asarray(traj["action"])
    traj["action"] = _f32(a[:, :6], _zeros(a, 1))
    return traj


def stanford_mask_vit_dataset_transform(traj: Dict) -> Dict:
    obs = _obs(traj)
    eef = np.asarray(obs["end_effector_pose"])
    obs["EEF_state"] = np.concatenate(
        [eef[:, :4], np.zeros_like(eef[:, :2])], axis=-1)
    obs["gripper_state"] = eef[:, -1:]
    a = np.asarray(traj["action"])
    traj["action"] = _f32(a[:, :4], _zeros(a, 2), a[:, -1:])
    return traj


def tokyo_lsmo_dataset_transform(traj: Dict) -> Dict:
    obs = _obs(traj)
    state = np.asarray(obs["state"])
    obs["EEF_state"] = state[:, :6]
    obs["gripper_state"] = state[:, -1:]
    return traj


def dlr_sara_pour_dataset_transform(traj: Dict) -> Dict:
    return traj


def dlr_sara_grid_clamp_dataset_transform(traj: Dict) -> Dict:
    _obs(traj)["state"] = np.asarray(_obs(traj)["state"])[:, :6]
    return traj


def dlr_edan_shared_control_dataset_transform(traj: Dict) -> Dict:
    a = np.asarray(traj["action"])
    traj["action"] = _f32(a[:, :6], invert_gripper_actions(a[:, -1:]))
    return traj


def asu_table_top_dataset_transform(traj: Dict) -> Dict:
    obs = _obs(traj)
    obs["EEF_state"] = np.asarray(traj["ground_truth_states"]["EE"])
    obs["gripper_state"] = np.asarray(obs["state"])[:, -1:]
    return traj


def robocook_dataset_transform(traj: Dict) -> Dict:
    obs = _obs(traj)
    state = np.asarray(obs["state"])
    obs["EEF_state"] = state[:, :6]
    obs["gripper_state"] = state[:, -1:]
    return traj


def imperial_wristcam_dataset_transform(traj: Dict) -> Dict:
    traj["action"] = np.asarray(traj["action"], np.float32)[..., :-1]
    return traj


def iamlab_pick_insert_dataset_transform(traj: Dict) -> Dict:
    obs = _obs(traj)
    state = np.asarray(obs["state"])
    obs["joint_state"] = state[:, :7]
    obs["gripper_state"] = state[:, 7:8]
    a = np.asarray(traj["action"])
    traj["action"] = _f32(a[:, :3], quat_to_euler(a[:, 3:7]), a[:, 7:8])
    return traj


def uiuc_d3field_dataset_transform(traj: Dict) -> Dict:
    a = np.asarray(traj["action"], np.float32)
    traj["action"] = _f32(a, np.zeros_like(a), np.zeros_like(a[:, :1]))
    return traj


def utaustin_mutex_dataset_transform(traj: Dict) -> Dict:
    _obs(traj)["state"] = np.asarray(_obs(traj)["state"])[:, :8]
    a = np.asarray(traj["action"])
    traj["action"] = _f32(a[:, :6], _grip_inv_clip(a[:, -1:]))
    return traj


def berkeley_fanuc_dataset_transform(traj: Dict) -> Dict:
    obs = _obs(traj)
    state = np.asarray(obs["state"])
    obs["joint_state"] = state[:, :6]
    obs["gripper_state"] = state[:, 6:7]
    # no gripper action stored: derive from (inverted) gripper state
    traj["action"] = _f32(traj["action"],
                          invert_gripper_actions(obs["gripper_state"]))
    return traj


def cmu_playing_with_food_dataset_transform(traj: Dict) -> Dict:
    a = np.asarray(traj["action"])
    traj["action"] = _f32(a[:, :3], quat_to_euler(a[:, 3:7]), a[:, -1:])
    return traj


def playfusion_dataset_transform(traj: Dict) -> Dict:
    a = np.asarray(traj["action"])
    traj["action"] = _f32(a[:, :3], a[:, -4:])
    return traj


def cmu_stretch_dataset_transform(traj: Dict) -> Dict:
    obs = _obs(traj)
    state = np.asarray(obs["state"])
    obs["EEF_state"] = np.concatenate(
        [state[:, :3], np.zeros_like(state[:, :3])], axis=-1)
    obs["gripper_state"] = state[:, -1:]
    traj["action"] = np.asarray(traj["action"], np.float32)[..., :-1]
    return traj


def gnm_dataset_transform(traj: Dict) -> Dict:
    obs = _obs(traj)
    obs["state"] = np.concatenate(
        [np.asarray(obs["position"]),
         np.zeros_like(np.asarray(obs["state"])[:, :3]),
         np.asarray(obs["yaw"])], axis=-1)
    a = np.asarray(traj["action"], np.float32)
    traj["action"] = _f32(a, np.zeros_like(a), np.zeros_like(a),
                          np.zeros_like(a[:, :1]))
    return traj


def fmb_dataset_transform(traj: Dict) -> Dict:
    obs = _obs(traj)
    obs["proprio"] = np.concatenate(
        [np.asarray(obs["eef_pose"]),
         np.asarray(obs["state_gripper_pose"])[..., None]], axis=-1)
    return traj


def dobbe_dataset_transform(traj: Dict) -> Dict:
    _obs(traj)["proprio"] = _obs(traj)["state"]
    return traj


def roboset_dataset_transform(traj: Dict) -> Dict:
    _obs(traj)["proprio"] = _obs(traj)["state"]
    a = np.asarray(traj["action"])
    traj["action"] = _f32(a[:, :7], _grip_inv_clip(a[:, -1:]))
    return traj


def rh20t_dataset_transform(traj: Dict) -> Dict:
    a = traj["action"]
    traj["action"] = _f32(a["tcp_base"],
                          np.asarray(a["gripper"], np.float32)[:, None])
    obs = _obs(traj)
    obs["proprio"] = np.concatenate(
        [np.asarray(obs["tcp_base"]),
         np.asarray(obs["gripper_width"])[..., None]], axis=-1)
    return traj


# === T-DROID (transforms.py:820-830) ===
def tdroid_dataset_transform(traj: Dict) -> Dict:
    a = np.asarray(traj["action"])
    traj["action"] = _f32(a[:, :6],
                          binarize_gripper_actions(a[:, -1])[:, None])
    obs = _obs(traj)
    obs["EEF_state"] = np.asarray(obs["cartesian_position"])[:, :6]
    obs["gripper_state"] = np.asarray(obs["gripper_position"])[:, -1:]
    return traj


# === LIBERO suites (transforms.py:833-847) ===
def libero_dataset_transform(traj: Dict) -> Dict:
    """Gripper -1 (open)..1 (close) -> clip [0,1], flip -> +1 = open."""
    a = np.asarray(traj["action"])
    traj["action"] = _f32(a[:, :6], _grip_inv_clip(a[:, -1:]))
    obs = _obs(traj)
    state = np.asarray(obs["state"])
    obs["EEF_state"] = state[:, :6]
    obs["gripper_state"] = state[:, -2:]  # 2-D gripper state
    return traj


# === ALOHA (transforms.py:850-852) ===
def aloha_dataset_transform(traj: Dict) -> Dict:
    return traj  # already standardized
