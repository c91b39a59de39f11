"""Open-X Embodiment per-dataset configs (full reference breadth).

The port's copy of `openvla_oft_tpu/data/rlds/oxe/configs.py` (reference
`prismatic/vla/datasets/rlds/oxe/configs.py:54-726`):
a registration-driven table (not a dict literal) of observation-key mappings,
state/action encodings, and depth keys for every dataset the reference can
train on — the RT-X core, the magic-soup members, T-DROID, DROID, the LIBERO
suites, ALOHA fine-tuning sets, and the fork-added UR5e sets.

`state_obs_keys` is copied per-entry from the reference (verified 66/66
identical): the listed observation keys concatenate into the proprio vector,
with `None` entries padding a zero column. The StateEncoding describes the
*semantic* layout only — widths vary per entry in the reference itself (e.g.
bridge POS_EULER entries are 7-D with no pad column, taco_play's is 8-D), so
do NOT "normalize" entries to a fixed width; mixture members with unequal
proprio widths cannot share one interleaved proprio stream and should train
with use_proprio=False or per-dataset projectors.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Dict, Optional, Sequence

from openvla_oft_tpu_torch.data.rlds.oxe import transforms as T
from openvla_oft_tpu_torch.data.rlds.oxe.droid_utils import zero_action_filter


class StateEncoding(enum.IntEnum):
    """Proprio layouts (reference oxe/configs.py:33-40)."""

    NONE = -1
    POS_EULER = 1       # EEF XYZ + RPY + pad + gripper
    POS_QUAT = 2        # EEF XYZ + quat + gripper
    JOINT = 3           # 7 joints + gripper
    JOINT_BIMANUAL = 4  # 2x (6 joints + gripper)


class ActionEncoding(enum.IntEnum):
    """Action layouts (reference oxe/configs.py:43-50)."""

    EEF_POS = 1             # delta XYZ + RPY + gripper          (7)
    JOINT_POS = 2           # delta joints + gripper             (8)
    JOINT_POS_BIMANUAL = 3  # 2x (delta joints 6 + gripper)      (14)
    EEF_R6 = 4              # delta XYZ + R6 rotation + gripper  (10)


@dataclasses.dataclass(frozen=True)
class OXEDatasetConfig:
    name: str
    image_obs_keys: Dict[str, Optional[str]]
    state_obs_keys: Sequence[Optional[str]]
    state_encoding: StateEncoding
    action_encoding: ActionEncoding
    depth_obs_keys: Dict[str, Optional[str]] = dataclasses.field(
        default_factory=lambda: {"primary": None, "secondary": None,
                                 "wrist": None})
    aux_kwargs: Dict = dataclasses.field(default_factory=dict)


OXE_DATASET_CONFIGS: Dict[str, OXEDatasetConfig] = {}
OXE_STANDARDIZATION_TRANSFORMS: Dict[str, Callable] = {}

# shorthands used below
_PE, _PQ, _J, _JB = (StateEncoding.POS_EULER, StateEncoding.POS_QUAT,
                     StateEncoding.JOINT, StateEncoding.JOINT_BIMANUAL)
_EEF, _JP, _JPB = (ActionEncoding.EEF_POS, ActionEncoding.JOINT_POS,
                   ActionEncoding.JOINT_POS_BIMANUAL)


def register_dataset(name: str, *, primary: Optional[str] = "image",
                     secondary: Optional[str] = None,
                     wrist: Optional[str] = None,
                     state_obs_keys: Sequence[Optional[str]] = (),
                     state_encoding: StateEncoding = StateEncoding.NONE,
                     action_encoding: ActionEncoding = ActionEncoding.EEF_POS,
                     transform: Optional[Callable] = None,
                     image_obs_keys: Optional[Dict[str, Optional[str]]] = None,
                     depth_primary: Optional[str] = None,
                     depth_secondary: Optional[str] = None,
                     depth_wrist: Optional[str] = None,
                     aux_kwargs: Optional[Dict] = None):
    cfg = OXEDatasetConfig(
        name=name,
        image_obs_keys=image_obs_keys if image_obs_keys is not None else
        {"primary": primary, "secondary": secondary, "wrist": wrist},
        state_obs_keys=tuple(state_obs_keys),
        state_encoding=state_encoding,
        action_encoding=action_encoding,
        depth_obs_keys={"primary": depth_primary, "secondary": depth_secondary,
                        "wrist": depth_wrist},
        aux_kwargs=aux_kwargs or {})
    OXE_DATASET_CONFIGS[name] = cfg
    if transform is not None:
        OXE_STANDARDIZATION_TRANSFORMS[name] = transform
    return cfg


# === Fork-added UR5e sets (reference oxe/configs.py:55-71) ===
for _n in ("ur5e_pick_place", "ur5e_pick_place_abs_pose"):
    register_dataset(
        _n,
        image_obs_keys={"camera_front_image": "camera_front_image",
                        "camera_gripper_image": "camera_gripper_image",
                        "secondary": None, "wrist": None},
        state_obs_keys=["eef_pose"], state_encoding=_PE,
        transform=T.ur5e_pick_place_dataset_transform)

# === RT-X core (reference oxe/configs.py:72-207) ===
register_dataset("fractal20220817_data", primary="image",
                 state_obs_keys=["base_pose_tool_reached", "gripper_closed"],
                 state_encoding=_PQ, transform=T.rt1_dataset_transform)
register_dataset("kuka", primary="image",
                 state_obs_keys=["clip_function_input/base_pose_tool_reached",
                                 "gripper_closed"],
                 state_encoding=_PQ, transform=T.kuka_dataset_transform)
register_dataset("bridge_oxe", primary="image", secondary="image_1",
                 state_obs_keys=["EEF_state", "gripper_state"],
                 state_encoding=_PE, transform=T.bridge_oxe_dataset_transform)
for _n in ("bridge_orig", "bridge_dataset"):
    register_dataset(_n, primary="image_0", secondary="image_1",
                     state_obs_keys=["EEF_state", "gripper_state"],
                     state_encoding=_PE,
                     transform=T.bridge_orig_dataset_transform)
for _n in ("ppgm", "ppgm_static", "ppgm_wrist"):
    register_dataset(_n, primary="image", wrist="wrist_image",
                     state_obs_keys=["EEF_state", "gripper_state"],
                     state_encoding=_PE, transform=T.ppgm_dataset_transform)
register_dataset("taco_play", primary="rgb_static", wrist="rgb_gripper",
                 depth_primary="depth_static", depth_wrist="depth_gripper",
                 state_obs_keys=["state_eef", None, "state_gripper"],
                 state_encoding=_PE, transform=T.taco_play_dataset_transform)
register_dataset("jaco_play", primary="image", wrist="image_wrist",
                 state_obs_keys=["state_eef", None, "state_gripper"],
                 state_encoding=_PE, transform=T.jaco_play_dataset_transform)
register_dataset("berkeley_cable_routing", primary="image",
                 secondary="top_image", wrist="wrist45_image",
                 state_obs_keys=["robot_state", None], state_encoding=_J,
                 transform=T.berkeley_cable_routing_dataset_transform)
register_dataset("roboturk", primary="front_rgb",
                 state_obs_keys=[None] * 8,
                 transform=T.roboturk_dataset_transform)
register_dataset("nyu_door_opening_surprising_effectiveness", primary=None,
                 wrist="image", state_obs_keys=[None] * 8,
                 transform=T.nyu_door_opening_dataset_transform)
register_dataset("viola", primary="agentview_rgb", wrist="eye_in_hand_rgb",
                 state_obs_keys=["joint_states", "gripper_states"],
                 state_encoding=_J, transform=T.viola_dataset_transform)
register_dataset("berkeley_autolab_ur5", primary="image", wrist="hand_image",
                 depth_primary="depth", state_obs_keys=["state"],
                 state_encoding=_PQ,
                 transform=T.berkeley_autolab_ur5_dataset_transform)
register_dataset("toto", primary="image", state_obs_keys=["state", None],
                 state_encoding=_J, transform=T.toto_dataset_transform)
register_dataset("language_table", primary="rgb",
                 state_obs_keys=["effector_translation"] + [None] * 6,
                 state_encoding=_PE,
                 transform=T.language_table_dataset_transform)
register_dataset("columbia_cairlab_pusht_real", primary="image",
                 wrist="wrist_image",
                 state_obs_keys=["robot_state"] + [None] * 6,
                 state_encoding=_PE, transform=T.pusht_dataset_transform)

# === Externally-converted OXE members (configs.py:208-609) ===
register_dataset("stanford_kuka_multimodal_dataset_converted_externally_to_rlds",
                 primary="image", depth_primary="depth_image",
                 state_obs_keys=["ee_position", "ee_orientation", None],
                 state_encoding=_PQ,
                 transform=T.stanford_kuka_multimodal_dataset_transform)
register_dataset("nyu_rot_dataset_converted_externally_to_rlds",
                 primary="image",
                 state_obs_keys=["EEF_state", "gripper_state"],
                 state_encoding=_PE, transform=T.nyu_rot_dataset_transform)
register_dataset("stanford_hydra_dataset_converted_externally_to_rlds",
                 primary="image", wrist="wrist_image",
                 state_obs_keys=["EEF_state", "gripper_state"],
                 state_encoding=_PE,
                 transform=T.stanford_hydra_dataset_transform)
register_dataset("austin_buds_dataset_converted_externally_to_rlds",
                 primary="image", wrist="wrist_image",
                 state_obs_keys=["state"], state_encoding=_J,
                 transform=T.austin_buds_dataset_transform)
register_dataset("nyu_franka_play_dataset_converted_externally_to_rlds",
                 primary="image", secondary="image_additional_view",
                 depth_primary="depth",
                 depth_secondary="depth_additional_view",
                 state_obs_keys=["eef_state", None, None], state_encoding=_PE,
                 transform=T.nyu_franka_play_dataset_transform)
register_dataset("maniskill_dataset_converted_externally_to_rlds",
                 primary="image", wrist="wrist_image",
                 depth_primary="depth", depth_wrist="wrist_depth",
                 state_obs_keys=["tcp_pose", "gripper_state"],
                 state_encoding=_PQ, transform=T.maniskill_dataset_transform)
register_dataset("furniture_bench_dataset_converted_externally_to_rlds",
                 primary="image", wrist="wrist_image",
                 state_obs_keys=["state"], state_encoding=_PQ,
                 transform=T.furniture_bench_dataset_transform)
register_dataset("cmu_franka_exploration_dataset_converted_externally_to_rlds",
                 primary="highres_image", state_obs_keys=[None] * 8,
                 transform=T.cmu_franka_exploration_dataset_transform)
register_dataset("ucsd_kitchen_dataset_converted_externally_to_rlds",
                 primary="image", state_obs_keys=["joint_state", None],
                 state_encoding=_J, transform=T.ucsd_kitchen_dataset_transform)
register_dataset("ucsd_pick_and_place_dataset_converted_externally_to_rlds",
                 primary="image",
                 state_obs_keys=["EEF_state", "gripper_state"],
                 state_encoding=_PE,
                 transform=T.ucsd_pick_place_dataset_transform)
register_dataset("austin_sailor_dataset_converted_externally_to_rlds",
                 primary="image", wrist="wrist_image",
                 state_obs_keys=["state"], state_encoding=_PQ,
                 transform=T.austin_sailor_dataset_transform)
register_dataset("austin_sirius_dataset_converted_externally_to_rlds",
                 primary="image", wrist="wrist_image",
                 state_obs_keys=["state"], state_encoding=_PQ,
                 transform=T.austin_sirius_dataset_transform)
register_dataset("bc_z", primary="image",
                 state_obs_keys=["present/xyz", "present/axis_angle", None,
                                 "present/sensed_close"],
                 state_encoding=_PE, transform=T.bc_z_dataset_transform)
register_dataset("utokyo_pr2_opening_fridge_converted_externally_to_rlds",
                 primary="image",
                 state_obs_keys=["EEF_state", "gripper_state"],
                 state_encoding=_PE,
                 transform=T.tokyo_pr2_opening_fridge_dataset_transform)
register_dataset("utokyo_pr2_tabletop_manipulation_converted_externally_to_rlds",
                 primary="image",
                 state_obs_keys=["EEF_state", "gripper_state"],
                 state_encoding=_PE,
                 transform=T.tokyo_pr2_tabletop_manipulation_dataset_transform)
register_dataset("utokyo_xarm_pick_and_place_converted_externally_to_rlds",
                 primary="image", secondary="image2", wrist="hand_image",
                 state_obs_keys=["end_effector_pose", None, None],
                 state_encoding=_PE,
                 transform=T.utokyo_xarm_pick_place_dataset_transform)
register_dataset("utokyo_xarm_bimanual_converted_externally_to_rlds",
                 primary="image", state_obs_keys=["pose_r", None, None],
                 state_encoding=_PE,
                 transform=T.utokyo_xarm_bimanual_dataset_transform)
register_dataset("robo_net", primary="image", secondary="image1",
                 state_obs_keys=["EEF_state", "gripper_state"],
                 state_encoding=_PE, transform=T.robo_net_dataset_transform)
register_dataset("berkeley_mvp_converted_externally_to_rlds", primary=None,
                 wrist="hand_image", state_obs_keys=["pose", "gripper"],
                 state_encoding=_PQ, action_encoding=_JP,
                 transform=T.berkeley_mvp_dataset_transform)
register_dataset("berkeley_rpt_converted_externally_to_rlds", primary=None,
                 wrist="hand_image", state_obs_keys=["joint_pos", "gripper"],
                 state_encoding=_J, action_encoding=_JP,
                 transform=T.berkeley_rpt_dataset_transform)
register_dataset("kaist_nonprehensile_converted_externally_to_rlds",
                 primary="image", state_obs_keys=["state", None],
                 state_encoding=_PQ,
                 transform=T.kaist_nonprehensible_dataset_transform)
register_dataset("stanford_mask_vit_converted_externally_to_rlds",
                 primary="image",
                 state_obs_keys=["EEF_state", "gripper_state"],
                 state_encoding=_PE,
                 transform=T.stanford_mask_vit_dataset_transform)
register_dataset("tokyo_u_lsmo_converted_externally_to_rlds", primary="image",
                 state_obs_keys=["EEF_state", "gripper_state"],
                 state_encoding=_PE, transform=T.tokyo_lsmo_dataset_transform)
register_dataset("dlr_sara_pour_converted_externally_to_rlds", primary="image",
                 state_obs_keys=["state", None, None], state_encoding=_PE,
                 transform=T.dlr_sara_pour_dataset_transform)
register_dataset("dlr_sara_grid_clamp_converted_externally_to_rlds",
                 primary="image", state_obs_keys=["state", None, None],
                 state_encoding=_PE,
                 transform=T.dlr_sara_grid_clamp_dataset_transform)
register_dataset("dlr_edan_shared_control_converted_externally_to_rlds",
                 primary="image", state_obs_keys=["state", None],
                 state_encoding=_PE,
                 transform=T.dlr_edan_shared_control_dataset_transform)
register_dataset("asu_table_top_converted_externally_to_rlds", primary="image",
                 state_obs_keys=["EEF_state", "gripper_state"],
                 state_encoding=_PE, transform=T.asu_table_top_dataset_transform)
register_dataset("stanford_robocook_converted_externally_to_rlds",
                 primary="image_1", secondary="image_2",
                 depth_primary="depth_1", depth_secondary="depth_2",
                 state_obs_keys=["EEF_state", "gripper_state"],
                 state_encoding=_PE, transform=T.robocook_dataset_transform)
register_dataset("imperialcollege_sawyer_wrist_cam", primary="image",
                 wrist="wrist_image",
                 state_obs_keys=[None] * 7 + ["state"],
                 transform=T.imperial_wristcam_dataset_transform)
register_dataset("iamlab_cmu_pickup_insert_converted_externally_to_rlds",
                 primary="image", wrist="wrist_image",
                 state_obs_keys=["joint_state", "gripper_state"],
                 state_encoding=_J,
                 transform=T.iamlab_pick_insert_dataset_transform)
register_dataset("uiuc_d3field", primary="image_1", secondary="image_2",
                 depth_primary="depth_1", depth_secondary="depth_2",
                 state_obs_keys=[None] * 8,
                 transform=T.uiuc_d3field_dataset_transform)
register_dataset("utaustin_mutex", primary="image", wrist="wrist_image",
                 state_obs_keys=["state"], state_encoding=_J,
                 transform=T.utaustin_mutex_dataset_transform)
register_dataset("berkeley_fanuc_manipulation", primary="image",
                 wrist="wrist_image",
                 state_obs_keys=["joint_state", None, "gripper_state"],
                 state_encoding=_J, transform=T.berkeley_fanuc_dataset_transform)
register_dataset("cmu_playing_with_food", primary="image",
                 wrist="finger_vision_1",
                 state_obs_keys=["state", None, None], state_encoding=_PE,
                 transform=T.cmu_playing_with_food_dataset_transform)
register_dataset("cmu_play_fusion", primary="image", state_obs_keys=["state"],
                 state_encoding=_J, transform=T.playfusion_dataset_transform)
register_dataset("cmu_stretch", primary="image",
                 state_obs_keys=["EEF_state", "gripper_state"],
                 state_encoding=_PE, transform=T.cmu_stretch_dataset_transform)
for _n in ("berkeley_gnm_recon", "berkeley_gnm_cory_hall",
           "berkeley_gnm_sac_son"):
    register_dataset(_n, primary=None, wrist="image",
                     state_obs_keys=["state", None, None], state_encoding=_PE,
                     transform=T.gnm_dataset_transform)
register_dataset("droid", primary="exterior_image_1_left",
                 secondary="exterior_image_2_left", wrist="wrist_image_left",
                 state_obs_keys=["proprio"], state_encoding=_PQ,
                 transform=T.droid_baseact_transform,
                 aux_kwargs={"dataset_frame_transform_kwargs": {
                     "chunk_filter_fn": zero_action_filter}})
register_dataset("fmb_dataset", primary="image_side_1",
                 secondary="image_side_2", wrist="image_wrist_1",
                 depth_primary="image_side_1_depth",
                 depth_secondary="image_side_2_depth",
                 depth_wrist="image_wrist_1_depth",
                 state_obs_keys=["proprio"], state_encoding=_PE,
                 transform=T.fmb_dataset_transform)
register_dataset("dobbe", primary="wrist_image", state_obs_keys=["proprio"],
                 state_encoding=_PE, transform=T.dobbe_dataset_transform)
register_dataset("roboset", primary="image_left", secondary="image_right",
                 wrist="image_wrist", state_obs_keys=["proprio"],
                 state_encoding=_J, action_encoding=_JP,
                 transform=T.roboset_dataset_transform)
register_dataset("rh20t", primary="image_front",
                 secondary="image_side_right", wrist="image_wrist",
                 state_obs_keys=["proprio"], state_encoding=_PE,
                 transform=T.rh20t_dataset_transform)

# === T-DROID (configs.py:610-652) ===
for _n in ("tdroid_carrot_in_bowl", "tdroid_pour_corn_in_pot",
           "tdroid_flip_pot_upright", "tdroid_move_object_onto_plate",
           "tdroid_knock_object_over", "tdroid_cover_object_with_towel"):
    register_dataset(_n, primary="static_image",
                     depth_primary="static_depth_image",
                     state_obs_keys=["EEF_state", "gripper_state"],
                     state_encoding=_PE, transform=T.tdroid_dataset_transform)

# === DROID fine-tuning (configs.py:653-660) ===
register_dataset("droid_wipe", primary="exterior_image_2_left",
                 wrist="wrist_image_left", state_obs_keys=["proprio"],
                 state_encoding=_PE, transform=T.droid_finetuning_transform)

# === LIBERO suites (configs.py:661-696) ===
for _n in ("libero_spatial_no_noops", "libero_object_no_noops",
           "libero_goal_no_noops", "libero_10_no_noops",
           "libero_4_task_suites_no_noops"):
    # EEF_state (6) + 2-D gripper_state = 8 proprio dims (configs.py:665)
    register_dataset(_n, primary="image", wrist="wrist_image",
                     state_obs_keys=["EEF_state", "gripper_state"],
                     state_encoding=_PE, transform=T.libero_dataset_transform)

# === ALOHA fine-tuning sets (configs.py:697-726) ===
for _n in ("aloha1_fold_shorts_20_demos", "aloha1_fold_shirt_30_demos",
           "aloha1_scoop_X_into_bowl_45_demos",
           "aloha1_put_X_into_pot_300_demos", "aloha_scoop_x_into_bowl"):
    register_dataset(_n, primary="image",
                     image_obs_keys={"primary": "image", "secondary": None,
                                     "left_wrist": "left_wrist_image",
                                     "right_wrist": "right_wrist_image"},
                     state_obs_keys=["state"], state_encoding=_JB,
                     action_encoding=_JPB,
                     transform=T.aloha_dataset_transform)
