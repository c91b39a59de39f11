"""Named OXE dataset mixtures with sampling weights.

Constant tables mirroring `prismatic/vla/datasets/rlds/oxe/mixtures.py:11-233`
exactly, copied from `openvla_oft_tpu/data/rlds/oxe/mixtures.py` (dataset names and weights are the reproduction contract). Entries the
reference keeps commented out (broken raw data, wrist-only camera sets) are
omitted here the same way.
"""

from typing import Dict, List, Tuple

_RTX_CORE: List[Tuple[str, float]] = [
    ("fractal20220817_data", 0.54087122203),  # RT-1 (large-scale)
    ("kuka", 0.8341046294),
    ("bridge_orig", 1.0),
    ("taco_play", 2.0),
    ("jaco_play", 2.0),
    ("berkeley_cable_routing", 3.0),
    ("roboturk", 1.0),
    ("viola", 2.0),
    ("berkeley_autolab_ur5", 1.0),
    ("toto", 1.0),
]

_MAGIC_SOUP: List[Tuple[str, float]] = [
    ("fractal20220817_data", 0.54087122203),
    ("kuka", 0.8341046294),
    ("bridge_orig", 1.0),
    ("taco_play", 2.0),
    ("jaco_play", 1.0),
    ("berkeley_cable_routing", 1.0),
    ("roboturk", 2.0),
    ("viola", 2.0),
    ("berkeley_autolab_ur5", 2.0),
    ("toto", 1.0),
    ("language_table", 0.1),
    ("stanford_hydra_dataset_converted_externally_to_rlds", 2.0),
    ("austin_buds_dataset_converted_externally_to_rlds", 1.0),
    ("nyu_franka_play_dataset_converted_externally_to_rlds", 3.0),
    ("furniture_bench_dataset_converted_externally_to_rlds", 0.1),
    ("ucsd_kitchen_dataset_converted_externally_to_rlds", 2.0),
    ("austin_sailor_dataset_converted_externally_to_rlds", 1.0),
    ("austin_sirius_dataset_converted_externally_to_rlds", 1.0),
    ("dlr_edan_shared_control_converted_externally_to_rlds", 1.0),
    ("iamlab_cmu_pickup_insert_converted_externally_to_rlds", 1.0),
    ("utaustin_mutex", 1.0),
    ("berkeley_fanuc_manipulation", 2.0),
    ("cmu_stretch", 1.0),
]

# magic soup + the datasets added in MagicSoup++ (mixtures.py:112-141)
_MAGIC_SOUP_PLUS_EXTRAS: List[Tuple[str, float]] = [
    ("bc_z", 0.2),  # reference note: use v0.1.0, later versions broken
    ("fmb_dataset", 1.0),
    ("dobbe", 0.2),
]

OXE_NAMED_MIXTURES: Dict[str, List[Tuple[str, float]]] = {
    "bridge": [("bridge_orig", 1.0)],
    "ur5e_pick_place": [("ur5e_pick_place", 1.0)],
    "bridge_rt_1": [("bridge_orig", 1.0), ("fractal20220817_data", 1.0)],
    "rtx": list(_RTX_CORE),
    "rtx_franka": list(_RTX_CORE) + [
        ("taco_play", 1.0),
        ("berkeley_cable_routing", 1.0),
        ("viola", 1.0),
        ("toto", 1.0),
        ("stanford_hydra_dataset_converted_externally_to_rlds", 1.0),
        ("austin_buds_dataset_converted_externally_to_rlds", 3.0),
        ("nyu_franka_play_dataset_converted_externally_to_rlds", 3.0),
        ("maniskill_dataset_converted_externally_to_rlds", 0.1),
        ("furniture_bench_dataset_converted_externally_to_rlds", 0.1),
        ("cmu_franka_exploration_dataset_converted_externally_to_rlds", 5.0),
        ("austin_sailor_dataset_converted_externally_to_rlds", 1.0),
        ("austin_sirius_dataset_converted_externally_to_rlds", 1.0),
        ("berkeley_rpt_converted_externally_to_rlds", 1.0),
        ("kaist_nonprehensile_converted_externally_to_rlds", 3.0),
        ("stanford_robocook_converted_externally_to_rlds", 1.0),
        ("iamlab_cmu_pickup_insert_converted_externally_to_rlds", 1.0),
        ("utaustin_mutex", 1.0),
        ("cmu_play_fusion", 1.0),
    ],
    "oxe_magic_soup": list(_MAGIC_SOUP),
    "oxe_magic_soup_plus": list(_MAGIC_SOUP) + _MAGIC_SOUP_PLUS_EXTRAS + [
        ("droid", 0.06)],
    # ++ minus droid and language_table, fractal upweighted to 1.0
    # (mixtures.py:143-172)
    "oxe_magic_soup_plus_minus": (
        [("fractal20220817_data", 1.0)]
        + [e for e in _MAGIC_SOUP[1:] if e[0] != "language_table"]
        + _MAGIC_SOUP_PLUS_EXTRAS),
    # T-DROID single-task sets
    **{name: [(name, 1.0)] for name in (
        "tdroid_carrot_in_bowl", "tdroid_pour_corn_in_pot",
        "tdroid_flip_pot_upright", "tdroid_move_object_onto_plate",
        "tdroid_knock_object_over", "tdroid_cover_object_with_towel",
        "droid_wipe")},
    # LIBERO suites
    **{name: [(name, 1.0)] for name in (
        "libero_spatial_no_noops", "libero_object_no_noops",
        "libero_goal_no_noops", "libero_10_no_noops")},
    "libero_4_task_suites_no_noops": [
        ("libero_spatial_no_noops", 1.0),
        ("libero_object_no_noops", 1.0),
        ("libero_goal_no_noops", 1.0),
        ("libero_10_no_noops", 1.0),
    ],
    # ALOHA fine-tuning sets
    **{name: [(name, 1.0)] for name in (
        "aloha1_fold_shorts_20_demos", "aloha1_fold_shirt_30_demos",
        "aloha1_scoop_X_into_bowl_45_demos",
        "aloha1_put_X_into_pot_300_demos", "aloha_scoop_x_into_bowl")},
}
