"""Resolve OXE dataset names/mixtures into loading kwargs.

The port's copy of `openvla_oft_tpu/data/rlds/oxe/materialize.py` (reference
`prismatic/vla/datasets/rlds/oxe/materialize.py:21-134`)
with the same contracts:
  - only EEF_POS / EEF_R6 / JOINT_POS_BIMANUAL action encodings are loadable;
  - for EEF encodings only the gripper dimension is absolute and exempt from
    normalization; bimanual joint actions are fully absolute and normalized;
  - requested camera views must exist in the dataset config;
  - mixtures are deduplicated, and entries that fail validation are skipped
    with a warning instead of aborting the run.
"""

from __future__ import annotations

import warnings
from pathlib import Path
from typing import Any, Dict, List, Sequence, Tuple

from openvla_oft_tpu_torch.data.rlds.oxe.configs import (
    ActionEncoding,
    OXE_DATASET_CONFIGS,
)
from openvla_oft_tpu_torch.data.rlds.oxe.configs import (  # noqa: F401 (re-export)
    OXE_STANDARDIZATION_TRANSFORMS,
)
from openvla_oft_tpu_torch.data.rlds.oxe.mixtures import OXE_NAMED_MIXTURES

_ACTION_MASKS = {
    # encoding -> (absolute_action_mask, action_normalization_mask)
    ActionEncoding.EEF_POS: ([False] * 6 + [True], [True] * 6 + [False]),
    ActionEncoding.EEF_R6: ([False] * 9 + [True], [True] * 9 + [False]),
    ActionEncoding.JOINT_POS_BIMANUAL: ([True] * 14, [True] * 14),
}


def dataset_action_normalization_mask(dataset_name: str):
    """Per-dim normalization mask for a registered dataset (reference
    rlds/dataset.py:229-235 stores it as dataset_statistics["action"]["mask"]
    so the absolute gripper dimension is exempt from Q99 normalization).
    Returns None for unregistered names."""
    cfg = OXE_DATASET_CONFIGS.get(dataset_name)
    if cfg is None or cfg.action_encoding not in _ACTION_MASKS:
        return None
    return list(_ACTION_MASKS[cfg.action_encoding][1])


def make_oxe_dataset_kwargs(
    dataset_name: str,
    data_root_dir,
    load_camera_views: Sequence[str] = ("primary",),
    load_depth: bool = False,
    load_proprio: bool = True,
    load_language: bool = True,
    action_proprio_normalization_type=None,
) -> Dict[str, Any]:
    """Reference `make_oxe_dataset_kwargs` (materialize.py:21-79)."""
    cfg = OXE_DATASET_CONFIGS[dataset_name]
    if cfg.action_encoding not in _ACTION_MASKS:
        raise ValueError(
            f"Cannot load `{dataset_name}`; only EEF_POS & EEF_R6 & "
            f"JOINT_POS_BIMANUAL actions supported!")
    absolute_action_mask, normalization_mask = _ACTION_MASKS[cfg.action_encoding]

    missing = set(load_camera_views) - set(cfg.image_obs_keys)
    if missing:
        raise ValueError(
            f"Cannot load `{dataset_name}`; missing camera views `{missing}`")

    out: Dict[str, Any] = {
        "name": dataset_name,
        "data_dir": str(data_root_dir),
        "image_obs_keys": {k: v for k, v in cfg.image_obs_keys.items()
                           if k in load_camera_views},
        "absolute_action_mask": list(absolute_action_mask),
        "action_normalization_mask": list(normalization_mask),
        # index (not .get): an unregistered transform must fail loudly here,
        # as in the reference — standardize_fn=None would silently train on
        # raw, non-standard action conventions.
        "standardize_fn": OXE_STANDARDIZATION_TRANSFORMS[dataset_name],
    }
    if load_depth:
        out["depth_obs_keys"] = {k: v for k, v in cfg.depth_obs_keys.items()
                                 if k in load_camera_views}
    if load_proprio:
        out["state_obs_keys"] = list(cfg.state_obs_keys)
    if load_language:
        out["language_key"] = "language_instruction"
    if action_proprio_normalization_type is not None:
        out["action_proprio_normalization_type"] = \
            action_proprio_normalization_type
    out.update(cfg.aux_kwargs)
    return out


def get_oxe_dataset_kwargs_and_weights(
    data_root_dir,
    mixture_spec,
    load_camera_views: Sequence[str] = ("primary",),
    load_depth: bool = False,
    load_proprio: bool = True,
    load_language: bool = True,
    action_proprio_normalization_type=None,
) -> Tuple[List[Dict[str, Any]], List[float]]:
    """Reference `get_oxe_dataset_kwargs_and_weights` (materialize.py:82-134).

    `mixture_spec` is a mixture name (resolved via OXE_NAMED_MIXTURES) or an
    explicit [(name, weight), ...] list. Duplicates are dropped; datasets that
    fail validation are skipped with a warning.
    """
    if isinstance(mixture_spec, str):
        mixture_spec = OXE_NAMED_MIXTURES[mixture_spec]

    seen, filtered = set(), []
    for name, weight in mixture_spec:
        if name in seen:
            warnings.warn(f"Skipping duplicate dataset: {(name, weight)}")
            continue
        seen.add(name)
        filtered.append((name, weight))

    per_dataset_kwargs, sampling_weights = [], []
    for name, weight in filtered:
        try:
            per_dataset_kwargs.append(make_oxe_dataset_kwargs(
                name, Path(data_root_dir), load_camera_views, load_depth,
                load_proprio, load_language,
                action_proprio_normalization_type))
            sampling_weights.append(weight)
        except ValueError as e:
            warnings.warn(f"Skipping `{name}` due to error: {e}")
    return per_dataset_kwargs, sampling_weights
