"""Trajectory and action transforms and dataset statistics (NumPy): the
port's copy of `openvla_oft_tpu/data/transforms.py` (reference
`prismatic/vla/datasets/rlds/traj_transforms.py:14-58` for the action
chunks, `.../utils/data_utils.py:97-153` for the normalizer and the gripper
relabels, `:176-284` for the statistics and their JSON sidecar).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from openvla_oft_tpu_torch.constants import NormalizationType


def chunk_actions(actions: np.ndarray, window_size: int = 1,
                  future_action_window_size: int = 0) -> np.ndarray:
    """(T, D) -> (T - future, window + future, D).

    Past indices floor at 0; future indices cap at the last frame (the final
    action repeats), matching `chunk_act_obs`.
    """
    t = actions.shape[0]
    eff = t - future_action_window_size
    offs = np.arange(-window_size + 1, 1 + future_action_window_size)
    idx = offs[None, :] + np.arange(eff)[:, None]
    idx = np.clip(idx, 0, t - 1)
    return actions[idx]


def chunk_obs_pad_mask(traj_len: int, window_size: int,
                       future_action_window_size: int = 0) -> np.ndarray:
    eff = traj_len - future_action_window_size
    offs = np.arange(-window_size + 1, 1)
    idx = offs[None, :] + np.arange(eff)[:, None]
    return idx >= 0


def compute_dataset_statistics(actions: np.ndarray,
                               proprios: Optional[np.ndarray] = None,
                               num_trajectories: Optional[int] = None) -> Dict:
    """Per-dimension stats over all transitions (reference
    `get_dataset_statistics`, data_utils.py:176-262)."""

    def stats(x):
        return {
            "mean": x.mean(0).tolist(),
            "std": x.std(0).tolist(),
            "max": x.max(0).tolist(),
            "min": x.min(0).tolist(),
            "q01": np.quantile(x, 0.01, axis=0).tolist(),
            "q99": np.quantile(x, 0.99, axis=0).tolist(),
        }

    out = {"action": stats(actions),
           "num_transitions": int(actions.shape[0]),
           "num_trajectories": int(num_trajectories or 1)}
    if proprios is not None:
        out["proprio"] = stats(proprios)
    return out


def normalize(x: np.ndarray, metadata: Dict,
              norm_type: NormalizationType) -> np.ndarray:
    """Normalize actions or proprio by the reference's rules
    (data_utils.py:97-153): the bounds map [low, high] to [-1, 1] with
    clipping; masked-out dims pass through; degenerate dims (min == max)
    map to 0."""
    x = np.asarray(x, np.float32)
    if "mask" in metadata:
        mask = np.asarray(metadata["mask"])
    else:
        # sized off whichever bounds the stats carry (partial stats, e.g.
        # proprio dicts with only q01/q99, are legal)
        key = next(k for k in ("min", "q01", "mean") if k in metadata)
        mask = np.ones_like(np.asarray(metadata[key]), dtype=bool)
    if norm_type == NormalizationType.NORMAL:
        mean = np.asarray(metadata["mean"], np.float32)
        std = np.asarray(metadata["std"], np.float32)
        return np.where(mask, (x - mean) / (std + 1e-8), x)
    if norm_type == NormalizationType.BOUNDS:
        low = np.asarray(metadata["min"], np.float32)
        high = np.asarray(metadata["max"], np.float32)
    elif norm_type == NormalizationType.BOUNDS_Q99:
        low = np.asarray(metadata["q01"], np.float32)
        high = np.asarray(metadata["q99"], np.float32)
    else:
        raise ValueError(f"Unknown normalization type {norm_type}")
    out = np.where(mask, np.clip(2 * (x - low) / (high - low + 1e-8) - 1, -1, 1), x)
    if "min" in metadata and "max" in metadata:
        zeros = np.asarray(metadata["min"]) == np.asarray(metadata["max"])
    else:  # partial stats: degenerate dims judged by the active bounds
        zeros = low == high
    return np.where(zeros, 0.0, out)


def normalize_proprio(proprio: np.ndarray, norm_stats: Dict,
                      norm_type: NormalizationType) -> np.ndarray:
    """Eval-side proprio normalization (openvla_utils.py:645-675)."""
    return normalize(proprio, norm_stats["proprio"], norm_type)


def binarize_gripper_actions(actions: np.ndarray) -> np.ndarray:
    """Continuous [0,1] gripper -> binary, relabeling in-between values with
    the state reached after them (data_utils.py:155+ reverse scan)."""
    open_mask = actions > 0.95
    closed_mask = actions < 0.05
    in_between = ~(open_mask | closed_mask)
    out = np.empty_like(actions, dtype=np.float32)
    carry = float(actions[-1])
    for i in reversed(range(len(actions))):
        if not in_between[i]:
            carry = float(open_mask[i])
        out[i] = carry
    return out


def invert_gripper_actions(actions: np.ndarray) -> np.ndarray:
    return 1.0 - actions


def rel2abs_gripper_actions(actions: np.ndarray) -> np.ndarray:
    """Relative gripper commands (input: +1 = closing, -1 = opening, 0 = no
    change) -> absolute state in [0, 1] with **1 = open, 0 = closed**
    (reference data_utils.py:132-153: `opening_mask = actions < -0.1` maps to
    state +1, and `new_actions/2 + 0.5` makes open = 1)."""
    opening = actions < -0.1
    closing = actions > 0.1
    # state intent: +1 = open after an opening command, -1 = closed
    thresholded = np.where(opening, 1.0, np.where(closing, -1.0, 0.0))
    out = np.empty_like(actions, dtype=np.float32)
    # carry latest nonzero intent; before the first intent the state is its
    # opposite (you only close an open gripper); no intents at all = open.
    nonzero = np.nonzero(thresholded)[0]
    carry = -thresholded[nonzero[0]] if len(nonzero) else 1.0
    for i in range(len(actions)):
        if thresholded[i] != 0.0:
            carry = thresholded[i]
        out[i] = carry
    return (out + 1.0) / 2.0


def save_dataset_statistics(stats: Dict[str, Dict], run_dir: str) -> str:
    """Write `dataset_statistics.json` (reference data_utils.py:265-284)."""
    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, "dataset_statistics.json")
    # atomic write: concurrent writers each rename a complete file; readers
    # never see a torn one
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(stats, f, indent=2)
    os.replace(tmp, path)
    return path


def load_dataset_statistics(path: str) -> Dict:
    """Load a reference-format `dataset_statistics.json`
    (openvla_utils.py:352-377)."""
    if os.path.isdir(path):
        path = os.path.join(path, "dataset_statistics.json")
    with open(path) as f:
        return json.load(f)
