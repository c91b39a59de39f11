"""Dataset statistics with their JSON sidecar: the port's copy of the
statistics functions of `openvla_oft_tpu/data/transforms.py` (reference
`prismatic/vla/datasets/rlds/utils/data_utils.py:176-284`).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np


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
