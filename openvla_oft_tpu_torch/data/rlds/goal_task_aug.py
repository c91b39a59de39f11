"""Goal relabeling + task augmentation (reference
`prismatic/vla/datasets/rlds/utils/{goal_relabeling,task_augmentation}.py`);
the port's copy of `openvla_oft_tpu/data/rlds/goal_task_aug.py`.

- `uniform_goal_relabel`: for each frame, pick a uniformly random STRICTLY
  FUTURE frame ([t+1, T), reference goal_relabeling.py) as the goal image.
- `keep_image_or_language`: task augmentation by modality dropout — with some
  probability keep only the goal image or only the language instruction,
  training the policy to follow either conditioning alone.

NumPy implementations operating on per-trajectory dicts.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def uniform_goal_relabel(traj: Dict, rng: np.random.Generator) -> Dict:
    """Attach `task/image_goal` = frames[t'] with t' ~ Uniform[t+1, T)
    (reference utils/goal_relabeling.py:15-26 samples STRICTLY future states,
    clamped to T-1 for the final frame)."""
    images = traj["images"]
    t = len(images)
    low = np.minimum(np.arange(t) + 1, t - 1)
    goal_idx = rng.integers(low, np.maximum(t, low + 1))
    traj.setdefault("task", {})["image_goal_idx"] = goal_idx
    traj["task"]["image_goal"] = [images[i] for i in goal_idx]
    return traj


def keep_image_or_language(traj: Dict, rng: np.random.Generator,
                           keep_image_prob: float = 0.5) -> Dict:
    """Modality dropout: goal-image-only or language-only conditioning."""
    task = traj.setdefault("task", {})
    has_both = "image_goal" in task and traj.get("language_instruction")
    if not has_both:
        return traj
    if rng.random() < keep_image_prob:
        traj["language_instruction"] = b"" if isinstance(
            traj["language_instruction"], bytes) else ""
    else:
        task.pop("image_goal", None)
        task.pop("image_goal_idx", None)
    return traj
