"""Training metrics and trackers (reference `prismatic/training/metrics.py` +
the fine-tune script's deque smoothing, finetune.py:543-581).

Trackers: JSONL always; Weights & Biases when the package exists (gated — not
in this image). `VLAMetrics` smooths with bounded deques and tracks per-dataset
sub-metrics like the reference.
"""

from __future__ import annotations

import collections
import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np


class JSONLinesTracker:
    """Append-only JSONL metric log (reference `JSONLinesTracker`)."""

    def __init__(self, run_dir: str, run_id: str = "run"):
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, f"{run_id}-metrics.jsonl")

    def write(self, step: int, metrics: Dict[str, Any]) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def finalize(self) -> None:
        pass


class WeightsBiasesTracker:
    """W&B tracker, active only if wandb is importable and configured."""

    def __init__(self, run_dir: str, run_id: str, project: str = "openvla-oft-tpu",
                 entity: Optional[str] = None, config: Optional[dict] = None):
        try:
            import wandb

            self._run = wandb.init(project=project, entity=entity, name=run_id,
                                   dir=run_dir, config=config or {})
        except Exception:
            self._run = None

    def write(self, step: int, metrics: Dict[str, Any]) -> None:
        if self._run is not None:
            self._run.log({k: float(v) for k, v in metrics.items()}, step=step)

    def finalize(self) -> None:
        if self._run is not None:
            self._run.finish()


class VLAMetrics:
    """Deque-smoothed metric aggregation (reference `VLAMetrics`,
    metrics.py:208+; smoothing window matches finetune.py's
    `grad_accumulation_steps`-aware deques)."""

    def __init__(self, trackers, window: int = 100):
        self.trackers = list(trackers)
        self.window = window
        self._deques: Dict[str, collections.deque] = {}
        self._step_times = collections.deque(maxlen=window)
        self._last = time.time()

    def commit(self, **metrics) -> None:
        for k, v in metrics.items():
            self._deques.setdefault(
                k, collections.deque(maxlen=self.window)).append(float(v))
        now = time.time()
        self._step_times.append(now - self._last)
        self._last = now

    def push(self, step: int, extra: Optional[Dict[str, Any]] = None) -> Dict[str, float]:
        smoothed = {k: float(np.mean(d)) for k, d in self._deques.items() if d}
        if self._step_times:
            smoothed["step_time"] = float(np.mean(self._step_times))
        if extra:
            smoothed.update({k: float(v) for k, v in extra.items()})
        for t in self.trackers:
            t.write(step, smoothed)
        return smoothed

    def finalize(self) -> None:
        for t in self.trackers:
            t.finalize()
