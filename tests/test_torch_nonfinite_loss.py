"""Both training loops run on past a non-finite loss, as the JAX loops do.

`vla_scripts/finetune.py`, `train.py` and `pretrain.py` have no check on
the loss: a step whose loss is NaN updates the trainables and the run goes
on, its metrics logging the NaN (`VLAMetrics` keeps whatever value it is
given). The port's fine-tuning loop (`training/finetune.py`) and the loop of
`scripts/train.py` and `scripts/pretrain.py` (`scripts/train.py::run_loop`)
do the same: here a NaN is written into one trainable leaf after step 0, so
that the loss turns NaN at step 1, and each run still completes its
`max_steps` and logs the NaN.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from openvla_oft_tpu_torch.bridge import tree_leaves
from openvla_oft_tpu_torch.scripts import train as PT
from openvla_oft_tpu_torch.training import finetune as FT
from test_torch_finetune_cli import TINY_RUN
from test_torch_train_scripts import _train_cfg


def _poison_after_step_zero(seen):
    def on_step(step, metrics, state):
        seen.append(metrics["loss"])
        if step == 0:
            with torch.no_grad():
                tree_leaves(state.trainables)[0].fill_(float("nan"))
    return on_step


def _rows(run_dir):
    return [json.loads(line) for f in Path(run_dir).glob("*-metrics.jsonl")
            for line in f.read_text().splitlines()]


def test_finetune_trains_on_past_a_nan_loss(tmp_path):
    seen = []
    out = FT.main(TINY_RUN + ["--batch_size", "2", "--max_steps", "3",
                              "--run_root_dir", str(tmp_path)],
                  on_step=_poison_after_step_zero(seen))
    assert out["final_step"] == 3 and len(seen) == 3
    assert np.isfinite(seen[0]) and np.isnan(seen[1]) and np.isnan(seen[2])
    rows = _rows(out["run_dir"])
    assert [r["step"] for r in rows] == [0, 1, 2]
    assert np.isfinite(rows[0]["loss"]) and np.isnan(rows[1]["loss"])


def test_train_script_trains_on_past_a_nan_loss(tmp_path):
    """run_loop logs every 10 steps, so 11 steps reach the second log line,
    whose smoothed loss holds the NaN."""
    seen = []
    cfg = dataclasses.replace(_train_cfg(tmp_path, "vla-last-layer-train"), max_steps=11,
                              save_interval=11)
    out = PT.train(cfg, on_step=_poison_after_step_zero(seen))
    assert out["final_step"] == 11 and len(seen) == 11
    assert np.isfinite(seen[0]) and all(np.isnan(v) for v in seen[1:])
    rows = _rows(out["run_dir"])
    assert [r["step"] for r in rows] == [0, 10]
    assert np.isfinite(rows[0]["loss"]) and np.isnan(rows[1]["loss"])
