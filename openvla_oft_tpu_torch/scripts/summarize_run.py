"""Summarize a fine-tuning run's metrics JSONL into a markdown loss-curve table.

    python -m openvla_oft_tpu_torch.scripts.summarize_run runs/<run_id>/<run_id>-metrics.jsonl [window]

Port of `vla_scripts/summarize_run.py`: prints the record count, a table of
12 records spread over the run (step, loss, current-action L1, step time)
and a summary JSON (windowed mean losses at the start and the end, their
ratio, the median step time after the first 3 records, the final L1). It
reads the records `training/metrics.py::JSONLinesTracker` writes, under the
names the fine-tuning CLI gives them (`loss`, `curr_action_l1_loss`,
`step_time`, `step`).
"""

from __future__ import annotations

import json
import sys

import numpy as np


def summarize(path: str, window: int = 20) -> dict:
    with open(path) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    recs = [r for r in recs if "loss" in r]
    steps = np.asarray([r["step"] for r in recs])
    loss = np.asarray([r["loss"] for r in recs])
    l1 = np.asarray([r.get("curr_action_l1_loss", np.nan) for r in recs])
    st = np.asarray([r.get("step_time", np.nan) for r in recs])

    print(f"records: {len(recs)}  steps {steps.min()}..{steps.max()}")
    print("| step | loss | curr-action L1 | step time (s) |")
    print("|---:|---:|---:|---:|")
    idx = np.unique(np.linspace(0, len(recs) - 1, 12).astype(int))
    for i in idx:
        print(f"| {steps[i]} | {loss[i]:.4f} | {l1[i]:.4f} | {st[i]:.3f} |")

    k = min(window, len(recs) // 3 or 1)
    first, last = float(loss[:k].mean()), float(loss[-k:].mean())
    # steady-state step time: drop the first 3 records (warm-up)
    sst = float(np.nanmedian(st[3:])) if len(st) > 3 else float(np.nanmedian(st))
    out = {
        "first_window_loss": round(first, 4),
        "last_window_loss": round(last, 4),
        "descent_ratio": round(last / first, 4),
        "median_step_time_s": round(sst, 4),
        "final_l1": round(float(l1[-k:].mean()), 4),
        "n_records": len(recs),
        "max_step": int(steps.max()),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    summarize(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else 20)
