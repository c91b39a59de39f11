"""Multi-process fine-tuning dryrun: two gloo processes on the CPU.

The port of `vla_scripts/dryrun_multiprocess.py`. It writes a small LIBERO
episode set (four shards, from the JPEG frames of
`tests/goldens/jpeg_decode_tf.npz`), launches two processes that join one
process group through a `file://` store and run the fine-tuning CLI
(`training/finetune.py`) with `--multihost True` on a ("dp", "fsdp", "tp") =
(1, 2, 1) mesh, `random:tiny`, `--device cpu`:

  - each process reads its own half of the episode shards
    (`data/rlds/pipeline.py`, files[proc::n_proc]) and trains on its rows of
    the global batch;
  - the trainables and the optimizer's state shard over fsdp; the save
    gathers them on every rank and rank 0 writes the resume file and the
    per-module `.pt` exports;
  - a second two-process launch resumes from that file and trains further.

Run:  python -m openvla_oft_tpu_torch.scripts.dryrun_multiprocess [--steps 2]
Exit code 0 = all of the above ran and the resumed run advanced.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
RUN_ID = "mp_dryrun"
DATASET = "libero_mp_synth"


def child(args) -> None:
    from openvla_oft_tpu_torch.training.finetune import main

    steps = args.steps * 2 if args.resume else args.steps
    argv = ["--vla_path", "random:tiny", "--device", "cpu",
            "--data_root_dir", args.data_root, "--dataset_name", DATASET,
            "--robot_platform", "libero", "--run_root_dir", args.run_root,
            "--shuffle_buffer_size", "50", "--use_l1_regression", "True",
            "--use_proprio", "True", "--num_images_in_input", "1", "--lora_rank", "4",
            "--batch_size", "4", "--learning_rate", "1e-3", "--max_steps", str(steps),
            "--save_freq", str(args.steps), "--image_aug", "False",
            "--resume", str(args.resume), "--run_id_override", RUN_ID,
            "--wandb_log_freq", "1", "--merge_lora_during_training", "False",
            "--multihost", "True", "--coordinator_address", f"file://{args.store}",
            "--num_processes", "2", "--process_id", str(args.child),
            "--mesh_fsdp", "2", "--seq_bucket", "96"]
    out = main(argv)
    print(f"[mp-child {args.child}] done final_step={out['final_step']}", flush=True)


def write_dataset(root: str) -> None:
    """Eight short LIBERO episodes in four shards of two."""
    from openvla_oft_tpu_torch.data.rlds.pipeline import write_episode_tfrecords

    with np.load(REPO / "tests" / "goldens" / "jpeg_decode_tf.npz") as z:
        frames = [z[f"data_{i}"].tobytes() for i in range(len(z["names"]))]
    rng = np.random.default_rng(0)
    episodes = []
    for e in range(8):
        t = 10 + e
        episodes.append({"images": [frames[(e + i) % len(frames)] for i in range(t)],
                         "actions": rng.uniform(-1, 1, (t, 7)),
                         "proprio": rng.standard_normal((t, 8)),
                         "language_instruction": f"move the block {e % 4}"})
    write_episode_tfrecords(os.path.join(root, DATASET), episodes, shard_size=2)


def launch(args, data_root: str, run_root: str, resume: bool, timeout: float) -> list:
    """The two processes of one phase (`_ranks.py`); each is joined within
    `timeout` seconds in all and killed after it. Returns their logs."""
    from openvla_oft_tpu_torch.scripts import _ranks

    phase = "resume" if resume else "fresh"
    store = os.path.join(run_root, f"store_{phase}")
    cmds = []
    for i in range(2):
        cmd = [sys.executable, "-m", "openvla_oft_tpu_torch.scripts.dryrun_multiprocess",
               "--child", str(i), "--store", store, "--data-root", data_root,
               "--run-root", run_root, "--steps", str(args.steps)]
        if resume:
            cmd.append("--resume")
        cmds.append(cmd)
    procs = _ranks.start(cmds, [Path(run_root) / f"{phase}_p{i}.log" for i in range(2)])
    return _ranks.join(procs, timeout, f"{phase} phase")


def parent(args) -> int:
    data_root = args.data_root or tempfile.mkdtemp(prefix="mp_rlds_")
    if not (Path(data_root) / DATASET).exists():
        write_dataset(data_root)
    run_root = args.run_root or tempfile.mkdtemp(prefix="mp_runs_")
    os.makedirs(run_root, exist_ok=True)
    run_dir = Path(run_root) / RUN_ID

    print(f"[mp-dryrun] phase 1: a fresh 2-process run ({args.steps} steps)", flush=True)
    p0, _ = launch(args, data_root, run_root, False, args.timeout)
    metrics_path = run_dir / f"{RUN_ID}-metrics.jsonl"
    recs = [json.loads(line) for line in open(metrics_path)]
    losses = [r["loss"] for r in recs if "loss" in r]
    assert losses and np.isfinite(losses).all(), f"bad losses {losses}"
    assert (run_dir / "ckpt" / f"{args.steps:06d}.pt").exists(), "no resume file"
    assert "rank=0/2 mesh=(1, 2, 1)" in p0, "the process group did not form"
    assert "process 0/2 reads 2 of the episode shards" in p0, "no per-process file shard"
    assert list(Path(run_root).glob(f"{RUN_ID}--{args.steps}_chkpt/action_head--*.pt")), \
        "rank 0 wrote no .pt export after the collective gather"

    print(f"[mp-dryrun] phase 2: a 2-process resume to {args.steps * 2} steps", flush=True)
    r0, _ = launch(args, data_root, run_root, True, args.timeout)
    assert f"resumed at gradient step {args.steps}" in r0, "the resume restored nothing"
    assert (run_dir / "ckpt" / f"{args.steps * 2:06d}.pt").exists(), "the resume made no save"
    recs = [json.loads(line) for line in open(metrics_path)]
    assert any(r["step"] >= args.steps for r in recs), "the resumed run made no progress"
    print("[mp-dryrun] OK: 2-process train, collective save, resume all green", flush=True)
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--child", type=int, default=None)
    ap.add_argument("--store", default=None)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--run-root", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds each phase's processes may take in all")
    a = ap.parse_args()
    if a.child is None:
        sys.exit(parent(a))
    child(a)
