"""The port's multi-GPU flags in the fine-tuning CLI, and the data split, on the CPU.

`--multihost` and `--mesh_*` run (they used to raise naming ROADMAP item
17): `--multihost` on a one-rank gloo group in this process, bitwise the
loss of the run without it; `--mesh_fsdp 2` on two gloo processes
(`torch_parallel_worker.py`), the global batch split over the data ranks,
the first step's loss within 1e-5 of the one-device run's (fp32; the batch
mean is taken per rank, then averaged) and the second's within 1e-3 (Adam's
first update is about lr * sign(g), so a gradient entry near zero whose
partial sums change its sign moves its weight by up to 2 lr). A mesh larger than the process group, or one with
no group, raises. The RLDS reader gives each process a disjoint shard of the
episode files and shuffles with seed + process. The two-process CLI run and
its resume go through `scripts/dryrun_multiprocess.py`.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from openvla_oft_tpu_torch.constants import get_platform
from openvla_oft_tpu_torch.data.rlds import pipeline as RP
from openvla_oft_tpu_torch.training import finetune as FT
from test_torch_finetune_cli import TINY_RUN
from torch_parallel_worker import launch

ROOT = Path(__file__).resolve().parents[1]
RUN = TINY_RUN + ["--batch_size", "2", "--max_steps", "2", "--seq_bucket", "128",
                  "--run_id_override", "mesh"]


def _losses(argv):
    seen = []
    FT.main(argv, on_step=lambda i, m, s: seen.append(m["loss"]))
    return seen


def _one_rank_group(tmp_path):
    return ["--multihost", "True", "--coordinator_address",
            f"file://{tmp_path / 'store'}", "--num_processes", "1", "--process_id", "0"]


@pytest.mark.parametrize("flag", ["multihost", "mesh"])
def test_multi_gpu_flags_run(tmp_path, flag):
    """Each flag that raised now trains: --multihost on a one-rank group
    (every leaf a DTensor on the (1, 1, 1) mesh) gives the plain run's
    losses bitwise; --mesh_fsdp 2 on two processes splits the batch and
    gives them within the bounds above, and its checkpoint resumes on one
    process."""
    ref = _losses(RUN + ["--run_root_dir", str(tmp_path / "ref")])
    if flag == "multihost":
        try:
            got = _losses(RUN + _one_rank_group(tmp_path)
                          + ["--run_root_dir", str(tmp_path / "run")])
        finally:
            dist.destroy_process_group()
        assert got == ref
        return
    out = launch("finetune", 2, {"mesh": (1, 2, 1), "argv": RUN + [
        "--mesh_fsdp", "2", "--run_root_dir", str(tmp_path / "run")]}, tmp_path / "ranks")
    for o in out:
        assert o["final_step"] == 2
        losses = [loss for _, loss in o["steps"]]
        np.testing.assert_allclose(losses[0], ref[0], rtol=1e-5)
        np.testing.assert_allclose(losses[1], ref[1], rtol=1e-3)
    assert (tmp_path / "run" / "mesh" / "ckpt" / "000002.pt").exists()
    # The two ranks' save is the one-process format: one process resumes it.
    resumed = _losses(RUN + ["--run_root_dir", str(tmp_path / "run"), "--resume", "True",
                             "--max_steps", "3"])
    assert len(resumed) == 1 and np.isfinite(resumed).all()


def test_mesh_without_a_group_names_torchrun(tmp_path):
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node"):
        FT.main(RUN + ["--mesh_tp", "2", "--run_root_dir", str(tmp_path)])


def test_mesh_larger_than_the_group_raises(tmp_path):
    try:
        with pytest.raises(ValueError, match="mesh 1x2x1 needs 2 ranks"):
            FT.main(RUN + _one_rank_group(tmp_path)
                    + ["--mesh_fsdp", "2", "--run_root_dir", str(tmp_path / "run")])
    finally:
        dist.destroy_process_group()


# --- (v) the RLDS reader's process shards ----------------------------------

@pytest.fixture(scope="module")
def episodes(tmp_path_factory):
    """Eight one-instruction episodes in four shards (the dryrun's set)."""
    from openvla_oft_tpu_torch.scripts.dryrun_multiprocess import DATASET, write_dataset

    root = str(tmp_path_factory.mktemp("rlds"))
    write_dataset(root)
    return root, DATASET


def _instructions(root, name, **kw):
    frames, _ = RP._build_encoded_frames(root, name, get_platform("libero"), **kw)
    return [f["language_instruction"] for f in frames]


@pytest.mark.parametrize("n_proc", [2, 4])
def test_process_shards_are_disjoint_and_cover_every_file(episodes, n_proc):
    """Process i of n reads files[i::n]: its frames are those of its files'
    episodes, and the shards together are the one-process stream."""
    root, name = episodes
    files = RP._files(root, name)
    whole = _instructions(root, name, train=False, process_index=0, process_count=1)
    shards = [_instructions(root, name, train=False, process_index=i, process_count=n_proc)
              for i in range(n_proc)]
    for i, shard in enumerate(shards):
        assert sorted(shard) == sorted(_frames_of(files, files[i::n_proc]))
    assert sorted(sum(shards, [])) == sorted(whole)


def _frames_of(files, subset):
    """The instructions of `subset`'s frames: file k holds episodes 2k and
    2k + 1 (`write_dataset`), episode e has 10 + e steps and one frame per
    step with a whole action chunk after it."""
    future = get_platform("libero").num_actions_chunk - 1
    out = []
    for f in subset:
        k = files.index(f)
        for e in (2 * k, 2 * k + 1):
            out += [f"move the block {e % 4}".encode()] * (10 + e - future)
    return out


def test_process_shuffle_seed_is_seed_plus_process(episodes, monkeypatch):
    root, name = episodes
    seeds = []
    real = RP.np.random.default_rng
    monkeypatch.setattr(RP.np.random, "default_rng",
                        lambda s=None: seeds.append(s) or real(s))
    frames, _ = RP._build_encoded_frames(root, name, get_platform("libero"), train=True,
                                         seed=5, process_index=1, process_count=2)
    next(iter(frames))
    assert 6 in seeds


def test_single_process_reads_every_shard(episodes):
    root, name = episodes
    assert RP._process_shard(None, None) == (0, 1)
    a = _instructions(root, name, train=False)
    b = _instructions(root, name, train=False, process_index=0, process_count=1)
    assert a == b and len(set(a)) == 4


# --- (vi) the two-process run and its resume ------------------------------

def test_two_process_finetune_and_resume(tmp_path):
    """scripts/dryrun_multiprocess.py: two gloo processes, --multihost on a
    (1, 2, 1) mesh over RLDS shards, a collective save, then a resume that
    advances (each phase joined within 240 s, its processes killed after)."""
    r = subprocess.run(
        [sys.executable, "-m", "openvla_oft_tpu_torch.scripts.dryrun_multiprocess",
         "--steps", "2", "--timeout", "240", "--data-root", str(tmp_path / "rlds"),
         "--run-root", str(tmp_path / "runs")],
        capture_output=True, text=True, timeout=600, cwd=str(ROOT),
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert r.returncode == 0, f"stdout:\n{r.stdout[-3000:]}\nstderr:\n{r.stderr[-3000:]}"
    assert "2-process train, collective save, resume all green" in r.stdout
