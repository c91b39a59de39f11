"""The port's fine-tuning launchers (`openvla_oft_tpu_torch/scripts/*.sh`),
the counterparts of `vla_scripts/*.sh`: their flags are config fields and
the JAX launchers' own, the variant launchers stay wrappers, the torchrun
form starts one process per rank, and a 2-step run at random:tiny on the
CPU through `finetune.sh` with EXTRA_ARGS."""

import dataclasses
import json
import os
import re
import subprocess
from pathlib import Path

import pytest

from openvla_oft_tpu_torch.scripts.merge_lora_weights_and_save import MergeConfig
from openvla_oft_tpu_torch.training.finetune import TorchFinetuneConfig

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "openvla_oft_tpu_torch" / "scripts"
JAX = ROOT / "vla_scripts"
FLAG = re.compile(r"(?<=\s)--([a-z0-9_]+)")


def flags(path: Path) -> set:
    """Whitespace-anchored --flags outside comments (a `--x` inside a run-id
    note such as "parallel_dec--8_acts_chunk" is data), torchrun's own
    `--nproc-per-node` excepted."""
    text = re.sub(r"#.*", "", path.read_text())
    return set(FLAG.findall(re.sub(r"torchrun --nproc-per-node \S+", "torchrun", text)))


@pytest.mark.parametrize("sh,config", [("finetune.sh", TorchFinetuneConfig),
                                       ("finetune_aloha.sh", TorchFinetuneConfig),
                                       ("merge_lora_weights_and_save.sh", MergeConfig)])
def test_launcher_flags_are_config_fields_and_jaxs(sh, config):
    names = {f.name for f in dataclasses.fields(config)}
    got = flags(PORT / sh)
    assert got and got <= names, got - names
    assert got == flags(JAX / sh)


@pytest.mark.parametrize("sh", ["finetune_libero.sh", "finetune_abs_pose.sh"])
def test_variant_launchers_delegate(sh):
    text = re.sub(r"#.*", "", (PORT / sh).read_text())
    assert 'exec bash "$(dirname "$0")/finetune.sh"' in text
    assert not FLAG.findall(text), f"{sh} should delegate, not duplicate flags"


def _fake(bin_dir: Path, name: str) -> None:
    """A `name` on PATH that prints its arguments, one per line."""
    path = bin_dir / name
    path.write_text('#!/bin/bash\nprintf "%s\\n" "$0" "$@"\n')
    path.chmod(0o755)


def _argv(script: str, tmp_path: Path, env: dict, *args) -> list:
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir(exist_ok=True)
    for name in ("python", "torchrun"):
        _fake(bin_dir, name)
    out = subprocess.run(["bash", str(PORT / script), *args], cwd=tmp_path, text=True,
                         capture_output=True, timeout=60,
                         env={**os.environ, **env, "PATH": f"{bin_dir}:{os.environ['PATH']}"})
    assert out.returncode == 0, out.stderr
    return out.stdout.splitlines()


def test_torchrun_starts_one_process_per_rank(tmp_path):
    argv = _argv("finetune.sh", tmp_path, {"MESH_FSDP": "2", "MESH_TP": "2",
                                           "MULTIHOST": "true"})
    assert Path(argv[0]).name == "torchrun"
    assert argv[1:5] == ["--nproc-per-node", "4", "-m",
                         "openvla_oft_tpu_torch.training.finetune"]
    assert argv[argv.index("--multihost") + 1] == "true"
    assert argv[argv.index("--mesh_tp") + 1] == "2"
    plain = _argv("finetune.sh", tmp_path, {"EXTRA_ARGS": "--batch_size 2"}, "ckpt", "note",
                  "true", "7")
    assert Path(plain[0]).name == "python" and plain[1:3] == [
        "-m", "openvla_oft_tpu_torch.training.finetune"]
    assert plain[plain.index("--vla_path") + 1] == "ckpt"
    assert plain[-6:] == ["--resume", "true", "--resume_step", "7", "--batch_size", "2"]
    aloha = _argv("finetune_aloha.sh", tmp_path, {}, "--max_steps", "3")
    assert aloha[1:3] == ["--nproc-per-node", "8"] and aloha[-2:] == ["--max_steps", "3"]
    assert "oft-plus-aloha_scoop_x_into_bowl" in aloha


@pytest.mark.parametrize("sh,dataset,root", [
    ("finetune_libero.sh", "libero_spatial_no_noops", "datasets/rlds/libero"),
    ("finetune_abs_pose.sh", "ur5e_pick_place_abs_pose", "datasets/rlds")])
def test_variant_defaults(tmp_path, sh, dataset, root):
    argv = _argv(sh, tmp_path, {})
    assert argv[argv.index("--dataset_name") + 1] == dataset
    assert argv[argv.index("--data_root_dir") + 1] == root


def test_merge_launcher_passes_its_positionals(tmp_path):
    argv = _argv("merge_lora_weights_and_save.sh", tmp_path, {}, "BASE", "RUN",
                 "--device", "cpu")
    assert argv[1:] == ["-m", "openvla_oft_tpu_torch.scripts.merge_lora_weights_and_save",
                        "--base_checkpoint", "BASE", "--finetune_run_dir", "RUN",
                        "--device", "cpu"]


def test_finetune_sh_runs_two_steps(tmp_path):
    extra = ("--device cpu --data_root_dir dummy --robot_platform libero --batch_size 2 "
             "--max_steps 2 --save_freq 100 --merge_lora_during_training false "
             "--lora_rank 4 --wandb_log_freq 1")
    out = subprocess.run(["bash", str(PORT / "finetune.sh"), "random:tiny", "smoke", "false",
                          "0", str(tmp_path / "runs")], cwd=tmp_path, text=True,
                         capture_output=True, timeout=300,
                         env={**os.environ, "EXTRA_ARGS": extra})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "done: 2 micro-steps" in out.stdout
    (run,) = [p for p in (tmp_path / "runs").iterdir() if p.name.endswith("--smoke")]
    rows = [json.loads(ln) for ln in next(run.glob("*-metrics.jsonl")).read_text().splitlines()]
    assert [r["step"] for r in rows if "loss" in r][-1] == 1
    assert (run / "ckpt").is_dir() and any((run / "ckpt").iterdir())
