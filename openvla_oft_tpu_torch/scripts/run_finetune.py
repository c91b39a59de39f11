"""Restart wrapper for the fine-tuning CLI: relaunch until it exits cleanly.

The port's copy of `vla_scripts/run_finetune.py` (reference
`vla-scripts/run_finetune.py`): runs `python -m
openvla_oft_tpu_torch.training.finetune` with the arguments after `--`
until it exits with 0, at most `--max_restarts` times, `--restart_delay_s`
apart. Every attempt after the first adds `--resume True` (the latest resume
file in the run's `ckpt/`), unless the arguments already hold `--resume` or
`--resume=...` (matched exactly: `--resume_step` does not count). With the
CLI's preemption handling (SIGTERM: a checkpoint, then a clean return) a
preempted run loses no step.

    python -m openvla_oft_tpu_torch.scripts.run_finetune [--max_restarts N] \
        [--restart_delay_s S] -- --vla_path ... --run_root_dir ...
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
import time

FINETUNE = "openvla_oft_tpu_torch.training.finetune"


@dataclasses.dataclass
class RunnerConfig:
    max_restarts: int = 100
    restart_delay_s: float = 10.0


def with_resume(args: list, attempt: int) -> list:
    """The CLI's arguments for attempt `attempt` (0 first)."""
    has_resume = any(a == "--resume" or a.startswith("--resume=") for a in args)
    return list(args) + (["--resume", "True"] if attempt > 0 and not has_resume else [])


def main(argv=None) -> int:
    from openvla_oft_tpu_torch.utils.cli import parse_args

    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" in argv:
        split = argv.index("--")
        runner_args, ft_args = argv[:split], argv[split + 1:]
    else:
        runner_args, ft_args = [], argv
    cfg = parse_args(RunnerConfig, runner_args)
    for attempt in range(cfg.max_restarts):
        args = with_resume(ft_args, attempt)
        print(f"[run_finetune] attempt {attempt}: -m {FINETUNE} {' '.join(args)}", flush=True)
        proc = subprocess.run([sys.executable, "-m", FINETUNE] + args)
        if proc.returncode == 0:
            print("[run_finetune] finetune finished cleanly")
            return 0
        print(f"[run_finetune] exited with {proc.returncode}; restarting in "
              f"{cfg.restart_delay_s} s", flush=True)
        time.sleep(cfg.restart_delay_s)
    print("[run_finetune] exceeded max_restarts")
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
