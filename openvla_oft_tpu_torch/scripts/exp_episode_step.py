"""The fine-tuning step fed by episode data against the dummy-data step, on
the card, in turns within one process, with where the main thread's time
goes:

    PYTHONPATH=. python -m openvla_oft_tpu_torch.scripts.exp_episode_step

It writes `chip_smoke.py`'s phase 13 dataset (24 raw LIBERO episodes, two
cameras of the decode golden's 256 x 256 frames), then runs the CLI at
random:7b, B = 8, image augmentation, `--steps` steps, for each variant:

  dummy   `--data_root_dir dummy`
  host    the episodes, the augmentation in the host library, the loader's
          default threads
  host-2  the same with 2 decode threads
  plain   the episodes, the augmentation's numpy plain version

in rounds whose order alternates (`--variants`, `--rounds`). Each run logs
its step times and, for every step, the main thread's CPU time and its
involuntary context switches (`getrusage(RUSAGE_THREAD)`: preempted for
another thread) and the process's CPU time (host clock, Linux). Needs a
CUDA device and the repo root on the path (it imports `chip_smoke`).
"""

from __future__ import annotations

import argparse
import functools
import gc
import resource
import shutil
import tempfile
import time


def _thread_usage() -> tuple:
    """(CPU seconds, involuntary context switches) of the calling thread."""
    r = resource.getrusage(resource.RUSAGE_THREAD)
    return r.ru_utime + r.ru_stime, r.ru_nivcsw


def _process_cpu() -> float:
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


def main(argv=None) -> dict:
    import numpy as np
    import torch

    import chip_smoke as C
    from openvla_oft_tpu_torch import _build
    from openvla_oft_tpu_torch.data.rlds import augment, pipeline
    from openvla_oft_tpu_torch.training import finetune as FT

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=6)
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--variants", default="dummy,host,host-2,plain")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("exp_episode_step needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = C.card_line()
    C.log(card)
    _build.build()
    make = pipeline.make_rlds_iterator
    aug = augment.augment_image
    variants = args.variants.split(",")
    out: dict = {}
    root, runs = tempfile.mkdtemp(prefix="exp_episodes_"), tempfile.mkdtemp(prefix="exp_runs_")
    try:
        C.write_episodes(C.decode_golden(card), root)
        flags = [f for f in C.EPISODE_FLAGS]
        flags[flags.index("--use_val_set") + 1] = "False"
        flags += ["--max_steps", str(args.steps), "--run_root_dir", runs]
        for r in range(args.rounds):
            for label in (variants if r % 2 == 0 else variants[::-1]):
                pipeline.make_rlds_iterator = (functools.partial(make, decode_parallelism=2)
                                               if label == "host-2" else make)
                augment.augment_image = augment.augment_image_plain if label == "plain" else aug
                seen, last = [], {}

                def on_step(step, m, state):
                    now = (*_thread_usage(), _process_cpu(), time.perf_counter())
                    if last:
                        prev = last["v"]
                        seen.append((m["step_time"], m["data_time"], now[0] - prev[0],
                                     now[1] - prev[1], now[2] - prev[2]))
                    last["v"] = now

                root_dir = "dummy" if label == "dummy" else root
                FT.main(flags + ["--data_root_dir", root_dir], on_step=on_step)
                gc.collect()
                torch.cuda.empty_cache()
                steps = [s[0] for s in seen]
                out.setdefault(label, []).append(seen)
                C.log(f"[exp] {label}: steps after the first "
                      f"{', '.join(f'{t:.4f}' for t in steps)} s (median "
                      f"{float(np.median(steps)):.4f}); main thread CPU a step "
                      f"{float(np.median([s[2] for s in seen])):.3f} s, preempted "
                      f"{float(np.median([s[3] for s in seen])):.0f} times; process CPU a step "
                      f"{float(np.median([s[4] for s in seen])):.3f} s; waits for the batch "
                      f"{float(np.median([s[1] for s in seen])) * 1e3:.2f} ms "
                      f"(host clock, {card})")
    finally:
        pipeline.make_rlds_iterator, augment.augment_image = make, aug
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(runs, ignore_errors=True)
    for label, rounds in out.items():
        steps = [s[0] for run in rounds for s in run]
        C.log(f"[exp] {label}: median step over {len(rounds)} runs "
              f"{float(np.median(steps)):.4f} s, quartiles "
              f"{float(np.percentile(steps, 25)):.4f}-{float(np.percentile(steps, 75)):.4f}")
    return out


if __name__ == "__main__":
    main()
