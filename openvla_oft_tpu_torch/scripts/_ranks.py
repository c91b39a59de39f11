"""The rank launcher of the multi-process dryruns (`dryrun_multiprocess.py`,
`dryrun_multichip.py`): n commands started side by side from the repo's
root, each with its output in a log of its own, joined within one time
limit."""

from __future__ import annotations

import os
import subprocess
import time
from pathlib import Path
from typing import List, Sequence

REPO = Path(__file__).resolve().parents[2]


def start(cmds: Sequence[Sequence[str]], logs: Sequence[Path]) -> list:
    """Start each of `cmds` (argv lists) with one OpenMP thread and the repo
    on PYTHONPATH, its stdout and stderr written to the log of the same
    index. Returns the handles `join` takes."""
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(filter(None, [str(REPO), os.environ.get("PYTHONPATH")]))}
    procs = []
    for cmd, log in zip(cmds, logs):
        f = open(log, "w")
        procs.append((subprocess.Popen(list(cmd), env=env, cwd=str(REPO), stdout=f,
                                       stderr=subprocess.STDOUT), f, Path(log)))
    return procs


def join(procs: list, timeout: float, label: str) -> List[str]:
    """Wait for every process of `start` within `timeout` seconds in all, kill
    those still running after it, and return the logs' texts. Raises, with
    each log's last 3,000 characters, unless every exit code is 0."""
    deadline = time.monotonic() + timeout
    rcs = []
    for p, _, _ in procs:
        try:
            rcs.append(p.wait(timeout=max(deadline - time.monotonic(), 0.1)))
        except subprocess.TimeoutExpired:
            rcs.append(None)
    for p, f, _ in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        f.close()
    texts = [log.read_text() for _, _, log in procs]
    if any(rc != 0 for rc in rcs):
        raise AssertionError(f"{label}: exit codes {rcs} (None: killed at the time limit)\n"
                             + "\n".join(t[-3000:] for t in texts))
    return texts
