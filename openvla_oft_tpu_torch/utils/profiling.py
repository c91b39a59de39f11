"""Profiling and step-timing utilities.

Port of `openvla_oft_tpu/utils/profiling.py`, with the same names: `trace()`
wraps a region in a `torch.profiler` trace (CPU activity, and CUDA activity
where a card is present) and writes it as a Chrome trace into `log_dir`
(viewable in Perfetto or chrome://tracing); `annotate()` names a region in
it; `host_sync()` waits for the device by reading a value on the host; and
`StepTimer` gives p50 / p90 wall-clock statistics of the steps it timed.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, List, Optional

import numpy as np


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a `torch.profiler` trace of the enclosed region, with CUDA
    activity where a card is present, written to
    `log_dir/trace-<pid>-<time>.json` (Chrome trace format)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir,
                                              f"trace-{os.getpid()}-{time.time_ns()}.json"))


def annotate(name: str):
    """A named range in the trace (`torch.profiler.record_function`)."""
    from torch.profiler import record_function

    return record_function(name)


def host_sync(x) -> float:
    """The sum of `x` read on the host, which waits for the device to finish
    the work that produced it."""
    import torch

    return float(torch.as_tensor(x).float().sum().item())


class StepTimer:
    """Wall-clock step statistics with percentile summary."""

    def __init__(self, window: int = 200):
        self.times: List[float] = []
        self.window = window
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        assert self._t0 is not None
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        self.times = self.times[-self.window:]
        self._t0 = None
        return dt

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {"p50": float(np.percentile(arr, 50)),
                "p90": float(np.percentile(arr, 90)),
                "mean": float(arr.mean()),
                "steps_per_sec": float(1.0 / max(arr.mean(), 1e-9))}
