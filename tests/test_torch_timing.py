"""`utils/timing.py::device_ms` on scripted torch.profiler windows, on the CPU.

The profiler can drop kernel records from a window. `device_ms` traces at
least two windows, takes every kernel any of them recorded as the census,
and uses a window only if it holds every kernel of the census: a complete
window gives the plain mean, a window with some instances missing gives
per-kernel means times each kernel's instances per call, and a window that
lost a kernel altogether is never used (with none left, the CUDA events'
time is taken instead). The reading is then held against `queued_ms`, the
CUDA events around the same calls queued behind a spin kernel: a reading
below QUEUED_FLOOR of them, with a gap allowed for each kernel of a call, is
traced again and, if it stays below, replaced by them.
"""

from types import SimpleNamespace

import pytest
import torch

from openvla_oft_tpu_torch.utils import timing

ITERS = 10


def _window(counts: dict) -> list:
    """Kernel events: {name: (instances, µs each)}."""
    events, t = [], 0.0
    for name, (n, us) in counts.items():
        for _ in range(n):
            events.append(SimpleNamespace(name=name, device_type=torch.autograd.DeviceType.CUDA,
                                          time_range=SimpleNamespace(start=t, end=t + us)))
            t += us
    return events


@pytest.fixture
def scripted(monkeypatch):
    """Feeds `profiled` the given windows in order, one per profiler window."""
    def install(windows):
        queue = [_window(w) for w in windows]

        class Profile:
            def __init__(self, **_):
                self.window = queue.pop(0)

            def __enter__(self):
                return self

            def __exit__(self, *exc):
                return False

            def events(self):
                return self.window

        monkeypatch.setattr(torch.profiler, "profile", Profile)
        monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
        monkeypatch.setattr(timing.time, "sleep", lambda s: None)
        monkeypatch.setattr(timing, "cuda_time_ms", lambda fn, **kw: 99.0)
        return queue
    return install


def _measure():
    return timing.device_ms(lambda: None, torch.zeros(4), iters=ITERS)


@pytest.mark.parametrize("case", [
    # (windows of ITERS calls, ms, how starts with, windows traced)
    ([{"A": (10, 30.0), "B": (10, 10.0), "fill": (10, 5.0)}, {"A": (10, 30.0), "B": (10, 10.0)}],
     0.040, "device time (torch.profiler)", 2),
    # A runs twice per call; 3 of its 20 records are missing in every window.
    ([{"A": (17, 30.0), "B": (10, 10.0)}] * 4,
     0.070, "device time (torch.profiler, 27 of 30 instances recorded", 4),
    # The first window lost every B: it is not used, the second is.
    ([{"A": (10, 30.0)}, {"A": (10, 30.0), "B": (10, 10.0)}],
     0.040, "device time (torch.profiler)", 2),
    # A window with instances missing, then a complete one, which is used.
    ([{"A": (17, 30.0), "B": (10, 10.0)}, {"A": (20, 20.0), "B": (10, 10.0)}],
     0.050, "device time (torch.profiler)", 2),
    # Every window lost some of A or all of B: the last that holds both is used.
    ([{"A": (8, 30.0), "B": (10, 10.0)}, {"A": (10, 30.0)}, {"A": (9, 30.0), "B": (10, 10.0)},
      {"A": (10, 30.0)}],
     0.040, "device time (torch.profiler, 19 of 20", 4),
    # No window recorded anything: CUDA events.
    ([{}] * 4, 99.0, "CUDA events", 4),
], ids=["complete", "partial", "kernel_dropped", "partial_then_complete", "kernel_dropped_often",
        "empty"])
def test_device_ms_windows(scripted, case):
    windows, ms, how, traced = case
    queue = scripted(windows)
    got, got_how = _measure()
    assert got == pytest.approx(ms)
    assert got_how.startswith(how)
    assert len(windows) - len(queue) == traced


@pytest.mark.parametrize("case", [
    # (windows, queued_ms, ms, how contains, windows traced)
    ([{"A": (10, 40.0)}] * 2, 0.042, 0.040, "device time (torch.profiler), 0.95 of CUDA events", 2),
    # Both first windows read A at half its time: traced again, the median
    # over the five complete windows is A's own time.
    ([{"A": (10, 15.0)}] * 2 + [{"A": (10, 30.0)}] * 3, 0.031, 0.030,
     "device time (torch.profiler), 0.97 of CUDA events", 5),
    # Every window reads half: the events' time is taken.
    ([{"A": (10, 15.0)}] * 5, 0.031, 0.031, "CUDA events on a full queue (torch.profiler read", 5),
    # Ten short kernels a call: the gaps between them on a full queue (2 µs
    # each) keep a reading at 0.70 of the events.
    ([{f"K{i}": (10, 3.5) for i in range(10)}] * 2, 0.050, 0.035,
     "device time (torch.profiler), 0.70 of CUDA events", 2),
], ids=["agrees", "half_then_traced_again", "half_always", "many_short_kernels"])
def test_device_ms_held_against_queued_events(scripted, monkeypatch, case):
    windows, queued, ms, how, traced = case
    queue = scripted(windows)
    monkeypatch.setattr(timing, "queued_ms", lambda fn, flush, iters: queued)
    got, got_how = _measure()
    assert got == pytest.approx(ms)
    assert how in got_how
    assert len(windows) - len(queue) == traced
