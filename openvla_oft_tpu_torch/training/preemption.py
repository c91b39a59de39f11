"""Preemption-aware training: SIGTERM and SIGINT latch a flag the loop polls.

The port's copy of `openvla_oft_tpu/training/preemption.py`. The reference
recovers only by hand (`--resume True --resume_step N`) and its restart
wrappers; a scheduler that preempts a job sends SIGTERM with a short grace
window, so the fine-tuning loop polls `guard.should_stop` after each
micro-step and, when it is set, saves a checkpoint and returns. Together with
`scripts/run_finetune.py`'s restart loop and `--resume` this loses no step.

Usage::

    with PreemptionGuard() as guard:
        for batch in batches:
            state, _ = train_step(state, batch, ...)
            if guard.should_stop:
                save_checkpoint(...)
                break
"""

from __future__ import annotations

import signal
import threading
from types import FrameType
from typing import List, Optional


class PreemptionGuard:
    """Latches SIGTERM and SIGINT into an event the training loop polls.

    The handler only sets the event (it may run between any two bytecodes);
    the loop acts after the step in flight, so the checkpoint is a
    consistent post-step state. A second signal of the same kind restores
    the previous handler and re-raises, so a save that hangs can still be
    interrupted. Outside the main thread the handlers cannot be installed
    and the guard is a flag that only `request_stop()` sets. Leaving the
    `with` block restores the previous handlers, also on an exception.
    """

    def __init__(self, signals: Optional[List[int]] = None):
        self.signals = list(signals) if signals is not None else [signal.SIGTERM,
                                                                  signal.SIGINT]
        self._event = threading.Event()
        self._prev: dict = {}
        self._received: Optional[int] = None

    def __enter__(self) -> "PreemptionGuard":
        for sig in self.signals:
            try:
                self._prev[sig] = signal.signal(sig, self._handle)
            except (ValueError, OSError):
                pass            # not the main thread, or a signal the platform lacks
        return self

    def __exit__(self, *exc) -> None:
        for sig, prev in self._prev.items():
            try:
                # None: the previous handler was installed from C and cannot be
                # restored from Python; the default takes its place.
                signal.signal(sig, prev if prev is not None else signal.SIG_DFL)
            except (ValueError, OSError, TypeError):
                pass
        self._prev.clear()

    def _handle(self, signum: int, frame: Optional[FrameType]) -> None:
        if self._event.is_set():
            prev = self._prev.get(signum)
            signal.signal(signum, prev if prev is not None else signal.SIG_DFL)
            signal.raise_signal(signum)
            return
        self._received = signum
        self._event.set()

    @property
    def should_stop(self) -> bool:
        return self._event.is_set()

    @property
    def received_signal(self) -> Optional[int]:
        return self._received

    def request_stop(self) -> None:
        """The programmatic trigger (tests, wall-clock limits, host agents)."""
        self._event.set()
