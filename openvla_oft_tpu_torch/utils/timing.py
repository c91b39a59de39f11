"""Kernel timing on the card: CUDA events around a call, or the device time
of its kernels from torch.profiler."""

from __future__ import annotations

import time

import numpy as np
import torch

L2_FLUSH_BYTES = 64 * 2**20      # more than the H100's 50 MB of L2
# torch.profiler windows: idle host time on each side of the traced work (s),
# and how many windows are tried before a trace counts as not measured.
PROFILE_PAD_S, PROFILE_TRIES = 0.05, 3


def l2_flush_buffer(device="cuda") -> torch.Tensor:
    """A buffer larger than the L2 cache, for `cuda_time_ms(flush=...)`."""
    return torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3, flush=None) -> float:
    """Median of `iters` CUDA-event timings of fn() after `warmup` calls.
    `flush`, a buffer larger than the 50 MB L2, is zeroed before each timed
    call, so that fn reads its operands from device memory, as a serving
    request that streams every weight once does."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def profiled(fn, complete=bool) -> list:
    """The device kernels of fn() under torch.profiler (CUDA activity only),
    or [] when PROFILE_TRIES windows gave none that `complete` accepts. A
    window of a few ms has come back with no device activity at all, so each
    window is padded with idle host time on both sides and tried again."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels and complete(kernels):
            return kernels
        print(f"[profile] torch.profiler window recorded {len(kernels)} device kernels, "
              f"not a complete run: traced again", flush=True)
    return []


def device_ms(fn, flush, iters: int = 10) -> tuple:
    """(ms, how): the device time of fn's kernels per call (torch.profiler,
    the mean of `iters` calls), the L2 flushed before each call. Fills and
    memsets (the flush, and any zeroing that fn does) are not counted. Beside
    the CUDA events around the wrapper, this leaves out the host's time in it.
    A window is complete when every kernel name came `iters` times (or a
    multiple); where none is, the time is the CUDA events' around the call."""
    def calls():
        for _ in range(iters):
            flush.zero_()
            fn()

    def timed_kernels(events):
        return [e for e in events
                if "fill" not in e.name.lower() and "memset" not in e.name.lower()]

    def complete(events):
        names = [e.name for e in timed_kernels(events)]
        return bool(names) and all(names.count(n) % iters == 0 for n in set(names))

    fn()
    kernels = timed_kernels(profiled(calls, complete))
    if not kernels:
        print("[profile] torch.profiler recorded no complete window: CUDA events instead",
              flush=True)
        return cuda_time_ms(fn, flush=flush), "CUDA events (torch.profiler recorded none)"
    return (sum(e.time_range.end - e.time_range.start for e in kernels) / 1e3 / iters,
            "device time (torch.profiler)")
