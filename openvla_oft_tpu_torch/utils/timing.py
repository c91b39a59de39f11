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
CENSUS_WINDOWS = 2   # the fewest windows whose kernels device_ms takes as a call's
# device_ms holds the profiler's reading against CUDA events around the same
# calls queued behind a spin kernel of SPIN_CYCLES (about 10 ms at the H100's
# 1.98 GHz, longer than the host takes to queue them): the card then runs
# them back to back, so the events' time per call is at least the device
# time. A reading that, with GAP_MS for each kernel of a call (the gap
# between two kernels on a full queue), stays below QUEUED_FLOOR of them is
# traced again, then replaced.
SPIN_CYCLES, QUEUED_FLOOR, GAP_MS = 20_000_000, 0.75, 0.002


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


def _window(fn) -> list:
    """The device kernels of fn() in one torch.profiler window (CUDA activity
    only), padded with idle host time on both sides: a window of a few ms
    has come back with no device activity at all, or with some of its
    kernels missing."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def profiled(fn, complete=bool) -> list:
    """The device kernels of fn(): the first of PROFILE_TRIES windows that
    `complete` accepts, or []."""
    for _ in range(PROFILE_TRIES):
        kernels = _window(fn)
        if kernels and complete(kernels):
            return kernels
        print(f"[profile] torch.profiler window recorded {len(kernels)} device kernels, "
              f"not a complete run: traced again", flush=True)
    return []


def queued_ms(fn, flush, iters: int = 10):
    """fn's time per call from CUDA events around `iters` calls, each after
    zeroing `flush`, queued behind a spin kernel so that no call waits on
    the host, less the same span for the flushes alone: the device time
    plus the gaps between kernels. None when the spin ended before the host
    had queued every call, or with no card."""
    def span(body):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(iters):
            flush.zero_()
            body()
        end.record()
        queued = not start.query()
        end.synchronize()
        return start.elapsed_time(end) if queued else None

    if not (hasattr(torch.cuda, "_sleep") and torch.cuda.is_available()):
        return None
    fn()
    spans = span(fn), span(lambda: None)
    return None if None in spans else (spans[0] - spans[1]) / iters


def device_ms(fn, flush, iters: int = 10) -> tuple:
    """(ms, how): the device time of fn's kernels per call (torch.profiler,
    the mean of `iters` calls), the L2 flushed before each call. Fills and
    memsets (the flush, and any zeroing that fn does) are not counted. Beside
    the CUDA events around the wrapper, this leaves out the host's time in it.

    The profiler can drop kernel records, so at least CENSUS_WINDOWS windows
    of `iters` calls are traced (at most CENSUS_WINDOWS + PROFILE_TRIES - 1).
    Their census is every kernel name any of them recorded, with its most
    instances per call. A window is used only if it holds every kernel of the
    census: the median over the complete ones (each kernel's instances per
    call times `iters`), else the last with some instances missing, whose
    time is each kernel's mean over its recorded instances times its
    instances per call (`how` says how many were recorded). Where no window
    holds every kernel, the time is the CUDA events' around the call.

    A window taken as complete has read a kernel at half the time of every
    other reading. So the reading is held against `queued_ms`: where it
    stays below QUEUED_FLOOR of it even with GAP_MS for each kernel of a
    call, PROFILE_TRIES more windows are traced and the median over all
    complete windows is taken; if that is still below, the time is
    `queued_ms`'s and `how` says so. Otherwise `how` ends with the ratio."""
    def calls():
        for _ in range(iters):
            flush.zero_()
            fn()

    def names(window):
        return [e.name for e in window
                if "fill" not in e.name.lower() and "memset" not in e.name.lower()]

    fn()
    windows, census = [], {}

    def complete(window):
        got = names(window)
        return (bool(census) and set(got) == set(census)
                and all(got.count(n) == c * iters for n, c in census.items()))

    def trace(first, last, settle=True):
        for tries in range(first, last):
            windows.append(_window(calls))
            got = names(windows[-1])
            for n in set(got):
                census[n] = max(census.get(n, 0), round(got.count(n) / iters), 1)
            if settle and tries >= CENSUS_WINDOWS:
                if any(complete(w) for w in windows):
                    break
                print(f"[profile] no complete torch.profiler window among {tries}", flush=True)

    def per_call(window):
        by_name = {}
        for e in window:
            if e.name in census:
                by_name.setdefault(e.name, []).append(e.time_range.end - e.time_range.start)
        return (sum(float(np.mean(d)) * census[n] for n, d in by_name.items()) / 1e3,
                sum(len(d) for d in by_name.values()))

    def reading():
        usable = [w for w in windows if census and set(names(w)) == set(census)]
        if not usable:
            return None, ""
        whole = [w for w in usable if complete(w)]
        if whole:
            return (float(np.median([per_call(w)[0] for w in whole])),
                    "device time (torch.profiler)")
        ms, recorded = per_call(usable[-1])
        return ms, (f"device time (torch.profiler, {recorded} of "
                    f"{iters * sum(census.values())} instances recorded: per-kernel means)")

    trace(1, CENSUS_WINDOWS + PROFILE_TRIES)
    ms, how = reading()
    if ms is None:
        print("[profile] no torch.profiler window held every kernel: CUDA events instead",
              flush=True)
        return (cuda_time_ms(fn, flush=flush),
                "CUDA events (no torch.profiler window held every kernel)")
    queued = queued_ms(fn, flush, iters)
    if queued is None:
        return ms, f"{how}, not held against CUDA events on a full queue"
    # fn's kernels per call, its fills and memsets included (less the flush).
    gaps = GAP_MS * max(1, round(max(len(w) for w in windows) / iters) - 1)
    if ms + gaps < QUEUED_FLOOR * queued:
        print(f"[profile] torch.profiler read {ms:.4f} ms, below {QUEUED_FLOOR} of the "
              f"{queued:.4f} ms of CUDA events on a full queue: traced again", flush=True)
        first = len(windows) + 1
        trace(first, first + PROFILE_TRIES, settle=False)
        ms, how = reading()
        if ms is None or ms + gaps < QUEUED_FLOOR * queued:
            print(f"[profile] torch.profiler read {ms} ms again: CUDA events on a full queue "
                  f"instead", flush=True)
            return queued, (f"CUDA events on a full queue (torch.profiler read {ms} ms, below "
                            f"{QUEUED_FLOOR} of them)")
    return ms, f"{how}, {ms / queued:.2f} of CUDA events on a full queue"
