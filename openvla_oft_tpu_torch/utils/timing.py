"""Kernel timing on the card with CUDA events."""

from __future__ import annotations

import numpy as np
import torch

L2_FLUSH_BYTES = 64 * 2**20      # more than the H100's 50 MB of L2


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
