"""Host-to-device prefetch on a CUDA side stream: the port of
`openvla_oft_tpu/data/prefetch.py::DevicePrefetcher`.

A worker thread pulls host batches (dicts of numpy arrays), drops
`drop_keys` (the dataset name) and copies each array to the device while
the training step runs: pinned host memory, `non_blocking` copies on its
own CUDA stream, then an event recorded on that stream. The consumer's
stream waits on the event before it uses the batch, and each tensor is
`record_stream`ed on it, so the caching allocator does not hand its memory
to the worker's next copies before the step is done with it. `depth`
batches are in flight at most. With `device="cpu"` it is a plain bounded
queue of tensors (what the CPU tests use). An exception of the source is
raised again in the consumer; `close()` stops the worker and releases the
buffered device batches.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch


class DevicePrefetcher:
    """Wrap a host batch iterator; yields dicts of tensors on `device`."""

    def __init__(self, batches: Iterator, device="cuda", depth: int = 2,
                 drop_keys: tuple = ("dataset_name",)):
        self._source = batches
        self._device = torch.device(device)
        self._stream = (torch.cuda.Stream(device=self._device)
                        if self._device.type == "cuda" else None)
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._drop = set(drop_keys)
        self._done = object()
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="device-prefetch")
        self._thread.start()

    def _put(self, item) -> bool:
        """Bounded put that notices close(): False when stopping."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _transfer(self, batch: dict):
        host = {k: torch.as_tensor(v) for k, v in batch.items()
                if k not in self._drop and isinstance(v, (np.ndarray, torch.Tensor))}
        if self._stream is None:
            return host, None
        with torch.cuda.stream(self._stream):
            dev = {k: t.pin_memory().to(self._device, non_blocking=True)
                   for k, t in host.items()}
            event = torch.cuda.Event()
            event.record(self._stream)
        return dev, event

    def _worker(self):
        try:
            for batch in self._source:
                if self._stop.is_set():
                    return
                if not self._put(self._transfer(batch)):
                    return
        except BaseException as e:  # raised again in the consumer
            self._error = e
        finally:
            self._put(self._done)

    def close(self) -> None:
        """Stop the worker and release the buffered batches (a consumer that
        stops early would leave `depth` device batches held)."""
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        item = self._queue.get()
        if item is self._done:
            if self._error is not None:
                raise self._error
            raise StopIteration
        batch, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(event)
            for t in batch.values():
                t.record_stream(stream)
        return batch
