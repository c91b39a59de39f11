"""Length-grouped batching (the port's copy of `openvla_oft_tpu/data/batching.py`,
reference `prismatic/util/batching_utils.py:23-212` `SplitModalitySampler`):
examples grouped by length, each batch padded to the smallest of a few
fixed buckets, so padded batches waste little and the shapes stay few.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Sequence

import numpy as np


class LengthGroupedBatcher:
    """Buffers examples and emits batches of similar sequence length, each
    labelled with the smallest bucket that fits it."""

    def __init__(self, batch_size: int, buckets: Sequence[int] = (64, 96, 128),
                 buffer_batches: int = 16, seed: int = 0):
        self.batch_size = batch_size
        self.buckets = tuple(sorted(buckets))
        self.buffer_size = batch_size * buffer_batches
        self.rng = np.random.default_rng(seed)

    def _bucket(self, length: int) -> int:
        for b in self.buckets:
            if length <= b:
                return b
        raise ValueError(f"sequence length {length} exceeds largest bucket "
                         f"{self.buckets[-1]}")

    def __call__(self, dataset) -> Iterator[tuple]:
        """Yields (bucket_len, [examples]) groups."""
        pools: Dict[int, List] = {b: [] for b in self.buckets}
        n_buffered = 0
        for ex in dataset:
            b = self._bucket(len(ex["input_ids"]))
            pools[b].append(ex)
            n_buffered += 1
            if len(pools[b]) == self.batch_size:
                yield b, pools[b]
                n_buffered -= self.batch_size
                pools[b] = []
            elif n_buffered >= self.buffer_size:
                # At the cap, the fullest pool goes out as a short batch.
                fullest = max(pools, key=lambda k: len(pools[k]))
                take = pools[fullest]
                pools[fullest] = []
                n_buffered -= len(take)
                if take:
                    yield fullest, take
        # The end of the stream drains every pool, short batches included.
        for b, pool in pools.items():
            while pool:
                yield b, pool[: self.batch_size]
                pool = pool[self.batch_size:]


def grouped_batch_iterator(dataset, batch_size: int, collator,
                           buckets: Sequence[int] = (64, 96, 128), seed: int = 0):
    """Length-grouped analog of `data.collator.batch_iterator`."""
    batcher = LengthGroupedBatcher(batch_size, buckets, seed=seed)
    for bucket_len, examples in batcher(dataset):
        yield dataclasses.replace(collator, max_length=bucket_len)(examples)
