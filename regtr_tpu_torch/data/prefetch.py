"""Threaded prefetching data loader (the port's own copy of
regtr_tpu/data/prefetch.py; a CPU test holds the batches equal in order and
contents).

Samples are loaded in worker threads (numpy, pickle and scipy release the
interpreter lock for the heavy work), and collated batches wait in a
bounded queue, so the host prepares the next batches while the card runs
the current one.

Several ranks: `shard=(rank, world)` partitions the sample indices (every
world-th from the rank's).  `shard_pad` wraps a short shard to the longest
one's length, so that every rank yields the same number of batches: the
train and validation loops run collectives on every batch, and a rank with
one batch more would leave the others waiting.  The few duplicated samples
bias the averaged metrics negligibly (as torch's DistributedSampler does).
"""
from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Tuple

import numpy as np


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        collate_fn: Callable,
        shuffle: bool = False,
        num_workers: int = 4,
        prefetch: int = 2,
        seed: int = 0,
        drop_last: bool = False,
        shard: Optional[Tuple[int, int]] = None,
        shard_pad: bool = False,
        pad_last_batch: bool = False,
        group_key: Optional[Callable] = None,
    ):
        if shard is not None and not 0 <= shard[0] < shard[1]:
            raise ValueError(f"shard {shard}: rank not in [0, world)")
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.num_workers = max(0, num_workers)
        self.prefetch = max(1, prefetch)
        self.seed = seed
        self.drop_last = drop_last
        self.shard = shard
        self.shard_pad = shard_pad
        # Wrap-pad the final batch to full batch_size with leading samples,
        # so every batch has one shape (val); never for test protocols,
        # where duplicated pairs would corrupt the scores.
        self.pad_last_batch = pad_last_batch
        # group_key(sample) -> hashable: samples are regrouped into
        # same-key batches as they stream through (size-grouped test
        # batching).  The batch order changes, so consumers key results on
        # the sample's idx; the multiset of samples does not change.  Not
        # for collective loops: grouping makes the ranks' batch counts
        # differ.
        self.group_key = group_key
        self._epoch = 0

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def _indices(self):
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(idx)
        if self.shard is not None:
            rank, world = self.shard
            full, idx = idx, idx[rank::world]
            if self.shard_pad and n > 0:
                target = -(-n // world)       # the longest shard's length
                if len(idx) == 0:
                    idx = full[[rank % n]]
                while len(idx) < target:
                    idx = np.concatenate([idx, idx[:target - len(idx)]])
        return idx

    def __len__(self):
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _sample_batches(self, idx, pool=None):
        """Yield the loaded samples of each batch.

        Ungrouped: fixed index slices in (shuffled) order.  Grouped: samples
        stream through a per-key buffer and a batch leaves whenever a key
        holds `batch_size` samples; the remainders leave at the end in
        sorted key order.
        """
        def load(i):
            return self.dataset[int(i)]

        if self.group_key is None:
            batches = [idx[i: i + self.batch_size]
                       for i in range(0, len(idx), self.batch_size)]
            if self.drop_last:
                batches = [b for b in batches if len(b) == self.batch_size]
            elif self.pad_last_batch and batches:
                last = batches[-1]
                if len(last) < self.batch_size:
                    fill = np.resize(idx, self.batch_size - len(last))
                    batches[-1] = np.concatenate([last, fill])
            for b in batches:
                if pool is not None:
                    yield list(pool.map(load, b))
                else:
                    yield [load(i) for i in b]
            return

        if pool is not None:
            # A bounded window of loads in flight: pool.map would submit
            # every load at once and hold the whole dataset in memory.
            window = max(2 * self.num_workers, self.batch_size)
            futs: deque = deque()

            def _samples():
                for i in idx:
                    futs.append(pool.submit(load, i))
                    if len(futs) >= window:
                        yield futs.popleft().result()
                while futs:
                    yield futs.popleft().result()

            samples = _samples()
        else:
            samples = (load(i) for i in idx)

        pending: dict = {}
        for s in samples:
            k = self.group_key(s)
            pending.setdefault(k, []).append(s)
            if len(pending[k]) == self.batch_size:
                yield pending.pop(k)
        for k in sorted(pending):
            yield pending[k]

    def __iter__(self):
        idx = self._indices()

        if self.num_workers == 0:
            for samples in self._sample_batches(idx):
                yield self.collate_fn(samples)
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()

        def _put(item):
            """Bounded put that gives up once the consumer has left."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for samples in self._sample_batches(idx, pool):
                        if stop.is_set() or not _put(
                                self.collate_fn(samples)):
                            return
            except BaseException as e:   # raised again in the consumer
                _put(e)
            finally:
                _put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # The consumer may leave mid-epoch: release the producer.
            stop.set()
            t.join(timeout=5.0)
