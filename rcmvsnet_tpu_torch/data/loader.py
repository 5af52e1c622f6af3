"""Host-side data pipeline: shuffled sharded sampling, batching, and
background prefetch — the torch DataLoader + DistributedSampler replacement
(the reference's train_rcmvsnet.py:592-603).

Single-process: the global batch spans the whole mesh, so 'sharding' is
just batch assembly; multi-host, pass process_index/process_count to have
each host build its local slice (DistributedSampler semantics: per-epoch
seed-shuffled, padded to a multiple of the world size).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np


def _stack_tree(samples):
    first = samples[0]
    if isinstance(first, dict):
        return {k: _stack_tree([s[k] for s in samples]) for k in first}
    if isinstance(first, str):
        return [s for s in samples]
    return np.stack(samples)


def epoch_indices(n: int, epoch: int, shuffle: bool, seed: int,
                  process_index: int = 0, process_count: int = 1,
                  drop_last: bool = True) -> np.ndarray:
    """Per-epoch (optionally shuffled) index shard for this process."""
    order = np.arange(n)
    if shuffle:
        np.random.RandomState(seed + epoch).shuffle(order)
    if process_count > 1:
        pad = (-n) % process_count
        if pad and not drop_last:
            # pad to a multiple of process_count by tiling, like torch's
            # DistributedSampler — order[:pad] alone under-pads when
            # pad > n (e.g. n=1, p=4), leaving unequal shards
            order = np.concatenate(
                [order, np.tile(order, -(-pad // n))[:pad]])
        elif pad:
            # drop the tail so every process yields the SAME number of
            # batches — unequal shards would leave one process issuing
            # collectives with no peer (multi-process deadlock)
            order = order[:n - (n % process_count)]
        order = order[process_index::process_count]
    return order


class DataLoader:
    """Iterates batched samples with a background prefetch thread."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = True,
                 process_index: int = 0, process_count: int = 1,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.process_index = process_index
        self.process_count = process_count
        self.prefetch = prefetch
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return (n // self.process_count) // self.batch_size
        shard = -(-n // self.process_count)  # padded shard (wrap)
        return -(-shard // self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        order = epoch_indices(len(self.dataset), self.epoch, self.shuffle,
                              self.seed, self.process_index,
                              self.process_count, self.drop_last)
        nb = len(order) // self.batch_size if self.drop_last else \
            -(-len(order) // self.batch_size)
        batches = [order[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(nb)]

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = object()
        cancelled = threading.Event()

        def _put(item) -> bool:
            # bounded put that gives up when the consumer abandoned the
            # iterator (early break / exception): a plain q.put would
            # block the thread forever and pin prefetch+1 batches alive
            while not cancelled.is_set():
                try:
                    q.put(item, timeout=0.25)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for idxs in batches:
                    batch = _stack_tree([self.dataset[int(i)] for i in idxs])
                    if not _put(batch):
                        return
                _put(stop)
            except BaseException as exc:  # surface in the consumer —
                # a swallowed load error would silently truncate the
                # epoch (and desync collective counts across processes)
                _put(exc)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, BaseException):
                    raise RuntimeError(
                        "DataLoader worker failed while loading a batch"
                    ) from item
                yield item
        finally:
            cancelled.set()
