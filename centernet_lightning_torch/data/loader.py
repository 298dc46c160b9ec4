"""Threaded prefetching data loader (a copy of the JAX package's
data/loader.py).

Replaces torch.utils.data.DataLoader (reference centernet.py:224-227); it
yields numpy batches, which the consumer uploads to the card.
Decoding + augmentation are numpy/cv2 (GIL-released C code), so a thread
pool gives real parallelism without process-fork overhead; a bounded
prefetch queue keeps the host pipeline ahead of the device.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional

import numpy as np

__all__ = ["DataLoader"]


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int = 32,
        shuffle: bool = False,
        collate_fn: Optional[Callable] = None,
        num_workers: int = 4,
        drop_last: bool = False,
        seed: int = 0,
        prefetch: int = 2,
        shard_id: int = 0,
        num_shards: int = 1,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.collate_fn = collate_fn or (lambda items: items)
        self.num_workers = max(0, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.shard_id = shard_id
        self.num_shards = max(1, num_shards)
        self._epoch = 0

    def _shard_len(self) -> int:
        n = len(self.dataset)
        if self.num_shards > 1:
            # lockstep across ranks: every shard sees exactly n // shards
            n = n // self.num_shards
        return n

    def __len__(self) -> int:
        n = self._shard_len()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            # seed is shared across ranks: one GLOBAL permutation, each
            # rank takes its interleaved slice (disjoint local slices of
            # one global epoch)
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
        if self.num_shards > 1:
            order = order[self.shard_id::self.num_shards][:self._shard_len()]
        for start in range(0, len(order), self.batch_size):
            idxs = order[start : start + self.batch_size]
            if self.drop_last and len(idxs) < self.batch_size:
                return
            yield idxs

    def __iter__(self) -> Iterator:
        self._epoch += 1
        if self.num_workers == 0:
            for idxs in self._batches():
                yield self.collate_fn([self.dataset[int(i)] for i in idxs])
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()  # set when the consumer abandons iteration

        def producer():
            # dataset errors (missing/corrupt images, ...) are forwarded to
            # the consumer and re-raised there; the sentinel ALWAYS lands so
            # iteration can never block forever on a dead producer
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for idxs in self._batches():
                        items = list(
                            pool.map(self.dataset.__getitem__, map(int, idxs))
                        )
                        batch = self.collate_fn(items)
                        while not stop.is_set():
                            try:
                                q.put(batch, timeout=0.1)
                                break
                            except queue.Full:
                                continue
                        if stop.is_set():
                            return
            except BaseException as exc:  # noqa: BLE001 - forwarded
                while not stop.is_set():
                    try:
                        q.put(exc, timeout=0.1)
                        return
                    except queue.Full:
                        continue
            finally:
                while not stop.is_set():
                    try:
                        q.put(sentinel, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                batch = q.get()
                if batch is sentinel:
                    break
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            # unblocks the producer if the consumer broke out early
            stop.set()
            thread.join(timeout=5)
