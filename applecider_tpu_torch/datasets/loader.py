"""Seeded host-side batcher with a background prefetch thread (counterpart
of the single-process path of ``applecider_tpu/datasets/loader.py``).

A dataset exposes ``len``, ``sample(idx) -> dict`` and ``collate(list[dict])
-> {"data": ...}``. Each epoch shuffles with ``seed + epoch``, batches with
optional drop-last, and assembles the next batches in a thread while the
caller runs the current one.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


class DataLoader:
    def __init__(self, dataset, batch_size: int = 32, shuffle: bool = True, seed: int = 42,
                 drop_last: bool = False, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = int(seed)
        self.drop_last = drop_last
        self.prefetch = int(prefetch)
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batch_indices(self) -> list[np.ndarray]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        batches = [idx[i: i + self.batch_size] for i in range(0, len(idx), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def _make_batch(self, indices: np.ndarray) -> dict:
        return self.dataset.collate([self.dataset.sample(int(i)) for i in indices])

    def __iter__(self) -> Iterator[dict]:
        batches = self._batch_indices()
        self._epoch += 1
        if self.prefetch <= 0:
            for b in batches:
                yield self._make_batch(b)
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        error: list[BaseException] = []
        stop = threading.Event()  # set when the consumer abandons the epoch

        def put(item) -> bool:
            # gives up once the consumer is gone, so an abandoned epoch does
            # not leave this thread blocked on a full queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for b in batches:
                    if stop.is_set() or not put(self._make_batch(b)):
                        return
            except BaseException as e:  # re-raised in the consumer
                error.append(e)
            finally:
                put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if error:
                        raise error[0]
                    return
                yield item
        finally:
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=5.0)
