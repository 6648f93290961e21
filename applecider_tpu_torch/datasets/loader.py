"""Seeded host-side batcher with a background prefetch thread (counterpart
of ``applecider_tpu/datasets/loader.py``).

A dataset exposes ``len``, ``sample(idx) -> dict`` and ``collate(list[dict])
-> {"data": ...}``. Each epoch shuffles with ``seed + epoch``, batches with
optional drop-last, and assembles the next batches in a thread while the
caller runs the current one.

``num_shards``/``shard_index`` stride the epoch over the data axis of a
mesh (``parallel/``): every rank shuffles the same permutation and takes
every ``num_shards``-th index from its own, cut to the common shard length,
so the shards are disjoint and every rank runs the same number of batches
of the same shape. ``shard_emit_plan`` says what each shard emits, which
``Trainer.predict`` inverts to give rows in dataset order.
"""

from __future__ import annotations

import queue
import threading
import warnings
from typing import Iterator

import numpy as np


class DataLoader:
    def __init__(self, dataset, batch_size: int = 32, shuffle: bool = True, seed: int = 42,
                 drop_last: bool = False, prefetch: int = 2, num_shards: int = 1,
                 shard_index: int = 0):
        """With ``num_shards`` > 1 and a common shard length that is not a
        multiple of ``batch_size``, ``drop_last`` turns on with a warning, so
        that no rank gets a short batch the others do not."""
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = int(seed)
        self.drop_last = drop_last
        self.prefetch = int(prefetch)
        self.num_shards = int(num_shards)
        self.shard_index = int(shard_index)
        if not 0 <= self.shard_index < self.num_shards:
            raise ValueError(f"shard_index {shard_index} outside [0, {num_shards})")
        if self.num_shards > 1 and not self.drop_last \
                and (len(dataset) // self.num_shards) % self.batch_size:
            warnings.warn(
                f"sharded loader: common shard length {len(dataset) // self.num_shards} is not "
                f"a multiple of batch_size {self.batch_size}; enabling drop_last so every rank "
                "runs steps of the same shape (predict() recovers the dropped rows)",
                stacklevel=2)
            self.drop_last = True
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def __len__(self) -> int:
        n = len(self.dataset) // self.num_shards  # the common shard length
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _permutation(self) -> np.ndarray:
        """The epoch's permutation, the same on every rank."""
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        return idx

    def _shard_slice(self, idx: np.ndarray, shard: int) -> np.ndarray:
        """The indices shard ``shard`` emits this epoch (drop_last applied)."""
        out = idx[shard::self.num_shards][: len(idx) // self.num_shards]
        if self.drop_last:
            out = out[: len(out) // self.batch_size * self.batch_size]
        return out

    def shard_emit_plan(self) -> dict:
        """What every shard emits on the next ``__iter__``, without changing
        state: ``{"per_shard": [indices of shard s in emission order, ...],
        "leftover": the indices no shard emits}`` (the common-length cut and
        drop_last)."""
        idx = self._permutation()
        per_shard = [self._shard_slice(idx, s) for s in range(self.num_shards)]
        mask = np.ones(len(idx), bool)
        mask[np.concatenate(per_shard)] = False
        return {"per_shard": per_shard, "leftover": np.flatnonzero(mask)}

    def _batch_indices(self) -> list[np.ndarray]:
        idx = self._permutation()
        if self.num_shards > 1:
            idx = self._shard_slice(idx, self.shard_index)
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
