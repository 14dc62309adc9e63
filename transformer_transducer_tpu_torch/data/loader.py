"""Threaded prefetching batch loader (port of ``data/loader.py``).

Replaces the reference's worker-process ``torch.utils.data.DataLoader``
(``train.py:174-177``): feature extraction is numpy work that releases the
GIL, so a thread pool and a bounded prefetch queue keep the card fed.
Batches are dicts of stacked numpy arrays.  The batch order for a given
seed and epoch is the JAX package's (``np.random.default_rng(seed +
epoch)``), so both packages see the same batches.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 8, seed: int = 0, drop_last: bool = True,
                 prefetch_batches: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch_batches
        self.epoch = 0
        # one-shot batch offset for a mid-epoch resume: the next __iter__
        # starts at this batch of the (seed + epoch) order, then it resets
        self.start_batch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _order(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self._order()
        self.epoch += 1
        n_batches = len(self)
        first_batch = min(self.start_batch, n_batches)
        self.start_batch = 0
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()   # the consumer abandoned the iterator
        error: list = []

        def put(item) -> bool:
            """A bounded put that gives up once the consumer is gone, so an
            abandoned iterator never leaves the producer blocked."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in range(first_batch, n_batches):
                        if stop.is_set():
                            return
                        ids = order[b * self.batch_size:(b + 1) * self.batch_size]
                        items = list(pool.map(self.dataset.__getitem__, ids))
                        batch = {key: np.stack([it[i] for it in items])
                                 for i, key in enumerate(("inputs", "inputs_length",
                                                          "targets", "targets_length"))}
                        if not put(batch):
                            return
            except BaseException as e:   # surface worker errors, never hang
                error.append(e)
            finally:
                put(sentinel)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is sentinel:
                    break
                yield item
            thread.join()
        finally:
            stop.set()
            while True:   # drain so that a blocked put() can finish
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    break
            thread.join(timeout=5.0)
        if error:
            raise RuntimeError(
                f"DataLoader worker failed: {error[0]!r}") from error[0]
