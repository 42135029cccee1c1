"""Prefetching data loader (port of ``torchok_tpu.data.loader.DataLoader``).

* worker *threads*: the per-sample host work is numpy (and decode, later),
  which releases the GIL; ``num_workers: 0`` loads synchronously;
* batches are collated to numpy on the host; the engine-installed
  ``device_fn`` copies a batch to the trainer's device and runs the
  dataset's batched device transform suffix there;
* one producer thread keeps ``prefetch_factor`` host batches ready, so host
  work overlaps the device's compute on the previous batch;
* a producer exception is re-raised in the consumer, and an early consumer
  exit (``limit_*_batches``) stops and joins the producer.
"""
from __future__ import annotations

import queue as queue_mod
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

_SENTINEL = object()


def default_collate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    batch: Dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        first = vals[0]
        if isinstance(first, np.ndarray):
            batch[key] = np.stack(vals)
        elif isinstance(first, (bool, np.bool_)):
            batch[key] = np.asarray(vals, dtype=bool)
        elif isinstance(first, (int, np.integer)):
            batch[key] = np.asarray(vals, dtype=np.int64)
        elif isinstance(first, (float, np.floating)):
            batch[key] = np.asarray(vals, dtype=np.float32)
        else:
            batch[key] = vals  # ragged / metadata: keep as list
    return batch


class DataLoader:
    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False, num_workers: Optional[int] = None,
                 collate_fn: Optional[Callable] = None, prefetch_factor: int = 2,
                 seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        # torch semantics: 0 = synchronous in-thread loading; None = default
        self.num_workers = 4 if num_workers is None else max(0, int(num_workers))
        self.collate_fn = collate_fn or getattr(dataset, "collate_fn", None) or default_collate
        self.prefetch_factor = max(1, prefetch_factor)
        self.seed = seed
        self.epoch = 0
        # engine-installed: numpy host batch -> device batch with the
        # device transform suffix applied
        self.device_fn: Optional[Callable[[Dict[str, Any]], Any]] = None

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        """Epoch-deterministic order and host transform draws, with
        torchok_tpu's two seeds (the dataset's ``seed`` takes the second)."""
        self.epoch = epoch
        if hasattr(self.dataset, "seed"):
            self.dataset.seed(self.seed * 1_000_003 + epoch)

    def _index_batches(self) -> List[np.ndarray]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed * 7_368_787 + self.epoch)
            rng.shuffle(order)
        return [order[i:i + self.batch_size] for i in range(0, len(order), self.batch_size)
                if i + self.batch_size <= len(order) or not self.drop_last]

    @property
    def _vectorized(self) -> bool:
        return (hasattr(self.dataset, "get_batch")
                and getattr(self.dataset, "host_pipeline_empty", False)
                and self.collate_fn is default_collate)

    def _fetch(self, pool: Optional[ThreadPoolExecutor], idxs: np.ndarray) -> Dict[str, Any]:
        if self._vectorized:
            return self.dataset.get_batch(idxs)
        if pool is None or len(idxs) < 2 * self.num_workers:
            return self.collate_fn([self.dataset[int(i)] for i in idxs])
        chunks = np.array_split(idxs, self.num_workers)
        parts = list(pool.map(lambda c: [self.dataset[int(i)] for i in c], chunks))
        return self.collate_fn([s for part in parts for s in part])

    def _to_device(self, host_batch: Dict[str, Any]) -> Any:
        if self.device_fn is None:
            return host_batch
        return self.device_fn(host_batch)

    def __iter__(self) -> Iterator[Any]:
        batches = self._index_batches()
        if self.num_workers == 0:
            for idxs in batches:
                yield self._to_device(self._fetch(None, idxs))
            return

        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.prefetch_factor)
        stop = threading.Event()

        def put(item) -> None:
            # bounded put that re-checks stop: the consumer may have left
            # early with the queue full
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue_mod.Full:
                    continue

        def producer():
            try:
                for idxs in batches:
                    if stop.is_set():
                        return
                    put((None, self._fetch(pool, idxs)))
            except BaseException as exc:  # noqa: BLE001 — re-raised by the consumer
                put((exc, None))
            finally:
                put(_SENTINEL)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _SENTINEL:
                    break
                error, host_batch = item
                if error is not None:
                    raise error
                yield self._to_device(host_batch)
        finally:
            stop.set()
            while True:  # unblock a producer waiting on a full queue
                try:
                    q.get_nowait()
                except queue_mod.Empty:
                    break
            t.join(timeout=5)
            pool.shutdown(wait=False)
