"""Batch iteration + background prefetch.

Port of ``repro.data.pipeline`` for one device: ``ShardedLoader`` places
each global batch on the training device (meshes and batch shardings come
with the distribution slice); ``Prefetcher`` overlaps host-side batch
synthesis with device compute through a worker thread.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import torch

__all__ = ["ShardedLoader", "Prefetcher"]


class ShardedLoader:
    """Deterministic per-step global batches, placed on ``device``."""

    def __init__(self, batch_fn: Callable[[int], dict], device=None):
        """batch_fn(step) -> global batch dict of tensors."""
        self.batch_fn = batch_fn
        self.device = None if device is None else torch.device(device)

    def get(self, step: int) -> dict:
        batch = self.batch_fn(step)
        if self.device is None:
            return batch
        return {k: v.to(self.device) for k, v in batch.items()}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.get(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch of up to ``depth`` batches."""

    def __init__(self, loader: ShardedLoader, depth: int = 2,
                 start_step: int = 0):
        self.loader = loader
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            try:
                batch = self.loader.get(step)
            except Exception as e:                     # surface in consumer
                self.q.put(e)
                return
            while not self._stop.is_set():
                try:
                    self.q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self):
        item = self.q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def stop(self):
        """Stop the worker and wait for it (bounded)."""
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10)
