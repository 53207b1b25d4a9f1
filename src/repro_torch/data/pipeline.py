"""Batch iteration + background prefetch.

Port of ``repro.data.pipeline``: ``ShardedLoader`` takes each step's global
batch and places this rank's shard of it on the training device;
``Prefetcher`` overlaps host-side batch synthesis with device compute
through a worker thread.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import torch

__all__ = ["ShardedLoader", "Prefetcher"]


def _batch_dim(spec) -> Optional[int]:
    """The dim a batch spec shards over the data axes, or None."""
    for d, e in enumerate(spec):
        if e is not None:
            return d
    return None


class ShardedLoader:
    """Deterministic per-step global batches, this rank's rows placed on
    ``device``.

    ``specs`` (the plan's ``batch_specs``, a spec per leaf) name the dim
    each leaf splits over the data axes; ``data`` is this rank's ``(index,
    count)`` along them.  Each rank takes its rows of each microbatch --
    global microbatch ``i`` of ``accum_steps``, then this rank's
    ``1/count`` of it -- as the reference splits the global batch into
    microbatches and GSPMD shards each over ``data``; the local batch
    then splits into this rank's parts of the microbatches in order.  A
    leaf whose spec replicates is kept whole on every rank."""

    def __init__(self, batch_fn: Callable[[int], dict], device=None,
                 specs: Optional[dict] = None, data=(0, 1),
                 accum_steps: int = 1):
        """batch_fn(step) -> global batch dict of tensors."""
        self.batch_fn = batch_fn
        self.device = None if device is None else torch.device(device)
        self.specs = specs
        self.data = tuple(data)
        self.accum_steps = accum_steps

    def _local(self, name: str, x: torch.Tensor) -> torch.Tensor:
        dim = _batch_dim(self.specs[name])
        index, count = self.data
        if dim is None or count == 1:
            return x
        micro = x.shape[dim] // self.accum_steps
        if x.shape[dim] % self.accum_steps or micro % count:
            raise ValueError(
                f"batch leaf {name!r} dim {dim} ({x.shape[dim]}) does not "
                f"split into {self.accum_steps} microbatches of whole "
                f"shards for {count} data ranks")
        rows = micro // count
        parts = [m.narrow(dim, index * rows, rows)
                 for m in x.split(micro, dim=dim)]
        return torch.cat(parts, dim=dim)

    def get(self, step: int) -> dict:
        batch = self.batch_fn(step)
        if self.specs is not None:
            batch = {k: self._local(k, v) for k, v in batch.items()}
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
