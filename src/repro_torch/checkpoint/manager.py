"""Checkpointing: atomic, async, in the JAX package's layout.

Port of ``repro.checkpoint.manager``; each package reads what the other
writes.  Layout: ``<dir>/step_<N>/`` containing

  * ``arrays.npz``  — flat {path: np.ndarray} of every leaf
  * ``meta.msgpack``— step, leaf paths, shapes, dtypes and any extra

A leaf's path joins its keys with ``"\\x1f"`` in the order the reference's
``jax.tree_util.tree_flatten_with_path`` walks a tree: dict keys sorted,
list and tuple entries by index (``params\\x1fembed\\x1ftable``,
``opt\\x1fm\\x1f...``, ``opt\\x1ft``, ``step``, ``rng``).

Write protocol:
  1. write into ``step_<N>.tmp/``
  2. fsync + atomic ``rename`` to ``step_<N>/``
  3. prune old checkpoints beyond ``keep``

``save`` copies every leaf to host memory on the calling thread (a CUDA
tensor by a synchronous device-to-host copy, a CPU tensor by a clone), so
a step queued after it cannot change what is written, even though the
optimizer updates parameters and moments in place; with
``asynchronous=True`` steps 1-3 then run on a worker thread.  ``restore``
places each leaf as its target leaf is: a tensor target gives a tensor on
``device`` (default: the target's own device), any other target a numpy
array.

On a mesh the parameters and moments are ``DTensor`` shards.  ``save``
gathers each to its full tensor on every rank (every rank must call it),
and only the rank that writes (``write=True``, rank 0) writes the
reference's layout, byte for byte as a flat run.  ``restore(...,
shardings=)`` has each rank read the full arrays and keep its shard, so
a checkpoint restores onto any mesh, or none, whatever wrote it.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
from typing import Any, Optional

import msgpack
import numpy as np
import torch

__all__ = ["CheckpointManager"]

_SEP = "\x1f"


def _walk(tree, path=()):
    """(path, leaf) pairs in the reference's flatten order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (str(i),))
    else:
        yield _SEP.join(path), tree


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves taken in ``_walk`` order."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)


def _host_copy(leaf) -> np.ndarray:
    """A host copy of one leaf that nothing else aliases (a ``DTensor``
    gathered to its full tensor first)."""
    if hasattr(leaf, "full_tensor"):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


class CheckpointManager:
    """Save, list and restore checkpoints under ``directory``.

    ``stats`` records the seconds each call spent: ``snapshot_s`` (the
    host copy on the caller's thread), ``write_s`` (steps 1-3, on the
    worker thread when asynchronous) and ``restore_s``."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self.stats = {"snapshot_s": [], "write_s": [], "restore_s": []}

    # ------------------------------------------------------------------
    def _write(self, step: int, flat: dict, extra: dict):
        t0 = time.perf_counter()
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
            np.savez(f, **flat)
            f.flush()
            os.fsync(f.fileno())
        meta = {"step": step,
                "keys": list(flat.keys()),
                "shapes": {k: list(v.shape) for k, v in flat.items()},
                "dtypes": {k: str(v.dtype) for k, v in flat.items()},
                **extra}
        with open(os.path.join(tmp, "meta.msgpack"), "wb") as f:
            f.write(msgpack.packb(meta))
            f.flush()
            os.fsync(f.fileno())
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)                          # atomic commit
        self._prune()
        self.stats["write_s"].append(time.perf_counter() - t0)

    def _prune(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[dict] = None,
             asynchronous: bool = False, write: bool = True):
        """Checkpoint a tree of tensors (``DTensor`` shards included),
        numpy arrays and numbers.  With ``asynchronous=True`` the host
        snapshot is taken here and the write runs on a worker thread
        (training continues).  ``write=False``: only the snapshot (a
        mesh rank other than the writer, taking part in the gather)."""
        if self._error:
            raise self._error
        if asynchronous:
            self.wait()
        t0 = time.perf_counter()
        flat = {k: _host_copy(v) for k, v in _walk(tree)}
        self.stats["snapshot_s"].append(time.perf_counter() - t0)
        if not write:
            return
        if not asynchronous:
            self._write(step, flat, extra or {})
            return

        def work():
            try:
                self._write(step, flat, extra or {})
            except Exception as e:                     # pragma: no cover
                self._error = e
        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error:
            raise self._error

    # ------------------------------------------------------------------
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def nbytes(self, step: int) -> int:
        """Bytes the checkpoint of ``step`` holds on disk."""
        path = os.path.join(self.dir, f"step_{step}")
        return sum(os.path.getsize(os.path.join(path, n))
                   for n in os.listdir(path))

    def restore(self, step: int, target: Any, device=None,
                shardings=None) -> Any:
        """Restore into the structure of ``target``, whose leaves give the
        paths and shapes (tensors, meta-device tensors included, or numpy
        arrays).  Raises ``KeyError`` for a leaf the checkpoint lacks and
        ``ValueError`` for a shape that differs.  A tensor target leaf
        becomes a tensor on ``device`` (default: that leaf's device), any
        other one a numpy array; the checkpoint's dtype is kept.
        ``shardings``: a tree of ``target``'s structure whose leaves
        (``sharding.NamedSharding``) place each tensor leaf as a
        ``DTensor`` holding this rank's shard of the full array."""
        t0 = time.perf_counter()
        path = os.path.join(self.dir, f"step_{step}", "arrays.npz")
        places = ([s for _, s in _walk(shardings)] if shardings is not None
                  else None)
        out = []
        with np.load(path) as z:
            stored = set(z.files)
            for i, (key, tleaf) in enumerate(_walk(target)):
                if key not in stored:
                    raise KeyError(f"checkpoint missing leaf {key!r}")
                arr = z[key]
                if tuple(arr.shape) != _shape(tleaf):
                    raise ValueError(
                        f"shape mismatch for {key!r}: ckpt {arr.shape} vs "
                        f"target {_shape(tleaf)}")
                if isinstance(tleaf, torch.Tensor):
                    arr = torch.from_numpy(arr).to(
                        device if device is not None else tleaf.device)
                    if places is not None:
                        arr = places[i].place(arr)
                out.append(arr)
        self.stats["restore_s"].append(time.perf_counter() - t0)
        return _rebuild(target, iter(out))

    def load_meta(self, step: int) -> dict:
        path = os.path.join(self.dir, f"step_{step}", "meta.msgpack")
        with open(path, "rb") as f:
            return msgpack.unpackb(f.read())
