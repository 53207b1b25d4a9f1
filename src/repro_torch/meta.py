"""The dry run's hooks in the model code.

The dry run (``launch/dryrun.py``) runs the port's own step, prefill or
decode on the meta device, where a tensor has a shape and a dtype and no
values, and counts every operation as it dispatches.  Two host loops of
the model code run one step per token or chunk, and on the meta device
each of their operations costs about 100 µs of Python: they take a meta
path that runs one step and scales its counts (:func:`scaled`) to the
loop's trip count.  What the loop keeps alive for the backward is
allocated as one buffer of the same bytes (:func:`hold`).

Outside a dry run (no counter entered) nothing here has an effect.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

__all__ = ["is_meta", "Counting", "current", "scaled", "uncounted", "track",
           "hold", "add_counts"]


def is_meta(*tensors: torch.Tensor) -> bool:
    """Whether any of ``tensors`` lies on the meta device."""
    return any(t.device.type == "meta" for t in tensors)


class Counting:
    """What a counter exposes to the model code: ``scale`` multiplies
    every count of the operations dispatched meanwhile; ``live`` off
    keeps their allocations out of the live bytes."""
    scale: int = 1
    live: bool = True

    def add_counts(self, nbytes: int, ops: int) -> None:
        """Count ``ops`` operations moving ``nbytes`` (times ``scale``)."""

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live from now."""


_STACK: list = []


def current() -> Optional[Counting]:
    """The innermost counter entered, else None."""
    return _STACK[-1] if _STACK else None


@contextlib.contextmanager
def entered(counter: Counting):
    """Make ``counter`` the one :func:`current` returns."""
    _STACK.append(counter)
    try:
        yield counter
    finally:
        _STACK.remove(counter)


@contextlib.contextmanager
def scaled(n: int):
    """Count each operation of the block ``n`` times and keep its
    allocations out of the live bytes: the block is one step of a loop
    of ``n`` equal steps."""
    c = current()
    if c is None:
        yield
        return
    prev = c.scale, c.live
    c.scale, c.live = prev[0] * n, False
    try:
        yield
    finally:
        c.scale, c.live = prev


def uncounted(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with no operation counted, its result (a
    tensor or a tuple of them) live from now: a meta path's stand-in for
    what the loop's operations make."""
    c = current()
    if c is None:
        return fn(*args, **kwargs)
    prev = c.scale, c.live
    c.scale, c.live = 0, False
    try:
        out = fn(*args, **kwargs)
    finally:
        c.scale, c.live = prev
    track(*(out if isinstance(out, tuple) else (out,)))
    return out


def track(*tensors) -> None:
    """Count the tensors' storages as live from now (None is skipped)."""
    c = current()
    if c is not None and c.live:
        for t in tensors:
            if t is not None:
                c.track(t)


def hold(nbytes: int, device) -> torch.Tensor:
    """A buffer of ``nbytes`` bytes: what a loop keeps for its backward,
    held as long as the returned tensor."""
    return uncounted(torch.empty, (int(nbytes),), dtype=torch.uint8,
                     device=device)


def add_counts(nbytes: int, ops: int = 1) -> None:
    """Count ``ops`` operations moving ``nbytes`` that a meta path does
    not run (to the counter entered, if any)."""
    c = current()
    if c is not None:
        c.add_counts(nbytes, ops)
