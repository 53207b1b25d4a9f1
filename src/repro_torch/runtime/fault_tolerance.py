"""Fault-tolerance runtime: preemption handling, straggler monitoring,
bounded retries, and elastic mesh re-configuration.

Port of ``repro.runtime.fault_tolerance`` (pure Python, the same code).
``PreemptionHandler(install=True)`` installs signal handlers, which Python
allows only in the main thread: the training CLI installs it, no library
constructor does.

On a real cluster these hooks are driven by the scheduler (SIGTERM before
preemption, per-host heartbeats).  Everything here is pure library logic —
unit-tested with injected clocks/signals — so the training loop composes it
identically on 1 CPU or 1024 hosts.
"""

from __future__ import annotations

import signal
import threading
import time
from typing import Callable, Dict, List

__all__ = ["PreemptionHandler", "StragglerMonitor", "retry",
           "ElasticController"]


class PreemptionHandler:
    """Converts SIGTERM/SIGINT into a checkpoint-then-exit request.

    Usage::
        prm = PreemptionHandler(install=True)
        for step in ...:
            ...
            if prm.should_stop:
                ckpt.save(step, state); break
    """

    def __init__(self, install: bool = False, signals=(signal.SIGTERM,)):
        self._stop = threading.Event()
        if install:
            for sig in signals:
                signal.signal(sig, self._handler)

    def _handler(self, signum, frame):
        self._stop.set()

    def request_stop(self):
        """Programmatic trigger (tests / external schedulers)."""
        self._stop.set()

    @property
    def should_stop(self) -> bool:
        return self._stop.is_set()


class StragglerMonitor:
    """Flags hosts whose step times exceed ``threshold`` x the fleet median.

    Feed per-host step durations each step; ``stragglers()`` returns hosts
    that were slow for ``patience`` consecutive steps — the signal a real
    deployment uses to trigger hot-spare swap-in (elastic re-shard).
    """

    def __init__(self, n_hosts: int, threshold: float = 2.0,
                 patience: int = 3):
        self.n_hosts = n_hosts
        self.threshold = threshold
        self.patience = patience
        self._slow_streak = [0] * n_hosts
        self.history: List[List[float]] = []

    def record(self, step_times: List[float]):
        assert len(step_times) == self.n_hosts
        self.history.append(list(step_times))
        med = sorted(step_times)[self.n_hosts // 2]
        for h, t in enumerate(step_times):
            if t > self.threshold * med:
                self._slow_streak[h] += 1
            else:
                self._slow_streak[h] = 0

    def stragglers(self) -> List[int]:
        return [h for h, s in enumerate(self._slow_streak)
                if s >= self.patience]


def retry(fn: Callable, max_attempts: int = 3, backoff: float = 0.5,
          retriable=(RuntimeError, OSError), sleep=time.sleep):
    """Bounded retry with exponential backoff (transient collective failures,
    checkpoint-storage hiccups)."""
    last = None
    for attempt in range(max_attempts):
        try:
            return fn()
        except retriable as e:                         # noqa: PERF203
            last = e
            if attempt + 1 < max_attempts:
                sleep(backoff * (2 ** attempt))
    raise last


class ElasticController:
    """Decides the mesh shape when the healthy-host set changes.

    Given the nominal mesh (pods, data, model) and a healthy-chip count,
    returns the largest runnable mesh that keeps the `model` axis intact
    (TP degree is fixed by memory) and shrinks the data axis — the standard
    elastic-DP policy.  The training loop then: checkpoint -> rebuild mesh ->
    restore (CheckpointManager reshards) -> continue.
    """

    def __init__(self, model_parallel: int, chips_per_host: int = 4):
        self.tp = model_parallel
        self.chips_per_host = chips_per_host

    def plan_mesh(self, healthy_chips: int) -> Dict[str, int]:
        dp = healthy_chips // self.tp
        if dp < 1:
            raise RuntimeError(
                f"not enough chips ({healthy_chips}) for TP={self.tp}")
        return {"data": dp, "model": self.tp}

    def should_rescale(self, current_dp: int, healthy_chips: int) -> bool:
        return self.plan_mesh(healthy_chips)["data"] != current_dp
