"""Dispatch and in-place-update guards for the eager training step.

Port of ``repro.analysis.tracing``, whose two guards watch what ``jit``
does: recompiles and buffer donation.  Eager PyTorch has neither, and the
same two regressions take other forms here:

  * **Drifting work**: a step that dispatches different work from call to
    call at fixed shapes (a branch on a value, a cache that never fills, a
    fallback that kicks in) still *works*, it just costs host time each
    step.  :class:`RetraceGuard` records what each call dispatches (every
    PyTorch operation, with its output shapes and dtypes, and the launches
    each kernel wrapper counts) and fails if a call after the first
    dispatches other work than the call before it.
  * **Copies**: the optimizer updates the parameters and the moments in
    place (``optim/__init__.py``, ``engine/step.py``), so a step holds one
    copy of the state.  An update that silently rebinds a leaf to a new
    tensor doubles that memory.  :func:`check_inplace_update` holds every
    parameter and moment leaf of the returned state to its input's
    storage and names each leaf that was copied.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["RetraceGuard", "InplaceReport", "check_inplace_update",
           "check_step_inplace"]


def _launch_counts() -> dict:
    """Every kernel wrapper's launch counters (``kernels/``), by name."""
    from .. import kernels
    out = {}
    for name in kernels.__all__:
        fn = getattr(kernels, name)
        for attr in ("launches", "launches_dx"):
            if hasattr(fn, attr):
                out[f"{name}.{attr}"] = getattr(fn, attr)
    return out


class _Dispatched(TorchDispatchMode):
    """Counts (operation, output shapes and dtypes) as they dispatch."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        sig = tuple((tuple(t.shape), str(t.dtype)) for t in outs
                    if isinstance(t, torch.Tensor))
        self.ops[str(func), sig] += 1
        return out


@dataclasses.dataclass
class RetraceGuard:
    """Wrap a step and record the work each call dispatches.

    >>> guard = RetraceGuard(step_fn)
    >>> state, metrics = guard(state, batch)     # may differ (first call)
    >>> state, metrics = guard(state, batch)     # must dispatch the same
    >>> guard.assert_no_retrace()

    ``changes`` records the call indices whose work differed from the
    call before.  The first call may do one-time work (the reference's
    compile); a change at any later call means something in the step
    drifts between calls at fixed shapes.
    """

    fn: Callable
    calls: int = 0
    changes: List[int] = dataclasses.field(default_factory=list)
    _last: Any = dataclasses.field(default=None, repr=False)

    def __call__(self, *args, **kwargs):
        before = _launch_counts()
        with _Dispatched() as mode:
            out = self.fn(*args, **kwargs)
        after = _launch_counts()
        work = (frozenset(mode.ops.items()),
                frozenset((k, after[k] - before[k]) for k in after))
        if self._last is not None and work != self._last:
            self.changes.append(self.calls)
        self._last = work
        self.calls += 1
        return out

    @property
    def retraces(self) -> int:
        """Calls after the second whose work differed from the call
        before (the first call's one-time work excepted)."""
        return sum(1 for i in self.changes if i > 1)

    def assert_no_retrace(self) -> None:
        if self.retraces:
            raise AssertionError(
                f"the step's dispatched work changed on call(s) "
                f"{[i for i in self.changes if i > 1]} of {self.calls} "
                f"(changes at {self.changes}); something in the step drifts "
                f"between calls at fixed shapes — a branch on a value, a "
                f"cache that refills, or a new input shape")


# ---------------------------------------------------------------------------
# In-place updates
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InplaceReport:
    n_leaves: int
    copied: Tuple[str, ...]            # leaves whose storage changed
    detail: str

    @property
    def ok(self) -> bool:
        return not self.copied


def _named_leaves(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _named_leaves(tree[k], f"{prefix}{k}/")]
    return [(prefix.rstrip("/"), tree)]


def _state_leaves(state) -> List[Tuple[str, torch.Tensor]]:
    """Every parameter and optimizer-moment leaf of a TrainState."""
    leaves = _named_leaves({"params": state.params,
                            "opt_state": state.opt_state})
    return [(k, v) for k, v in leaves
            if isinstance(v, torch.Tensor) and v.dim() > 0]


def check_inplace_update(fn: Callable, state, *rest,
                         out_index: int = 0) -> Tuple[Any, InplaceReport]:
    """Call ``fn(state, *rest)`` and hold every parameter and moment leaf
    of the returned state (``out[out_index]``) to the storage of the input
    leaf of the same path.  Returns ``(fn's result, InplaceReport)``."""
    before = {k: v.untyped_storage().data_ptr()
              for k, v in _state_leaves(state)}
    out = fn(state, *rest)
    new = out[out_index] if isinstance(out, (tuple, list)) else out
    after = dict(_state_leaves(new))
    copied = tuple(k for k, ptr in before.items()
                   if k not in after
                   or after[k].untyped_storage().data_ptr() != ptr)
    n = len(before)
    if copied:
        shown = ", ".join(copied[:8]) + (" ..." if len(copied) > 8 else "")
        detail = (f"{len(copied)}/{n} parameter and moment leaves were "
                  f"copied, not updated in place ({shown}); the step holds "
                  f"two copies of them")
    else:
        detail = f"all {n} parameter and moment leaves updated in place"
    return out, InplaceReport(n_leaves=n, copied=copied, detail=detail)


def check_step_inplace(step_fn, state, batch) -> InplaceReport:
    """The in-place check for the engine step's signature
    ``step_fn(state, batch) -> (new_state, metrics)``."""
    _, report = check_inplace_update(step_fn, state, batch, out_index=0)
    return report
