"""Full-precision exemption registry + profiler markers for quantization.

Port of ``repro.core.exempt``.  The paper's guarantees (Theorem 1
unbiasedness, the Eq. 6 variance decomposition) only cover GEMMs that run
through the FQT primitive under the resolved
:class:`~repro_torch.core.policy.QuantPolicy`.  Every other matmul of the
model is either an intentional full-precision computation (attention
scores and probabilities: the paper quantizes only linear layers) or a
leak.  This module draws the line between the two:

  * :func:`fp_exempt` — registers ``path`` with a human ``reason`` in a
    process-global registry and marks what runs inside as ``fp[path]``;
  * :func:`quant_scope` — the marker the FQT primitive opens around each
    role's quantize+GEMM work: ``q[path|role]`` for quantized execution,
    ``qfp[path|role]`` for GEMMs the resolved policy runs in full
    precision (QAT backwards, ``None`` roles, exact-pinned layers);
  * :func:`key_scope` — ``qk[path]`` around the backward's per-site key
    derivation.

The reference's markers are ``jax.named_scope`` names (trace-time
metadata, free at run time).  Here they are ``torch.profiler.
record_function`` ranges of the same names, opened only while a profiler
records; while a GEMM-site walk runs (``analysis/graph.py``), which
cannot read profiler ranges, a marker pushes its name onto the walk's
stack instead (:func:`walking`).  Outside both a marker costs two flag
checks, so the host-bound training step pays nothing for them.  The
registry and the argument checks run on every call, as in the reference.
"""

from __future__ import annotations

import contextlib
import re
import threading
from typing import Dict, Iterator, List, Optional

import torch

__all__ = ["fp_exempt", "quant_scope", "key_scope", "exemption_registry",
           "clear_exemptions", "walking", "walk_stack", "MARKER_RE",
           "KEY_SCOPE_RE", "GEMM_ROLES"]

# Roles a quant_scope marker may claim.  "fwd" also covers the gradients
# of an exact-pinned forward GEMM (the whole matmul is full precision).
GEMM_ROLES = ("fwd", "wgrad", "agrad")

# q[path|role] / qfp[path|role] / fp[path] inside a marker name.
MARKER_RE = re.compile(r"\b(qfp|q|fp)\[([^\]]*)\]")

# qk[path]: the key-lineage marker (not matched by MARKER_RE).
KEY_SCOPE_RE = re.compile(r"\bqk\[([^\]]*)\]")

_LOCK = threading.Lock()
_REGISTRY: Dict[str, str] = {}


def _check_static_str(name: str, value) -> str:
    if not isinstance(value, str) or not value:
        raise TypeError(f"{name} must be a non-empty static str, got "
                        f"{value!r}; exemption paths are trace-time metadata "
                        f"and cannot be traced values")
    if "]" in value or "[" in value:
        raise ValueError(f"{name}={value!r} may not contain '[' or ']' "
                         f"(they delimit the jaxpr marker)")
    return value


def _check_path(path: str) -> None:
    if "]" in path or "[" in path:
        raise ValueError(f"path={path!r} may not contain '[' or ']'")


# The marker names open while a GEMM-site walk runs, innermost last; None
# outside a walk.  One list for every thread: the autograd engine may run
# a backward on a thread of its own, where the FQT backward's scopes open,
# and the walk's dispatch reads the stack there.
_WALK: Optional[List[str]] = None


@contextlib.contextmanager
def walking():
    """Markers push their names onto a fresh walk stack (not re-entrant:
    one walk at a time)."""
    global _WALK
    if _WALK is not None:
        raise RuntimeError("a GEMM-site walk is already running")
    _WALK = []
    try:
        yield
    finally:
        _WALK = None


def walk_stack() -> tuple:
    """The marker names open now in the running walk, innermost last."""
    return tuple(_WALK) if _WALK is not None else ()


@contextlib.contextmanager
def _pushed(name: str):
    stack = _WALK
    stack.append(name)
    try:
        yield
    finally:
        stack.pop()


def _marker(name: str):
    """The walk's stack entry ``name`` while a walk runs, a profiler range
    named ``name`` while a profiler records, else a no-op context."""
    if _WALK is not None:
        return _pushed(name)
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


@contextlib.contextmanager
def fp_exempt(path: str, reason: str) -> Iterator[None]:
    """Declare the GEMMs run inside as intentionally full precision.

    ``path`` is the logical name reports group under (e.g.
    ``"attn.sdpa"``); ``reason`` is the human justification recorded in
    the exemption registry.  Both must be non-empty strings.
    """
    _check_static_str("path", path)
    if not isinstance(reason, str) or not reason.strip():
        raise TypeError(f"fp_exempt({path!r}): reason must be a non-empty "
                        f"str explaining why these GEMMs stay full precision")
    with _LOCK:
        _REGISTRY.setdefault(path, reason)
    with _marker(f"fp[{path}]"):
        yield


def quant_scope(path: str, role: str, quantized: bool):
    """Marker scope for one GEMM role of the FQT primitive:
    ``q[path|role]`` when ``quantized``, else ``qfp[path|role]``."""
    if role not in GEMM_ROLES:
        raise ValueError(f"unknown GEMM role {role!r}; expected one of "
                         f"{GEMM_ROLES}")
    # path may legitimately be "" (direct fqt_matmul calls outside a model)
    _check_path(path)
    tag = "q" if quantized else "qfp"
    return _marker(f"{tag}[{path}|{role}]")


def key_scope(path: str):
    """Marker scope ``qk[path]`` for the backward's per-site key
    derivation (``fold_in`` + ``split``), which runs before either role
    scope opens."""
    _check_path(path)
    return _marker(f"qk[{path}]")


def exemption_registry() -> Dict[str, str]:
    """Snapshot of the declared exemptions: {path: reason}."""
    with _LOCK:
        return dict(_REGISTRY)


def clear_exemptions() -> None:
    """Reset the registry (test isolation only)."""
    with _LOCK:
        _REGISTRY.clear()
