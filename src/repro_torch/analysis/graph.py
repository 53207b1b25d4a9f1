"""GEMM-site walker: run a function once on the meta device and attribute
every GEMM to a quantization marker.

Port of ``repro.analysis.graph``.  The reference walks a jaxpr; eager
PyTorch has none, so :func:`iter_gemm_sites` runs the function (its
tensors on the meta device: shapes and dtypes, nothing computed) under a
``TorchDispatchMode`` and records one :class:`GemmSite` per GEMM as it
dispatches (:data:`GEMM_OPS`, the one table ``launch/dryrun.py`` counts
with too), carrying:

  * FLOPs (2*M*N*K*batch, times the trip count of a loop the model runs
    once on meta and scales, ``meta.scaled``: the reference's scan
    multiplier),
  * the contraction size K and the operand dtypes (the range analysis
    needs them for int32-accumulator bounds),
  * the quantization marker innermost at the GEMM (``q[path|role]`` /
    ``qfp[path|role]`` / ``fp[path]``, ``core/exempt.py``),
  * a ``file:line`` of the port's code, best effort.

The markers: while a walk runs, ``core/exempt.py``'s scopes push their
names onto the walk's stack.  A forward GEMM sees the stack open at its
dispatch.  The autograd engine runs a backward node's GEMMs after those
scopes have closed, so every node the forward makes is tagged with the
stack open when the operation that made it dispatched, and a backward
GEMM sees its node's tag with what the backward itself opened (the FQT
backward's ``q[path|wgrad]``, ``q[path|agrad]``) inside it: the
reference's transposed equations keep their forward's name stack the
same way.  On meta the kernel wrappers run their plain versions, each one
GEMM (``kernels/codes.py``), and operations a meta path runs without
counting (``meta.uncounted``) make no site.
"""

from __future__ import annotations

import dataclasses
import math
import sys
from typing import List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .. import meta
from ..core import exempt
from ..core.exempt import MARKER_RE

__all__ = ["GemmSite", "iter_gemm_sites", "site_flops", "classify_stack",
           "GEMM_OPS", "gemm_dims", "gemm_flops", "GemmWalk"]

# aten GEMMs -> (lhs, rhs) argument positions: every matmul, linear,
# einsum and tensordot of the port reaches one of these
GEMM_OPS = {"mm": (0, 1), "_int_mm": (0, 1), "addmm": (1, 2), "bmm": (0, 1),
            "baddbmm": (1, 2)}

_TAG = "repro_torch.markers"      # a node's markers, in Node.metadata


def gemm_dims(name: str, args) -> Tuple[int, int, int, int]:
    """(batch, M, K, N) of aten GEMM ``name`` called with ``args``."""
    a, b = (args[i] for i in GEMM_OPS[name])
    if a.dim() == 2:
        return 1, a.shape[0], a.shape[1], b.shape[1]
    return a.shape[0], a.shape[1], a.shape[2], b.shape[2]


def gemm_flops(name: str, args) -> int:
    """2 * batch * M * N * K of aten GEMM ``name`` called with ``args``."""
    batch, m, k, n = gemm_dims(name, args)
    return 2 * batch * m * k * n


@dataclasses.dataclass(frozen=True)
class GemmSite:
    """One GEMM found in the walked function."""

    primitive: str                 # the aten op: "mm" | "bmm" | "_int_mm" ...
    flops: float                   # 2*M*N*K*batch * loop multiplier
    contract: int                  # K
    mult: int                      # the meta path's loop multiplier
    lhs_dtype: str
    rhs_dtype: str
    stack: str                     # the marker names open, outer first
    kind: str                      # "quantized"|"policy_fp"|"exempt"|"unmarked"
    path: Optional[str]            # marker path (None when unmarked)
    role: Optional[str]            # marker role for q/qfp (None otherwise)
    src: str                       # "file:line" of the port (best effort)
    m: int = 0                     # output rows (batch*M)
    n: int = 0                     # output cols N

    @property
    def integer_gemm(self) -> bool:
        """True when both operands are integer codes (an int8 GEMM)."""
        return (self.lhs_dtype.startswith(("int", "uint"))
                and self.rhs_dtype.startswith(("int", "uint")))


def _classify(stack: str) -> Tuple[str, Optional[str], Optional[str]]:
    """(kind, path, role) from the innermost marker in a stack string."""
    last = None
    for m in MARKER_RE.finditer(stack):
        last = m
    if last is None:
        return "unmarked", None, None
    tag, payload = last.group(1), last.group(2)
    if tag == "fp":
        return "exempt", payload, None
    path, _, role = payload.rpartition("|")
    kind = "quantized" if tag == "q" else "policy_fp"
    return kind, path, role or None


# the soundness and planner passes attribute other operations with the
# same innermost-marker rule the GEMM walk uses
classify_stack = _classify


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _src(node) -> str:
    """The innermost frame of the port's own code outside this package
    (the model code for a forward GEMM, the FQT backward for its GEMMs),
    or the backward node's name."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if "repro_torch" in fn and "analysis" not in fn:
            return f"{fn}:{f.f_lineno}"
        f = f.f_back
    return f"<{node.name()}>" if node is not None else "?"


class GemmWalk(TorchDispatchMode, meta.Counting):
    """Records a :class:`GemmSite` for each GEMM dispatched while entered
    (see the module docstring); ``sites`` holds them in order."""

    def __init__(self):
        super().__init__()
        self.scale, self.live = 1, False
        self.sites: List[GemmSite] = []
        self._pending: list = []        # (tensor, markers) to tag

    def _tag_pending(self) -> None:
        # the outputs of the operations dispatched since the last call
        # have their autograd nodes by now: tag each new node
        for t, markers in self._pending:
            fn = t.grad_fn
            if fn is not None and _TAG not in fn.metadata:
                fn.metadata[_TAG] = markers
        self._pending.clear()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self._tag_pending()
        out = func(*args, **kwargs)
        if func.namespace != "aten":
            return out
        node = torch._C._current_autograd_node()
        markers = ((node.metadata.get(_TAG, ()) if node is not None else ())
                   + exempt.walk_stack())
        name = func.overloadpacket.__name__
        if name in GEMM_OPS and self.scale:
            batch, m, k, n = gemm_dims(name, args)
            a, b = (args[i] for i in GEMM_OPS[name])
            stack = "/".join(markers)
            kind, path, role = _classify(stack)
            self.sites.append(GemmSite(
                primitive=name,
                flops=float(2 * batch * m * k * n * self.scale),
                contract=int(k), mult=self.scale,
                lhs_dtype=str(a.dtype).replace("torch.", ""),
                rhs_dtype=str(b.dtype).replace("torch.", ""),
                stack=stack, kind=kind, path=path, role=role,
                src=_src(node), m=int(batch * m), n=int(n)))
        self._pending.extend((t, markers) for t in _tensors(out))
        return out

    def __enter__(self):
        self._walking = exempt.walking()
        self._walking.__enter__()
        self._entered = meta.entered(self)
        self._entered.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._pending.clear()
            self._entered.__exit__(*exc)
            self._walking.__exit__(*exc)


def iter_gemm_sites(fn, *args, **kwargs) -> Tuple[GemmSite, ...]:
    """Every GEMM ``fn(*args, **kwargs)`` dispatches, attributed.  Give it
    meta-device tensors: then nothing is computed or allocated."""
    with GemmWalk() as walk:
        fn(*args, **kwargs)
    return tuple(walk.sites)


def site_flops(sites, kind: Optional[str] = None) -> float:
    """Total FLOPs over ``sites``, optionally filtered by marker kind."""
    return math.fsum(s.flops for s in sites
                     if kind is None or s.kind == kind)
