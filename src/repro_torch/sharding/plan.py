"""Sharding plan: logical-parameter roles -> mesh partition specs.

Port of ``repro.sharding.plan``.  Megatron-style tensor parallelism over
the ``model`` axis; batch over ``(pod, data)``.  Every rule is
divisibility-audited against the mesh's axis sizes, falling back to
replication when a dim does not divide, so the same plan drives the
16x16 production mesh, the 2x16x16 multi-pod mesh and tiny test meshes.

A spec is a tuple with one entry per tensor dim: ``None`` (replicated),
an axis name, or a tuple of axis names (the batch over ``("pod",
"data")``) -- the counterpart of JAX's ``PartitionSpec``, kept with the
reference's distinctions: ``()`` for a rule of ``None``, an unmatched
path or a leaf with fewer dims than its rule, ``(None, ...)`` from
:meth:`ShardingPlan._trailing_spec`.  Paths are ``"/" + "/".join(keys)``
over nested dicts (list entries by index), which match the reference's
leaf for leaf.

:meth:`ShardingPlan.shardings` turns specs into :class:`NamedSharding`
objects: ``DTensor`` placements (``Shard(d)``/``Replicate()`` per mesh
dim) on a ``torch.distributed`` ``DeviceMesh``.  A plan built on a plain
``{axis: size}`` mapping computes specs with no process group.

The reference's ``attn_shardings`` and ``moe_dispatch_sharding`` (and
``models/lm.py``'s activation constraints) are GSPMD layout hints that
change no number; they have no counterpart until the model axis splits
the compute (ROADMAP.md queue 1).

Role rules:
  column-parallel (shard GEMM output):  wq/wk/wv, gate/up/fc1, z/x/dt proj,
                                        rwkv r/k/v/g, lm_head, fuse
  row-parallel    (shard GEMM input):   wo, down/fc2, out_proj, rwkv wo/cm_wv
  expert-parallel (shard expert axis):  moe experts
  vocab-parallel:                       embedding table
  replicated:                           norms, routers, loras, decays, bc_proj
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import torch

__all__ = ["ShardingPlan", "NamedSharding", "make_plan", "local_shard"]

# trailing-dims spec per role; leading stacked axes (L / n_outer,inner) get None
_COL2 = ("_", "model")            # (in, out) -> shard out
_ROW2 = ("model", "_")            # (in, out) -> shard in
_VEC = ("model",)
_REP = None                       # fully replicated

_RULES = [
    # (path substring, trailing spec) -- first match wins
    ("embed/table", ("model", "_")),
    ("lm_head/w", _COL2),
    ("pos_embed", _REP),
    # attention
    ("attn/wq/w", _COL2), ("attn/wk/w", _COL2), ("attn/wv/w", _COL2),
    ("attn/wq/b", _VEC), ("attn/wk/b", _VEC), ("attn/wv/b", _VEC),
    ("attn/wo/w", _ROW2),
    # dense mlp
    ("mlp/gate/w", _COL2), ("mlp/up/w", _COL2), ("mlp/fc1/w", _COL2),
    ("mlp/down/w", _ROW2), ("mlp/fc2/w", _ROW2),
    ("mlp/gate/b", _VEC), ("mlp/up/b", _VEC), ("mlp/fc1/b", _VEC),
    # moe: expert axis parallel (trailing dims (E, in, out))
    ("moe/router", _REP),
    ("moe/experts", ("model", "_", "_")),
    # rwkv6
    ("wr/w", _COL2), ("wk/w", _COL2), ("wv/w", _COL2), ("wg/w", _COL2),
    ("wo/w", _ROW2),
    ("cm_wk/w", _COL2), ("cm_wv/w", _ROW2), ("cm_wr/w", _REP),
    ("/u", ("model", "_")),
    ("ln_x", _VEC),
    # mamba2
    ("z_proj/w", _COL2), ("x_proj/w", _COL2), ("dt_proj/w", _COL2),
    ("bc_proj", _REP),
    ("conv_x_w", ("_", "model")), ("conv_x_b", _VEC),
    ("conv_bc", _REP),
    ("A_log", _VEC), ("/D", _VEC), ("dt_bias", _VEC),
    ("out_norm", _VEC),
    ("out_proj/w", _ROW2),
    ("fuse/w", _COL2),
]


def _map_with_path(fn, tree, path=()):
    """``fn(path_str, leaf)`` over the leaves of nested dicts, lists and
    tuples, in the tree's own structure."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/" + "/".join(path), tree)


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()))


def _mesh_shape(mesh) -> dict:
    """``{axis: size}`` of a ``DeviceMesh`` or a plain mapping."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a ShardingPlan needs a DeviceMesh with dim names")
    return dict(zip(names, (int(s) for s in mesh.mesh.shape)))


def local_shard(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's shard of ``full`` under ``DTensor`` ``placements`` on
    ``mesh`` (a view; the plan shards only dims that divide)."""
    out = full
    for i, p in enumerate(placements):
        if p.is_shard():
            n = mesh.size(i)
            out = out.chunk(n, dim=p.dim)[mesh.get_local_rank(i)]
    return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a ``DeviceMesh`` as ``DTensor`` placements: the
    counterpart of JAX's ``NamedSharding``."""
    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for name in self.mesh.mesh_dim_names:
            dims = [d for d, e in enumerate(self.spec)
                    if e == name or (isinstance(e, tuple) and name in e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the full tensor (a view)."""
        return local_shard(full, self.mesh, self.placements)

    def place(self, full: torch.Tensor):
        """A ``DTensor`` holding this rank's shard of ``full`` (copied, so
        the full tensor can go)."""
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(self.local(full).contiguous().clone(),
                                  self.mesh, self.placements,
                                  run_check=False, shape=full.shape,
                                  stride=full.contiguous().stride())


class ShardingPlan:
    """Holds the mesh and axis naming and produces specs and shardings
    for trees."""

    def __init__(self, mesh, data_axes=("data",), model_axis="model"):
        self.mesh = mesh
        self.shape = _mesh_shape(mesh)
        self.data_axes = tuple(a for a in data_axes if a in self.shape)
        self.model_axis = model_axis if model_axis in self.shape else None
        self.model_size = self.shape.get(model_axis, 1)
        self.dp_size = math.prod(self.shape[a] for a in self.data_axes)
        self._data_group = None
        self._runs = {}

    # -- parameters ---------------------------------------------------------
    def _trailing_spec(self, trailing, shape) -> tuple:
        """Map a rule's trailing pattern onto the last len(pattern) dims."""
        n_lead = len(shape) - len(trailing)
        if n_lead < 0:
            return ()
        spec = [None] * n_lead
        for dim, tag in zip(shape[n_lead:], trailing, strict=True):
            if tag == "model" and self.model_axis and \
                    dim % self.model_size == 0:
                spec.append(self.model_axis)
            else:
                spec.append(None)
        return tuple(spec)

    def param_spec(self, path: str, leaf) -> tuple:
        for needle, trailing in _RULES:
            if needle in path:
                if trailing is None:
                    return ()
                return self._trailing_spec(trailing, _shape(leaf))
        return ()  # norms, scalars, anything unmatched -> replicate

    def param_specs(self, abstract_params):
        return _map_with_path(self.param_spec, abstract_params)

    # -- batches / caches ----------------------------------------------------
    def _dp(self, batch_dim: int):
        """Data axes (a name, or a tuple of several) if the batch dim
        divides, else None."""
        if self.data_axes and batch_dim % self.dp_size == 0:
            return (self.data_axes if len(self.data_axes) > 1
                    else self.data_axes[0])
        return None

    def batch_spec(self, path: str, leaf) -> tuple:
        shape = _shape(leaf)
        if "positions" in path and len(shape) == 3:     # (3, B, T) m-rope
            return (None, self._dp(shape[1]), None)
        return (self._dp(shape[0]),) + (None,) * (len(shape) - 1)

    def batch_specs(self, abstract_batch):
        return _map_with_path(self.batch_spec, abstract_batch)

    def cache_spec(self, path: str, leaf) -> tuple:
        shape = _shape(leaf)
        if "index" in path:
            return ()
        m = self.model_axis

        def md(dim):
            return m if (m and dim % self.model_size == 0) else None

        def lead(k):
            return (None,) * (len(shape) - k)

        if "/kv/" in path or "self_kv" in path or "cross_kv" in path:
            # (L, B, S, kv*hd) or hybrid (n_outer, B, S, kv*hd)
            return lead(3) + (self._dp(shape[-3]), None, md(shape[-1]))
        if path.endswith("/h"):                    # mamba (..., B, H, P, N)
            return lead(4) + (self._dp(shape[-4]), md(shape[-3]), None, None)
        if "conv_x" in path:                       # (..., B, k-1, d_inner)
            return lead(3) + (self._dp(shape[-3]), None, md(shape[-1]))
        if "conv_bc" in path:
            return lead(3) + (self._dp(shape[-3]), None, None)
        if path.endswith("/s"):                    # rwkv (L, B, H, hd, hd)
            return (None, self._dp(shape[1]), md(shape[2]), None, None)
        if "x_tm" in path or "x_cm" in path:       # (L, B, d)
            return (None, self._dp(shape[1]), None)
        return (None,) * len(shape)

    def cache_specs(self, abstract_cache):
        return _map_with_path(self.cache_spec, abstract_cache)

    # -- materialization -----------------------------------------------------
    def shardings(self, spec_tree):
        """Specs -> :class:`NamedSharding` on this plan's ``DeviceMesh``
        (spec tuples are the leaves)."""
        if isinstance(self.mesh, Mapping):
            raise ValueError("shardings need a DeviceMesh; this plan was "
                             "built on a plain mapping of axis sizes")

        def walk(t):
            if isinstance(t, dict):
                return {k: walk(v) for k, v in t.items()}
            return NamedSharding(self.mesh, tuple(t))
        return walk(spec_tree)

    # -- the data-parallel group ---------------------------------------------
    def data_group(self):
        """``(process group, this rank's index, size)`` of the ranks that
        split the batch with this one: the mesh's ranks that share every
        coordinate but the data axes (``("pod", "data")`` flattened pod
        first, as the batch spec splits rows).  Built once, collectively."""
        if self._data_group is None:
            import torch.distributed as dist
            if isinstance(self.mesh, Mapping):
                raise ValueError("a data group needs a DeviceMesh")
            if len(self.data_axes) == 1:
                axis = self.data_axes[0]
                group = self.mesh.get_group(axis)
            else:
                group, _ = dist.new_subgroups_by_enumeration(
                    self._data_grid())
            self._data_group = (group, dist.get_rank(group),
                                dist.get_world_size(group))
        return self._data_group

    def _data_grid(self) -> list:
        """The global ranks of every data group, one list each, in the
        batch's row order."""
        names = list(self.mesh.mesh_dim_names)
        keep = [names.index(a) for a in self.data_axes]
        rest = [i for i in range(len(names)) if i not in keep]
        return self.mesh.mesh.permute(*rest, *keep).reshape(
            -1, self.dp_size).tolist()

    def data_runs(self, k: int):
        """``(process group, this rank's index in it)`` of this rank's run
        of ``k`` consecutive ranks of its data group (the ranks that share
        a loss chunk).  Built once per ``k``, collectively: every rank of
        the mesh calls it."""
        if k not in self._runs:
            import torch.distributed as dist
            runs = [row[i:i + k] for row in self._data_grid()
                    for i in range(0, len(row), k)]
            group, _ = dist.new_subgroups_by_enumeration(runs)
            self._runs[k] = (group, dist.get_rank(group))
        return self._runs[k]


def make_plan(mesh) -> ShardingPlan:
    """The plan of a mesh: batch over ``pod`` and ``data`` where present,
    tensor parallelism over ``model``."""
    axes = list(_mesh_shape(mesh))
    data_axes = tuple(a for a in ("pod", "data") if a in axes)
    return ShardingPlan(mesh, data_axes=data_axes, model_axis="model")
