"""Dry run: every (arch x shape x mesh) cell of the port on the meta
device, counted, with its roofline on the H100.

Port of ``repro.launch.dryrun``.  The reference lowers and compiles each
cell with XLA for 512 placeholder devices and reads XLA's cost and memory
analyses.  The port has no compiler to ask, so it runs its own code: the
training step (``engine/step.py`` ``make_step_fn``), ``prefill`` or
``decode`` of one cell, once, on the meta device (shapes and dtypes, no
values, no allocation), as rank 0 of the mesh, and counts every
operation as it dispatches (:class:`Counter`):

  * GEMM FLOPs: ``2 M N K`` at every ``mm``, ``bmm``, ``addmm``,
    ``baddbmm`` and ``_int_mm`` (``torch.utils.flop_counter`` has no
    ``_int_mm``; the table is ``analysis/graph.py``'s, which the GEMM-site
    walker reads too): the attention products, the quantized GEMMs (on the
    ``kernel`` backend their plain versions, whose products are the
    kernels'), the recomputation of a ``remat`` step;
  * bytes: the operand and result bytes of every operation that is not a
    view, as if nothing were fused: an upper bound of the HBM traffic
    (``bytes_accessed``); and the least a rank must move, its resident
    inputs read once and the state it updates or makes written once
    (``bytes_min``: the roofline's memory term);
  * the peak of live tensor bytes, parameters, optimizer state, caches
    and the batch resident from the start (``resident_bytes``; storages,
    so a view costs nothing);
  * the bytes and count of every collective (``c10d`` and functional),
    by the reference's families (``launch/roofline.py``).

Cells (the reference's): train cells run the mesh step with
``loss_chunks=16``, ``remat=True``, ``sgd(0.9)`` and
``fqt(bhq, 5, native, bhq_block=1024)`` on bfloat16 activations; prefill
and decode cells run on the rank's share of the batch and of the
bfloat16 cache under the plan's ``batch_specs``/``cache_specs``.  A mesh
cell runs on the production mesh (16x16, or 2x16x16 with ``--mesh
multi``) of a fake process group (``torch.testing``'s ``fake`` backend:
collectives that move nothing) of 256 or 512 ranks in this one process.
The port stores parameters, moments and caches sharded over ``model``
and gathers them to compute (the GEMMs do not split over ``model`` yet:
ROADMAP.md queue 1, item 3), so a rank's GEMM FLOPs are its data share's
and the gathers are among its collectives.  A flat cell (``mesh=None``)
runs the whole batch on one device.

Eager PyTorch runs every layer, so the reference's scan correction has no
counterpart.  On the meta device ``prng.bits`` draws nothing (an empty
tensor of the draw's shape), and RWKV6's WKV recurrence, a Python loop
over tokens, runs one step with its counts scaled (``meta.py``).

Records go to ``<out>/<arch>__<shape>__<mesh>.json``; a cell that raises
is a failure, named at the end, and the run exits 1.

    python -m repro_torch.launch.dryrun --arch granite-3-2b \\
        --shape decode_32k --mesh single
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .. import meta
from ..analysis.graph import GEMM_OPS, gemm_flops
from ..configs import ARCH_NAMES, SHAPES, ShapeSpec, get_config, shape_grid
from ..core import QuantPolicy
from ..engine import (abstract_train_state, make_step_fn, place_state,
                      state_shardings)
from ..models import build_model
from ..optim import sgd, tree_leaves
from ..sharding import make_plan
from ..sharding.plan import NamedSharding
from .roofline import (COLLECTIVES, collective_bytes, model_flops,
                       roofline_terms)

__all__ = ["Counter", "run_cell", "main", "count_params",
           "active_param_frac", "ACT_DTYPE", "CARD_BYTES"]

ACT_DTYPE = torch.bfloat16
CARD_BYTES = 80 * 10 ** 9            # one H100's HBM
BYTES_NOTE = ("bytes_accessed: operand and result bytes of every "
              "non-view operation, nothing fused, an upper bound of the "
              "HBM traffic (the roofline's memory_s_unfused); bytes_min: "
              "the resident inputs read once and the parameters, "
              "optimizer state or cache the call updates or makes written "
              "once, a lower bound (the roofline's memory_s)")

# c10d ops take their result (in place) as the first argument; the
# functional ones return it
_C10D = {"allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
         "allgather_": "all-gather", "_allgather_base_": "all-gather",
         "allgather_coalesced_": "all-gather",
         "allgather_into_tensor_coalesced_": "all-gather",
         "reduce_scatter_": "reduce-scatter",
         "_reduce_scatter_base_": "reduce-scatter",
         "reduce_scatter_tensor_coalesced_": "reduce-scatter",
         "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
         "send": "collective-permute", "recv_": "collective-permute"}
_FUNCTIONAL = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
               "all_gather_into_tensor": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_to_all_single": "all-to-all"}
# ops of those namespaces that move no tensor of their own
_NOT_MOVED = {"wait_tensor", "_wrap_tensor_autograd", "barrier",
              "monitored_barrier_"}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Counter(TorchDispatchMode, meta.Counting):
    """Counts one rank's work as its operations dispatch (see the module
    docstring).  ``resident(tree)`` counts a tree's tensors as live from
    the start.  ``gemms_only``: count the GEMMs' FLOPs and the
    collectives, not bytes or live tensors (a light mode for a step on
    the card)."""

    def __init__(self, gemms_only: bool = False):
        super().__init__()
        self.gemms_only = gemms_only
        self.scale, self.live = 1, not gemms_only
        self.gemm_flops = 0
        self.gemm_calls = 0
        self.bytes = 0
        self.ops = 0
        self.coll = []                    # (family, bytes)
        self.live_bytes = 0
        self.peak_bytes = 0
        self.resident_bytes = 0
        self._storages = {}

    # -- live bytes -------------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live_bytes -= self._storages.pop(key, 0)

    def add_counts(self, nbytes: int, ops: int) -> None:
        self.bytes += int(nbytes) * self.scale
        self.ops += ops * self.scale

    def track(self, t: torch.Tensor) -> None:
        self._track(t)

    def resident(self, *trees) -> None:
        for tree in trees:
            for t in _tensors(tree):
                self._track(t.to_local() if hasattr(t, "to_local") else t)
        self.resident_bytes = self.live_bytes

    # -- dispatch ---------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        ns = func.namespace
        if ns in ("c10d", "_c10d_functional") and name not in _NOT_MOVED:
            table = _C10D if ns == "c10d" else _FUNCTIONAL
            if name not in table:
                raise NotImplementedError(f"the dry run counts no {func}")
            nb = sum(_nbytes(t) for t in _tensors(
                args[0] if ns == "c10d" else out))
            self.coll.extend([(table[name], nb)] * self.scale)
        elif ns == "aten" and not func.is_view:
            self.ops += self.scale
            if name in GEMM_OPS:
                self.gemm_flops += gemm_flops(name, args) * self.scale
                self.gemm_calls += self.scale
            if self.gemms_only:
                return out
            seen = {t.untyped_storage()._cdata: _nbytes(t)
                    for t in _tensors((args, kwargs))}
            for t in _tensors(out):
                seen.setdefault(t.untyped_storage()._cdata, 0)
                seen[t.untyped_storage()._cdata] += _nbytes(t)
            self.bytes += sum(seen.values()) * self.scale
        if self.live:
            for t in _tensors(out):
                self._track(t)
        return out

    def __enter__(self):
        self._entered = meta.entered(self)
        self._entered.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        self._entered.__exit__(*exc)
        return super().__exit__(*exc)

    def collectives(self) -> dict:
        return collective_bytes(self.coll)


def count_params(params) -> int:
    return sum(math.prod(t.shape) for t in tree_leaves(params))


def active_param_frac(cfg) -> float:
    """MoE: fraction of expert params active per token (top-k / E)."""
    if not cfg.moe_experts:
        return 1.0
    d, ff, E, K = cfg.d_model, cfg.d_ff, cfg.moe_experts, cfg.moe_topk
    expert = (3 if cfg.act == "swiglu" else 2) * d * ff * E
    hd = cfg.hd
    attn = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd + cfg.n_heads * hd * d
    dense_part = attn + d * E
    total = expert + dense_part
    return (expert * (K / E) + dense_part) / total


# ---------------------------------------------------------------------------
# meshes and shares
# ---------------------------------------------------------------------------

def _fake_group(world: int) -> None:
    """A fake process group of ``world`` ranks in this process, as rank 0
    (started anew when the size changes)."""
    import torch.distributed as dist
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "the dry run's mesh cells need torch's fake process group "
            "(torch.testing._internal.distributed.fake_pg); this torch "
            "has none") from e
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def cell_mesh(mesh, multi_pod: bool = False):
    """``(DeviceMesh or None, name, ranks)`` of a cell: ``"production"``
    (16x16, or 2x16x16 when ``multi_pod``), a ``(data, model)`` test
    shape, or None (flat)."""
    from torch.distributed.device_mesh import init_device_mesh
    from .mesh import production_mesh_shape
    if mesh is None:
        return None, "flat", 1
    if mesh == "production":
        shape, names = production_mesh_shape(multi_pod)
    else:
        shape, names = tuple(mesh), ("data", "model")
    world = math.prod(shape)
    _fake_group(world)
    return (init_device_mesh("cpu", shape, mesh_dim_names=names),
            "x".join(map(str, shape)), world)


def _sharding(plan, spec):
    return NamedSharding(plan.mesh, tuple(spec))


def _share(full: torch.Tensor, plan, spec, keep_model: bool):
    """This rank's share of a meta tensor under ``spec``; with
    ``keep_model`` False, whole over the model axis."""
    if not keep_model and plan.model_axis:
        spec = tuple(None if e == plan.model_axis else e for e in spec)
    return _sharding(plan, spec).local(full).contiguous().clone()


def _map2(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map2(fn, v, specs[k]) for k, v in tree.items()}
    return fn(tree, specs)


def _gather_model(shard: torch.Tensor, plan, spec) -> torch.Tensor:
    """A shard stored split over the model axis, gathered over it (the
    compute of the port does not split over ``model``)."""
    if not plan.model_axis or plan.model_axis not in tuple(spec):
        return shard
    from torch.distributed.tensor import DTensor, Replicate
    sh = _sharding(plan, spec)
    dt = DTensor.from_local(shard, plan.mesh, sh.placements,
                            run_check=False)
    names = plan.mesh.mesh_dim_names
    want = [Replicate() if n == plan.model_axis else p
            for n, p in zip(names, sh.placements)]
    return dt.redistribute(plan.mesh, want).to_local()


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------

def _run_train(model, shape, policy, plan, counter, remat, loss_chunks, opt,
               dtype):
    astate = abstract_train_state(model, opt)
    specs = model.input_specs(shape, dtype=dtype)["batch"]
    if plan is None:
        state, batch, replicated = astate, specs, False
    else:
        state = place_state(astate, state_shardings(plan, astate))
        bspecs = plan.batch_specs(specs)
        batch = _map2(lambda t, s: _share(t, plan, s, False), specs, bspecs)
        replicated = plan._dp(shape.global_batch) is None
    step = make_step_fn(model, policy, opt, lambda s: 1e-3, remat=remat,
                        mesh=None if plan is None else plan.mesh,
                        replicated_batch=replicated,
                        loss_kwargs={"dtype": dtype,
                                     "loss_chunks": loss_chunks})
    resident = (state.params, state.opt_state)
    counter.resident(*resident, batch)
    with counter:
        step(state, batch)
    return resident


def _run_serve(model, shape, policy, plan, counter, dtype):
    specs = model.input_specs(shape, dtype=dtype)
    params = model.init(0, device="meta")
    if plan is None:
        stored, batch, cache = params, specs["batch"], specs.get("cache")
        cspecs = None
    else:
        pspecs = plan.param_specs(params)
        stored = _map2(lambda t, s: _share(t, plan, s, True), params,
                       pspecs)
        bspecs = plan.batch_specs(specs["batch"])
        batch = _map2(lambda t, s: _share(t, plan, s, False),
                      specs["batch"], bspecs)
        cache = cspecs = None
        if "cache" in specs:
            cspecs = plan.cache_specs(specs["cache"])
            cache = _map2(lambda t, s: _share(t, plan, s, True),
                          specs["cache"], cspecs)
    counter.resident(stored, batch, cache)
    written = 0                       # a decode writes one row a layer
    with counter:
        full = (stored if plan is None else
                _map2(lambda t, s: _gather_model(t, plan, s), stored,
                      pspecs))
        if shape.kind == "prefill":
            _, made = model.prefill(full, batch, policy, dtype=dtype)
            written = sum(_nbytes(t) for t in _tensors(made))
        else:
            work = (cache if cspecs is None else
                    _map2(lambda t, s: _gather_model(t, plan, s), cache,
                          cspecs))
            model.decode(full, work, batch, policy)
    return stored, cache, written


def _cell_policy(policy: QuantPolicy, cfg, shape: ShapeSpec, plan):
    """``policy`` for a train cell on ``plan``'s mesh: BHQ's row block cut
    to the largest block of ``bhq_block`` rows or fewer that divides
    every rank's rows of a batch-spanning operand (``B/data x T``, and an
    encoder's ``B/data x enc_seq``), as the port's BHQ needs
    (``sharding.data.bhq_blocks``; the reference's blocks straddle ranks:
    ROADMAP.md queue 1, item 3).  The record names the block."""
    if (plan is None or shape.kind != "train"
            or policy.grad_quantizer != "bhq"):
        return policy
    data = plan.dp_size if plan._dp(shape.global_batch) else 1
    local = shape.global_batch // data
    rows = [local * shape.seq_len]
    if cfg.family == "audio":
        rows.append(local * cfg.enc_seq)
    block = math.gcd(policy.bhq_block, *rows)
    if block == policy.bhq_block:
        return policy
    return dataclasses.replace(policy, bhq_block=block)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             policy: Optional[QuantPolicy] = None, mesh="production",
             smoke: bool = False, shape: Optional[ShapeSpec] = None,
             remat: bool = True, loss_chunks: int = 16, opt=None,
             dtype=ACT_DTYPE, verbose: bool = True) -> dict:
    """Run one cell on the meta device and return its record.

    ``mesh``: ``"production"`` (the reference's meshes), a ``(data,
    model)`` test shape, or None (flat, one device); ``smoke``: the
    reduced config; ``shape``: a :class:`ShapeSpec` in place of
    ``SHAPES[shape_name]``; ``opt``: the training step's optimizer
    (``sgd(0.9)``); ``dtype``: the activations' and caches'."""
    cfg = get_config(arch, smoke=smoke)
    shape = shape or SHAPES[shape_name]
    policy = policy or QuantPolicy.fqt("bhq", 5, backend="native",
                                       bhq_block=1024)
    t0 = time.perf_counter()
    dmesh, mesh_name, n_chips = cell_mesh(mesh, multi_pod)
    plan = None if dmesh is None else make_plan(dmesh)
    policy = _cell_policy(policy, cfg, shape, plan)
    model = build_model(cfg)
    counter = Counter()
    if shape.kind == "train":
        resident = _run_train(model, shape, policy, plan, counter, remat,
                              loss_chunks, opt or sgd(momentum=0.9), dtype)
        param_bytes = sum(_nbytes(_local(t)) for t in _tensors(resident[0]))
        state_bytes = sum(_nbytes(_local(t)) for t in _tensors(resident[1]))
        written = param_bytes + state_bytes
    else:
        stored, cache, written = _run_serve(model, shape, policy, plan,
                                            counter, dtype)
        param_bytes = sum(_nbytes(t) for t in _tensors(stored))
        state_bytes = sum(_nbytes(t) for t in _tensors(cache))
    bytes_min = counter.resident_bytes + written
    wall = time.perf_counter() - t0
    aparams = model.init(0, device="meta")
    n_params = count_params(aparams)
    n_tokens = (shape.global_batch * shape.seq_len
                if shape.kind in ("train", "prefill") else shape.global_batch)
    mf = model_flops(n_params, n_tokens,
                     "train" if shape.kind == "train" else "fwd",
                     active_frac=active_param_frac(cfg))
    coll = counter.collectives()
    terms = roofline_terms(counter.gemm_flops, bytes_min, coll["total"],
                           backend=policy.backend,
                           unfused_bytes=counter.bytes)
    record = {
        "arch": arch, "shape": shape.name, "mesh": mesh_name,
        "kind": shape.kind, "n_chips": n_chips, "n_params": n_params,
        "active_frac": active_param_frac(cfg),
        "policy": policy.describe() if hasattr(policy, "describe")
        else repr(policy),
        "remat": remat if shape.kind == "train" else None,
        "bhq_block": policy.bhq_block,
        "per_device": {
            "flops": counter.gemm_flops,
            "gemm_calls": counter.gemm_calls,
            "bytes_accessed": counter.bytes,
            "bytes_min": bytes_min,
            "bytes_note": BYTES_NOTE,
            "ops": counter.ops,
            "collective_bytes": coll["total"],
            "collectives": {k: coll[k] for k in COLLECTIVES},
            "collective_counts": coll["counts"],
            "param_bytes": param_bytes,
            "state_bytes": state_bytes,
            "resident_bytes": counter.resident_bytes,
            "peak_bytes": counter.peak_bytes,
            "fits_80gb": counter.peak_bytes <= CARD_BYTES,
        },
        "model_flops_global": mf,
        "useful_flops_ratio": ((mf / n_chips / counter.gemm_flops)
                               if counter.gemm_flops else None),
        "roofline": terms,
        "wall_s": wall,
    }
    if verbose:
        print(f"[dryrun] {arch:22s} {shape.name:12s} {mesh_name:8s} ok "
              f"c={terms['compute_s'] * 1e3:9.2f}ms "
              f"m={terms['memory_s'] * 1e3:9.2f}ms "
              f"n={terms['collective_s'] * 1e3:9.2f}ms "
              f"dom={terms['bottleneck']:10s} "
              f"peak={counter.peak_bytes / 1e9:7.2f}GB "
              f"useful={record['useful_flops_ratio'] or 0:.3f} "
              f"({wall:.1f}s)", flush=True)
    return record


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def main(argv=None):
    ap = argparse.ArgumentParser(description="dry run of the port's cells "
                                 "on the meta device")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--quant", default="bhq")
    ap.add_argument("--grad-bits", type=int, default=5)
    ap.add_argument("--backend", default="native",
                    choices=["simulate", "native", "kernel"],
                    help="quantized-GEMM backend (core/backend.py)")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = ARCH_NAMES if args.arch == "all" else args.arch.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    policy = QuantPolicy.fqt(args.quant, args.grad_bits,
                             backend=args.backend, bhq_block=1024)

    failures = []
    for arch in archs:
        cfg = get_config(arch)
        shapes = ([s.name for s in shape_grid(cfg)]
                  if args.shape == "all" else args.shape.split(","))
        for shape_name in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape_name}__{'multi' if mp else 'single'}"
                path = os.path.join(args.out, tag + ".json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[dryrun] skip {tag} (exists)", flush=True)
                    continue
                try:
                    rec = run_cell(arch, shape_name, multi_pod=mp,
                                   policy=policy)
                    with open(path, "w") as f:
                        json.dump(rec, f, indent=1)
                except Exception as e:
                    traceback.print_exc()
                    failures.append((tag, f"{type(e).__name__}: {e}"))
                    print(f"[dryrun] FAIL {tag}", flush=True)
    if failures:
        print(f"\n[dryrun] {len(failures)} FAILURES:")
        for tag, err in failures:
            print(f"  {tag}: {err[:200]}")
        raise SystemExit(1)
    print("\n[dryrun] all cells ran OK")


if __name__ == "__main__":
    main()
