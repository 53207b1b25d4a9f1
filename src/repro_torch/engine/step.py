"""The training step: FQT loss and gradients, gradient accumulation, the
data-parallel gradient exchange, clipping and the optimizer update over a
:class:`TrainState`.

Port of ``repro.engine.step.make_step_fn``.  RNG contract (paper Theorem 1
needs independent SR draws): every step splits ``state.rng`` into
``(base, compress, next)``; microbatch ``i`` quantizes under
``fold_in(base, i)``, so SR noise is independent across microbatches and
steps.  Gradients come from ``torch.autograd.grad`` through the FQT
``autograd.Function`` of every linear layer.

On a mesh the step computes the flat step's function, as the reference's
GSPMD step does.  Each data rank runs its rows of each microbatch inside
the data group (``sharding/data.py``: per-tensor ranges over the whole
batch, SR bits at global flat indices, BHQ blocks by global index) with
its loss weighted by ``1 / size``: every rank holds as many rows as the
next (``ShardedLoader``), so the gradients summed over the group are
those of the global mean.  Parameters and
moments are stored as ``DTensor`` shards (the plan's rules over
``model``); the step gathers the full parameters for its compute and
updates each rank's own shard (AdamW is elementwise).  With
``compress_axis`` the fp32-reduced gradients then go through the int8
compressed exchange under the ``compress`` key, as the reference
compresses the replica view.  A one-rank mesh runs every collective
and gives the flat step's numbers bit for bit.
"""

from __future__ import annotations

import torch

from .. import prng
from ..core.compression import compressed_grad_allreduce
from ..optim import (clip_by_global_norm, tree_leaves, tree_map,
                     tree_unflatten)
from ..sharding import DataGroup, make_plan, use_data_group
from ..sharding.plan import local_shard
from .state import TrainState

__all__ = ["make_step_fn", "split_microbatches"]

# where the refused mesh cases stand in ROADMAP.md
MESH_ITEM = "ROADMAP.md queue 1, item 3 (open: data parallelism)"


def split_microbatches(batch: dict, accum_steps: int) -> list:
    """The batch as ``accum_steps`` microbatches along its batch dim: dim
    0 of every leaf but the VLM's M-RoPE ``positions`` (3, B, T), split
    along dim 1, as the reference splits it.  Raises ValueError naming the
    first leaf whose batch dim does not divide."""
    out = [{} for _ in range(accum_steps)]
    for name, x in batch.items():
        dim = 1 if name == "positions" and x.dim() == 3 else 0
        if x.shape[dim] % accum_steps:
            raise ValueError(f"batch leaf {name!r} dim {dim} "
                             f"({x.shape[dim]}) not divisible by "
                             f"accum_steps={accum_steps}")
        for i, part in enumerate(x.chunk(accum_steps, dim=dim)):
            out[i][name] = part
    return out


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _full(tree):
    """The full tensors of a tree of ``DTensor`` shards."""
    return tree_map(lambda p: p.full_tensor() if _is_dtensor(p) else p, tree)


def _local(tree):
    """The local shards (views) of a tree's ``DTensor`` leaves."""
    return tree_map(lambda p: p.to_local() if _is_dtensor(p) else p, tree)


def _own_shard(g, p):
    """This rank's part of the full gradient ``g`` of parameter ``p``."""
    if not _is_dtensor(p):
        return g
    return local_shard(g, p.device_mesh, p.placements)


def _sum_over(group, tensors: list) -> list:
    """SUM all-reduce of same-dtype tensors as one flat buffer, handed
    back as fresh tensors (a view at an odd offset of the buffer could
    take another vectorization, and summation order, in a reduction)."""
    import torch.distributed as dist
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    return [f.view_as(t).clone() for f, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def make_step_fn(model, policy, opt, lr_fn, *, clip_norm: float = 1.0,
                 remat: bool = True, accum_steps: int = 1, mesh=None,
                 compress_axis=None, loss_kwargs=None,
                 replicated_batch: bool = False):
    """Build ``step_fn(state, batch) -> (state, metrics)``.  The state's
    parameters and moments are updated in place and returned in a new
    :class:`TrainState`; ``metrics`` holds device scalars ``loss`` and
    ``grad_norm`` (and ``ce``) and the host float ``lr``.

    ``mesh``: a ``DeviceMesh`` (``launch/mesh.py``); ``batch`` is then
    this rank's rows (``ShardedLoader``), or the whole batch on every rank
    when ``replicated_batch`` (its batch dim does not divide the data
    axes: nothing is summed over them).  ``compress_axis``: the mesh axis
    of the compressed exchange (``policy.dp_grad_bits`` bits)."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if compress_axis is not None and (
            mesh is None or compress_axis not in mesh.mesh_dim_names):
        raise ValueError(f"compress_axis={compress_axis!r} needs a mesh "
                         f"with that axis")
    kw = dict(loss_kwargs or {})
    group = None
    if mesh is not None and not replicated_batch:
        plan = make_plan(mesh)
        group = DataGroup(*plan.data_group(), runs=plan.data_runs)
        if group.size > 1 and model.cfg.moe_experts:
            raise NotImplementedError(
                f"{model.cfg.name}: MoE routing is token-global (capacity, "
                f"positions, the load-balance loss); data parallelism over "
                f"{group.size} ranks is not ported ({MESH_ITEM})")

    def loss_and_grads(params, batch, key, weight=None):
        with torch.enable_grad():
            ps = tree_map(lambda p: p.detach().requires_grad_(), params)
            loss, mets = model.loss(ps, batch, key, policy, remat=remat,
                                    **kw)
            if weight is not None:
                loss = loss * weight
                mets = {k: v * weight if isinstance(v, torch.Tensor) else v
                        for k, v in mets.items()}
            leaves = tree_leaves(ps)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        mets = {k: (v.detach() if isinstance(v, torch.Tensor) else v)
                for k, v in mets.items()}
        return loss.detach(), mets, tree_unflatten(params, grads)

    def step_fn(state: TrainState, batch):
        base_key, compress_key, next_rng = prng.split(state.rng, 3)
        params = _full(state.params) if mesh is not None else state.params
        micro = ([batch] if accum_steps == 1
                 else split_microbatches(batch, accum_steps))
        grads, losses, mets_all = None, [], []
        # every rank holds as many rows as the next (ShardedLoader), so
        # its share of the global mean is 1/size (exactly 1.0 alone)
        w = None if group is None else 1.0 / group.size
        with use_data_group(group):
            for i, mb in enumerate(micro):
                l, m, g = loss_and_grads(params, mb,
                                         prng.fold_in(base_key, i), w)
                grads = g if grads is None else tree_map(torch.add, grads, g)
                losses.append(l)
                mets_all.append(m)
        if accum_steps > 1:
            grads = tree_map(lambda g: g / accum_steps, grads)
        if group is not None:
            # the gradients and the loss terms of the global mean
            grads = tree_unflatten(grads, _sum_over(group.group,
                                                    tree_leaves(grads)))
            names = [k for k in mets_all[0]
                     if isinstance(mets_all[0][k], torch.Tensor)]
            rows = _sum_over(group.group, [torch.stack(
                [l] + [m[k] for k in names]) for l, m in
                zip(losses, mets_all)])
            losses = [r[0] for r in rows]
            for m, r in zip(mets_all, rows):
                m.update({k: r[j + 1] for j, k in enumerate(names)})
        if accum_steps == 1:
            loss, mets = losses[0], mets_all[0]
        else:
            loss = torch.mean(torch.stack(losses))
            mets = {k: sum(m[k] for m in mets_all) / accum_steps
                    for k in mets_all[0]}
        if compress_axis is not None:
            grads = compressed_grad_allreduce(
                grads, mesh, compress_axis, compress_key,
                bits=policy.dp_grad_bits, mean=True)
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        lr = lr_fn(state.step)
        if mesh is None:
            params, opt_state = opt.apply(state.params, grads,
                                          state.opt_state, lr)
        else:
            # the update on each rank's own shards, in place
            own = tree_map(_own_shard, grads, state.params)
            _, new = opt.apply(_local(state.params), own,
                               _local(state.opt_state), lr)
            params = state.params
            opt_state = {k: state.opt_state[k] if isinstance(v, dict)
                         else v for k, v in new.items()}
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr, **mets}
        return TrainState(params=params, opt_state=opt_state,
                          step=state.step + 1, rng=next_rng), metrics

    return step_fn
