"""The training step: FQT loss and gradients, gradient accumulation,
clipping and the optimizer update over a :class:`TrainState`.

Port of ``repro.engine.step.make_step_fn``.  RNG contract (paper Theorem 1
needs independent SR draws): every step splits ``state.rng`` into
``(base, compress, next)``; microbatch ``i`` quantizes under
``fold_in(base, i)``, so SR noise is independent across microbatches and
steps.  Gradients come from ``torch.autograd.grad`` through the FQT
``autograd.Function`` of every linear layer.  The compressed cross-replica
all-reduce (``compress_axis``) and meshes belong to the distribution
slice and raise.
"""

from __future__ import annotations

import torch

from .. import prng
from ..optim import clip_by_global_norm, tree_leaves, tree_map
from .state import TrainState

__all__ = ["make_step_fn", "split_microbatches"]

DISTRIBUTION_SLICE = "the distribution slice of the port"


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


def _unflatten(tree, leaves):
    """``leaves`` (in ``tree_leaves`` order) back into ``tree``'s shape."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(tree)


def make_step_fn(model, policy, opt, lr_fn, *, clip_norm: float = 1.0,
                 remat: bool = True, accum_steps: int = 1, mesh=None,
                 compress_axis=None, loss_kwargs=None):
    """Build ``step_fn(state, batch) -> (state, metrics)``.  The state's
    parameters and moments are updated in place and returned in a new
    :class:`TrainState`; ``metrics`` holds device scalars ``loss`` and
    ``grad_norm`` (and ``ce``) and the host float ``lr``."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if mesh is not None or compress_axis is not None:
        raise NotImplementedError(
            f"meshes and the compressed gradient all-reduce come with "
            f"{DISTRIBUTION_SLICE}")
    kw = dict(loss_kwargs or {})

    def loss_and_grads(params, batch, key):
        with torch.enable_grad():
            ps = tree_map(lambda p: p.detach().requires_grad_(), params)
            loss, mets = model.loss(ps, batch, key, policy, remat=remat,
                                    **kw)
            leaves = tree_leaves(ps)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        mets = {k: (v.detach() if isinstance(v, torch.Tensor) else v)
                for k, v in mets.items()}
        return loss.detach(), mets, _unflatten(params, grads)

    def step_fn(state: TrainState, batch):
        base_key, _compress_key, next_rng = prng.split(state.rng, 3)
        if accum_steps == 1:
            loss, mets, grads = loss_and_grads(
                state.params, batch, prng.fold_in(base_key, 0))
        else:
            grads, losses, mets_all = None, [], []
            for i, mb in enumerate(split_microbatches(batch, accum_steps)):
                l, m, g = loss_and_grads(state.params, mb,
                                         prng.fold_in(base_key, i))
                grads = g if grads is None else tree_map(torch.add, grads, g)
                losses.append(l)
                mets_all.append(m)
            grads = tree_map(lambda g: g / accum_steps, grads)
            loss = torch.mean(torch.stack(losses))
            mets = {k: sum(m[k] for m in mets_all) / accum_steps
                    for k in mets_all[0]}
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        lr = lr_fn(state.step)
        params, opt_state = opt.apply(state.params, grads, state.opt_state,
                                      lr)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr, **mets}
        return TrainState(params=params, opt_state=opt_state,
                          step=state.step + 1, rng=next_rng), metrics

    return step_fn
