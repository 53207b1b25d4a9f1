"""Optimizers written out over the parameter dict: SGD with momentum (the
paper's optimizer for ResNets), AdamW (for the LM archs), the cosine
schedule with linear warmup (paper App. E) and global-norm clipping.

Port of ``repro.optim``, with the same functional API: ``opt = adamw()``;
``state = opt.init(params)``; ``params, state = opt.apply(params, grads,
state, lr)``.  Parameters and states are nested dicts of tensors of one
structure.  Unlike the reference, ``apply`` updates the parameter and
moment tensors in place (and returns them), so a step holds no second
copy of either.  ``torch.optim`` is not used: its AdamW places ``eps`` and
the weight decay differently from the reference.

Scalars a step needs on the host (the bias corrections, the learning
rate) are evaluated in float32 from the host step count, as the reference
evaluates them on the device, so no step waits on the card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

__all__ = ["Optimizer", "sgd", "adamw", "cosine_schedule",
           "clip_by_global_norm", "global_norm", "tree_map", "tree_leaves",
           "tree_unflatten"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    apply: Callable                 # (params, grads, state, lr) -> (params, state)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in sorted-key order (the order ``jax.tree.leaves`` walks)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(tree, leaves):
    """``leaves`` (in :func:`tree_leaves` order) back into ``tree``'s
    shape."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(tree)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g))
                          for g in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """``(grads * min(1, max_norm / (norm + 1e-12)), norm)``; the scale
    stays on the device."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


def sgd(momentum: float = 0.9, weight_decay: float = 0.0,
        nesterov: bool = False) -> Optimizer:
    """SGD with (heavy-ball) momentum — the paper's CIFAR/ImageNet setting."""

    def init(params):
        return {"mu": tree_map(torch.zeros_like, params)}

    def apply(params, grads, state, lr):
        def one(p, g, mu):
            if weight_decay:
                g = g + weight_decay * p
            mu.mul_(momentum).add_(g)
            upd = momentum * mu + g if nesterov else mu
            p.sub_(lr * upd)
        tree_map(one, params, grads, state["mu"])
        return params, state

    return Optimizer(init=init, apply=apply)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    """AdamW as the reference writes it: ``p -= lr * (m_hat / (sqrt(v_hat)
    + eps) + weight_decay * p)``.  The step count ``t`` is a host int."""

    def init(params):
        return {"m": tree_map(torch.zeros_like, params),
                "v": tree_map(torch.zeros_like, params), "t": 0}

    def apply(params, grads, state, lr):
        t = int(state["t"]) + 1
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(t))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(t))

        def one(p, g, m, v):
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * torch.square(g))
            step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            p.sub_(lr * (step + weight_decay * p))
        tree_map(one, params, grads, state["m"], state["v"])
        return params, {"m": state["m"], "v": state["v"], "t": t}

    return Optimizer(init=init, apply=apply)


def cosine_schedule(base_lr: float, total_steps: int,
                    warmup_steps: int = 0, final_frac: float = 0.0):
    """Linear warmup + cosine decay (paper App. E): ``lr(step)`` as a
    Python float, evaluated in float32."""
    f32 = np.float32

    def lr(step) -> float:
        s = f32(step)
        if s < warmup_steps:
            return float(f32(base_lr) * s / f32(max(warmup_steps, 1)))
        prog = np.clip((s - f32(warmup_steps))
                       / f32(max(total_steps - warmup_steps, 1)),
                       f32(0), f32(1))
        cos = f32(final_frac) + f32(1 - final_frac) * f32(0.5) * (
            f32(1) + np.cos(f32(math.pi) * prog))
        return float(f32(base_lr) * cos)

    return lr
