"""TrainState: what a training step consumes and produces.

Port of ``repro.engine.state``: ``(params, opt_state, step, rng)``.  The
parameters and optimizer moments are tensors on the training device and
are updated in place by the step; ``step`` (and AdamW's ``t``) are host
ints, so the learning rate and bias corrections need nothing from the
card; ``rng`` is a ``prng`` key kept on the CPU, split every step and
never reused.  ``interop.train_state_from_jax`` carries a reference
state across.

Checkpoints hold the dict form (``as_dict``) in the reference's dtypes
(``checkpoint_tree``): ``step`` and AdamW's ``t`` as 0-d int32 and
``rng`` as ``uint32[2]``, as the reference keeps them on the device, so
each package restores what the other wrote.  (The reference's restore
checks shapes, not dtypes: the key's int64 words would load there as
another key.)

On a mesh, ``state_shardings`` gives each leaf its sharding from the
plan's parameter rules, and :func:`place_state` stores the parameters and
moments as ``DTensor``, each rank holding its shard.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .. import prng

__all__ = ["TrainState", "init_train_state", "abstract_train_state",
           "state_specs", "state_shardings", "place_state"]


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int                        # optimizer step count
    rng: torch.Tensor                # PRNG key (CPU); split every step

    # Checkpoints store the dict form: stable flat paths ("params/...",
    # "opt/...", "step", "rng") independent of this class's field order.
    def as_dict(self) -> dict:
        return {"params": self.params, "opt": self.opt_state,
                "step": self.step, "rng": self.rng}

    @staticmethod
    def from_dict(d: dict) -> "TrainState":
        return TrainState(params=d["params"], opt_state=d["opt"],
                          step=d["step"], rng=d["rng"])

    def checkpoint_tree(self) -> dict:
        """``as_dict`` in the reference's dtypes: the host ints ``step``
        and ``t`` as 0-d int32, the key as its two uint32 words."""
        return _to_checkpoint(self.as_dict())

    @staticmethod
    def from_checkpoint_tree(tree: dict) -> "TrainState":
        """Inverse of :meth:`checkpoint_tree` (the host leaves may be
        numpy arrays or tensors)."""
        opt = dict(tree["opt"])
        if "t" in opt:
            opt["t"] = int(opt["t"])
        rng = np.asarray(tree["rng"]).astype(np.uint64)
        return TrainState(params=tree["params"], opt_state=opt,
                          step=int(tree["step"]),
                          rng=prng.PRNGKey((int(rng[0]) << 32) | int(rng[1])))


def _to_checkpoint(d: dict) -> dict:
    opt = dict(d["opt"])
    if "t" in opt:
        opt["t"] = np.asarray(int(opt["t"]), np.int32)
    return {"params": d["params"], "opt": opt,
            "step": np.asarray(int(d["step"]), np.int32),
            "rng": d["rng"].cpu().numpy().astype(np.uint32)}


def init_train_state(model, opt, seed: int = 0, device=None) -> TrainState:
    """Fresh state: params from ``model.init`` on ``device`` (CUDA unless
    asked otherwise), zeroed optimizer state, step 0, and an rng stream
    independent of the init key (``split(PRNGKey(seed))``, as the
    reference).  The init key's two words seed the parameter draw."""
    init_key, rng = prng.split(prng.PRNGKey(seed))
    hi, lo = init_key.tolist()
    params = model.init((hi << 32) | lo, device=device)
    return TrainState(params=params, opt_state=opt.init(params), step=0,
                      rng=rng)


def abstract_train_state(model, opt, seed: int = 0) -> TrainState:
    """The state's skeleton on the meta device (no allocation, no draw):
    the restore target of a checkpoint."""
    return init_train_state(model, opt, seed, device="meta")


def state_specs(plan, abstract_state: TrainState) -> TrainState:
    """Spec tree for a TrainState.  Optimizer moments mirror the param
    tree path for path, so the plan's substring rules apply verbatim;
    ``step``, ``rng`` (and AdamW's ``t``) are replicated, ``()``."""
    return TrainState(params=plan.param_specs(abstract_state.params),
                      opt_state=plan.param_specs(abstract_state.opt_state),
                      step=(), rng=())


def state_shardings(plan, abstract_state: TrainState) -> TrainState:
    """:class:`~repro_torch.sharding.NamedSharding` tree for a TrainState
    (placement and checkpoint restore)."""
    specs = state_specs(plan, abstract_state)
    return TrainState(params=plan.shardings(specs.params),
                      opt_state=plan.shardings(specs.opt_state),
                      step=plan.shardings(()), rng=plan.shardings(()))


def _place(tree, shardings):
    if isinstance(tree, dict):
        return {k: _place(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return shardings.place(tree)
    return tree


def place_state(state: TrainState, shardings: TrainState) -> TrainState:
    """``state`` with its parameters and moments as ``DTensor`` shards per
    ``shardings`` (every rank holds the full state to start from: the same
    seed, or the same checkpoint); ``step``, ``rng`` and ``t`` stay host
    values."""
    return TrainState(params=_place(state.params, shardings.params),
                      opt_state=_place(state.opt_state, shardings.opt_state),
                      step=state.step, rng=state.rng)
