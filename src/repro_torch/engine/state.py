"""TrainState: what a training step consumes and produces.

Port of ``repro.engine.state``: ``(params, opt_state, step, rng)``.  The
parameters and optimizer moments are tensors on the training device and
are updated in place by the step; ``step`` (and AdamW's ``t``) are host
ints, so the learning rate and bias corrections need nothing from the
card; ``rng`` is a ``prng`` key kept on the CPU, split every step and
never reused.  ``interop.train_state_from_jax`` carries a reference
state across.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .. import prng

__all__ = ["TrainState", "init_train_state"]


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int                        # optimizer step count
    rng: torch.Tensor                # PRNG key (CPU); split every step


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
