"""Training engine: :class:`TrainState`, the step (:func:`make_step_fn`)
and the loop (:class:`Engine`), the one way a training step is built and
run (``launch/train.py`` drives it)."""

from .engine import Engine
from .state import (TrainState, abstract_train_state, init_train_state,
                    place_state, state_shardings, state_specs)
from .step import make_step_fn, split_microbatches

__all__ = ["Engine", "TrainState", "abstract_train_state", "init_train_state",
           "make_step_fn", "split_microbatches", "state_specs",
           "state_shardings", "place_state"]
