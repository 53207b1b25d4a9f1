"""Engine: one object that owns the training loop.

Port of ``repro.engine.engine.Engine`` for one device::

    eng = Engine(cfg, QuantPolicy.fqt("bhq", 5, bhq_block=256,
                                      backend="kernel"),
                 steps=200, batch_size=8, seq_len=64)
    history = eng.run()

It builds the model, the optimizer (AdamW or SGD), the cosine schedule,
the data loader with prefetch and the step (:func:`make_step_fn`) once,
and runs the loop, keeping losses as device scalars and reading them on
the host only on log steps.  Checkpoints (``ckpt_dir``) and meshes come
with later slices and raise.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from ..data import Prefetcher, ShardedLoader, make_batch_for
from ..device import resolve_device
from ..models import build_model
from ..optim import Optimizer, adamw, cosine_schedule, sgd
from .state import TrainState, init_train_state
from .step import DISTRIBUTION_SLICE, make_step_fn

__all__ = ["Engine"]

CHECKPOINT_SLICE = "the checkpoint slice of the port"


class Engine:
    """Builds the step once and runs the training loop on ``device`` (CUDA
    unless the caller asks otherwise).

    ``batch_size`` is the global batch per optimizer step; with
    ``accum_steps=k`` the step consumes it as k sequential microbatches.
    ``batch_fn(step) -> batch`` must be a pure function of the step.
    """

    def __init__(self, cfg, policy, *, steps: int, batch_size: int,
                 seq_len: int, lr: float = 3e-3, opt_name: str = "adamw",
                 opt: Optional[Optimizer] = None, accum_steps: int = 1,
                 mesh=None, remat: bool = False, clip_norm: float = 1.0,
                 loss_kwargs: Optional[dict] = None,
                 ckpt_dir: Optional[str] = None, log_every: int = 10,
                 seed: int = 0,
                 batch_fn: Optional[Callable[[int], dict]] = None,
                 device=None, log_fn=print):
        if batch_size % accum_steps:
            raise ValueError(f"batch_size={batch_size} not divisible by "
                             f"accum_steps={accum_steps}")
        if ckpt_dir is not None:
            raise NotImplementedError(f"checkpoints (ckpt_dir) come with "
                                      f"{CHECKPOINT_SLICE}")
        if mesh is not None:
            raise NotImplementedError(f"meshes come with {DISTRIBUTION_SLICE}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.policy = policy
        self.steps = steps
        self.seed = seed
        self.log_every = log_every
        self.log_fn = log_fn or (lambda *a: None)
        self.model = build_model(cfg)
        self.opt = opt or (adamw() if opt_name == "adamw"
                           else sgd(momentum=0.9))
        self.lr_fn = cosine_schedule(lr, steps,
                                     warmup_steps=max(steps // 20, 1))
        self.batch_fn = batch_fn or (
            lambda s: make_batch_for(cfg, batch_size, seq_len, step=s,
                                     seed=seed))
        self.loader = ShardedLoader(self.batch_fn, device=self.device)
        self.step_fn = make_step_fn(
            self.model, policy, self.opt, self.lr_fn, clip_norm=clip_norm,
            remat=remat, accum_steps=accum_steps, loss_kwargs=loss_kwargs)
        self.state: Optional[TrainState] = None

    def init_state(self) -> TrainState:
        return init_train_state(self.model, self.opt, self.seed, self.device)

    def run(self, steps: Optional[int] = None):
        """Train until ``steps``; returns history ``[(step, loss), ...]``
        with one entry per executed step."""
        steps = steps if steps is not None else self.steps
        state = self.state if self.state is not None else self.init_state()
        start = int(state.step)
        pf = Prefetcher(self.loader, depth=2, start_step=start)
        history, pending = [], []

        def drain():
            history.extend((s, float(l)) for s, l in pending)
            pending.clear()

        t0 = time.time()
        try:
            for step in range(start, steps):
                state, mets = self.step_fn(state, pf.next())
                pending.append((step, mets["loss"]))
                if step % self.log_every == 0 or step == steps - 1:
                    drain()
                    self.log_fn(
                        f"[engine] step {step:5d} "
                        f"loss {history[-1][1]:8.4f} "
                        f"gnorm {float(mets['grad_norm']):8.3f} "
                        f"({time.time() - t0:.1f}s)")
        finally:
            pf.stop()
            self.state = state
            drain()
        return history
