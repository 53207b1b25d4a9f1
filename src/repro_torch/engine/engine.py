"""Engine: one object that owns the training loop.

Port of ``repro.engine.engine.Engine`` for one device::

    eng = Engine(cfg, QuantPolicy.fqt("bhq", 5, bhq_block=256,
                                      backend="kernel"),
                 steps=200, batch_size=8, seq_len=64, ckpt_dir="/ckpts")
    history = eng.run()

It builds the model, the optimizer (AdamW or SGD), the cosine schedule,
the data loader with prefetch and the step (:func:`make_step_fn`) once,
and runs the loop, keeping losses as device scalars and reading them on
the host only on log and checkpoint steps.  With ``ckpt_dir`` it saves
the whole :class:`TrainState` every ``ckpt_every`` steps (asynchronously:
the host snapshot is taken in the loop, the write runs on a worker
thread), resumes from the latest checkpoint, and on a preemption request
(``preemption.should_stop``) checkpoints synchronously and stops.

On a mesh (``launch/mesh.py``; every rank of the process group builds
the same engine) the plan places the state per ``state_shardings``
(parameters and moments as ``DTensor`` shards), the loader hands each
rank its rows of every microbatch per the plan's batch specs, and the
step computes the flat step's function (``engine/step.py``).  Every
rank takes part in a checkpoint's gather; rank 0 alone logs and writes.
A checkpoint restores onto this engine's mesh whatever mesh, or none,
wrote it.

Resume semantics: the checkpoint holds ``(params, opt_state, step, rng)``.
On restore, the data loader fast-forwards to ``step`` (batches are
seed-by-step, so the stream continues exactly where it stopped) and the rng
stream continues from the saved key — a run that is preempted and resumed is
bit-identical to one that never stopped.  Checkpoints are the reference's
layout and dtypes, so either package resumes the other's.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from .. import prng
from ..checkpoint import CheckpointManager
from ..data import Prefetcher, ShardedLoader, make_batch_for
from ..device import resolve_device
from ..models import build_model
from ..optim import Optimizer, adamw, cosine_schedule, sgd
from ..runtime import PreemptionHandler, StragglerMonitor
from ..sharding import make_plan
from .state import (TrainState, abstract_train_state, init_train_state,
                    place_state, state_shardings)
from .step import make_step_fn

__all__ = ["Engine"]


class Engine:
    """Builds the step once and runs the training loop on ``device`` (CUDA
    unless the caller asks otherwise).

    ``batch_size`` is the global batch per optimizer step; with
    ``accum_steps=k`` the step consumes it as k sequential microbatches.
    ``batch_fn(step) -> batch`` must be a pure function of the step; on a
    mesh ``batch_fn(0)`` is called once at construction for the batch
    specs.  ``mesh``: a ``DeviceMesh`` whose device type is ``device``'s;
    ``compress_axis``: its axis for the int8 compressed gradient
    exchange.
    ``straggler_probe(local_dt) -> [dt_host0, ...]`` feeds the straggler
    monitor the fleet's step times; without it the monitor stays idle.
    """

    def __init__(self, cfg, policy, *, steps: int, batch_size: int,
                 seq_len: int, lr: float = 3e-3, opt_name: str = "adamw",
                 opt: Optional[Optimizer] = None, accum_steps: int = 1,
                 mesh=None, remat: bool = False, clip_norm: float = 1.0,
                 compress_axis: Optional[str] = None,
                 loss_kwargs: Optional[dict] = None,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 100,
                 keep: int = 3, log_every: int = 10, seed: int = 0,
                 resume: bool = True,
                 preemption: Optional[PreemptionHandler] = None,
                 straggler: Optional[StragglerMonitor] = None,
                 straggler_probe: Optional[Callable[[float], list]] = None,
                 batch_fn: Optional[Callable[[int], dict]] = None,
                 device=None, log_fn=print):
        if batch_size % accum_steps:
            raise ValueError(f"batch_size={batch_size} not divisible by "
                             f"accum_steps={accum_steps}")
        self.device = resolve_device(device)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh cannot train on "
                             f"{self.device}")
        self.mesh = mesh
        self.rank0 = mesh is None or torch.distributed.get_rank() == 0
        self.cfg = cfg
        self.policy = policy
        self.steps = steps
        self.seed = seed
        self.resume = resume
        self.log_every = log_every
        self.log_fn = (log_fn if log_fn and self.rank0
                       else (lambda *a: None))
        self.preemption = preemption
        self.straggler = straggler or StragglerMonitor(
            n_hosts=1 if mesh is None else torch.distributed.get_world_size())
        self.straggler_probe = straggler_probe
        self.model = build_model(cfg)
        self.opt = opt or (adamw() if opt_name == "adamw"
                           else sgd(momentum=0.9))
        self.lr_fn = cosine_schedule(lr, steps,
                                     warmup_steps=max(steps // 20, 1))
        self.batch_fn = batch_fn or (
            lambda s: make_batch_for(cfg, batch_size, seq_len, step=s,
                                     seed=seed))
        self.plan = make_plan(mesh) if mesh is not None else None
        self.shardings = None
        replicated = False
        if self.plan is None:
            self.loader = ShardedLoader(self.batch_fn, device=self.device)
        else:
            self.shardings = state_shardings(
                self.plan, abstract_train_state(self.model, self.opt, seed))
            specs = self.plan.batch_specs(self.batch_fn(0))
            replicated = all(e is None for e in specs["labels"])
            _, index, count = self.plan.data_group()
            self.loader = ShardedLoader(self.batch_fn, device=self.device,
                                        specs=specs, data=(index, count),
                                        accum_steps=accum_steps)
        self.step_fn = make_step_fn(
            self.model, policy, self.opt, self.lr_fn, clip_norm=clip_norm,
            remat=remat, accum_steps=accum_steps, mesh=mesh,
            compress_axis=compress_axis, loss_kwargs=loss_kwargs,
            replicated_batch=replicated)
        self.ckpt = (CheckpointManager(ckpt_dir, keep=keep)
                     if ckpt_dir else None)
        self.ckpt_every = ckpt_every
        self.state: Optional[TrainState] = None

    # -- state lifecycle ----------------------------------------------------
    def init_state(self) -> TrainState:
        state = init_train_state(self.model, self.opt, self.seed,
                                 self.device)
        if self.shardings is not None:
            state = place_state(state, self.shardings)
        return state

    def restore_state(self, step: Optional[int] = None) -> TrainState:
        """Restore the full TrainState onto this engine's device (elastic:
        onto this engine's mesh, whatever mesh wrote the checkpoint).

        Pre-engine checkpoints ({params, opt} only, no step/rng leaves)
        migrate: step comes from the checkpoint index, the rng stream
        restarts (SR draws after resume differ from the unpreempted run —
        logged, since the bit-identical-resume guarantee needs a
        full-state checkpoint)."""
        step = step if step is not None else self.ckpt.latest_step()
        target = abstract_train_state(self.model, self.opt,
                                      self.seed).checkpoint_tree()
        sh = None
        if self.shardings is not None:
            sh = TrainState.as_dict(self.shardings)
        legacy = "step" not in self.ckpt.load_meta(step)["keys"]
        if legacy:
            target = {k: target[k] for k in ("params", "opt")}
            sh = sh and {k: sh[k] for k in ("params", "opt")}
        tree = self.ckpt.restore(step, target, device=self.device,
                                 shardings=sh)
        if legacy:
            self.log_fn(f"[engine] legacy checkpoint (no step/rng) at "
                        f"step {step}: resuming data stream, restarting "
                        f"rng stream")
            key = prng.fold_in(prng.PRNGKey(self.seed), step)
            tree = {**tree, "step": step, "rng": key.numpy()}
        return TrainState.from_checkpoint_tree(tree)

    def _startup_state(self) -> TrainState:
        if self.ckpt and self.resume and self.ckpt.latest_step() is not None:
            state = self.restore_state()
            self.log_fn(f"[engine] resumed from step {int(state.step)}")
            return state
        return self.init_state()

    def _save(self, state: TrainState, asynchronous: bool = True):
        self.ckpt.save(int(state.step), state.checkpoint_tree(),
                       extra={"data_step": int(state.step)},
                       asynchronous=asynchronous, write=self.rank0)

    def _should_stop(self) -> bool:
        """The preemption request, agreed by every rank on a mesh (any
        rank's request stops all)."""
        stop = bool(self.preemption and self.preemption.should_stop)
        if self.mesh is None or not self.preemption:
            return stop
        flag = torch.tensor(float(stop), device=self.device)
        torch.distributed.all_reduce(flag, op=torch.distributed.ReduceOp.MAX)
        return bool(flag.item())

    # -- the loop -----------------------------------------------------------
    def run(self, steps: Optional[int] = None):
        """Train until ``steps``; returns history ``[(step, loss), ...]``
        with one entry per executed step."""
        steps = steps if steps is not None else self.steps
        state = self.state if self.state is not None else self._startup_state()
        start = int(state.step)
        pf = Prefetcher(self.loader, depth=2, start_step=start)
        history, pending = [], []

        def drain():
            history.extend((s, float(l)) for s, l in pending)
            pending.clear()

        t0 = time.time()
        try:
            for step in range(start, steps):
                t_step = time.time()
                state, mets = self.step_fn(state, pf.next())
                pending.append((step, mets["loss"]))
                if self.straggler_probe is not None:
                    self.straggler.record(
                        self.straggler_probe(time.time() - t_step))
                    slow = self.straggler.stragglers()
                    if slow:
                        self.log_fn(f"[engine] stragglers: {slow}")
                if step % self.log_every == 0 or step == steps - 1:
                    drain()
                    self.log_fn(
                        f"[engine] step {step:5d} "
                        f"loss {history[-1][1]:8.4f} "
                        f"gnorm {float(mets['grad_norm']):8.3f} "
                        f"({time.time() - t0:.1f}s)")
                if self.ckpt and (step + 1) % self.ckpt_every == 0:
                    drain()
                    self._save(state)
                if self._should_stop():
                    if self.ckpt:
                        # drain any in-flight async save first: both write
                        # step_<N>.tmp
                        self.ckpt.wait()
                        if (step + 1) % self.ckpt_every != 0:
                            self._save(state, asynchronous=False)
                    self.log_fn(f"[engine] preempted at step {step + 1}; "
                                f"checkpointed")
                    break
        finally:
            pf.stop()
            if self.ckpt:
                self.ckpt.wait()
            self.state = state
            drain()
        if self.ckpt and self.mesh is not None:
            torch.distributed.barrier()    # rank 0's writes are done
        return history
