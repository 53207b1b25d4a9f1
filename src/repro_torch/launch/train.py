"""Training CLI on top of the engine (:mod:`repro_torch.engine`).

Port of ``repro.launch.train``: parses the same arguments, resolves the
quantization policy and drives ``Engine.run()``.  It trains on the card
unless ``--device cpu`` is given (the kernels' plain versions then run)::

    PYTHONPATH=src python -m repro_torch.launch.train --full --steps 200 \\
        --quant bhq --grad-bits 5 --backend kernel
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 2

``--backend`` is ``simulate``, ``native`` (``torch._int_mm`` on the int8
codes) or ``kernel`` (the reference's ``pallas``).  ``--ckpt-dir`` saves
the whole training state every 100 steps and resumes from the latest
checkpoint there (either package's); SIGTERM checkpoints and stops.
``--override-file`` reads a precision plan (``overrides_to_json``'s
format) before any ``--override``.  ``--mesh DATAxMODEL`` trains on a
``(data, model)`` mesh of that many ranks, one process a rank, under
``torchrun``: NCCL on the cards, gloo with ``--device cpu``::

    PYTHONPATH=src torchrun --nproc-per-node 4 \\
        -m repro_torch.launch.train --device cpu --mesh 2x2 --steps 3

``train_loop`` is the reference's compatibility wrapper over
``Engine(...).run()``.
"""

from __future__ import annotations

import argparse

from ..configs import get_config
from ..core import QuantPolicy
from ..engine import Engine
from ..models import model_quant_paths
from ..runtime import PreemptionHandler

__all__ = ["train_loop", "main", "parse_override", "parse_mesh"]


def train_loop(cfg, policy: QuantPolicy, *, steps: int, batch_size: int,
               seq_len: int, lr: float = 3e-3, opt_name: str = "adamw",
               ckpt_dir: str | None = None, ckpt_every: int = 100,
               log_every: int = 10, seed: int = 0, remat: bool = False,
               resume: bool = True, preemption: PreemptionHandler | None = None,
               log_fn=print, **engine_kwargs):
    """Compatibility wrapper over ``Engine(...).run()``: returns
    ``(params, opt_state, history)`` with one ``(step, loss)`` entry per
    executed step.  Extra kwargs (``accum_steps=``, ``device=``, ...) pass
    through to :class:`~repro_torch.engine.Engine`."""
    eng = Engine(cfg, policy, steps=steps, batch_size=batch_size,
                 seq_len=seq_len, lr=lr, opt_name=opt_name,
                 ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                 log_every=log_every, seed=seed, remat=remat, resume=resume,
                 preemption=preemption, log_fn=log_fn, **engine_kwargs)
    history = eng.run()
    return eng.state.params, eng.state.opt_state, history


def parse_override(text: str):
    """One ``--override`` entry -> (path_regex, override-ish), with the
    reference's grammar: ``PATTERN=exact`` | ``PATTERN=bits:B`` |
    ``PATTERN=ROLE:QUANT[:B]``."""
    pattern, sep, rhs = text.partition("=")
    if not sep or not pattern or not rhs:
        raise argparse.ArgumentTypeError(f"{text!r}: expected PATTERN=SPEC")
    if rhs == "exact":
        value = "exact"
    else:
        head, _, rest = rhs.partition(":")
        if head == "bits":
            value = int(rest)
        elif rest:
            value = {head: rest}      # "agrad:bhq:4" -> {"agrad": "bhq:4"}
        else:
            raise argparse.ArgumentTypeError(
                f"{text!r}: expected exact | bits:B | ROLE:QUANT[:B]")
    from ..core.policy import _normalize_overrides
    try:
        _normalize_overrides(((pattern, value),))
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e)) from None
    return pattern, value


def parse_mesh(text: str):
    """``--mesh DATAxMODEL`` (e.g. ``2x2``) -> (data, model)."""
    try:
        data, model = (int(v) for v in text.lower().split("x"))
        if data < 1 or model < 1:
            raise ValueError
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"{text!r}: expected DATAxMODEL, e.g. 2x2") from None
    return data, model


def main(argv=None):
    ap = argparse.ArgumentParser(description="FQT training driver")
    ap.add_argument("--arch", default="statquant-tx")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8,
                    help="GLOBAL batch per optimizer step")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--opt", default="adamw", choices=["adamw", "sgd"])
    ap.add_argument("--quant", default="bhq", choices=["ptq", "psq", "bhq",
                                                       "qat", "exact"])
    ap.add_argument("--grad-bits", type=int, default=5)
    ap.add_argument("--backend", default="simulate",
                    choices=["simulate", "native", "kernel"],
                    help="quantized-GEMM execution backend; native = "
                         "torch._int_mm on the int8 codes; kernel = the "
                         "CUDA kernels for the forward AND both backward "
                         "GEMMs (their plain versions with --device cpu)")
    ap.add_argument("--device", default=None,
                    help="training device (default: cuda)")
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                    type=parse_mesh,
                    help="sharded training on a (data, model) mesh: one "
                         "process a rank (torchrun), DATA*MODEL ranks")
    ap.add_argument("--accum", type=int, default=1,
                    help="gradient-accumulation microbatches per step")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint the training state here and resume "
                         "from the latest checkpoint in it")
    ap.add_argument("--override", action="append", default=[],
                    metavar="PATTERN=SPEC", type=parse_override,
                    help="per-layer policy override (repeatable, applied in "
                         "order): PATTERN=exact | PATTERN=bits:B | "
                         "PATTERN=ROLE:QUANT[:B]")
    ap.add_argument("--override-file", default=None, metavar="PLAN.json",
                    help="load per-layer overrides from a JSON file (the "
                         "format overrides_to_json writes), applied before "
                         "any --override, so CLI entries win")
    args = ap.parse_args(argv)

    file_overrides = ()
    if args.override_file:
        import json

        from ..core.policy import overrides_from_json
        with open(args.override_file) as fh:
            doc = json.load(fh)
        try:
            file_overrides = overrides_from_json(doc)
        except (TypeError, ValueError, KeyError) as e:
            ap.error(f"--override-file {args.override_file}: {e}")
    overrides = tuple(file_overrides) + tuple(args.override)
    if args.quant == "exact":
        if overrides:
            ap.error("--override/--override-file have no effect with "
                     "--quant exact (the policy quantizes nothing)")
        policy = QuantPolicy.exact()
    elif args.quant == "qat":
        policy = QuantPolicy.qat(backend=args.backend, overrides=overrides)
    else:
        policy = QuantPolicy.fqt(args.quant, args.grad_bits, bhq_block=256,
                                 backend=args.backend, overrides=overrides)

    cfg = get_config(args.arch, smoke=args.smoke)
    if overrides:
        print("[train] resolved per-layer quantizer specs:")
        for path, desc in policy.spec_table(model_quant_paths(cfg)):
            print(f"  {path:32s} {desc}")

    mesh, device = None, args.device
    if args.mesh is not None:
        import torch.distributed as dist

        from .mesh import init_distributed, make_test_mesh
        data, model = args.mesh
        device = init_distributed(args.device)
        if data * model != dist.get_world_size():
            ap.error(f"--mesh {data}x{model} needs {data * model} ranks, "
                     f"the process group has {dist.get_world_size()}")
        mesh = make_test_mesh(data, model, device=device)

    prm = PreemptionHandler(install=True)
    eng = Engine(cfg, policy, steps=args.steps, batch_size=args.batch,
                 seq_len=args.seq, lr=args.lr, opt_name=args.opt,
                 accum_steps=args.accum, ckpt_dir=args.ckpt_dir,
                 preemption=prm, device=device, mesh=mesh)
    return eng.run()


if __name__ == "__main__":
    main()
