"""Training CLI on top of the engine (:mod:`repro_torch.engine`).

Port of ``repro.launch.train``: parses the same arguments, resolves the
quantization policy and drives ``Engine.run()``.  It trains on the card
unless ``--device cpu`` is given (the kernels' plain versions then run)::

    PYTHONPATH=src python -m repro_torch.launch.train --full --steps 200 \\
        --quant bhq --grad-bits 5 --backend kernel
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 2

``--backend`` is ``simulate`` or ``kernel`` (the reference's ``pallas``).
``--ckpt-dir``, ``--mesh`` and ``--override-file`` belong to later slices
of the port and raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse

from ..configs import get_config
from ..core import QuantPolicy
from ..engine import Engine
from ..models import model_quant_paths

__all__ = ["main", "parse_override"]


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
                    choices=["simulate", "kernel"],
                    help="quantized-GEMM execution backend; kernel = the "
                         "CUDA kernels for the forward AND both backward "
                         "GEMMs (their plain versions with --device cpu)")
    ap.add_argument("--device", default=None,
                    help="training device (default: cuda)")
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                    help="sharded training: not ported yet (raises)")
    ap.add_argument("--accum", type=int, default=1,
                    help="gradient-accumulation microbatches per step")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoints: not ported yet (raises)")
    ap.add_argument("--override", action="append", default=[],
                    metavar="PATTERN=SPEC", type=parse_override,
                    help="per-layer policy override (repeatable, applied in "
                         "order): PATTERN=exact | PATTERN=bits:B | "
                         "PATTERN=ROLE:QUANT[:B]")
    ap.add_argument("--override-file", default=None, metavar="PLAN.json",
                    help="per-layer overrides from a precision plan: not "
                         "ported yet (raises)")
    args = ap.parse_args(argv)

    if args.mesh is not None:
        raise NotImplementedError("--mesh: sharded training comes with the "
                                  "distribution slice of the port")
    if args.override_file is not None:
        raise NotImplementedError("--override-file: precision plans come "
                                  "with the analysis slice of the port")
    overrides = tuple(args.override)
    if args.quant == "exact":
        if overrides:
            ap.error("--override has no effect with --quant exact (the "
                     "policy quantizes nothing)")
        policy = QuantPolicy.exact()
    elif args.quant == "qat":
        policy = QuantPolicy.qat(backend=args.backend, overrides=overrides)
    else:
        policy = QuantPolicy.fqt(args.quant, args.grad_bits, bhq_block=256,
                                 backend=args.backend, overrides=overrides)

    cfg = get_config(args.arch, smoke=args.smoke)
    if overrides:
        print("[train] resolved per-layer quantizer specs:")
        for path in model_quant_paths(cfg):
            print(f"  {path:32s} {policy.resolve(path).describe()}")

    eng = Engine(cfg, policy, steps=args.steps, batch_size=args.batch,
                 seq_len=args.seq, lr=args.lr, opt_name=args.opt,
                 accum_steps=args.accum, ckpt_dir=args.ckpt_dir,
                 device=args.device)
    return eng.run()


if __name__ == "__main__":
    main()
