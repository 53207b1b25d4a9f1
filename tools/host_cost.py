"""Host cost of a training step in checkouts of the port, on the CPU.

    python3 tools/host_cost.py TREE [TREE ...] [--steps N]

For each checkout TREE, in the order given, one process each: the
reduced statquant-tx and granite-moe-1b-a400m configs, 8 x 16 tokens,
``fqt(psq,8)`` on the ``kernel`` backend (on CPU tensors the wrappers run
their kernels' plain versions), the engine's defaults (``remat`` off),
one thread.  It prints, per config, the PyTorch operations one step
dispatches and the Python function calls it makes (``cProfile``): counts
that do not depend on the machine's load; and the median wall of
``--steps`` steps after one warm-up step.  At these sizes a step is
mostly dispatch, so the numbers follow the host work of the layers above
the kernels (autograd Functions, quantizer plumbing), not the kernels.
"""
from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import statistics
import subprocess
import sys
import time
from pathlib import Path

CONFIGS = ("statquant-tx", "granite-moe-1b-a400m")


def _measure(steps: int) -> dict:
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.configs import get_config
    from repro_torch.core import QuantPolicy
    from repro_torch.engine import Engine
    torch.set_num_threads(1)

    class Ops(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Ops.n += 1
            return func(*args, **(kwargs or {}))
    out = {}
    for arch in CONFIGS:
        eng = Engine(get_config(arch, smoke=True),
                     QuantPolicy.fqt("psq", 8, backend="kernel"),
                     steps=steps + 2, batch_size=8, seq_len=16, seed=0,
                     device="cpu", log_every=10 ** 9, log_fn=None)
        state = eng.init_state()
        batch = eng.loader.get(0)
        state, _ = eng.step_fn(state, batch)            # warm-up
        Ops.n = 0
        with Ops():
            state, _ = eng.step_fn(state, batch)
        prof = cProfile.Profile()
        prof.enable()
        state, _ = eng.step_fn(state, batch)
        prof.disable()
        calls = pstats.Stats(prof).total_calls
        walls = []
        for _ in range(steps):
            t0 = time.perf_counter()
            state, _ = eng.step_fn(state, batch)
            walls.append((time.perf_counter() - t0) * 1e3)
        out[arch] = {"ops": Ops.n, "python_calls": calls,
                     "median_ms": statistics.median(walls), "ms": walls}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", type=Path)
    ap.add_argument("--steps", type=int, default=9)
    ap.add_argument("--of", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.of is not None:
        sys.path.insert(0, str(args.of.resolve() / "src"))
        print(json.dumps(_measure(args.steps)))
        return
    for tree in args.trees:
        env = dict(os.environ, OMP_NUM_THREADS="1")
        res = subprocess.run([sys.executable, __file__, "--of", str(tree),
                              "--steps", str(args.steps)], env=env,
                             capture_output=True, text=True, check=True)
        for arch, r in json.loads(res.stdout.splitlines()[-1]).items():
            print(f"[host] {tree} {arch}: {r['ops']} PyTorch operations "
                  f"and {r['python_calls']} Python calls a step, median "
                  f"step {r['median_ms']:.2f} ms (of {len(r['ms'])})",
                  flush=True)


if __name__ == "__main__":
    main()
