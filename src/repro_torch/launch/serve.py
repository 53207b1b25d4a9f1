"""Serving CLI: a thin driver over the continuous-batching engine.

Port of ``repro.launch.serve.main``.  Weights and activations run through
the deterministic forward quantizers (``QuantPolicy.qat``) on the ``kernel``
backend by default, with the int8 KV cache; the engine owns scheduling.
The CLI builds random parameters from ``--seed``, submits a mixed-length
synthetic workload, and reports throughput and per-step latency
percentiles.  It runs on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
        --full --slots 8 --max-seq 256 --requests 16
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..configs import get_config
from ..core import QuantPolicy
from ..models import build_model
from ..serve import ServeEngine

__all__ = ["main"]


def _latency_stats(step_times):
    dts = np.asarray([dt for dt, n in step_times if n > 0])
    if dts.size == 0:
        return 0.0, 0.0
    return float(np.percentile(dts, 50)), float(np.percentile(dts, 95))


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="continuous-batching quantized serving driver")
    ap.add_argument("--arch", default="statquant-tx")
    ap.add_argument("--smoke", dest="smoke", action="store_true",
                    help="reduced config (default)")
    ap.add_argument("--full", dest="smoke", action="store_false",
                    help="full-size config")
    ap.set_defaults(smoke=True)
    ap.add_argument("--slots", type=int, default=4,
                    help="decode-slot pool size (static decode batch)")
    ap.add_argument("--max-seq", type=int, default=64,
                    help="per-slot KV cache length")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--min-prompt", type=int, default=4)
    ap.add_argument("--max-prompt", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="<= 0 => greedy")
    ap.add_argument("--top-k", type=int, default=0, help="<= 0 => disabled")
    ap.add_argument("--top-p", type=float, default=0.0,
                    help="nucleus sampling mass; outside (0,1) => disabled")
    ap.add_argument("--eos", type=int, default=None,
                    help="EOS token id (evicts the slot on emission)")
    ap.add_argument("--kv-cache", choices=["int8", "fp32"], default="int8",
                    help="KV-cache storage")
    ap.add_argument("--backend", default="kernel",
                    choices=["simulate", "kernel"],
                    help="execution backend for the quantized ops, "
                         "including the int8-KV dequant")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    policy = QuantPolicy.qat(backend=args.backend)  # fwd-only quantization
    params = build_model(cfg).init(args.seed, device=args.device)
    eng = ServeEngine(cfg, params, policy=policy, slots=args.slots,
                      max_seq=args.max_seq,
                      kv_quant=args.kv_cache == "int8", eos_id=args.eos,
                      seed=args.seed, device=args.device)

    # warmup: every prefill bucket the workload can hit, off the clock
    hi = min(args.max_prompt, args.max_seq - 1)
    lo = min(args.min_prompt, hi)
    b = 1
    while b < hi:
        b *= 2
        if b >= lo:
            eng.submit([1] * min(b, hi), max_new=2)
    eng.submit([1], max_new=2)
    eng.run()
    eng.step_times.clear()

    rng = np.random.RandomState(args.seed)
    for _ in range(args.requests):
        plen = int(rng.randint(lo, hi + 1))
        prompt = rng.randint(0, cfg.vocab_size, size=plen)
        eng.submit(prompt, max_new=args.max_new,
                   temperature=args.temperature, top_k=args.top_k,
                   top_p=args.top_p)

    t0 = time.perf_counter()
    completions = eng.run()
    dt = time.perf_counter() - t0
    n_tok = sum(len(c.tokens) for c in completions.values())
    p50, p95 = _latency_stats(eng.step_times)
    print(f"[serve] {len(completions)} requests, {n_tok} tokens in "
          f"{dt:.2f}s ({n_tok / max(dt, 1e-9):.1f} tok/s, "
          f"kv={args.kv_cache}, slots={args.slots}, device={eng.device})")
    print(f"[serve] per-step latency p50 {p50 * 1e3:.2f}ms "
          f"p95 {p95 * 1e3:.2f}ms")
    by_reason = {}
    for c in completions.values():
        by_reason[c.reason] = by_reason.get(c.reason, 0) + 1
    print(f"[serve] finish reasons: {by_reason}")
    if completions:
        rid0 = min(completions)
        print("[serve] sample:", completions[rid0].tokens[:16])
    return completions


if __name__ == "__main__":
    main()
