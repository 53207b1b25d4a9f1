"""Serving CLI: a thin driver over the continuous-batching engine.

Port of ``repro.launch.serve.main``.  Weights and activations run through
the deterministic forward quantizers (``QuantPolicy.qat``) on the ``kernel``
backend by default, with the int8 KV cache; the engine owns scheduling.
The CLI builds random parameters from ``--seed``, submits a mixed-length
synthetic workload, and reports throughput and per-step latency
percentiles.  It runs on the card unless ``--device cpu`` is given.
``--paged`` serves from the paged int8 page pool (prefix reuse, chunked
prefill, preemption, ``--spec-decode``) instead of one lane per slot.
``--weight-bits B`` bit-packs every dense kernel once at load and serves
from the packed codes.  ``--ckpt-dir DIR`` serves the parameters of the
latest training checkpoint in DIR (either package's) instead of random
ones.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
        --full --slots 8 --max-seq 256 --requests 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
        --full --paged --page-size 16 --spec-decode
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
        --full --weight-bits 4
    PYTHONPATH=src python -m repro_torch.launch.serve --ckpt-dir /ckpts
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch granite-moe-1b-a400m --full --paged --page-size 16

``generate`` is the static-batch helper without the engine (prefill once,
decode the whole batch in lockstep); it stops early once every row has
emitted ``eos_id``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..core import QuantPolicy
from ..models import build_model
from ..serve import ServeEngine, weight_nbytes

__all__ = ["generate", "main"]


def generate(model, params, batch, policy: QuantPolicy, *, max_new: int,
             max_seq: int, eos_id=None):
    """Prefill the prompt then greedy-decode up to ``max_new`` tokens.
    A VLM's prompt is its ``embeds`` and ``positions``; its decode steps
    take each new token's embedding (the stub frontend).  An audio
    model's prompt is its ``frames`` and ``tokens``; its decode steps take
    the tokens.

    Returns (B, n) int64 with n <= max_new: decoding stops as soon as
    every row has emitted ``eos_id`` (rows that finish early keep emitting
    ``eos_id`` while the rest of the batch drains).  ``eos_id=None``
    disables early stopping and always returns (B, max_new)."""
    cfg = model.cfg
    with torch.no_grad():
        logits, cache = model.prefill(params, batch, policy, max_seq)
        out = []
        tok = torch.argmax(logits[:, -1, :cfg.vocab_size], dim=-1)[:, None]
        finished = torch.zeros((tok.shape[0],), dtype=torch.bool,
                               device=tok.device)
        for _ in range(max_new):
            if eos_id is not None:
                finished = finished | (tok[:, 0] == eos_id)
                tok = torch.where(finished[:, None],
                                  torch.full_like(tok, eos_id), tok)
            out.append(tok)
            if eos_id is not None and bool(finished.all()):
                break
            dbatch = {"tokens": tok.to(torch.int32)}
            if cfg.family == "vlm":
                # stub frontend: decode steps feed the token embeddings
                table = params["embed"]["table"]
                dbatch = {"embeds": table[tok[:, 0]][:, None]}
            logits, cache = model.decode(params, cache, dbatch, policy)
            tok = torch.argmax(logits[:, -1, :cfg.vocab_size],
                               dim=-1)[:, None]
    return torch.cat(out, dim=1)


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
    ap.add_argument("--paged", action="store_true",
                    help="paged int8 KV engine (serve/paged.py): shared "
                         "page pool + block tables + prefix reuse instead "
                         "of one max-seq lane per slot")
    ap.add_argument("--page-size", type=int, default=8,
                    help="rows per KV page (paged mode)")
    ap.add_argument("--pages", type=int, default=None,
                    help="page-pool size; default sizes for slots lanes")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked-prefill width (paged mode); default = "
                         "whole-prompt prefill")
    ap.add_argument("--spec-decode", action="store_true",
                    help="self-speculative decoding (paged mode): draft = "
                         "same params under a 4-bit forward policy")
    ap.add_argument("--spec-k", type=int, default=3,
                    help="draft tokens proposed per verify step")
    ap.add_argument("--eos", type=int, default=None,
                    help="EOS token id (evicts the slot on emission)")
    ap.add_argument("--kv-cache", choices=["int8", "fp32"], default="int8",
                    help="KV-cache storage")
    ap.add_argument("--weight-bits", type=int, default=None,
                    choices=[8, 4, 2],
                    help="bit-pack every dense kernel once at load "
                         "(kernels/pack.py): resident GEMM weights drop to "
                         "bits/32 of fp32 and every forward unpacks tiles "
                         "in-kernel; omit to keep fp32 weights with "
                         "per-call forward quantization")
    ap.add_argument("--backend", default="kernel",
                    choices=["simulate", "native", "kernel"],
                    help="execution backend for the quantized ops, "
                         "including the int8-KV dequant")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions")
    ap.add_argument("--ckpt-dir", default=None,
                    help="restore params from an engine TrainState "
                         "checkpoint instead of random init")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    policy = QuantPolicy.qat(backend=args.backend)  # fwd-only quantization
    kv_quant = args.kv_cache == "int8"
    if args.paged and not kv_quant:
        ap.error("--paged requires --kv-cache int8 (pages store the codec)")
    for flag, name in ((args.spec_decode, "--spec-decode"),
                       (args.prefill_chunk, "--prefill-chunk"),
                       (args.pages, "--pages")):
        if flag and not args.paged:
            ap.error(f"{name} needs --paged")
    kw = dict(policy=policy, slots=args.slots, max_seq=args.max_seq,
              kv_quant=kv_quant, eos_id=args.eos, seed=args.seed,
              weight_bits=args.weight_bits, device=args.device)
    if args.paged:
        kw.update(paged=True, page_size=args.page_size, pages=args.pages,
                  prefill_chunk=args.prefill_chunk,
                  spec_decode=args.spec_decode, spec_k=args.spec_k)
    if args.ckpt_dir:
        eng = ServeEngine.from_checkpoint(cfg, args.ckpt_dir, **kw)
        print(f"[serve] params from the checkpoint in {args.ckpt_dir}")
    else:
        params = build_model(cfg).init(args.seed, device=args.device)
        eng = ServeEngine(cfg, params, **kw)
    if args.weight_bits is not None:
        print(f"[serve] packed w{args.weight_bits} weights: "
              f"{weight_nbytes(eng.params)} resident bytes")

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
    if args.paged:
        st = eng.pool_stats()
        print(f"[serve] paged: {st['pages_in_use']}/{st['n_pages']} pages "
              f"resident (peak {st['peak_pages_in_use']}), "
              f"prefix hits {st['prefix_hits']}, cow {st['cow_copies']}, "
              f"preemptions {st['preemptions']}")
        if args.spec_decode:
            sp = eng.spec_stats
            print(f"[serve] spec: {sp.spec_steps} rounds, acceptance "
                  f"{sp.acceptance_rate:.2f}, {sp.emitted} tokens emitted")
    if completions:
        rid0 = min(completions)
        print("[serve] sample:", completions[rid0].tokens[:16])
    return completions


if __name__ == "__main__":
    main()
