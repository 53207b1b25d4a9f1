"""Where ``chip_smoke.py``'s seconds go: run it (same arguments) with an
inclusive timer around each phase, each of its helpers and torch.profiler's
aggregation, and print every (phase, helper) that took over a second to
standard error, costliest first; all of them go to
``chiprun_out/chip_smoke_times.json``.  Needs the card, as ``chip_smoke.py``
does:

    python3 tools/chip_smoke_times.py [--phases PHASE ...]
"""
from __future__ import annotations

import collections
import functools
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

PHASES = ["kernel_vs_plain", "train_kernel_vs_plain", "serve_granite",
          "serve_granite_paged", "packed_kernel_vs_plain",
          "serve_granite_packed", "paged_features", "paged_reduced_exact",
          "serve_statquant", "train_statquant", "train_unfused",
          "train_packed", "ckpt_train", "ckpt_serve", "native_train",
          "theory_phase", "serve_moe", "train_moe", "vlm_phase",
          "hybrid_phase", "rwkv_phase", "audio_phase", "ops_phase",
          "dist_phase", "dryrun_phase", "audit_phase", "autotune_phase",
          "time_kernels"]
HELPERS = ["_profile", "_wall_ms", "_event_averages", "_replay",
           "_replay_plain", "_step_gemms", "_backward_vs",
           "_gemms_vs_simulate", "_full_width_vs_simulate", "_vs_plain",
           "_engine_vs_plain", "_family_serve", "_train_cut",
           "_mesh_vs_flat", "_alternating_walls_ms", "_kernels_per_call",
           "sr_kernels_vs_plain", "_record_forwards", "_reduced_vs_simulate",
           "_carried_steps", "_variance_estimate_sd", "_theorem1_on_card",
           "_train_engine", "_ckpt_engine", "_dist_engine", "_prefill_logits",
           "_profile_decode", "_profile_paged_decode", "_stepwise",
           "_record_sampling_logits", "_explain_divergence",
           "kv_pairs_vs_plain", "time_sr", "sr_sweep", "time_kv",
           "time_train_kernels", "_autotune_case", "time_packed_kernels",
           "time_floor", "_time_ms", "_host_us"]

SECONDS = collections.defaultdict(float)
CALLS = collections.defaultdict(int)
CURRENT = ["-"]


def timed(name, fn, is_phase=False):
    """``fn`` with its seconds added under (the running phase, ``name``)."""
    @functools.wraps(fn)
    def call(*a, **kw):
        outer = CURRENT[0]
        if is_phase:
            CURRENT[0] = name
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            SECONDS[(CURRENT[0], name)] += time.perf_counter() - t0
            CALLS[(CURRENT[0], name)] += 1
            CURRENT[0] = outer
    return call


def main(argv) -> int:
    for name in PHASES:
        setattr(cs, name, timed(name, getattr(cs, name), True))
    for name in HELPERS:
        if hasattr(cs, name):
            setattr(cs, name, timed(name, getattr(cs, name)))
    from torch.profiler import profiler
    profiler.profile.__exit__ = timed("profile.__exit__",
                                      profiler.profile.__exit__)
    profiler.profile.key_averages = timed("profile.key_averages",
                                          profiler.profile.key_averages)
    t0 = time.perf_counter()
    rc = 1
    try:
        rc = cs.main(argv)
    finally:
        rows = sorted(((s, k[0], k[1], CALLS[k])
                       for k, s in SECONDS.items()), reverse=True)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "chip_smoke_times.json").write_text(json.dumps(
            [dict(seconds=s, phase=p, helper=h, calls=n)
             for s, p, h, n in rows], indent=0))
        print(f"[times] {time.perf_counter() - t0:.1f}s in all, rc {rc}",
              file=sys.stderr)
        for s, p, h, n in rows:
            if s > 1.0:
                print(f"[times] {s:8.1f}s {n:4d}x {p:24s} {h}",
                      file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
