"""Roofline terms of a step on the H100.

Port of ``repro.launch.roofline``.  Per (arch x shape x mesh) cell:

  compute    = GEMM FLOPs per rank       / peak FLOP/s of the backend
  memory     = bytes per rank            / HBM bandwidth
  collective = collective bytes per rank / link bandwidth

and the step's lower bound is the largest.  The dry run's bytes for the
memory term are the least a rank must move (each input read once, each
updated state written once); its unfused count, every operand and result
of every operation, bounds the traffic from above and is reported apart
(``memory_s_unfused``), outside the bound.

The counts come from the dry run (``launch/dryrun.py``): the port's own
step on the meta device, one rank of the mesh, every operation and
collective counted as it dispatches.  So the reference's HLO parse has no
counterpart here: :func:`collective_bytes` sums the collectives the port
issued.

The peaks are NVIDIA's published dense rates of one H100 SXM (the data
sheet, no sparsity), at the 700 W power limit they assume (``HW``).  A
card set below 700 W reaches less; a share of a bound names the card's
limit beside it.  :func:`peak_for_backend` maps a ``QuantPolicy.backend``
to its denominator: ``kernel`` and ``native`` run their GEMMs on int8
codes on the tensor cores; ``simulate`` and ``exact`` run float32
matmuls, and with TF32 off (PyTorch's default for matmuls) those run
outside the tensor cores.  This is the denominator a step's ``mfu`` and a
kernel's share of its bound take.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

__all__ = ["HW", "COLLECTIVES", "collective_bytes", "roofline_terms",
           "model_flops", "peak_for_backend"]

# NVIDIA H100 SXM, dense peaks at a 700 W power limit
HW = {
    "name": "NVIDIA H100 SXM",
    "power_limit_w": 700.0,
    "peak_bf16": 989e12,      # FLOP/s, tensor cores
    "peak_int8": 1979e12,     # OP/s, tensor cores
    "peak_fp32": 67e12,       # FLOP/s, outside the tensor cores
    "hbm_bw": 3.35e12,        # B/s
    "link_bw": 450e9,         # B/s, NVLink, each way
}

# the collective families, as the reference names them
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def collective_bytes(calls: Iterable[Tuple[str, int]]) -> Dict[str, object]:
    """Per-rank bytes of each collective family over ``calls``, ``(family,
    bytes)`` of every collective the rank issued, plus ``total`` and
    ``counts``.  As in the reference, a call's bytes are its result's:
    the reduced tensor of an all-reduce, the gathered one of an
    all-gather (an upper bound of the wire bytes), the scattered one of a
    reduce-scatter (a lower bound)."""
    out = {k: 0 for k in COLLECTIVES}
    counts = {k: 0 for k in COLLECTIVES}
    for family, nbytes in calls:
        if family not in out:
            raise ValueError(f"unknown collective family {family!r}")
        out[family] += int(nbytes)
        counts[family] += 1
    out["total"] = sum(out[k] for k in COLLECTIVES)
    out["counts"] = counts
    return out


def model_flops(n_params: int, n_tokens: int, kind: str,
                active_frac: float = 1.0) -> float:
    """The 6ND (train) / 2ND (forward) 'useful flops' yardstick.

    n_params: total matmul-visible params; active_frac: the MoE share of
    parameters a token uses (top-k / E on the experts)."""
    per_tok = 6.0 if kind == "train" else 2.0
    return per_tok * n_params * active_frac * n_tokens


def peak_for_backend(backend: str) -> float:
    """The H100's peak for a ``QuantPolicy.backend``: int8 for ``kernel``
    and ``native``, float32 outside the tensor cores for ``simulate`` and
    ``exact``."""
    if backend in ("kernel", "native"):
        return HW["peak_int8"]
    if backend in ("simulate", "exact"):
        return HW["peak_fp32"]
    raise ValueError(f"unknown backend {backend!r}")


def roofline_terms(flops: float, bytes_accessed: float, coll_bytes: int,
                   int8: bool = True, backend: str | None = None,
                   unfused_bytes: float | None = None) -> dict:
    """The three lower bounds of a step's time and the largest: compute
    at the backend's peak (or int8 / bf16 by ``int8``), memory at the HBM
    rate, collectives at the link rate; ``compute_s_bf16peak`` is the
    compute term at the bf16 peak.  ``unfused_bytes`` (an upper bound of
    the traffic) gives ``memory_s_unfused``, which bounds nothing."""
    if backend is not None:
        peak = peak_for_backend(backend)
    else:
        peak = HW["peak_int8"] if int8 else HW["peak_bf16"]
    t_c = flops / peak
    t_m = bytes_accessed / HW["hbm_bw"]
    t_n = coll_bytes / HW["link_bw"]
    terms = {"compute_s": t_c, "memory_s": t_m, "collective_s": t_n,
             "compute_s_bf16peak": flops / HW["peak_bf16"]}
    dom = max(("compute_s", t_c), ("memory_s", t_m), ("collective_s", t_n),
              key=lambda kv: kv[1])
    terms["bottleneck"] = dom[0].replace("_s", "")
    terms["step_time_lb_s"] = dom[1]
    if unfused_bytes is not None:
        terms["memory_s_unfused"] = unfused_bytes / HW["hbm_bw"]
    return terms
