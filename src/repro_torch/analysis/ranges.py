"""Static numerics checks: int32 accumulator bounds + scale degeneracy.

Port of ``repro.analysis.ranges``.  The native and kernel backends
execute every quantized GEMM as an int8 x int8 -> int32 product
(``torch._int_mm``, the CUDA kernels' ``mma.sync``) over shifted-signed
codes ``c = codes - 2^(b-1)`` with ``codes in [0, 2^b-1]``
(core/backend.py).  The worst-case partial sum after contracting K
elements is therefore

    K * max|c_lhs| * max|c_rhs|  =  K * 2^(b_l - 1) * 2^(b_r - 1)

and the GEMM is overflow-safe iff that stays <= 2^31 - 1.  For int8 x int8
that gives K <= 131071 — comfortably above every shipped config, but int4
wgrad/agrad experiments (paper Sec. 5) and long-context MLPs can approach
it, and *nothing at runtime checks*: int32 accumulation wraps silently.
These bounds are pure functions of (K, bits) read off the walked GEMM
sites (analysis/graph.py), so the auditor enforces them on the meta
device, before anything runs.

The same module hosts the scale-degeneracy check the variance theory
assumes away: ``scale = B / max(R, _EPS)`` (core/quantizers.py) silently
maps a constant tensor (R = 0) to a single code, making the SR variance
``p(1-p)/S^2`` (Proposition 4, core/theory.py ``quantizer_variance``)
meaningless for that tensor.  ``check_scale_inputs`` flags ranges at the
``_EPS`` floor, where dequantization error is unbounded relative to R.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, List, Optional, Sequence, Tuple

from ..core.policy import QuantPolicy
from ..core.quantizers import _EPS, num_bins
from ..core.registry import get_quantizer
from .graph import GemmSite

__all__ = ["signed_code_bound", "accumulator_bound", "max_safe_k",
           "headroom_bits", "RangeFinding", "check_sites",
           "scale_is_degenerate", "check_scale_inputs"]

INT32_MAX = 2**31 - 1
_DTYPE_BITS = {"int8": 8, "uint8": 8, "int4": 4, "int2": 2, "int1": 1,
               "int16": 16, "int32": 32}


def signed_code_bound(bits: int) -> int:
    """max |c| over shifted-signed b-bit codes ``c = q - 2^(b-1)``,
    ``q in [0, 2^b - 1]`` — attained at q=0.

    Admits 1-bit (binary sign planes, bound 1): the packed weight kernels
    contract 1-bit codes against int8 activations, and their overflow
    check goes through the same bound (kernels/pack.max_safe_k_packed is
    the kernel-layer duplicate a tier-1 test pins to max_safe_k).
    """
    if not 1 <= bits <= 32:
        raise ValueError(f"bits={bits} out of range")
    return 1 << (bits - 1)


def accumulator_bound(k: int, lhs_bits: int, rhs_bits: int) -> int:
    """Worst-case |partial sum| after contracting K products of shifted
    lhs_bits x rhs_bits codes."""
    return k * signed_code_bound(lhs_bits) * signed_code_bound(rhs_bits)


def max_safe_k(lhs_bits: int, rhs_bits: int, acc_bits: int = 32) -> int:
    """Largest contraction K with no possible accumulator overflow.

    int8 x int8 -> int32: 131071.  int4 x int4 -> int32: ~33.5M.
    """
    acc_max = (1 << (acc_bits - 1)) - 1
    return acc_max // (signed_code_bound(lhs_bits)
                       * signed_code_bound(rhs_bits))


def headroom_bits(k: int, lhs_bits: int, rhs_bits: int,
                  acc_bits: int = 32) -> float:
    """log2(acc_max / worst-case bound): >0 safe, <0 can overflow."""
    acc_max = (1 << (acc_bits - 1)) - 1
    return math.log2(acc_max / accumulator_bound(k, lhs_bits, rhs_bits))


def scale_is_degenerate(dyn_range: float) -> bool:
    """True when ``scale = B / max(R, _EPS)`` hits the eps floor — the
    quantizer degenerates to one code and its variance model is void."""
    return dyn_range <= _EPS


def check_scale_inputs(ranges: Iterable[Tuple[str, float]]) -> List[str]:
    """Flag (name, dynamic-range) pairs whose scales are degenerate."""
    return [f"{name}: dynamic range {r:.3g} <= _EPS={_EPS:g}; scale is at "
            f"the eps floor and dequantization error is unbounded"
            for name, r in ranges if scale_is_degenerate(r)]


# ---------------------------------------------------------------------------
# Site-level checks (driven by the auditor)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RangeFinding:
    ok: bool
    severity: str           # "overflow" | "headroom" | "info"
    path: str
    role: Optional[str]
    k: int
    lhs_bits: int
    rhs_bits: int
    detail: str

    def __str__(self):
        tag = "OK" if self.ok else self.severity.upper()
        role = f"|{self.role}" if self.role else ""
        return (f"[range:{tag}] {self.path}{role} "
                f"K={self.k} {self.lhs_bits}x{self.rhs_bits}b: {self.detail}")


def _role_bits(policy: QuantPolicy, path: str,
               role: str) -> Optional[Tuple[int, int]]:
    """(lhs_bits, rhs_bits) of the integer GEMM executing ``role`` at
    ``path`` under ``policy``, or None when that role runs in fp.

    Per core/fqt.py: fwd = Q_f(X) @ Q_theta(W); wgrad = Q_f(X)^T @ Q_b1(dY);
    agrad = Q_b2(dY) @ Q_theta(W)^T.
    """
    if not policy.enabled:
        return None
    cfg = policy.resolve(path)
    if not cfg.quantize_fwd:
        return None
    if role == "fwd":
        return _spec_bits(cfg.fwd_act), _spec_bits(cfg.fwd_weight)
    if role == "wgrad":
        return None if cfg.wgrad is None else (_spec_bits(cfg.fwd_act),
                                               _spec_bits(cfg.wgrad))
    if role == "agrad":
        return None if cfg.agrad is None else (_spec_bits(cfg.agrad),
                                               _spec_bits(cfg.fwd_weight))
    return None


def _spec_bits(spec) -> int:
    """Effective bitwidth of a resolved spec: explicit bits, else the
    registered quantizer's ``default_bits`` (int4w=4, binary=1, ternary=2),
    else the repo-wide 8-bit default — so a ``binary`` weight role is
    range-checked at its true 1-bit bound, not a phantom 8."""
    if spec.bits is not None:
        return spec.bits
    try:
        q = get_quantizer(spec.name) if spec.name else None
    except ValueError:
        q = None
    default = getattr(q, "default_bits", None)
    return default if default is not None else 8


def _check_one(path: str, role: Optional[str], k: int, lb: int, rb: int,
               native: bool) -> RangeFinding:
    safe_k = max_safe_k(lb, rb)
    hr = headroom_bits(k, lb, rb)
    if k > safe_k:
        how = ("int32 accumulation WILL wrap for worst-case codes"
               if native else
               "would wrap if executed as a native int GEMM (currently "
               "simulated in fp32)")
        return RangeFinding(False, "overflow", path, role, k, lb, rb,
                            f"K={k} > max_safe_k={safe_k}; {how}")
    if hr < 1.0:
        return RangeFinding(True, "headroom", path, role, k, lb, rb,
                            f"only {hr:.2f} bits of int32 headroom "
                            f"(max_safe_k={safe_k})")
    return RangeFinding(True, "info", path, role, k, lb, rb,
                        f"{hr:.1f} bits of int32 headroom "
                        f"(max_safe_k={safe_k})")


def check_sites(sites: Sequence[GemmSite],
                policy: QuantPolicy) -> List[RangeFinding]:
    """Accumulator-overflow findings for every quantized GEMM site.

    Two passes per site:
      * **native dtype check** — the site already contracts integer codes
        (native and kernel backends): bound by the *stored* dtype.
      * **policy bits check** — the site is marked ``q[path|role]`` (any
        backend, including fp32 simulate): bound by the *policy* bitwidths
        (a packed weight role at its width), so a simulate walk still
        certifies the config would be safe run on int codes.  This is what catches
        int2/int4 configs before anyone spends card time on them.

    Only non-OK / low-headroom findings are returned, plus one info line
    for the worst-K quantized site so reports show the margin.
    """
    out: List[RangeFinding] = []
    worst: Optional[RangeFinding] = None
    for s in sites:
        checks: List[Tuple[int, int, bool]] = []
        if s.integer_gemm:
            lb = _DTYPE_BITS.get(s.lhs_dtype)
            rb = _DTYPE_BITS.get(s.rhs_dtype)
            if lb and rb and lb <= 16 and rb <= 16:
                checks.append((lb, rb, True))
        if s.kind == "quantized" and s.path and s.role:
            bits = _role_bits(policy, s.path, s.role)
            if bits is not None:
                checks.append((bits[0], bits[1], False))
        for lb, rb, native in checks:
            f = _check_one(s.path or "?", s.role, s.contract, lb, rb, native)
            if not f.ok or f.severity == "headroom":
                out.append(f)
            elif worst is None or f.k * 2 ** (f.lhs_bits + f.rhs_bits) > (
                    worst.k * 2 ** (worst.lhs_bits + worst.rhs_bits)):
                worst = f
    if worst is not None:
        out.append(worst)
    return out


def cross_check_variance_assumption(bits: int) -> Tuple[int, int]:
    """(num_bins, signed_code_bound) — ties the range model to the
    variance theory's bin count: codes span [0, B] with B = 2^b - 1
    (core/theory.py Proposition 4 machinery), so the shifted-signed bound
    is exactly (B + 1) / 2."""
    b = num_bins(bits)
    bound = signed_code_bound(bits)
    assert bound == (b + 1) // 2
    return b, bound
