"""Quantization-contract auditor: does the walked step run the policy?

Port of ``repro.analysis.audit``.  Runs a model's loss (and, by default,
its gradient: the Eq. 6 backward GEMMs are where FQT lives) once on the
meta device under the GEMM-site walker (analysis/graph.py) and diffs what
the step *actually dispatches* against what ``QuantPolicy.resolve(path)``
*declares* for every path in ``model_quant_paths(cfg)``:

  * an unmarked GEMM (no ``q[..]``/``qfp[..]``/``fp[..]`` marker) is a
    **leak** — a matmul outside both the FQT primitive and the declared
    exemption registry (core/exempt.py);
  * a declared path whose marker is missing means the layer stopped
    routing through ``fqt_matmul`` — the audit names the path;
  * a path quantized in the step but resolved exact (or vice versa) is a
    **contract mismatch**;
  * a marked path absent from ``model_quant_paths`` means the enumeration
    drifted from the model code.

The report carries FLOP-weighted coverage (fraction of non-exempt GEMM
FLOPs under the quantized contract, and a per-role breakdown) plus the
int32-accumulator range findings (analysis/ranges.py).

``mutation_selftest`` proves the auditor has teeth: it monkeypatches one
MLP ``dense`` call to a raw ``torch.matmul`` and asserts the audit turns
red naming that path, while the unmutated model audits clean at 100%
coverage.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .. import prng
from ..configs.base import ArchConfig, ShapeSpec
from ..core import QuantPolicy, exemption_registry
from ..models.api import build_model, model_quant_paths
from .graph import GemmSite, iter_gemm_sites
from .ranges import RangeFinding, check_sites

__all__ = ["Violation", "AuditReport", "audit_fn", "audit_model",
           "audit_step", "mutation_selftest", "SelftestResult"]


@dataclasses.dataclass(frozen=True)
class Violation:
    kind: str        # "unmarked-gemm"|"declared-missing"|"contract-mismatch"
                     # |"undeclared-path"
    path: str        # layer path ("?" for unmarked GEMMs)
    role: Optional[str]
    detail: str

    def __str__(self):
        role = f" role={self.role}" if self.role else ""
        return f"[{self.kind}] path={self.path!r}{role}: {self.detail}"


@dataclasses.dataclass(frozen=True)
class AuditReport:
    title: str
    sites: Tuple[GemmSite, ...]
    violations: Tuple[Violation, ...]
    range_findings: Tuple[RangeFinding, ...]
    exemptions: Dict[str, str]            # path -> reason (used in this walk)

    @property
    def ok(self) -> bool:
        return not self.violations and all(f.ok for f in self.range_findings)

    # -- coverage ---------------------------------------------------------
    def flops(self, kind: Optional[str] = None) -> float:
        return math.fsum(s.flops for s in self.sites
                         if kind is None or s.kind == kind)

    @property
    def coverage(self) -> float:
        """Quantized fraction of non-exempt GEMM FLOPs (1.0 = everything the
        policy could quantize is quantized)."""
        denom = self.flops() - self.flops("exempt")
        if denom <= 0:
            return 1.0
        return self.flops("quantized") / denom

    def role_flops(self) -> Dict[str, Dict[str, float]]:
        """{role: {"quantized": flops, "policy_fp": flops}}."""
        out: Dict[str, Dict[str, float]] = {}
        for s in self.sites:
            if s.role is None:
                continue
            bucket = out.setdefault(s.role, {"quantized": 0.0,
                                             "policy_fp": 0.0})
            if s.kind in bucket:
                bucket[s.kind] += s.flops
        return out

    # -- rendering --------------------------------------------------------
    def format(self, verbose: bool = False) -> str:
        lines = [f"== audit: {self.title} =="]
        n_by_kind: Dict[str, int] = {}
        for s in self.sites:
            n_by_kind[s.kind] = n_by_kind.get(s.kind, 0) + 1
        total = self.flops()
        lines.append(
            f"GEMMs: {len(self.sites)} "
            f"({', '.join(f'{k}={v}' for k, v in sorted(n_by_kind.items()))})"
            f"; total {total:.3g} FLOPs")
        lines.append(f"coverage: {100.0 * self.coverage:.1f}% of non-exempt "
                     f"GEMM FLOPs quantized")
        for role, fl in sorted(self.role_flops().items()):
            q, fp = fl["quantized"], fl["policy_fp"]
            pct = 100.0 * q / (q + fp) if q + fp else 0.0
            lines.append(f"  role {role:<6}: {pct:5.1f}% quantized "
                         f"({q:.3g} q / {fp:.3g} fp FLOPs)")
        if self.exemptions:
            lines.append(f"exempt paths ({len(self.exemptions)}):")
            for path, reason in sorted(self.exemptions.items()):
                fl = math.fsum(s.flops for s in self.sites
                               if s.kind == "exempt" and s.path == path)
                lines.append(f"  fp[{path}] ({fl:.3g} FLOPs): {reason}")
        for f in self.range_findings:
            if not f.ok or verbose:
                lines.append(f"  {f}")
        if self.violations:
            lines.append(f"VIOLATIONS ({len(self.violations)}):")
            lines.extend(f"  {v}" for v in self.violations)
        else:
            lines.append("contract: OK")
        return "\n".join(lines)


def _expected_roles(policy: QuantPolicy, path: str,
                    grad: bool) -> Dict[str, bool]:
    """{role: quantized?} the resolved policy declares for ``path``.

    A non-quantized forward (exact pin / disabled policy) emits a single
    ``qfp[path|fwd]`` marker that also scopes the autograd backward, so
    no wgrad/agrad markers are expected there.
    """
    cfg = policy.resolve(path) if policy.enabled else None
    fwd_q = bool(cfg is not None and cfg.quantize_fwd)
    expected = {"fwd": fwd_q}
    if grad and fwd_q:
        expected["wgrad"] = cfg.wgrad is not None
        expected["agrad"] = cfg.agrad is not None
    return expected


def audit_fn(fn, args, *, policy: QuantPolicy, paths: Sequence[str],
             grad_traced: bool = True, title: str = "fn") -> AuditReport:
    """Walk ``fn(*args)`` (give it meta-device tensors) and audit it.

    ``paths`` is the declared GEMM enumeration (``model_quant_paths``);
    ``grad_traced`` says whether ``fn`` runs the backward pass (so the
    wgrad/agrad contract is enforceable).
    """
    sites = iter_gemm_sites(fn, *args)
    registry = exemption_registry()
    violations: List[Violation] = []

    # 1) leaks: GEMMs under no marker at all
    for s in sites:
        if s.kind == "unmarked":
            violations.append(Violation(
                "unmarked-gemm", "?", None,
                f"{s.primitive} ({s.flops:.3g} FLOPs, K={s.contract}) at "
                f"{s.src} runs outside fqt_matmul and outside any "
                f"fp_exempt(...) block [stack: {s.stack or '<empty>'}]"))
        elif s.kind == "exempt" and s.path not in registry:
            violations.append(Violation(
                "undeclared-path", s.path or "?", None,
                f"fp[{s.path}] marker at {s.src} has no entry in the "
                f"exemption registry"))

    # 2) two-way diff of declared paths vs markers in the walk
    seen: Dict[Tuple[str, str], set] = {}
    for s in sites:
        if s.kind in ("quantized", "policy_fp") and s.role is not None:
            seen.setdefault((s.path, s.role), set()).add(s.kind)

    declared = tuple(dict.fromkeys(paths))
    for path in declared:
        for role, want_q in _expected_roles(policy, path,
                                            grad_traced).items():
            kinds = seen.pop((path, role), None)
            want = "quantized" if want_q else "policy_fp"
            if kinds is None:
                violations.append(Violation(
                    "declared-missing", path, role,
                    f"policy resolves this GEMM as {want} but no "
                    f"{'q' if want_q else 'qfp'}[{path}|{role}] marker "
                    f"appears in the walked step — the layer no longer "
                    f"routes through fqt_matmul"))
            elif want not in kinds:
                got = ", ".join(sorted(kinds))
                violations.append(Violation(
                    "contract-mismatch", path, role,
                    f"policy resolves {want} but the step runs {got}"))
    for (path, role), kinds in sorted(seen.items()):
        violations.append(Violation(
            "undeclared-path", path, role,
            f"marker {sorted(kinds)} in the step but the path is not in "
            f"model_quant_paths — the enumeration drifted from the model"))

    used_exempt = {p: registry[p] for p in
                   {s.path for s in sites if s.kind == "exempt"}
                   if p in registry}
    findings = check_sites(sites, policy)
    return AuditReport(title=title, sites=sites,
                       violations=tuple(violations),
                       range_findings=tuple(findings),
                       exemptions=used_exempt)


# ---------------------------------------------------------------------------
# Model-level entry points
# ---------------------------------------------------------------------------

def _loss_args(model, batch_size: int, seq_len: int):
    """(meta params, meta batch) for walking model.loss."""
    spec = ShapeSpec("audit", seq_len, batch_size, "train")
    batch = model.input_specs(spec)["batch"]
    return model.init(0, device="meta"), batch


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def audit_model(cfg: ArchConfig, policy: QuantPolicy, *, grad: bool = True,
                batch_size: int = 2, seq_len: int = 8,
                title: Optional[str] = None) -> AuditReport:
    """Audit ``cfg``'s training step (loss forward, plus backward when
    ``grad``) under ``policy``.  On the meta device: no parameter is
    materialized, nothing is computed."""
    model = build_model(cfg)
    params, batch = _loss_args(model, batch_size, seq_len)
    key = prng.PRNGKey(0)

    def run(p, b):
        with torch.enable_grad():
            leaves = [x.requires_grad_() for x in _leaves(p)]
            loss, _ = model.loss(p, b, key, policy)
            if grad:
                torch.autograd.grad(loss, leaves, allow_unused=True)

    return audit_fn(run, (params, batch), policy=policy,
                    paths=model_quant_paths(cfg), grad_traced=grad,
                    title=title or f"{cfg.name} [{policy.backend}"
                                   f"{'' if grad else ', fwd-only'}]")


def audit_step(cfg: ArchConfig, policy: QuantPolicy, *, batch_size: int = 2,
               seq_len: int = 8, accum_steps: int = 1,
               title: Optional[str] = None) -> AuditReport:
    """Audit a *full engine step* (engine/step.py ``make_step_fn``): loss,
    gradients, clipping and the AdamW update, on the meta device."""
    from ..engine import abstract_train_state, make_step_fn
    from ..optim import adamw, cosine_schedule

    model = build_model(cfg)
    opt = adamw()
    step_fn = make_step_fn(model, policy, opt, cosine_schedule(1e-3, 10),
                           remat=False, accum_steps=accum_steps)
    _, batch = _loss_args(model, batch_size, seq_len)
    state = abstract_train_state(model, opt)
    return audit_fn(step_fn, (state, batch), policy=policy,
                    paths=model_quant_paths(cfg), grad_traced=True,
                    title=title or f"{cfg.name} engine step "
                                   f"[{policy.backend}, accum={accum_steps}]")


# ---------------------------------------------------------------------------
# Mutation self-test
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SelftestResult:
    ok: bool
    target_path: str
    clean: AuditReport
    mutated: AuditReport
    detail: str


def mutation_selftest(cfg: ArchConfig, policy: QuantPolicy,
                      target: Optional[str] = None) -> SelftestResult:
    """Swap one MLP ``dense`` call for a raw ``torch.matmul`` and verify
    the audit (a) fails naming the leaked path and (b) passes clean at
    100% coverage on the unmutated model."""
    # `repro_torch.layers.mlp` the *module*: the package re-exports a
    # function under the same name
    mlp_mod = importlib.import_module(
        ".layers.mlp", package=__package__.rsplit(".", 1)[0])

    paths = model_quant_paths(cfg)
    if target is None:
        target = next((p for p in paths if ".mlp." in p or ".expert." in p),
                      paths[0])

    real_dense = mlp_mod.dense

    def leaky_dense(p, x, key, policy, tag=0, path=""):
        if path == target:
            return torch.matmul(x, p["w"])     # raw, unmarked, unquantized
        return real_dense(p, x, key, policy, tag, path)

    mlp_mod.dense = leaky_dense
    try:
        mutated = audit_model(cfg, policy,
                              title=f"{cfg.name} MUTATED({target})")
    finally:
        mlp_mod.dense = real_dense
    clean = audit_model(cfg, policy)

    names_path = any(v.path == target for v in mutated.violations)
    leaks = any(v.kind == "unmarked-gemm" for v in mutated.violations)
    problems = []
    if mutated.ok:
        problems.append("mutated model audited green")
    if not names_path:
        problems.append(f"no violation names the leaked path {target!r}")
    if not leaks:
        problems.append("raw torch.matmul not reported as an unmarked GEMM")
    if not clean.ok:
        problems.append("unmutated model audited red")
    if clean.coverage < 1.0:
        problems.append(f"clean coverage {100 * clean.coverage:.1f}% < 100%")
    ok = not problems
    detail = ("mutation self-test OK: audit turns red naming "
              f"{target!r} and recovers green at 100% coverage"
              if ok else "; ".join(problems))
    return SelftestResult(ok=ok, target_path=target, clean=clean,
                          mutated=mutated, detail=detail)
