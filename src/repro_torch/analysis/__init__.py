"""``repro_torch.analysis`` — static verification of the quantization
contract and of the kernels' tile choices.

Port of ``repro.analysis``.  The quantization layer (core/fqt.py +
core/policy.py) promises "every linear-layer GEMM runs under the resolved
policy; everything else is declared full-precision".  Nothing at run time
*checks* that promise: a layer that silently calls ``torch.matmul``
trains fine, converges fine, and reports FQT numbers that are quietly
part-fp32.  This package closes the loop without running the model: it
runs it on the meta device, where nothing is computed.

  ``audit``    (:mod:`.audit`)  walk a step's GEMMs (:mod:`.graph`),
               attribute each through the ``q[path|role]``/``qfp``/``fp``
               markers, and diff against ``QuantPolicy.resolve`` and the
               ``fp_exempt`` registry; FLOP-weighted coverage; mutation
               self-test.
  ``ranges``   (:mod:`.ranges`)  int32-accumulator overflow bounds for
               intM x intN GEMMs (asymmetric widths), scale-degeneracy
               checks.
  ``kernels``  (:mod:`.kernels`) static validation of every tile and split
               choice (shipped defaults + the persisted tuning cache).
  ``tracing``  (:mod:`.tracing`) a guard on the work a step dispatches and
               an in-place-update check of the engine step.
  ``lint``     (:mod:`.lint`)    AST rules RPR001-003 over layers/models,
               RPR002's kernel mode over kernels/.

CLI: ``python -m repro_torch.analysis {audit|lint|kernels}`` (see
__main__.py); every subcommand accepts ``--format json`` and exits
non-zero on any violation.
"""

from .audit import (AuditReport, SelftestResult, Violation, audit_fn,
                    audit_model, audit_step, mutation_selftest)
from .graph import GemmSite, classify_stack, iter_gemm_sites, site_flops
from .kernels import KernelCheckReport, KernelFinding, check_kernels
from .lint import LintFinding, lint_file, lint_source, lint_tree
from .ranges import (RangeFinding, accumulator_bound, check_sites,
                     headroom_bits, max_safe_k, signed_code_bound)
from .tracing import (InplaceReport, RetraceGuard, check_inplace_update,
                      check_step_inplace)

__all__ = [
    "AuditReport", "Violation", "SelftestResult",
    "audit_fn", "audit_model", "audit_step", "mutation_selftest",
    "GemmSite", "iter_gemm_sites", "site_flops", "classify_stack",
    "RangeFinding", "check_sites", "accumulator_bound", "max_safe_k",
    "headroom_bits", "signed_code_bound",
    "KernelCheckReport", "KernelFinding", "check_kernels",
    "LintFinding", "lint_source", "lint_file", "lint_tree",
    "RetraceGuard", "InplaceReport", "check_inplace_update",
    "check_step_inplace",
]
