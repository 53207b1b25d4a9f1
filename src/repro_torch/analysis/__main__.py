"""CLI: ``python -m repro_torch.analysis {audit|lint|kernels}``.

Port of ``python -m repro.analysis``'s ``audit``, ``lint`` and ``kernels``
subcommands.  Exit status is the contract: 0 = clean, 1 = violations.
Everything runs on the CPU, on the meta device: no card, no parameter
materialized.  Every subcommand accepts ``--format json`` for
machine-readable findings (rule id, path, severity); human text stays the
default.

  audit      quantization-contract audit of one or more configs under a
             policy, their GEMMs walked on the meta device; ``--selftest``
             additionally runs the mutation self-test (a deliberately
             leaked GEMM must turn the audit red); ``--step`` audits the
             full engine step.
  lint       AST rules RPR001-003 over src/repro_torch/{layers,models}
             and RPR002's kernel mode over src/repro_torch/kernels.
  kernels    static tile and split validation (shipped defaults +
             persisted tuning cache); ``--purge`` removes bad/stale
             persisted entries.
"""

from __future__ import annotations

import argparse
import json
import sys


def _build_policy(name: str, backend: str):
    from ..core import QuantPolicy
    factories = {
        "exact": lambda: QuantPolicy.exact(),
        "qat": lambda: QuantPolicy.qat(backend=backend),
        "fqt8": lambda: QuantPolicy.fqt("bhq", 8, backend=backend),
        "psq8": lambda: QuantPolicy.fqt("psq", 8, backend=backend),
        "bhq5": lambda: QuantPolicy.fqt("bhq", 5, backend=backend),
        "fqt4": lambda: QuantPolicy.fqt("bhq", 4, backend=backend),
        "fqt2": lambda: QuantPolicy.fqt("bhq", 2, backend=backend),
    }
    if name not in factories:
        raise SystemExit(f"unknown policy {name!r}; "
                         f"choose from {sorted(factories)}")
    return factories[name]()


def _configs(ns, default):
    from ..configs import ALL_NAMES
    configs = ns.config or default
    bad = [c for c in configs if c not in ALL_NAMES]
    if bad:
        raise SystemExit(f"unknown config(s) {bad}; choose from {ALL_NAMES}")
    return configs


def _emit(ns, doc: dict, text: str) -> None:
    if getattr(ns, "format", "text") == "json":
        print(json.dumps(doc, indent=2, default=str))
    else:
        print(text)


def _cmd_audit(ns) -> int:
    from ..configs import get_config
    from .audit import audit_model, audit_step, mutation_selftest

    policy = _build_policy(ns.policy, ns.backend)
    rc = 0
    reports, texts = [], []
    for name in _configs(ns, ["statquant-tx", "whisper-medium"]):
        cfg = get_config(name, smoke=not ns.full_size)
        if ns.step:
            report = audit_step(cfg, policy)
        else:
            report = audit_model(cfg, policy, grad=not ns.fwd_only)
        findings = (
            [{"rule": f"audit/{v.kind}", "severity": "error", "path": v.path,
              "role": v.role, "detail": v.detail} for v in report.violations]
            + [{"rule": "range", "severity": f.severity, "path": f.path,
                "role": f.role, "detail": f.detail}
               for f in report.range_findings if not f.ok])
        reports.append({"title": report.title, "ok": report.ok,
                        "findings": findings})
        texts.append(report.format(verbose=ns.verbose))
        if not report.ok:
            rc = 1
        if ns.selftest:
            result = mutation_selftest(cfg, policy)
            reports[-1]["selftest"] = {"ok": result.ok,
                                       "detail": result.detail}
            texts.append(f"== mutation self-test: {name} ==\n{result.detail}")
            if not result.ok:
                texts.append(result.mutated.format())
                rc = 1
    _emit(ns, {"tool": "audit", "ok": rc == 0, "reports": reports},
          "\n\n".join(texts))
    return rc


def _cmd_lint(ns) -> int:
    from .lint import lint_tree

    findings = lint_tree(ns.root or None)
    n = len(findings)
    doc = {"tool": "lint", "ok": not findings,
           "findings": [{"rule": f.rule, "severity": "error",
                         "path": f"{f.file}:{f.line}", "detail": f.message}
                        for f in findings]}
    text = "\n".join(str(f) for f in findings)
    text += ("\n" if text else "") + (f"lint: {n} finding(s)" if n
                                      else "lint: OK")
    _emit(ns, doc, text)
    return 1 if findings else 0


def _cmd_kernels(ns) -> int:
    from .kernels import check_kernels, purge_bad_entries

    report = check_kernels(ns.cache)
    text = report.format(verbose=ns.verbose)
    purged = None
    if ns.purge:
        purged = purge_bad_entries(report)
        text += (f"\npurged {purged} bad/stale cache "
                 f"entr{'y' if purged == 1 else 'ies'}")
    doc = {"tool": "kernels", "ok": report.ok,
           "findings": [{"rule": f"kernel/{f.severity}",
                         "severity": f.severity, "path": str(f.key),
                         "source": f.source, "detail": f.detail}
                        for f in report.findings],
           **({"purged": purged} if purged is not None else {})}
    _emit(ns, doc, text)
    return 0 if report.ok else 1


def _add_common(p, step_help: str):
    p.add_argument("--config", action="append",
                   help="arch config name (repeatable; default: the two "
                        "smoke configs statquant-tx + whisper-medium)")
    p.add_argument("--policy", default="fqt8",
                   choices=["exact", "qat", "fqt8", "psq8", "bhq5", "fqt4",
                            "fqt2"])
    p.add_argument("--backend", default="simulate",
                   choices=["simulate", "native", "kernel"])
    p.add_argument("--step", action="store_true", help=step_help)
    p.add_argument("--full-size", action="store_true",
                   help="use the full config instead of its smoke variant")
    p.add_argument("--format", default="text", choices=["text", "json"],
                   help="output format (json: rule id, path, severity)")
    p.add_argument("-v", "--verbose", action="store_true")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static analysis of the quantization contract: "
                    "contract audit, repo lint, kernel tile and split "
                    "validation.")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("audit", help="quantization-contract audit")
    _add_common(p, "audit the full engine step (loss+grad+optimizer)")
    p.add_argument("--selftest", action="store_true",
                   help="also run the mutation self-test")
    p.add_argument("--fwd-only", action="store_true",
                   help="trace the forward only (no gradient contract)")
    p.set_defaults(fn=_cmd_audit)

    p = sub.add_parser("lint", help="AST contract rules RPR001-003")
    p.add_argument("--root", action="append",
                   help="directory to lint (repeatable; default: "
                        "src/repro_torch/layers + src/repro_torch/models)")
    p.add_argument("--format", default="text", choices=["text", "json"])
    p.set_defaults(fn=_cmd_lint)

    p = sub.add_parser("kernels", help="static tile and split validation")
    p.add_argument("--cache", default=None,
                   help="tuning-cache path (default: "
                        "$REPRO_TORCH_TUNING_CACHE or "
                        "~/.cache/repro_torch/tuning.json)")
    p.add_argument("--purge", action="store_true",
                   help="remove bad/stale persisted entries")
    p.add_argument("--format", default="text", choices=["text", "json"])
    p.add_argument("-v", "--verbose", action="store_true")
    p.set_defaults(fn=_cmd_kernels)

    ns = parser.parse_args(argv)
    return ns.fn(ns)


if __name__ == "__main__":
    sys.exit(main())
