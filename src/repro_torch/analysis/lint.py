"""Repo lint rules for the quantization contract (AST-level, no imports).

Port of ``repro.analysis.lint``.  Three rules, scoped to
``src/repro_torch/layers/`` and ``src/repro_torch/models/`` — the code
that is supposed to route every linear-layer GEMM through ``fqt_matmul``
and declare everything else with ``fp_exempt``:

  **RPR001**  ``dense(...)`` / ``fqt_matmul(...)`` called without a layer
              ``path``.  A pathless call resolves against the policy
              default only — per-layer overrides silently stop matching
              and the auditor cannot attribute the GEMM.

  **RPR002**  raw GEMM (``matmul`` / ``mm`` / ``bmm`` / ``einsum`` /
              ``linear`` / ``baddbmm`` / ``addmm`` / ``tensordot`` call,
              or the ``@`` operator) not lexically inside a
              ``with fp_exempt(...)`` block.  This is the *static* half of
              the leak check the auditor enforces on the walked step —
              it fires on code paths no smoke-config walk reaches
              (decode steps, rare branches).

  **RPR003**  ``fp_exempt(path, reason)`` called with non-literal
              arguments.  The registry and the markers are trace-time
              static strings; a computed path would make the audit
              nondeterministic and the exemption table unreadable.

RPR002 also runs in **kernel mode** over ``src/repro_torch/kernels/``
(the plain versions beside the CUDA kernels): there a code GEMM must
state its int32 accumulation, ``torch._int_mm`` or a GEMM whose every
operand is converted to ``torch.int32`` in the call (int32 accumulation
is the quantization contract at the kernel layer — an implicit
accumulator dtype is exactly how a sub-byte code GEMM silently widens to
a float and loses bit-exactness), and the ``@`` operator is banned
outright.

The linter is syntactic by design: it never imports the modules it
checks, so it runs before any PyTorch initialization and on files that
do not import cleanly.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

__all__ = ["LintFinding", "lint_source", "lint_file", "lint_tree",
           "default_roots", "kernel_default_roots", "GEMM_CALLS"]

GEMM_CALLS = ("matmul", "mm", "bmm", "einsum", "linear", "baddbmm",
              "addmm", "tensordot")

# call name -> index of the positional `path` argument
_PATHED_CALLS = {"dense": 5, "fqt_matmul": 4}


@dataclasses.dataclass(frozen=True)
class LintFinding:
    file: str
    line: int
    rule: str
    message: str

    def __str__(self):
        return f"{self.file}:{self.line}: {self.rule} {self.message}"


def _call_name(func) -> Optional[str]:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _is_fp_exempt(node) -> bool:
    return (isinstance(node, ast.Call)
            and _call_name(node.func) == "fp_exempt")


def _str_literal(node) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    # implicit concatenation of string literals parses as a Constant
    # already; a JoinedStr (f-string) is NOT static
    return None


class _Checker(ast.NodeVisitor):
    def __init__(self, file: str):
        self.file = file
        self.findings: List[LintFinding] = []
        self._exempt_depth = 0

    def _emit(self, node, rule: str, message: str) -> None:
        self.findings.append(
            LintFinding(self.file, node.lineno, rule, message))

    # -- with fp_exempt(...) lexical scoping ----------------------------
    def visit_With(self, node: ast.With) -> None:
        exempting = any(_is_fp_exempt(item.context_expr)
                        for item in node.items)
        for item in node.items:
            if _is_fp_exempt(item.context_expr):
                self._check_rpr003(item.context_expr)
                # arguments of fp_exempt itself are not exempt code
                self.generic_visit(item.context_expr)
        if exempting:
            self._exempt_depth += 1
        for stmt in node.body:
            self.visit(stmt)
        if exempting:
            self._exempt_depth -= 1
        for item in node.items:
            if not _is_fp_exempt(item.context_expr):
                self.visit(item.context_expr)
            if item.optional_vars is not None:
                self.visit(item.optional_vars)

    visit_AsyncWith = visit_With

    # -- calls -----------------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        name = _call_name(node.func)
        if name in _PATHED_CALLS:
            self._check_rpr001(node, name, _PATHED_CALLS[name])
        elif name in GEMM_CALLS and not self._exempt_depth:
            self._emit(node, "RPR002",
                       f"raw GEMM `{name}(...)` outside any "
                       f"`with fp_exempt(path, reason):` block; route it "
                       f"through fqt_matmul or declare the exemption")
        elif name == "fp_exempt":
            # bare call (not as a context manager) still registers: check
            self._check_rpr003(node)
        self.generic_visit(node)

    def visit_BinOp(self, node: ast.BinOp) -> None:
        if isinstance(node.op, ast.MatMult) and not self._exempt_depth:
            self._emit(node, "RPR002",
                       "raw GEMM `@` outside any `with fp_exempt(path, "
                       "reason):` block; route it through fqt_matmul or "
                       "declare the exemption")
        self.generic_visit(node)

    # -- rules -----------------------------------------------------------
    def _check_rpr001(self, node: ast.Call, name: str, idx: int) -> None:
        path_arg = None
        for kw in node.keywords:
            if kw.arg == "path":
                path_arg = kw.value
            elif kw.arg is None:        # **kwargs: cannot see inside; pass
                return
        if path_arg is None and len(node.args) > idx:
            path_arg = node.args[idx]
        if path_arg is None:
            self._emit(node, "RPR001",
                       f"`{name}(...)` without a layer `path`; pathless "
                       f"GEMMs only match the policy defaults and the "
                       f"auditor cannot attribute them")
        elif _str_literal(path_arg) == "":
            self._emit(node, "RPR001",
                       f"`{name}(...)` with an empty `path` literal")

    def _check_rpr003(self, node: ast.Call) -> None:
        args = list(node.args) + [kw.value for kw in node.keywords
                                  if kw.arg in ("path", "reason")]
        if len(node.args) + len(node.keywords) < 2:
            self._emit(node, "RPR003",
                       "`fp_exempt(...)` needs both a path and a reason")
            return
        for arg in args:
            if _str_literal(arg) is None and not (
                    isinstance(arg, ast.Name) and arg.id.isupper()):
                # allow module-level UPPER_CASE constants (shared reasons)
                self._emit(node, "RPR003",
                           "`fp_exempt(...)` arguments must be string "
                           "literals (or UPPER_CASE module constants) so "
                           "the exemption registry is static")
                return


def _int32_operand(node) -> bool:
    """``x.to(torch.int32)`` / ``x.to(dtype=torch.int32)`` / ``x.int()``."""
    if not (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)):
        return False
    if node.func.attr == "int" and not node.args:
        return True
    if node.func.attr != "to":
        return False
    args = list(node.args) + [kw.value for kw in node.keywords
                              if kw.arg == "dtype"]
    return any(_call_name(a) == "int32" for a in args)


class _KernelChecker(ast.NodeVisitor):
    """RPR002 kernel mode (see module docstring)."""

    def __init__(self, file: str):
        self.file = file
        self.findings: List[LintFinding] = []

    def _emit(self, node, rule: str, message: str) -> None:
        self.findings.append(
            LintFinding(self.file, node.lineno, rule, message))

    def visit_Call(self, node: ast.Call) -> None:
        name = _call_name(node.func)
        if name in GEMM_CALLS:
            operands = [a for a in node.args
                        if not (isinstance(a, ast.Constant)
                                and isinstance(a.value, str))]
            if not operands or not all(_int32_operand(a) for a in operands):
                self._emit(node, "RPR002",
                           f"kernel-layer GEMM `{name}(...)` without int32 "
                           f"accumulation stated; contract codes through "
                           f"torch._int_mm (kernels/codes.py) or int32 "
                           f"operands")
        self.generic_visit(node)

    def visit_BinOp(self, node: ast.BinOp) -> None:
        if isinstance(node.op, ast.MatMult):
            self._emit(node, "RPR002",
                       "`@` operator in a kernel module; contract codes "
                       "through torch._int_mm (kernels/codes.py)")
        self.generic_visit(node)


def lint_source(source: str, file: str = "<string>",
                mode: str = "contract") -> List[LintFinding]:
    try:
        tree = ast.parse(source, filename=file)
    except SyntaxError as e:
        return [LintFinding(file, e.lineno or 0, "RPR000",
                            f"syntax error: {e.msg}")]
    checker = _KernelChecker(file) if mode == "kernel" else _Checker(file)
    checker.visit(tree)
    return checker.findings


def lint_file(path: str, mode: str = "contract") -> List[LintFinding]:
    with open(path, encoding="utf-8") as f:
        return lint_source(f.read(), path, mode)


def default_roots() -> Tuple[str, ...]:
    """The directories the contract rules apply to."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return (os.path.join(pkg, "layers"), os.path.join(pkg, "models"))


def kernel_default_roots() -> Tuple[str, ...]:
    """The directories the kernel-mode RPR002 rule applies to."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return (os.path.join(pkg, "kernels"),)


def _walk(roots: Sequence[str]) -> List[str]:
    paths: List[str] = []
    for root in roots:
        for dirpath, _dirnames, filenames in sorted(os.walk(root)):
            paths.extend(os.path.join(dirpath, fn) for fn in sorted(filenames)
                         if fn.endswith(".py"))
    return paths


def lint_tree(roots: Optional[Sequence[str]] = None,
              kernel_roots: Optional[Sequence[str]] = None
              ) -> List[LintFinding]:
    findings: List[LintFinding] = []
    for p in _walk(roots or default_roots()):
        findings.extend(lint_file(p))
    for p in _walk(kernel_default_roots()
                   if kernel_roots is None else kernel_roots):
        findings.extend(lint_file(p, mode="kernel"))
    return findings
