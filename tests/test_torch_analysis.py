"""``repro_torch.analysis``: the contract auditor, the GEMM-site walker,
the range analysis, the step guards, lint and the CLI, on the CPU.

Counterparts of ``tests/test_analysis.py``, each held as the reference's
is (the audit clean on every backend, ``exact`` and QAT, the families,
the engine step, the mutation self-test, each ``audit_fn`` violation
kind, the bounds against real int32 wrap-around — here through
``torch._int_mm`` — each lint rule and the CLI's JSON), and parity with
the JAX package, exactly: the port's GEMM sites, as a multiset of (kind,
path, role, FLOPs, K), against the reference's ``iter_gemm_sites`` over
the same config's loss and gradient, its coverage and ``role_flops``;
``check_sites``' findings against the reference's on those sites; and
``ranges``' functions against the reference's over a grid of K and bits.
The reference scans its layers (a site's ``mult`` is the depth) and
vmaps its experts (one batched GEMM of E experts); the port runs each
layer and expert as its own GEMM, so a reference site is held as
``mult`` (times E for an expert path) sites of its share of the FLOPs.
"""

import collections
import dataclasses
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import audit_model as jax_audit_model  # noqa: E402
from repro.analysis import ranges as jranges  # noqa: E402
from repro.analysis.ranges import check_sites as jax_check_sites  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import QuantPolicy as JaxPolicy  # noqa: E402
from repro_torch.analysis import (RetraceGuard, audit_fn,  # noqa: E402
                                  audit_model, audit_step,
                                  check_inplace_update, iter_gemm_sites,
                                  lint_source, lint_tree, mutation_selftest)
from repro_torch.analysis import ranges  # noqa: E402
from repro_torch.analysis.graph import GemmSite  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import QuantPolicy, fp_exempt, quant_scope  # noqa: E402
from repro_torch.kernels.pack import max_safe_k_packed  # noqa: E402
from repro_torch.optim import tree_leaves  # noqa: E402
from torch_one_thread import one_intra_op_thread  # noqa: E402,F401

FQT8 = QuantPolicy.fqt("bhq", 8)


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# Parity with the reference's walk
# ---------------------------------------------------------------------------

PARITY = [("statquant-tx", "psq", 8), ("statquant-tx", "bhq", 5),
          ("olmoe-1b-7b", "bhq", 8),
          pytest.param("whisper-medium", "bhq", 8, marks=pytest.mark.slow)]


@functools.lru_cache(maxsize=None)
def _audits(arch, quant, bits):
    """(reference report, port report) of the reduced config's loss and
    gradient under fqt(quant, bits) on simulate."""
    ref = jax_audit_model(jax_config(arch, smoke=True),
                          JaxPolicy.fqt(quant, bits))
    port = audit_model(get_config(arch, smoke=True),
                       QuantPolicy.fqt(quant, bits))
    return ref, port


def _ref_sites(report, experts):
    out = collections.Counter()
    for s in report.sites:
        n = s.mult * (experts if s.path and ".moe.expert." in s.path else 1)
        out[s.kind, s.path, s.role, s.flops / n, s.contract] += n
    return out


@pytest.mark.parametrize("arch,quant,bits", PARITY)
def test_gemm_sites_equal_the_references(arch, quant, bits):
    ref, port = _audits(arch, quant, bits)
    experts = get_config(arch, smoke=True).moe_experts or 1
    got = collections.Counter((s.kind, s.path, s.role, s.flops, s.contract)
                              for s in port.sites)
    assert got == _ref_sites(ref, experts)
    assert port.role_flops() == ref.role_flops()
    assert port.coverage == ref.coverage == 1.0
    assert port.ok and ref.ok
    assert port.exemptions == ref.exemptions


def _finding(f):
    return (f.ok, f.severity, f.path, f.role, f.k, f.lhs_bits, f.rhs_bits,
            f.detail)


@pytest.mark.parametrize("weight_bits", [8, 4, 2])
@pytest.mark.parametrize("arch,quant,bits", PARITY[:3])
def test_check_sites_findings_equal_the_references(arch, quant, bits,
                                                   weight_bits):
    """The range findings on the same sites: under the walked policy and
    under narrower weights (W4A8, W2A8), where the reference's policy bits
    bound each role."""
    ref, port = _audits(arch, quant, bits)
    pol = QuantPolicy.fqt(quant, bits, weight_bits=weight_bits)
    jpol = JaxPolicy.fqt(quant, bits, weight_bits=weight_bits)
    got = sorted(map(_finding, ranges.check_sites(port.sites, pol)))
    want = sorted(map(_finding, jax_check_sites(ref.sites, jpol)))
    assert got == want and got


def test_check_sites_on_int8_sites_equal_the_references():
    """Sites that contract int8 codes (native, kernel): the stored-dtype
    bound as well as the policy's, over and under max_safe_k."""
    sites = []
    for k in (512, ranges.max_safe_k(8, 8), ranges.max_safe_k(8, 8) + 1):
        for dt in ("int8", "float32"):
            sites.append(dict(primitive="dot_general", flops=2.0 * k,
                              contract=k, mult=1, lhs_dtype=dt, rhs_dtype=dt,
                              stack="q[layers.mlp.fc1|agrad]",
                              kind="quantized", path="layers.mlp.fc1",
                              role="agrad", src="t", m=2, n=2))
    from repro.analysis import GemmSite as JaxSite
    got = ranges.check_sites([GemmSite(**s) for s in sites], FQT8)
    want = jax_check_sites([JaxSite(**s) for s in sites],
                           JaxPolicy.fqt("bhq", 8))
    assert sorted(map(_finding, got)) == sorted(map(_finding, want))
    assert any(not f.ok for f in got)


def test_ranges_functions_equal_the_references():
    bits = (1, 2, 3, 4, 5, 8, 16)
    for b in bits:
        assert ranges.signed_code_bound(b) == jranges.signed_code_bound(b)
    for lb in bits:
        for rb in bits:
            for acc in (16, 32):
                assert (ranges.max_safe_k(lb, rb, acc)
                        == jranges.max_safe_k(lb, rb, acc))
            for k in (1, 512, 10240, 131071, 131072, 2 ** 24):
                assert (ranges.accumulator_bound(k, lb, rb)
                        == jranges.accumulator_bound(k, lb, rb))
                assert (ranges.headroom_bits(k, lb, rb)
                        == jranges.headroom_bits(k, lb, rb))
    for r in (0.0, 1e-13, 1e-12, 1e-11, 0.5):
        assert ranges.scale_is_degenerate(r) == jranges.scale_is_degenerate(r)
    pairs = [("w", 0.0), ("x", 1e-13), ("ok", 0.5)]
    assert ranges.check_scale_inputs(pairs) == jranges.check_scale_inputs(
        pairs)
    for b in (2, 4, 5, 8):
        assert (ranges.cross_check_variance_assumption(b)
                == jranges.cross_check_variance_assumption(b))


def test_max_safe_k_packed_is_pinned_to_max_safe_k():
    """kernels/pack.py keeps its own copy of the bound for the packed
    GEMMs' overflow check; it must equal the analysis's at every width."""
    for a in (1, 2, 4, 8):
        for b in (1, 2, 4, 8):
            assert max_safe_k_packed(a, b) == ranges.max_safe_k(a, b)


# ---------------------------------------------------------------------------
# Auditor: clean models across families and backends
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["simulate", "native", "kernel"])
def test_audit_lm_clean_all_backends(backend):
    cfg = get_config("statquant-tx", smoke=True)
    if backend == "simulate":             # the parity case's walk
        report = _audits("statquant-tx", "bhq", 5)[1]
    else:
        report = audit_model(cfg, QuantPolicy.fqt("bhq", 5, backend=backend))
    assert report.ok, report.format()
    assert report.coverage == 1.0
    roles = report.role_flops()
    assert set(roles) == {"fwd", "wgrad", "agrad"}
    assert all(v["policy_fp"] == 0.0 for v in roles.values())
    # the declared sdpa exemption is the only fp GEMM
    assert set(report.exemptions) == {"attn.sdpa"}
    if backend == "native":
        # the quantized GEMMs contract int8 codes (torch._int_mm)
        assert all(s.integer_gemm for s in report.sites
                   if s.kind == "quantized")


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-2.7b",
                                  "qwen2-vl-2b"])
def test_audit_families_clean(arch):
    """The families the parity cases do not hold site by site (RWKV6's and
    the hybrid's einsums lower apart from the reference's; the VLM's stub
    embeddings): clean at coverage 1.0."""
    report = audit_model(get_config(arch, smoke=True), FQT8)
    assert report.ok, report.format()
    assert report.coverage == 1.0


def test_audit_exact_and_qat():
    cfg = get_config("statquant-tx", smoke=True)
    exact = audit_model(cfg, QuantPolicy.exact())
    assert exact.ok, exact.format()
    assert exact.flops("quantized") == 0.0

    qat = audit_model(cfg, QuantPolicy.qat())
    assert qat.ok, qat.format()
    roles = qat.role_flops()
    # QAT: forward quantized, both backward GEMMs declared full precision
    assert roles["fwd"]["policy_fp"] == 0.0
    assert roles["fwd"]["quantized"] > 0.0
    assert roles["wgrad"]["quantized"] == 0.0
    assert roles["agrad"]["quantized"] == 0.0


def test_audit_engine_step_clean():
    """The whole engine step (loss, gradients, clipping, AdamW) on meta:
    clean, and its GEMMs the loss-and-gradient audit's.  (The reference
    marks its engine-step audit slow; the smoke run's ``[audit]`` walks
    the full-width step under psq8 and bhq5.)"""
    quant, bits = "psq", 8
    cfg = get_config("statquant-tx", smoke=True)
    pol = QuantPolicy.fqt(quant, bits, backend="kernel")
    report = audit_step(cfg, pol)
    assert report.ok, report.format()
    assert report.coverage == 1.0
    # the step's GEMMs are its loss and gradient's (simulate's walk)
    assert report.role_flops() == _audits("statquant-tx", quant,
                                          bits)[1].role_flops()


def test_mutation_selftest():
    cfg = get_config("statquant-tx", smoke=True)
    result = mutation_selftest(cfg, FQT8)
    assert result.ok, result.detail
    # the red run names the leaked path explicitly
    assert any(v.path == result.target_path
               for v in result.mutated.violations)
    assert any(v.kind == "unmarked-gemm" for v in result.mutated.violations)
    assert result.clean.coverage == 1.0


# ---------------------------------------------------------------------------
# Auditor: violation taxonomy on synthetic functions
# ---------------------------------------------------------------------------

def test_audit_fn_flags_unmarked_gemm():
    def f(x, w):
        return x @ w

    report = audit_fn(f, (meta(4, 8), meta(8, 4)), policy=FQT8, paths=(),
                      grad_traced=False)
    assert not report.ok
    [v] = report.violations
    assert v.kind == "unmarked-gemm"
    assert "fp_exempt" in v.detail


def test_audit_fn_accepts_exempt_gemm_and_its_backward():
    """An exempt GEMM and the two GEMMs autograd's backward runs for it
    (after the scope closed) all carry its marker."""
    def f(x, w):
        with torch.enable_grad():
            x, w = x.requires_grad_(), w.requires_grad_()
            with fp_exempt("test.block", "synthetic exemption for the test"):
                y = x @ w
            torch.autograd.grad(y.sum(), (x, w))

    report = audit_fn(f, (meta(4, 8), meta(8, 4)), policy=FQT8, paths=(),
                      grad_traced=False)
    assert report.ok, report.format()
    assert len(report.sites) == 3
    assert {s.kind for s in report.sites} == {"exempt"}
    assert report.exemptions["test.block"].startswith("synthetic")
    assert report.coverage == 1.0            # no non-exempt GEMMs at all


def test_audit_fn_contract_mismatch_and_missing():
    def f(x, w):
        with quant_scope("p1", "fwd", quantized=False):   # the step says fp
            return x @ w

    report = audit_fn(f, (meta(4, 8), meta(8, 4)), policy=FQT8,
                      paths=("p1", "p2"), grad_traced=False)
    kinds = {(v.kind, v.path) for v in report.violations}
    # p1 runs fp while the policy resolves quantized; p2 never appears
    assert ("contract-mismatch", "p1") in kinds
    assert ("declared-missing", "p2") in kinds


def test_audit_fn_undeclared_path():
    def f(x, w):
        with quant_scope("ghost", "fwd", quantized=True):
            return x @ w

    report = audit_fn(f, (meta(4, 8), meta(8, 4)), policy=FQT8, paths=(),
                      grad_traced=False)
    assert any(v.kind == "undeclared-path" and v.path == "ghost"
               for v in report.violations)


def test_walk_scales_a_meta_loop_and_skips_uncounted_work():
    """A loop the model runs once on meta and scales (meta.scaled) is one
    site of its trip count's FLOPs (the reference's scan multiplier);
    what a meta path runs uncounted makes no site."""
    from repro_torch import meta as m

    def f(x, w):
        with fp_exempt("test.loop", "synthetic loop"):
            with m.scaled(7):
                x @ w
            m.uncounted(torch.matmul, x, w)

    [s] = iter_gemm_sites(f, meta(4, 8), meta(8, 4))
    assert (s.mult, s.flops, s.contract) == (7, 7 * 2.0 * 4 * 8 * 4, 8)


# ---------------------------------------------------------------------------
# Range analysis against real int32 and int16 wrap-around
# ---------------------------------------------------------------------------

def test_max_safe_k_int8():
    assert ranges.signed_code_bound(8) == 128
    assert ranges.max_safe_k(8, 8) == 131071
    assert ranges.accumulator_bound(131071, 8, 8) <= 2**31 - 1
    assert ranges.accumulator_bound(131072, 8, 8) > 2**31 - 1
    assert (ranges.headroom_bits(131071, 8, 8) >= 0.0
            > ranges.headroom_bits(131072, 8, 8))


def _worst(k, rhs_code):
    a = torch.full((1, k), -128, dtype=torch.int8)
    b = torch.full((k, 1), rhs_code, dtype=torch.int8)
    return int(torch._int_mm(a, b)[0, 0])


def test_int32_wraparound_at_predicted_k():
    """The bound is exact: K = max_safe_k is the last safe contraction for
    worst-case int8 codes; K+1 wraps the int32 accumulator of
    torch._int_mm (the kernels' plain versions' product)."""
    k_safe = ranges.max_safe_k(8, 8)
    assert _worst(k_safe, -128) == ranges.accumulator_bound(k_safe, 8, 8)
    assert _worst(k_safe + 1, -128) < 0


def test_int32_wraparound_at_predicted_k_asymmetric_8x4():
    k_safe = ranges.max_safe_k(8, 4)
    assert k_safe == (2**31 - 1) // (128 * 8) == 16 * ranges.max_safe_k(8, 8) + 15
    code = -ranges.signed_code_bound(4)
    assert _worst(k_safe, code) == ranges.accumulator_bound(k_safe, 8, 4)
    assert _worst(k_safe + 1, code) < 0


def test_w4a8_widens_the_checked_bound():
    """check_sites bounds each role by the policy's widths: a contraction
    that overflows an 8x8 agrad GEMM is safe once the weights go 4-bit."""
    k = ranges.max_safe_k(8, 8) + 1
    assert k <= ranges.max_safe_k(8, 4)
    site = GemmSite(primitive="mm", flops=2.0 * k, contract=k, mult=1,
                    lhs_dtype="float32", rhs_dtype="float32",
                    stack="q[layers.0.mlp|agrad]", kind="quantized",
                    path="layers.0.mlp", role="agrad", src="test", m=4, n=4)
    red = ranges.check_sites([site], QuantPolicy.fqt("bhq", 8))
    assert any(f.severity == "overflow" and not f.ok
               and (f.lhs_bits, f.rhs_bits) == (8, 8) for f in red)
    green = ranges.check_sites([site],
                               QuantPolicy.fqt("bhq", 8, weight_bits=4))
    assert all(f.ok for f in green)
    assert any((f.lhs_bits, f.rhs_bits) == (8, 4) for f in green)


def test_int16_wraparound_brute_force_low_bits():
    k_safe = ranges.max_safe_k(4, 4, acc_bits=16)
    assert k_safe == (2**15 - 1) // (8 * 8)
    prod = np.int16(ranges.signed_code_bound(4)) ** 2
    safe = np.full(k_safe, prod, np.int16).sum(dtype=np.int16)
    assert int(safe) == ranges.accumulator_bound(k_safe, 4, 4)
    wrapped = np.full(k_safe + 1, prod, np.int16).sum(dtype=np.int16)
    assert int(wrapped) < 0


def test_int2_int4_bounds_scale():
    assert ranges.max_safe_k(4, 4) == (2**31 - 1) // 64
    assert ranges.max_safe_k(2, 2) == (2**31 - 1) // 4
    assert ranges.max_safe_k(4, 8) == (2**31 - 1) // (8 * 128)


def test_scale_degeneracy():
    flagged = ranges.check_scale_inputs([("w", 0.0), ("x", 1e-13),
                                         ("ok", 0.5)])
    assert len(flagged) == 2
    assert flagged[0].startswith("w:") and flagged[1].startswith("x:")


def test_range_check_rides_the_audit():
    """An int8 GEMM with K over the bound turns the audit red even when
    the marker contract holds."""
    k_bad = ranges.max_safe_k(8, 8) + 1

    def f(a, b):
        with fp_exempt("test.intgemm", "stress the accumulator bound"):
            return torch._int_mm(a, b)

    report = audit_fn(f, (meta(1, k_bad, dtype=torch.int8),
                          meta(k_bad, 8, dtype=torch.int8)),
                      policy=FQT8, paths=(), grad_traced=False)
    assert not report.ok
    assert any(f_.severity == "overflow" and not f_.ok
               for f_ in report.range_findings)


# ---------------------------------------------------------------------------
# Step guards
# ---------------------------------------------------------------------------

def test_retrace_guard():
    guard = RetraceGuard(lambda x: x * 2)
    x = torch.ones(4)
    guard(x)
    guard(x)
    guard.assert_no_retrace()
    assert guard.changes == []

    guard(torch.ones(8))                      # new shape => other work
    assert guard.retraces == 1
    with pytest.raises(AssertionError, match="changed on call"):
        guard.assert_no_retrace()


@functools.lru_cache(maxsize=None)
def _cpu_step():
    from repro_torch.data.synthetic import make_batch_for
    from repro_torch.engine import init_train_state, make_step_fn
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    cfg = get_config("statquant-tx", smoke=True)
    model, opt = build_model(cfg), adamw()
    step = make_step_fn(model, QuantPolicy.fqt("psq", 8, backend="kernel"),
                        opt, lambda s: 1e-3, remat=False)
    return step, init_train_state(model, opt, device="cpu"), \
        make_batch_for(cfg, 2, 8)


def test_retrace_guard_holds_the_engine_step():
    """The engine step dispatches the same operations, with the same
    shapes, at every call after the first."""
    step, state, batch = _cpu_step()
    guard = RetraceGuard(step)
    for _ in range(3):
        state, _ = guard(state, batch)
    guard.assert_no_retrace()
    assert guard.calls == 3


def test_inplace_update_of_the_engine_step():
    """Every parameter and AdamW moment of the returned state is its
    input's storage; a step that copies a leaf is named."""
    step, state, batch = _cpu_step()
    (new, _), report = check_inplace_update(step, state, batch)
    assert report.ok, report.detail
    assert report.n_leaves == 3 * len(tree_leaves(state.params))   # p, m, v

    def copying(s, b):
        out, mets = step(s, b)
        p = dict(out.params)
        p["lm_head"] = {k: v.clone() for k, v in p["lm_head"].items()}
        return dataclasses.replace(out, params=p), mets
    _, bad = check_inplace_update(copying, new, batch)
    assert not bad.ok
    assert bad.copied == ("params/lm_head/w",)
    assert "copied" in bad.detail


# ---------------------------------------------------------------------------
# Lint rules
# ---------------------------------------------------------------------------

def test_lint_repo_tree_is_clean():
    findings = lint_tree()
    assert findings == [], "\n".join(str(f) for f in findings)


def test_lint_rpr001_pathless_dense():
    src = """
def layer(p, x, key, policy):
    a = dense(p["w1"], x, key, policy, 1, "layers.up")      # ok
    b = dense(p["w2"], x, key, policy, 2)                   # missing path
    c = dense(p["w3"], x, key, policy, 3, path="")          # empty path
    d = fqt_matmul(x, p["w4"], key, policy)                 # missing path
    return a + b + c + d
"""
    assert [f.rule for f in lint_source(src)] == ["RPR001"] * 3


def test_lint_rpr002_raw_gemm():
    src = """
import torch

def bad(x, w):
    return torch.einsum("ij,jk->ik", x, w) + x @ w + torch.bmm(x, w)

def good(x, w):
    with fp_exempt("m.block", "documented reason"):
        return torch.matmul(x, w) + x @ w + F.linear(x, w)
"""
    findings = lint_source(src)
    assert [f.rule for f in findings] == ["RPR002"] * 3
    assert all(f.line == 5 for f in findings)


def test_lint_rpr003_nonliteral_exempt():
    src = """
def f(x, w, name):
    with fp_exempt("a." + name, "reason"):       # computed path
        return x @ w

def g(x, w):
    with fp_exempt("a.b"):                        # missing reason
        return x @ w

def h(x, w):
    with fp_exempt("a.c", SHARED_REASON):         # UPPER constant ok
        return x @ w
"""
    assert [f.rule for f in lint_source(src)] == ["RPR003", "RPR003"]


def test_lint_syntax_error_reported():
    [f] = lint_source("def broken(:\n")
    assert f.rule == "RPR000"


def test_lint_kernel_mode_contract():
    src = """
import torch

def good(a8, b8):
    return torch._int_mm(a8, b8)

def good32(a, b):
    return torch.mm(a.to(torch.int32), b.to(dtype=torch.int32))

def widened(a, b):
    return torch.matmul(a.to(torch.float64), b.to(torch.float64))

def raw(a, b):
    return torch.einsum("ij,jk->ik", a, b) + a @ b
"""
    rules = [(f.rule, f.line) for f in lint_source(src, mode="kernel")]
    assert rules == [("RPR002", 11), ("RPR002", 14), ("RPR002", 14)]
    # contract mode would also demand fp_exempt; kernel mode accepts an
    # int32 GEMM as it stands
    assert lint_source("def f(a, b):\n    return torch._int_mm(a, b)\n",
                       mode="kernel") == []


# ---------------------------------------------------------------------------
# CLI --format json
# ---------------------------------------------------------------------------

def _cli(argv, capsys):
    from repro_torch.analysis.__main__ import main
    rc = main(argv)
    return rc, capsys.readouterr().out


def test_cli_lint_json(capsys):
    rc, out = _cli(["lint", "--format", "json"], capsys)
    doc = json.loads(out)
    assert doc["tool"] == "lint" and doc["ok"] and rc == 0
    assert doc["findings"] == []


@pytest.mark.parametrize("extra", [[], ["--step"]])
def test_cli_audit_json(capsys, extra):
    rc, out = _cli(["audit", "--config", "statquant-tx", "--policy", "qat",
                    "--backend", "kernel", "--format", "json"] + extra,
                   capsys)
    doc = json.loads(out)
    assert rc == 0 and doc["tool"] == "audit" and doc["ok"]
    [rep] = doc["reports"]
    assert rep["ok"] and rep["findings"] == []
