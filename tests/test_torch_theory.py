"""The port's statistical instruments (``core/theory.py``, the variance
functions of ``core/quantizers.py`` and ``core/bhq.py``) against the JAX
package's.

Deterministic quantities (``quantizer_variance``, ``sr_variance_exact``,
the PTQ/PSQ/BHQ variance bounds, ``bhq_exact_variance``,
``theorem2_path_norms``) are held to float32 round-off (rtol 1e-5; BHQ's
float fields to the few ulps of its float64 powers, ROADMAP queue 3).
The Monte-Carlo estimators draw sample ``i`` under ``split(key, n)[i]``
in both packages and every SR bit agrees, so ``empirical_mean_and_variance``
gives the reference's mean and variance to float32 round-off (the port
accumulates in float64).  ``fqt_gradient_stats`` of reduced statquant-tx
(fixed batch, ``fqt(psq, 8)``) is held to the repo's cross-backend
tolerance (rtol 1e-3 / atol 5e-3) of the reference's from the same
parameters, both on ``simulate``.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.core.theory as jtheory  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.data import make_batch_for as jax_batch  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
import repro_torch.core as core  # noqa: E402
import repro_torch.core.theory as theory  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import make_batch_for  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import tree_leaves, tree_map  # noqa: E402
from torch_one_thread import one_intra_op_thread  # noqa: E402,F401

F32 = 1e-5
RTOL, ATOL = 1e-3, 5e-3


def _grad(seed, n=96, d=40, outliers=3, ratio=1e3):
    """The paper's regime (Fig. 4): most rows near zero, a few outliers;
    ragged against the 32-row BHQ blocks."""
    g = np.random.RandomState(seed).randn(n, d).astype(np.float32) / ratio
    g[:outliers] *= ratio
    return g


def _rel(got, want, rtol=F32):
    got, want = float(got), float(want)
    assert abs(got - want) <= rtol * abs(want), (got, want)


@pytest.mark.parametrize("bits", [4, 5, 8])
@pytest.mark.parametrize("quant", ["ptq", "psq", "bhq"])
def test_quantizer_variance_matches_the_reference(quant, bits):
    g = _grad(bits)
    kw = {"block_rows": 32} if quant == "bhq" else {}
    got = theory.quantizer_variance(torch.from_numpy(g), quant, bits, **kw)
    want = jax.jit(lambda a: jtheory.quantizer_variance(a, quant, bits,
                                                        **kw))(g)
    assert float(want) > 0
    _rel(got, want, 1e-5 if quant != "bhq" else 1e-4)
    with pytest.raises(ValueError):
        theory.quantizer_variance(torch.ones(4, 4), "nope", 4)


@pytest.mark.parametrize("bits", [3, 5, 8])
def test_variance_bounds_and_sr_variance_match_the_reference(bits):
    g = _grad(10 + bits)
    t, jt = torch.from_numpy(g), jnp.asarray(g)
    assert float(core.dynamic_range(t)) == float(jcore.dynamic_range(jt))
    _rel(core.ptq_variance_bound(t, bits), jcore.ptq_variance_bound(jt, bits))
    _rel(core.psq_variance_bound(t, bits), jcore.psq_variance_bound(jt, bits))
    s = t * 37.3
    _rel(core.sr_variance_exact(s),
         jcore.quantizers.sr_variance_exact(jnp.asarray(s.numpy())))
    qt = core.quantize_bhq_stoch(t, prng.PRNGKey(bits), bits, block_rows=32)
    jqt = jax.jit(lambda a: jcore.quantize_bhq_stoch(
        a, jax.random.PRNGKey(bits), bits, block_rows=32))(jt)
    np.testing.assert_array_equal(qt.codes.numpy(), np.asarray(jqt.codes))
    _rel(core.bhq_variance_bound(qt), jcore.bhq_variance_bound(jqt), 1e-4)
    for search in ("refined", "paper"):
        want = jax.jit(lambda a, s=search: jcore.bhq_exact_variance(
            a, bits, block_rows=32, g_search=s))(jt)
        _rel(core.bhq_exact_variance(t, bits, block_rows=32,
                                     g_search=search), want, 1e-4)


_PORT_Q = {
    "ptq": lambda x, k: core.quantize_ptq_stoch(x, k, 4).dequant(),
    "psq": lambda x, k: core.quantize_psq_stoch(x, k, 4).dequant(),
    "bhq": lambda x, k: core.quantize_bhq_stoch(x, k, 4,
                                                block_rows=32).dequant(),
}
_JAX_Q = {
    "ptq": lambda x, k: jcore.quantize_ptq_stoch(x, k, 4).dequant(),
    "psq": lambda x, k: jcore.quantize_psq_stoch(x, k, 4).dequant(),
    "bhq": lambda x, k: jcore.quantize_bhq_stoch(x, k, 4,
                                                 block_rows=32).dequant(),
}


@pytest.mark.parametrize("quant", list(_PORT_Q))
def test_empirical_mean_and_variance_match_the_reference(quant):
    """The same key gives the same samples: mean and variance equal the
    reference's to float32 round-off, and the variance lies near the
    exact one (32 draws: the estimate's relative spread is about
    sqrt(2/32) = 0.25)."""
    g = _grad(20)
    mean, var = theory.empirical_mean_and_variance(
        _PORT_Q[quant], torch.from_numpy(g), prng.PRNGKey(3), 32)
    jmean, jvar = jtheory.empirical_mean_and_variance(
        jax.jit(_JAX_Q[quant]), jnp.asarray(g), jax.random.PRNGKey(3), 32)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=F32,
                               atol=F32 * float(np.abs(g).max()))
    _rel(var, jvar, 1e-4)
    exact = float(theory.quantizer_variance(
        torch.from_numpy(g), quant, 4,
        **({"block_rows": 32} if quant == "bhq" else {})))
    assert abs(var - exact) < 0.75 * exact, (var, exact)
    assert theory.variance_of_tree([_PORT_Q[quant](torch.from_numpy(g), k)
                                    for k in prng.split(prng.PRNGKey(3), 32)
                                    ]) == pytest.approx(var, rel=1e-12)


def test_fqt_gradient_stats_match_the_reference():
    """Conditional on one batch of reduced statquant-tx (2 x 8 tokens),
    the FQT gradient's mean and variance over 4 draws under ``fqt(psq,
    8)`` on ``simulate`` in both packages: the port's within the
    cross-backend tolerance of the reference's, from the same parameters.
    (Across backends per-tensor ``Q_f`` turns float32 round-off into code
    flips, which move each draw by more than this tolerance at this
    size; the kernels' own agreement is held in the kernel tests.)"""
    jcfg, cfg = (jax_config("statquant-tx", smoke=True),
                 get_config("statquant-tx", smoke=True))
    jmodel, model = jax_build(jcfg), build_model(cfg)
    jp = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    jbatch, batch = jax_batch(jcfg, 2, 8), make_batch_for(cfg, 2, 8)
    jpol = jcore.QuantPolicy.fqt("psq", 8)
    pol = core.QuantPolicy.fqt("psq", 8)

    def jgrad(k):
        return jax.grad(lambda p: jmodel.loss(p, jbatch, k, jpol)[0])(jp)

    def grad(k):
        with torch.enable_grad():
            ps = tree_map(lambda t: t.detach().requires_grad_(), params)
            loss, _ = model.loss(ps, batch, k, pol)
            gs = torch.autograd.grad(loss, tree_leaves(ps))
        return _unflatten(params, gs)

    got = theory.fqt_gradient_stats(grad, prng.PRNGKey(9), n_samples=4)
    want = jtheory.fqt_gradient_stats(jax.jit(jgrad), jax.random.PRNGKey(9),
                                      n_samples=4)
    assert float(want["variance"]) > 0
    assert abs(got["variance"] - float(want["variance"])) <= \
        RTOL * float(want["variance"]), (got["variance"],
                                         float(want["variance"]))
    gl, wl = tree_leaves(got["mean"]), jax.tree.leaves(want["mean"])
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


def _unflatten(tree, leaves):
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(tree)


def test_theorem2_path_norms_match_the_reference():
    """Exact Jacobian path norms of a small chain (a linear layer, a
    tanh layer with a dict of parameters, a linear head)."""
    rng = np.random.RandomState(4)
    x = rng.randn(4, 3).astype(np.float32)
    ws = [rng.randn(3, 5).astype(np.float32) * 0.7,
          {"w": rng.randn(5, 4).astype(np.float32) * 0.5,
           "b": rng.randn(4).astype(np.float32) * 0.1},
          rng.randn(4, 2).astype(np.float32) * 0.7]
    jfns = [lambda h, w: h @ w, lambda h, p: jnp.tanh(h @ p["w"] + p["b"]),
            lambda h, w: h @ w]
    tfns = [lambda h, w: h @ w,
            lambda h, p: torch.tanh(h @ p["w"] + p["b"]),
            lambda h, w: h @ w]
    want = jax.jit(lambda a, p: jtheory.theorem2_path_norms(jfns, p, a))(
        x, [jax.tree.map(jnp.asarray, w) for w in ws])
    got = theory.theorem2_path_norms(
        tfns, [tree_map(torch.from_numpy, w) if isinstance(w, dict)
               else torch.from_numpy(w) for w in ws], torch.from_numpy(x))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _rel(g, w, 1e-4)
