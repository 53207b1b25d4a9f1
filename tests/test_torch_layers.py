"""The port's layers on the CPU, held against the JAX package.

The same parameters (JAX's init, moved across as numpy by
``repro_torch.interop.params_from_jax``) and inputs go through both, under
``exact`` and the serving policy: ``qat`` on JAX's fused ``native`` path
(the XLA twin of the Pallas kernel) against the port's ``kernel`` backend
(its plain version on the CPU).  Layer outputs agree to float32 round-off
(rtol 1e-5, atol 1e-5: the two frameworks sum in other orders and XLA's
CPU transcendentals differ in the last bit).  Whole-model logits are in
test_torch_models.py.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import layers as jl  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import QuantPolicy as JaxPolicy  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch import layers as tl  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import QuantPolicy  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

ARCHS = ["statquant-tx", "granite-3-2b"]
POLICIES = {
    "exact": (JaxPolicy.exact(), QuantPolicy.exact()),
    "qat": (JaxPolicy.qat(backend="native", fused=True),
            QuantPolicy.qat(backend="kernel")),
}
TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-3, atol=5e-3)


def _np(x):
    return np.asarray(x)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def models():
    """{arch: (jax cfg, jax model, jax params, port cfg, port model,
    port params)} on the reduced configs."""
    out = {}
    for arch in ARCHS:
        jcfg = jax_config(arch, smoke=True)
        jm = jax_build(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
        out[arch] = (jcfg, jm, jp, get_config(arch, smoke=True),
                     build_model(get_config(arch, smoke=True)), tp)
    return out


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms(kind):
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 32).astype(np.float32) * 2 + 1
    p = {"g": rng.rand(32).astype(np.float32) + 0.5}
    if kind == "layernorm":
        p["b"] = rng.randn(32).astype(np.float32)
    want = jl.apply_norm(jax.tree.map(jnp.asarray, p), jnp.asarray(x), kind)
    got = tl.apply_norm(params_from_jax(p, "cpu"), _t(x), kind)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_rope():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 7, 3, 16).astype(np.float32)
    pos = rng.randint(0, 300, (2, 7)).astype(np.int32)
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = tl.apply_rope(_t(x), _t(pos.astype(np.int64)), 10_000.0)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("act", ["swiglu", "gelu", "relu2"])
@pytest.mark.parametrize("pol", list(POLICIES))
def test_mlp(act, pol):
    jpol, tpol = POLICIES[pol]
    jp = jl.init_mlp(jax.random.PRNGKey(2), 32, 48, act)
    x = np.random.RandomState(2).randn(2, 5, 32).astype(np.float32)
    want = jl.mlp(jp, jnp.asarray(x), jax.random.PRNGKey(0), jpol, act)
    got = tl.mlp(params_from_jax(jax.tree.map(np.asarray, jp), "cpu"),
                 _t(x), None, tpol, act)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("pol", list(POLICIES))
def test_attention_prefill_and_int8_decode(models, arch, pol):
    jcfg, _, jp, tcfg, _, tp = models[arch]
    jpol, tpol = POLICIES[pol]
    ja = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    ta = jax.tree.map(lambda a: a[0], tp["layers"]["attn"])
    rng = np.random.RandomState(3)
    x = rng.randn(2, 6, jcfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(6), (2, 6))
    want, (wk, wv) = jl.attention(ja, jnp.asarray(x), jax.random.PRNGKey(0),
                                  jpol, jcfg, jnp.asarray(pos),
                                  return_kv=True)
    got, (gk, gv) = tl.attention(ta, _t(x), None, tpol, tcfg, _t(pos),
                                 return_kv=True)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    np.testing.assert_allclose(gk.numpy(), _np(wk), **TOL)
    # one int8-KV decode step at per-slot positions on a filled cache
    S = 8
    jc = jl.init_kv_cache_quant(jcfg, 2, S)
    tc = tl.init_kv_cache_quant(tcfg, 2, S)
    rows = rng.randn(2, S, jcfg.n_kv_heads * jcfg.hd).astype(np.float32)
    from repro.core import quantize_kv_rows
    for side in ("k", "v"):
        c, s, z = (np.asarray(a) for a in quantize_kv_rows(jnp.asarray(rows)))
        jc[side] = {"codes": jnp.asarray(c), "scale": jnp.asarray(s),
                    "zero": jnp.asarray(z)}
        tc[side] = {"codes": _t(c), "scale": _t(s), "zero": _t(z)}
    xd = rng.randn(2, 1, jcfg.d_model).astype(np.float32)
    index = np.array([3, 6], np.int32)
    jy, jc2 = jl.decode_attention(ja, jnp.asarray(xd), jc, jnp.asarray(index),
                                  jax.random.PRNGKey(0), jpol, jcfg)
    ty, tc2 = tl.decode_attention(ta, _t(xd), tc, _t(index.astype(np.int64)),
                                  None, tpol, tcfg)
    np.testing.assert_allclose(ty.numpy(), _np(jy), **TOL)
    # the written rows: the new positions' zeros, everything else untouched
    np.testing.assert_allclose(tc2["k"]["zero"].numpy(),
                               _np(jc2["k"]["zero"]), **TOL)
