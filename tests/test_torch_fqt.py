"""The port's FQT matmul, forward and both gradients (paper Eq. 3/6), on
the CPU against ``jax.grad`` of the JAX package's, from a shared key, under
QAT and FQT with each backward quantizer.  Agreement to float32
round-off: rtol 2e-6 plus an atol of 2e-5 relative to the output's scale
(the packages sum in different orders; codes are bit-identical).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import QuantPolicy as JaxPolicy  # noqa: E402
from repro.core import fqt_matmul as jax_fqt  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import QuantPolicy, fqt_matmul  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want):
    atol = 2e-5 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=atol)


POLICIES = {
    "qat": (lambda **kw: JaxPolicy.qat(**kw), lambda **kw: QuantPolicy.qat(
        **kw)),
    "ptq": (lambda **kw: JaxPolicy.fqt("ptq", 8, **kw),
            lambda **kw: QuantPolicy.fqt("ptq", 8, **kw)),
    "psq": (lambda **kw: JaxPolicy.fqt("psq", 8, **kw),
            lambda **kw: QuantPolicy.fqt("psq", 8, **kw)),
    "bhq": (lambda **kw: JaxPolicy.fqt("bhq", 5, bhq_block=32, **kw),
            lambda **kw: QuantPolicy.fqt("bhq", 5, bhq_block=32, **kw)),
}


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("backend", ["simulate", "kernel"])
def test_fqt_matmul_grads_match_jax_grad(policy, backend):
    """y, dX and dW of one FQT GEMM from a shared key: the port's
    ``simulate`` against JAX's ``simulate``, its ``kernel`` (plain
    versions on the CPU) against JAX's ``native`` fused twins."""
    rng = np.random.RandomState(7)
    x = rng.randn(2, 37, 48).astype(np.float32)
    w = (rng.randn(48, 33) * 0.2).astype(np.float32)
    gy = (rng.randn(2, 37, 33) * 1e-2).astype(np.float32)
    jmake, tmake = POLICIES[policy]
    jpol = (jmake() if backend == "simulate"
            else jmake(backend="native", fused=True))
    tpol = tmake(backend=backend)

    def jloss(x_, w_):
        y_ = jax_fqt(x_, w_, jax.random.PRNGKey(3), jpol)
        return jnp.sum(y_ * gy), y_
    (_, jy), (jdx, jdw) = jax.jit(jax.value_and_grad(
        jloss, (0, 1), has_aux=True))(jnp.asarray(x), jnp.asarray(w))
    jy, jdx, jdw = np.asarray(jy), np.asarray(jdx), np.asarray(jdw)
    xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
    y = fqt_matmul(xt, wt, prng.PRNGKey(3), tpol)
    tdx, tdw = torch.autograd.grad((y * _t(gy)).sum(), (xt, wt))
    _close(y.detach().numpy(), jy)
    _close(tdx.numpy(), jdx)
    _close(tdw.numpy(), jdw)
    assert tdx.dtype == torch.float32 and tdw.dtype == torch.float32
