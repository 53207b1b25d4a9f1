"""The port's ``native`` backend (``torch._int_mm`` on the int8 codes, the
float epilogue as torch ops) against the JAX package's ``native``
(``lax.dot_general(int8, int8 -> int32)``).

Integer codes are compared exactly; GEMM outputs to float32 round-off
(rtol 1e-5, atol 1e-5 times the output's scale), on ragged shapes such as
33 x 17 x 9, forward and both backward GEMMs, PTQ/PSQ/BHQ; the padding
``_int_mm`` needs on CUDA (M >= 32, K and N multiples of 8) is forced on
the CPU and must not change a bit.  End to end (serving and training):
tests/test_torch_native_e2e.py.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import QuantPolicy as JaxPolicy  # noqa: E402
from repro.core import fqt_matmul as jax_fqt  # noqa: E402
from repro.core.registry import QuantizerSpec as JaxSpec  # noqa: E402
from repro.core.registry import get_quantizer as jax_quantizer  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import QuantPolicy, fqt_matmul  # noqa: E402
from repro_torch.core.backend import (int_mm,  # noqa: E402
                                      padded_int_mm)
from repro_torch.core.registry import QuantizerSpec, get_quantizer  # noqa: E402

F32 = 1e-5            # float32 round-off, relative to the output's scale


def _close(got: torch.Tensor, want, what):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=F32,
                               atol=F32 * scale, err_msg=what)


def _randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("M,K,N", [(33, 17, 9), (5, 64, 40), (1, 8, 8),
                                   (64, 100, 3)])
def test_int_mm_padding_is_exact(M, K, N):
    rng = np.random.RandomState(M + K + N)
    a = torch.from_numpy(rng.randint(-128, 128, (M, K)).astype(np.int8))
    b = torch.from_numpy(rng.randint(-128, 128, (K, N)).astype(np.int8))
    want = (a.to(torch.int64) @ b.to(torch.int64)).to(torch.int32)
    for mm in (int_mm, padded_int_mm):
        assert torch.equal(mm(a, b), want)
        assert torch.equal(mm(a, b.T.contiguous().T), want)


@pytest.mark.parametrize("name", ["ptq", "psq", "bhq"])
def test_native_quantizer_codes_match_the_reference(name):
    """The backward quantizers on ``native`` give the reference's codes
    for the same key, bit for bit (ragged 33 x 17)."""
    x = _randn(0, 33, 17)
    kw = {"block_rows": 16} if name == "bhq" else {}
    got = get_quantizer(name).quantize(
        torch.from_numpy(x), prng.PRNGKey(7), QuantizerSpec(name, 5,
                                                            tuple(kw.items())),
        backend="native")
    codes, dequant = jax.jit(lambda a: (lambda q: (q.codes, q.dequant()))(
        jax_quantizer(name).quantize(a, jax.random.PRNGKey(7),
                                     JaxSpec(name, 5, tuple(kw.items())),
                                     backend="native")))(jnp.asarray(x))
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(codes))
    _close(got.dequant(), dequant, f"{name} dequant")


@pytest.mark.parametrize("M,K,N,quant,bits", [
    (33, 17, 9, "ptq", 8), (33, 17, 9, "psq", 8), (33, 17, 9, "psq", 4),
    (33, 17, 9, "bhq", 5), (8, 40, 24, "psq", 8)])
def test_native_fqt_gemms_match_the_reference(M, K, N, quant, bits):
    """Forward and both backward GEMMs of ``fqt_matmul`` on ``native``:
    the port's equal the reference's to float32 round-off."""
    x, w, g = _randn(1, M, K), _randn(2, K, N) * 0.3, _randn(3, M, N)
    kw = {"bhq_block": 16} if quant == "bhq" else {}
    pol = QuantPolicy.fqt(quant, bits, backend="native", **kw)
    jpol = JaxPolicy.fqt(quant, bits, backend="native", **kw)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = fqt_matmul(xt, wt, prng.PRNGKey(5), pol, path="p")
    dx, dw = torch.autograd.grad(y, (xt, wt), torch.from_numpy(g))

    @jax.jit
    def ref(xj, wj, gj):
        yj, vjp = jax.vjp(lambda a, b: jax_fqt(a, b, jax.random.PRNGKey(5),
                                               jpol, path="p"), xj, wj)
        return (yj,) + vjp(gj)
    jy, jdx, jdw = ref(x, w, g)
    _close(y, jy, "y")
    _close(dx, jdx, "dx")
    _close(dw, jdw, "dw")


def test_native_matches_simulate_and_kernel_in_the_port():
    """Within the port: ``native`` agrees with ``simulate`` and ``kernel``
    (the kernels' plain versions) to float32 round-off on one GEMM."""
    x, w, g = _randn(4, 33, 17), _randn(5, 17, 9), _randn(6, 33, 9)
    outs = []
    for backend in ("native", "simulate", "kernel"):
        xt = torch.from_numpy(x).requires_grad_()
        wt = torch.from_numpy(w).requires_grad_()
        y = fqt_matmul(xt, wt, prng.PRNGKey(2),
                       QuantPolicy.fqt("psq", 8, backend=backend), path="p")
        outs.append((y,) + torch.autograd.grad(y, (xt, wt),
                                                torch.from_numpy(g)))
    for other in outs[1:]:
        for a, b, what in zip(outs[0], other, ("y", "dx", "dw")):
            _close(a, b.detach().numpy(), what)
