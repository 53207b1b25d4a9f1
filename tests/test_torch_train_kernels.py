"""The training slice's kernel modules on the CPU, held against the JAX
package.

On a CPU tensor each wrapper runs its plain PyTorch version; these tests
feed it, the Pallas kernel (interpret mode) and its XLA twin the same numpy
inputs, SR bits included.  The port and the Pallas kernel accumulate the
int8 code GEMM exactly, the XLA twin in float32 (exact for K <= 1024),
and only the order of the float epilogue's sums differs: rtol 2e-6 plus an
atol of 2e-5 relative to the output's scale.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import backend as jbackend  # noqa: E402
from repro.core.quantizers import quantize_ptq_det as jax_ptq_det  # noqa: E402
from repro.kernels.fused_fqt import (  # noqa: E402
    fused_qboth_tn_matmul as pallas_qboth, fused_qboth_tn_matmul_xla,
    fused_qlhs_matmul as pallas_qlhs, fused_qlhs_matmul_xla)
from repro.kernels.q8_matmul import q8_matmul as pallas_q8  # noqa: E402
from repro_torch.core import backend as tbackend  # noqa: E402
from repro_torch.kernels import (fused_qboth_tn_matmul,  # noqa: E402
                                 fused_qboth_tn_matmul_plain,
                                 fused_qlhs_matmul, q8_matmul,
                                 q8_matmul_plain)

RAGGED = [(33, 67, 130), (1, 64, 49), (17, 130, 33)]
BITS = [4, 5, 8]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want):
    atol = 2e-5 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=atol)


def _rbits(rng, shape):
    return rng.randint(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("mkn", RAGGED)
@pytest.mark.parametrize("k_major", [False, True])
def test_q8_matmul_plain_vs_pallas_and_native(mkn, k_major):
    """The epilogue coefficients as core/backend.q8_gemm builds them; y8
    given as a (K, N) tensor or as the transpose of a (N, K) one."""
    M, K, N = mkn
    rng = np.random.RandomState(M + K + N)
    a8 = rng.randint(-16, 16, (M, K)).astype(np.int8)
    b8 = rng.randint(-128, 128, (K, N)).astype(np.int8)
    alpha_a = (rng.rand(M) * 0.1 + 0.01).astype(np.float32)
    beta_a = rng.randn(M).astype(np.float32)
    coeffs = jbackend.epilogue_coeffs(jnp.asarray(a8), alpha_a, beta_a,
                                      jnp.asarray(b8), np.float32(0.02),
                                      np.float32(-1.3))
    want_pl = np.asarray(pallas_q8(jnp.asarray(a8), jnp.asarray(b8),
                                   *coeffs, interpret=True))
    want_nat = np.asarray(jbackend.q8_gemm(
        jnp.asarray(a8), alpha_a, beta_a, jnp.asarray(b8), np.float32(0.02),
        np.float32(-1.3), backend="native"))
    y8 = _t(np.ascontiguousarray(b8.T)).T if k_major else _t(b8)
    tco = [_t(np.asarray(c)) for c in coeffs]
    before = q8_matmul.launches
    got = q8_matmul(_t(a8), y8, *tco).numpy()
    assert q8_matmul.launches == before          # the plain version ran
    _close(got, want_pl)
    _close(got, want_nat)
    via_backend = tbackend.q8_gemm(_t(a8), _t(alpha_a), _t(beta_a), y8,
                                   torch.tensor(0.02), torch.tensor(-1.3),
                                   backend="kernel").numpy()
    _close(via_backend, want_pl)
    np.testing.assert_array_equal(
        q8_matmul_plain(_t(a8), y8, *tco).numpy(), got)


@pytest.mark.parametrize("mkn", RAGGED)
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("psq", [True, False])
def test_fused_qlhs_dx_sr_plain_vs_pallas_and_xla(mkn, bits, psq):
    """dX mode (trans_b=True, SR from rbits) with PSQ per-row or PTQ
    broadcast scales, the (N, K) weight codes read transposed."""
    M, K, N = mkn
    rng = np.random.RandomState(M * 3 + K + bits)
    g = (rng.randn(M, K) * 1e-3).astype(np.float32)
    B = float((1 << bits) - 1)
    if psq:
        zero = g.min(axis=1, keepdims=True)
        scale = (B / np.maximum(g.max(axis=1, keepdims=True) - zero, 1e-12)
                 ).astype(np.float32)
    else:
        zero = np.full((M, 1), g.min(), np.float32)
        scale = np.full((M, 1), B / (g.max() - g.min()), np.float32)
    wq = jax_ptq_det(jnp.asarray((rng.randn(N, K) * 0.3).astype(np.float32)))
    w8 = np.asarray(wq.int8_codes)
    ab, bb = (np.float32(v) for v in jbackend.affine_factors(
        wq.scale, wq.zero, 8))
    u = (ab * w8.astype(np.int64).sum(axis=1).astype(np.float32)
         + np.float32(K) * bb).astype(np.float32)
    rb = _rbits(rng, (M, K))
    j = [jnp.asarray(a) for a in (g, scale, zero, rb, w8)]
    want_pl = np.asarray(pallas_qlhs(*j, ab, bb, jnp.asarray(u), bits=bits,
                                     trans_b=True, interpret=True))
    want_xla = np.asarray(fused_qlhs_matmul_xla(
        *j, ab, bb, jnp.asarray(u), bits=bits, trans_b=True))
    got = fused_qlhs_matmul(_t(g), _t(scale), _t(zero),
                            _t(rb.astype(np.int64)), _t(w8),
                            torch.tensor(ab), torch.tensor(bb), _t(u),
                            bits=bits, trans_b=True).numpy()
    _close(got, want_pl)
    _close(got, want_xla)


@pytest.mark.parametrize("kmn", [(67, 33, 130), (64, 1, 49), (130, 17, 33)])
@pytest.mark.parametrize("bits_b", BITS)
def test_fused_qboth_tn_plain_vs_pallas_and_xla(kmn, bits_b):
    """dW = Q_det(X).T @ Q_sr(dY): the kernel's plain version against the
    Pallas kernel and the XLA twin on the same operands, and the whole
    fused weight grad (core/backend.fused_fqt_dw, operands and a_vec
    included) against the reference's, from the same SR bits."""
    K, M, N = kmn
    rng = np.random.RandomState(K + M * 5 + bits_b)
    x = rng.randn(K, M).astype(np.float32)
    g = (rng.randn(K, N) * 1e-2).astype(np.float32)
    zx = np.float32(x.min())
    sx = np.float32(255.0 / (x.max() - x.min()))
    rb = _rbits(rng, (K, N))
    tops = tbackend.dw_operands(_t(x), torch.tensor(sx), torch.tensor(zx),
                                8, _t(g), _t(rb.astype(np.int64)), bits_b)
    j = [jnp.asarray(o.numpy()) for o in tops]
    j[6] = jnp.asarray(rb)                        # uint32 for JAX
    want_pl = np.asarray(pallas_qboth(*j, bits_a=8, bits_b=bits_b,
                                      interpret=True))
    want_xla = np.asarray(fused_qboth_tn_matmul_xla(*j, bits_a=8,
                                                    bits_b=bits_b))
    before = fused_qboth_tn_matmul.launches
    got = fused_qboth_tn_matmul(*tops, bits_a=8, bits_b=bits_b).numpy()
    assert fused_qboth_tn_matmul.launches == before
    _close(got, want_pl)
    _close(got, want_xla)
    np.testing.assert_array_equal(
        fused_qboth_tn_matmul_plain(*tops, bits_a=8, bits_b=bits_b).numpy(),
        got)
    want_dw = np.asarray(jbackend.fused_fqt_dw(
        jnp.asarray(x), sx, zx, 8, jnp.asarray(g), None, bits_b,
        backend="native", rbits=jnp.asarray(rb)))
    got_dw = tbackend.fused_fqt_dw(
        _t(x), torch.tensor(sx), torch.tensor(zx), 8, _t(g), None, bits_b,
        backend="kernel", rbits=_t(rb.astype(np.int64))).numpy()
    _close(got_dw, want_dw)


@pytest.mark.parametrize("quant", ["ptq", "psq"])
@pytest.mark.parametrize("bits", BITS)
def test_fused_fqt_dx_matches_reference(quant, bits):
    """The whole fused activation grad (core/backend.fused_fqt_dx: scales,
    u vector, the weight codes read transposed) against the reference's
    ``native`` twin and Pallas kernel, from the same SR bits."""
    from repro.core.registry import QuantizerSpec as JSpec
    from repro_torch.core import QuantizerSpec as TSpec
    from repro_torch.core import quantize_ptq_det
    rng = np.random.RandomState(bits + len(quant))
    g = (rng.randn(37, 48) * 1e-3).astype(np.float32)
    w = (rng.randn(29, 48) * 0.2).astype(np.float32)
    rb = _rbits(rng, g.shape)
    jwq = jax_ptq_det(jnp.asarray(w))
    got = tbackend.fused_fqt_dx(_t(g), None, TSpec(quant, bits),
                                quantize_ptq_det(_t(w)), backend="kernel",
                                rbits=_t(rb.astype(np.int64))).numpy()
    for backend, kw in (("native", {}), ("pallas", {"interpret": True})):
        want = np.asarray(jbackend.fused_fqt_dx(
            jnp.asarray(g), None, JSpec(quant, bits), jwq, backend=backend,
            rbits=jnp.asarray(rb), **kw))
        _close(got, want)


# uint32 SR bits at both ends of the range and either side of 2^31, held
# in int64 as prng.bits draws them: none may saturate or wrap
EDGE_BITS = np.array([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 31 + 1,
                      2 ** 32 - 129, 2 ** 32 - 128, 2 ** 32 - 1], np.uint32)


@pytest.mark.parametrize("gemm", ["dx", "dw"])
def test_sr_bits_across_all_32_bits_match_pallas(gemm):
    """The SR rule at the edges of uint32: the plain versions, given the
    bits as int64, round as the Pallas kernel does given them as uint32
    (bits >= 2^31 push t up by about a half, 2^32 - 1 by one whole code
    after the float32 conversion)."""
    rng = np.random.RandomState(7)
    K, N = 64, 24
    rb = np.resize(EDGE_BITS, (K, N))
    if gemm == "dx":
        g = (rng.randn(K, N) * 1e-3).astype(np.float32)
        zero = g.min(axis=1, keepdims=True)
        scale = (255.0 / (g.max(axis=1, keepdims=True) - zero)).astype(
            np.float32)
        w8 = rng.randint(-128, 128, (16, N)).astype(np.int8)
        u = rng.randn(16).astype(np.float32)
        ab, bb = np.float32(0.02), np.float32(-0.4)
        want = np.asarray(pallas_qlhs(
            *[jnp.asarray(a) for a in (g, scale, zero, rb, w8)], ab, bb,
            jnp.asarray(u), bits=8, trans_b=True, interpret=True))
        got = fused_qlhs_matmul(_t(g), _t(scale), _t(zero),
                                _t(rb.astype(np.int64)), _t(w8),
                                torch.tensor(ab), torch.tensor(bb), _t(u),
                                bits=8, trans_b=True).numpy()
    else:
        x = rng.randn(K, 16).astype(np.float32)
        g = (rng.randn(K, N) * 1e-2).astype(np.float32)
        tops = tbackend.dw_operands(
            _t(x), torch.tensor(np.float32(255.0 / (x.max() - x.min()))),
            torch.tensor(np.float32(x.min())), 8, _t(g),
            _t(rb.astype(np.int64)), 8)
        j = [jnp.asarray(o.numpy()) for o in tops]
        j[6] = jnp.asarray(rb)                    # uint32 for JAX
        want = np.asarray(pallas_qboth(*j, bits_a=8, bits_b=8,
                                       interpret=True))
        got = fused_qboth_tn_matmul(*tops, bits_a=8, bits_b=8).numpy()
    _close(got, want)


def test_training_wrappers_validate_on_cpu():
    x = torch.randn(4, 8)
    with pytest.raises(ValueError, match="contraction mismatch"):
        q8_matmul(torch.zeros(4, 8, dtype=torch.int8),
                  torch.zeros(7, 3, dtype=torch.int8), *[x] * 6)
    with pytest.raises(ValueError, match="contraction mismatch"):
        fused_qboth_tn_matmul(x, 1.0, 0.0, torch.randn(5, 3), 1.0, 0.0,
                              torch.zeros(5, 3, dtype=torch.int64),
                              torch.zeros(8), bits_a=8, bits_b=8)
    with pytest.raises(ValueError, match="bits"):
        fused_qboth_tn_matmul(x, 1.0, 0.0, torch.randn(4, 3), 1.0, 0.0,
                              torch.zeros(4, 3, dtype=torch.int64),
                              torch.zeros(8), bits_a=8, bits_b=1)
