"""The port's backward quantizers (PTQ, PSQ, BHQ) and the BHQ
activation-grad GEMM on the CPU, held against the JAX package.

Stochastic codes must be bit-identical for the same key (both packages
draw SR uniforms as ``threefry bits * 2^-32``).  BHQ's float fields agree
to a few float32 ulps: its powers go through XLA's float32 ``pow``, which
is not correctly rounded, so a scale may differ in its last bit.  GEMM
outputs agree to float32 round-off, rtol 2e-6 plus an atol of 2e-5
relative to the output's scale (the packages sum in different orders).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.bhq import quantize_bhq_stoch  # noqa: E402
from repro.core.quantizers import quantize_psq_stoch as jax_psq  # noqa: E402
from repro.core.quantizers import quantize_ptq_det as jax_ptq_det  # noqa: E402
from repro.core.quantizers import quantize_ptq_stoch as jax_ptq  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import (QuantPolicy, QuantizerSpec,  # noqa: E402
                              fqt_matmul, get_quantizer, qt_gemm_nt,
                              quantize_psq_stoch, quantize_ptq_det,
                              quantize_ptq_stoch)
from repro_torch.core import quantize_bhq_stoch as torch_bhq  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want):
    atol = 2e-5 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=atol)


# compiled once per shape: the reference's BHQ run op by op takes seconds
jax_bhq = jax.jit(quantize_bhq_stoch, static_argnums=(2,),
                  static_argnames=("block_rows", "g_search"))


def _grad_like(rng, n, d):
    """Rows of very different magnitudes, a few outliers: the gradient
    shape BHQ's grouping is for."""
    g = rng.randn(n, d) * np.exp(rng.randn(n, 1) * 1.5)
    g[rng.randint(0, n, 3)] *= 30
    return g.astype(np.float32)


@pytest.mark.parametrize("shape", [(37, 48), (5, 7, 33), (1, 130)])
@pytest.mark.parametrize("bits", [4, 5, 8])
@pytest.mark.parametrize("seed", [0, 977])
def test_ptq_psq_stochastic_codes_bit_identical(shape, bits, seed):
    rng = np.random.RandomState(seed + bits)
    x = (rng.randn(*shape) * 1e-2).astype(np.float32)
    for jq, tq in ((jax_ptq, quantize_ptq_stoch),
                   (jax_psq, quantize_psq_stoch)):
        j = jq(jnp.asarray(x), jax.random.PRNGKey(seed), bits)
        t = tq(_t(x), prng.PRNGKey(seed), bits)
        np.testing.assert_array_equal(t.codes.numpy(), np.asarray(j.codes))
        np.testing.assert_array_equal(t.zero.numpy(), np.asarray(j.zero))
        # XLA's CPU division may round the scale's last bit differently
        np.testing.assert_allclose(t.scale.numpy(), np.asarray(j.scale),
                                   rtol=2.4e-7, atol=0)
        _close(t.dequant().numpy(), np.asarray(j.dequant()))


@pytest.mark.parametrize("n,d,block_rows,bits,g_search", [
    (512, 64, 256, 5, "refined"), (300, 48, 256, 5, "refined"),
    (77, 33, 32, 4, "refined"), (96, 40, 32, 8, "refined"),
    (20, 24, 256, 5, "refined"), (77, 33, 32, 5, "paper")])
def test_bhq_codes_bit_identical(n, d, block_rows, bits, g_search):
    """Ragged row counts (zero padding rows in the last block) and a
    single short block, under both group searches; codes, grouping and
    permutation exact."""
    rng = np.random.RandomState(n + d + bits)
    g = _grad_like(rng, n, d)
    j = jax_bhq(jnp.asarray(g), jax.random.PRNGKey(bits), bits,
                block_rows=block_rows, g_search=g_search)
    t = torch_bhq(_t(g), prng.PRNGKey(bits), bits, block_rows=block_rows,
                  g_search=g_search)
    np.testing.assert_array_equal(t.codes.numpy(), np.asarray(j.codes))
    np.testing.assert_array_equal(t.seg.numpy(), np.asarray(j.seg))
    np.testing.assert_array_equal(t.inv_perm.numpy(), np.asarray(j.inv_perm))
    for field in ("zero", "row_scale", "n_vec", "coef"):
        want = np.asarray(getattr(j, field))
        np.testing.assert_allclose(getattr(t, field).numpy(), want,
                                   rtol=1e-6, atol=1e-30, err_msg=field)
    _close(t.dequant().numpy(), np.asarray(j.dequant()))


def test_bhq_through_the_registry_matches_policy_params():
    rng = np.random.RandomState(1)
    g = _grad_like(rng, 64, 16)
    spec = QuantPolicy.fqt("bhq", 5, bhq_block=32).resolve("x").agrad
    t = get_quantizer("bhq").quantize(_t(g), prng.PRNGKey(3), spec,
                                      backend="kernel")
    j = jax_bhq(jnp.asarray(g), jax.random.PRNGKey(3), 5, block_rows=32)
    assert t.codes.shape == (2, 32, 16)
    np.testing.assert_array_equal(t.codes.numpy(), np.asarray(j.codes))


@pytest.mark.parametrize("n,block_rows", [(70, 32), (64, 256)])
def test_qt_gemm_nt_bhq_matches_reference(n, block_rows):
    """dX = Q_b(dY) @ W-hat.T under BHQ: the int GEMM on raw codes
    (q8_matmul, W's codes read transposed) and the S^-1 epilogue, against
    the reference's ``native``; ``simulate`` against its ``simulate``."""
    from repro.core.backend import qt_gemm_nt as jax_nt
    rng = np.random.RandomState(n)
    g = _grad_like(rng, n, 48)
    w = (rng.randn(29, 48) * 0.2).astype(np.float32)
    jq = jax_bhq(jnp.asarray(g), jax.random.PRNGKey(0), 5,
                 block_rows=block_rows)
    tq = torch_bhq(_t(g), prng.PRNGKey(0), 5, block_rows=block_rows)
    jw, tw = jax_ptq_det(jnp.asarray(w)), quantize_ptq_det(_t(w))
    for jb, tb in (("native", "kernel"), ("simulate", "simulate")):
        want = np.asarray(jax_nt(jq, jw, backend=jb))
        got = qt_gemm_nt(tq, tw, backend=tb).numpy()
        assert got.shape == (n, 29)
        _close(got, want)


def test_quantizers_run_on_simulate_and_fqt_needs_a_key():
    x = torch.randn(6, 10)
    for name in ("ptq", "psq", "bhq"):
        q = get_quantizer(name).quantize(x, prng.PRNGKey(0),
                                         QuantizerSpec(name, 5),
                                         backend="simulate")
        assert q.dequant().shape == x.shape
    xt = x.clone().requires_grad_()
    y = fqt_matmul(xt, torch.randn(10, 3), None, QuantPolicy.fqt("psq", 8))
    with pytest.raises(ValueError, match="PRNG key"):
        y.sum().backward()
