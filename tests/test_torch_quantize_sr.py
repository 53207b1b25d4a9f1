"""The unfused backward quantizers of the port on the CPU, held against the
JAX package: ``quantize_sr_rows``/``quantize_sr_tensor`` (their plain
versions here) against the reference's ``quantize_sr_*_ref`` and the
Pallas kernels in interpret mode, fed the same uint32 SR bits, edge values
included; ``quantize_sr_*_qt`` against the reference's from the same key;
and the unfused FQT path (``fused=False``) against ``jax.grad`` of the
reference, GEMM by GEMM and for one training loss.

Codes, scales and zeros are held bit for bit.  The scale ``B / range``
divides as IEEE division does in both packages (``core.quantizers.
range_scale``; a Python number over a tensor would be reciprocal-then-
multiply in PyTorch, one ulp off for about a quarter of ranges).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import QuantPolicy as JaxPolicy  # noqa: E402
from repro.core import backend as jbackend  # noqa: E402
from repro.core import fqt_matmul as jax_fqt  # noqa: E402
from repro.kernels import quantize_sr as pallas_sr  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (QuantPolicy, fqt_matmul,  # noqa: E402
                              quantize_psq_stoch, quantize_ptq_stoch)
from repro_torch.core import backend as tbackend  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.kernels import (quantize_sr_rows,  # noqa: E402
                                 quantize_sr_rows_plain, quantize_sr_tensor,
                                 quantize_sr_tensor_plain)
from repro_torch.models import build_model  # noqa: E402

# SR bits at the edges of the uint32 range: 0 and 2^32 - 1, the top bit,
# and the largest values whose float32 conversion rounds down / up
EDGE_BITS = [0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 31 + 1, 2 ** 32 - 129,
             2 ** 32 - 128, 2 ** 32 - 1]
SHAPES = [(37, 130), (1, 64), (16, 1), (64, 513), (3, 5)]


def _inputs(M, N, seed, constant_row=True):
    rng = np.random.RandomState(seed)
    x = (rng.randn(M, N) * 1e-3).astype(np.float32)
    x[0, 0] = 5e-3                        # one row with a wider range
    if constant_row and M > 2:
        x[2] = 0.25                       # zero range: scale B / 1e-12
    rbits = rng.randint(0, 2 ** 32, (M, N), dtype=np.uint64)
    flat = rbits.reshape(-1)
    flat[:len(EDGE_BITS)] = EDGE_BITS[:flat.size]
    return x, rbits.astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _t64(bits_u32):
    return torch.from_numpy(np.asarray(bits_u32).astype(np.int64))


def _hold(got, want):
    """Codes, scales and zeros bit for bit."""
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().reshape(-1),
                                      np.asarray(w).reshape(-1))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bits", [8, 5, 2])
def test_quantize_sr_plain_matches_reference(shape, bits):
    x, rbits = _inputs(*shape, seed=sum(shape) + bits)
    jx, jb = jnp.asarray(x), jnp.asarray(rbits)
    _hold(quantize_sr_rows_plain(_t(x), _t64(rbits), bits),
          jref.quantize_sr_rows_ref(jx, jb, bits))
    _hold(quantize_sr_tensor_plain(_t(x), _t64(rbits), bits),
          jref.quantize_sr_tensor_ref(jx, jb, bits))
    # the wrappers run the plain versions on a CPU tensor
    for a, b in zip(quantize_sr_rows(_t(x), _t64(rbits), bits),
                    quantize_sr_rows_plain(_t(x), _t64(rbits), bits)):
        assert torch.equal(a, b)
    for a, b in zip(quantize_sr_tensor(_t(x), _t64(rbits), bits),
                    quantize_sr_tensor_plain(_t(x), _t64(rbits), bits)):
        assert torch.equal(a, b)


def test_quantize_sr_plain_matches_pallas_interpret():
    """The Pallas kernels themselves (interpret mode) at one small ragged
    shape, edge padding included, on the same bits."""
    x, rbits = _inputs(19, 150, seed=3)
    jx, jb = jnp.asarray(x), jnp.asarray(rbits)
    _hold(quantize_sr_rows_plain(_t(x), _t64(rbits), 8),
          pallas_sr.quantize_sr_rows(jx, jb, 8, bm=8, interpret=True))
    _hold(quantize_sr_tensor_plain(_t(x), _t64(rbits), 8),
          pallas_sr.quantize_sr_tensor(jx, jb, 8, bm=8, interpret=True))


def test_sr_bits_span_all_32_bits():
    """SR bits across the whole uint32 range, read from their int64
    storage without saturating: ``t = 0`` stays 0 up to 2^32 - 129 (whose
    float32 rounds below 2^32) and becomes 1 at 2^32 - 1 (whose float32 is
    2^32: u = 1.0); ``t = 127.5`` floors to 127 at 0 and reaches 128 at
    2^31."""
    x = np.array([[0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.5, 0.5]], np.float32)
    bits = np.array([[0, 0, 2 ** 31, 2 ** 32 - 129, 2 ** 32 - 128,
                      2 ** 32 - 1, 0, 2 ** 31]], np.uint32)
    codes, _, _ = quantize_sr_rows_plain(_t(x), _t64(bits), 8)
    want = jref.quantize_sr_rows_ref(jnp.asarray(x), jnp.asarray(bits), 8)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want[0]))
    assert (codes.numpy()[0].astype(int) + 128).tolist() == [
        0, 255, 0, 0, 1, 1, 127, 128]


@pytest.mark.parametrize("name", ["psq", "ptq"])
def test_quantize_sr_qt_matches_reference_and_port(name):
    """``quantize_sr_*_qt`` from one key: the same QTensor as the port's
    ``quantize_psq_stoch``/``quantize_ptq_stoch`` (bit for bit) and as the
    reference's ``quantize_sr_*_qt`` (bit for bit)."""
    rng = np.random.RandomState(11)
    x = (rng.randn(29, 77) * 1e-2).astype(np.float32)
    if name == "psq":
        got = tbackend.quantize_sr_rows_qt(_t(x), prng.PRNGKey(5), 8)
        same = quantize_psq_stoch(_t(x), prng.PRNGKey(5), 8)
        want = jbackend.quantize_sr_rows_qt(jnp.asarray(x),
                                            jax.random.PRNGKey(5), 8, True)
    else:
        got = tbackend.quantize_sr_tensor_qt(_t(x), prng.PRNGKey(5), 8)
        same = quantize_ptq_stoch(_t(x), prng.PRNGKey(5), 8)
        want = jbackend.quantize_sr_tensor_qt(jnp.asarray(x),
                                              jax.random.PRNGKey(5), 8, True)
    for field in ("codes", "scale", "zero"):
        assert torch.equal(getattr(got, field), getattr(same, field)), field
    assert got.shape == same.shape == tuple(x.shape) and got.bits == 8
    for field in ("codes", "scale", "zero"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)))


def _close(got, want):
    atol = 2e-5 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=atol)


@pytest.mark.parametrize("quant", ["psq", "ptq"])
def test_unfused_fqt_matmul_grads_match_jax_grad(quant):
    """y, dX and dW of one FQT GEMM with every role unfused (``fused=False``
    on the ``kernel`` backend: the ``quantize_sr`` kernels and ``q8_matmul``,
    as plain versions here) against ``jax.grad`` of the reference's unfused
    ``native`` path, from a shared key, to float32 round-off."""
    rng = np.random.RandomState(7)
    x = rng.randn(2, 37, 48).astype(np.float32)
    w = (rng.randn(48, 33) * 0.2).astype(np.float32)
    gy = (rng.randn(2, 37, 33) * 1e-2).astype(np.float32)
    jpol = JaxPolicy.fqt(quant, 8, backend="native", fused=False)
    tpol = QuantPolicy.fqt(quant, 8, backend="kernel", fused=False)

    def jloss(x_, w_):
        y_ = jax_fqt(x_, w_, jax.random.PRNGKey(3), jpol)
        return jnp.sum(y_ * gy), y_
    (_, jy), (jdx, jdw) = jax.jit(jax.value_and_grad(
        jloss, (0, 1), has_aux=True))(jnp.asarray(x), jnp.asarray(w))
    xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
    y = fqt_matmul(xt, wt, prng.PRNGKey(3), tpol)
    tdx, tdw = torch.autograd.grad((y * _t(gy)).sum(), (xt, wt))
    _close(y.detach().numpy(), np.asarray(jy))
    _close(tdx.numpy(), np.asarray(jdx))
    _close(tdw.numpy(), np.asarray(jdw))


@pytest.mark.parametrize("quant", ["psq", "ptq"])
def test_unfused_training_loss_and_grads_match_jax(quant):
    """The loss of reduced statquant-tx and its gradient through every
    layer, all GEMMs unfused, against ``jax.value_and_grad`` of the
    reference from the same parameters, batch and key: loss and gradient
    norm within the repo's rtol 1e-3 / atol 5e-3.  Leaf by leaf the
    gradients are not held: float32 round-off in the unquantized ops (the
    two packages sum in other orders, and XLA contracts some products)
    moves an occasional activation or gradient code by one step."""
    jcfg = jax_config("statquant-tx", smoke=True)
    jmodel = jax_build(jcfg)
    jp = jmodel.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)
    toks = rng.randint(0, jcfg.vocab_size, (2, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jpol = JaxPolicy.fqt(quant, 8, backend="native", fused=False)
    jl, jg = jax.jit(jax.value_and_grad(lambda p, b: jmodel.loss(
        p, b, jax.random.PRNGKey(4), jpol)[0]))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    cfg = get_config("statquant-tx", smoke=True)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    paths = sorted(jax.tree_util.tree_flatten_with_path(jg)[0],
                   key=lambda kv: jax.tree_util.keystr(kv[0]))
    leaves = []
    for path, _ in paths:
        t = tp
        for k in path:
            t = t[k.key]
        leaves.append(t.requires_grad_())
    tl, _ = build_model(cfg).loss(
        tp, {k: torch.from_numpy(v.astype(np.int64)) for k, v in
             batch.items()}, prng.PRNGKey(4),
        QuantPolicy.fqt(quant, 8, backend="kernel", fused=False))
    tg = torch.autograd.grad(tl, leaves)
    jleaves = [np.asarray(g, np.float64) for _, g in paths]
    tl, jl = float(tl.detach()), float(jl)
    assert abs(tl - jl) <= 5e-3 + 1e-3 * abs(jl)
    tn = float(torch.sqrt(sum((g.double() ** 2).sum() for g in tg)))
    jn = float(np.sqrt(sum((g ** 2).sum() for g in jleaves)))
    assert abs(tn - jn) <= 5e-3 + 1e-3 * jn


def test_range_scales_divide_as_the_reference():
    """Every quantizer scale ``B / range`` of the port equals the
    reference's bit for bit over many ranges: deterministic PTQ, PTQ, PSQ
    and the KV codec.  ``B / tensor`` in PyTorch (reciprocal, then
    multiply) would not: it parts from IEEE division here."""
    from repro.core import quantize_kv_rows as jax_kv
    from repro.core import quantize_psq_stoch as jax_psq
    from repro.core import quantize_ptq_det as jax_det
    from repro_torch.core import quantize_kv_rows, quantize_ptq_det
    rng = np.random.RandomState(0)
    x = (rng.randn(2000, 16) * rng.rand(2000, 1) * 1e-2).astype(np.float32)
    tx, jx = _t(x), jnp.asarray(x)
    rows = np.asarray(jax_psq(jx, jax.random.PRNGKey(1), 8).scale)
    np.testing.assert_array_equal(
        quantize_psq_stoch(tx, prng.PRNGKey(1), 8).scale.numpy(), rows)
    np.testing.assert_array_equal(quantize_kv_rows(tx)[1].numpy(),
                                  np.asarray(jax_kv(jx)[1]))
    for i in range(0, 2000, 50):
        for bits in (8, 4):
            np.testing.assert_array_equal(
                quantize_ptq_det(tx[i:i + 50], bits).scale.numpy(),
                np.asarray(jax_det(jx[i:i + 50], bits).scale))
            np.testing.assert_array_equal(
                quantize_ptq_stoch(tx[i:i + 50], prng.PRNGKey(i),
                                   bits).scale.numpy(),
                np.asarray(jax_det(jx[i:i + 50], bits).scale))
    rng_t = torch.from_numpy(x.max(1, keepdims=True) - x.min(1, keepdims=True))
    assert not torch.equal(255 / rng_t, torch.from_numpy(rows))
