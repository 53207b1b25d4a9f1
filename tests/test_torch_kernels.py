"""The port's kernel modules on the CPU, held against the JAX package.

On a CPU tensor each kernel wrapper runs its plain PyTorch version; these
tests feed it and the Pallas kernel (interpret mode) and its XLA twin the
same numpy inputs.  Integer codes must be bit-identical.  GEMM outputs
agree to float32 round-off: the Pallas kernel and the port accumulate the
int8 code GEMM exactly, the XLA twin in float32 (exact for K <= 1024), and
only the order of the float epilogue's sums differs — rtol 2e-6 plus an
atol of 2e-5 relative to the output's scale.  KV dequantization is
elementwise with IEEE division: bit-identical.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import backend as jbackend  # noqa: E402
from repro.core.kv_cache import quantize_kv_rows as jax_quantize_kv  # noqa: E402
from repro.core.quantizers import quantize_ptq_det as jax_ptq_det  # noqa: E402
from repro.kernels.fused_fqt import (fused_qlhs_matmul as pallas_qlhs,  # noqa: E402
                                     fused_qlhs_matmul_xla)
from repro.kernels.kv_dequant import kv_dequant_rows as pallas_kv  # noqa: E402
from repro_torch.core import backend as tbackend  # noqa: E402
from repro_torch.core import (QuantPolicy, dequant_kv_rows, fqt_matmul,  # noqa: E402
                              quantize_kv_rows, quantize_ptq_det)
from repro_torch.kernels import (fused_qlhs_matmul,  # noqa: E402
                                 fused_qlhs_matmul_plain, kv_dequant_rows,
                                 kv_dequant_rows_plain)

RAGGED = [(33, 67, 130), (1, 64, 49), (8, 96, 128)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _operands(mkn, bits, trans_b, stochastic, seed=0):
    M, K, N = mkn
    rng = np.random.RandomState(seed + M * 7 + N)
    x = rng.randn(M, K).astype(np.float32)
    w = (rng.randn(K, N) * 0.3).astype(np.float32)
    wq = jax_ptq_det(jnp.asarray(w), 8)
    w8 = np.asarray(wq.int8_codes)
    ab, bb = (np.float32(v) for v in jbackend.affine_factors(
        wq.scale, wq.zero, 8))
    B = float((1 << bits) - 1)
    if trans_b:                       # dX mode: per-row scales, (N, K) codes
        w8 = np.ascontiguousarray(w8.T)
        zero = x.min(axis=1, keepdims=True)
        scale = (B / np.maximum(x.max(axis=1, keepdims=True) - zero,
                                1e-12)).astype(np.float32)
        colsum = w8.astype(np.int64).sum(axis=1)
    else:                             # forward: per-tensor scale broadcast
        zero = np.full((M, 1), x.min(), np.float32)
        scale = np.full((M, 1), B / (x.max() - x.min()), np.float32)
        colsum = w8.astype(np.int64).sum(axis=0)
    u = (ab * colsum.astype(np.float32) + np.float32(K) * bb).astype(
        np.float32)
    rbits = (rng.randint(0, 2 ** 32, (M, K), dtype=np.uint64)
             .astype(np.uint32) if stochastic else None)
    return x, scale, zero, rbits, w8, ab, bb, u


@pytest.mark.parametrize("mkn", RAGGED)
@pytest.mark.parametrize("mode", ["fwd", "dx_sr"])
def test_fused_qlhs_plain_vs_pallas_and_xla(mkn, mode):
    trans_b = stochastic = mode == "dx_sr"
    bits = 6 if stochastic else 8
    x, sa, za, rb, w8, ab, bb, u = _operands(mkn, bits, trans_b, stochastic)
    j = [jnp.asarray(a) if a is not None else None
         for a in (x, sa, za, rb, w8)]
    want_pl = np.asarray(pallas_qlhs(*j, ab, bb, jnp.asarray(u), bits=bits,
                                     trans_b=trans_b, interpret=True))
    want_xla = np.asarray(fused_qlhs_matmul_xla(*j, ab, bb, jnp.asarray(u),
                                                bits=bits, trans_b=trans_b))
    rb_t = None if rb is None else _t(rb.astype(np.int64))
    got = fused_qlhs_matmul(_t(x), _t(sa), _t(za), rb_t, _t(w8),
                            torch.tensor(ab), torch.tensor(bb), _t(u),
                            bits=bits, trans_b=trans_b).numpy()
    atol = 2e-5 * float(np.abs(want_pl).max())
    np.testing.assert_allclose(got, want_pl, rtol=2e-6, atol=atol)
    np.testing.assert_allclose(got, want_xla, rtol=2e-6, atol=atol)


def test_fused_qlhs_wrapper_is_plain_on_cpu():
    x, sa, za, _, w8, ab, bb, u = _operands((5, 40, 24), 8, False, False)
    args = (_t(x), _t(sa), _t(za), None, _t(w8), torch.tensor(ab),
            torch.tensor(bb), _t(u))
    before = fused_qlhs_matmul.launches
    assert torch.equal(fused_qlhs_matmul(*args, bits=8),
                       fused_qlhs_matmul_plain(*args, bits=8))
    assert fused_qlhs_matmul.launches == before      # no kernel launched
    with pytest.raises(ValueError, match="contraction mismatch"):
        fused_qlhs_matmul(args[0], *args[1:4], _t(w8[:-1]), *args[5:],
                          bits=8)
    with pytest.raises(ValueError, match="bits"):
        fused_qlhs_matmul(*args, bits=9)


@pytest.mark.parametrize("mn", [(33, 130), (64, 512), (7, 48)])
def test_kv_dequant_plain_bit_identical_to_pallas(mn):
    M, N = mn
    rng = np.random.RandomState(M + N)
    x = (rng.randn(M, N) * 3).astype(np.float32)
    c8, scale, zero = (np.asarray(a) for a in jax_quantize_kv(jnp.asarray(x)))
    want = np.asarray(pallas_kv(jnp.asarray(c8), jnp.asarray(scale[:, None]),
                                jnp.asarray(zero[:, None]), interpret=True))
    before = kv_dequant_rows.launches
    got = kv_dequant_rows(_t(c8), _t(scale[:, None]), _t(zero[:, None]))
    assert kv_dequant_rows.launches == before
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        kv_dequant_rows_plain(_t(c8), _t(scale[:, None]),
                              _t(zero[:, None])).numpy(), want)


def test_kv_codec_matches_jax():
    """quantize_kv_rows gives JAX's codes, scales and zeros exactly (its
    scale divides as IEEE division does, ``core.quantizers.range_scale``);
    dequant_kv_rows on both backends, scale clamp included, is
    bit-identical to JAX's on the same codes."""
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 5, 48) * 2).astype(np.float32)
    x[0, 0] = 1.5                                   # zero-range row
    jc, js, jz = (np.asarray(a) for a in jax_quantize_kv(jnp.asarray(x)))
    tc, ts, tz = quantize_kv_rows(_t(x))
    np.testing.assert_array_equal(tc.numpy(), jc)
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(tz.numpy(), jz)
    from repro.core.kv_cache import dequant_kv_rows as jax_dequant
    want = np.asarray(jax_dequant(jnp.asarray(jc), jnp.asarray(js),
                                  jnp.asarray(jz)))
    for backend in ("simulate", "kernel"):
        got = dequant_kv_rows(_t(jc), _t(js), _t(jz), backend=backend)
        np.testing.assert_array_equal(got.numpy(), want)


def test_ptq_det_codes_and_epilogue_algebra():
    rng = np.random.RandomState(3)
    a = rng.randn(9, 17).astype(np.float32)
    b = (rng.randn(17, 11) * 0.5).astype(np.float32)
    jq, tq = jax_ptq_det(jnp.asarray(a), 8), quantize_ptq_det(_t(a), 8)
    np.testing.assert_array_equal(tq.codes.numpy(), np.asarray(jq.codes))
    np.testing.assert_array_equal(tq.int8_codes.numpy(),
                                  np.asarray(jq.int8_codes))
    assert float(tq.scale) == float(jq.scale)
    assert float(tq.zero) == float(jq.zero)
    jb, tb = jax_ptq_det(jnp.asarray(b), 8), quantize_ptq_det(_t(b), 8)
    ja = jbackend.affine_factors(jq.scale, jq.zero, 8)
    ta = tbackend.affine_factors(tq.scale, tq.zero, 8)
    jbb = jbackend.affine_factors(jb.scale, jb.zero, 8)
    tbb = tbackend.affine_factors(tb.scale, tb.zero, 8)
    jco = jbackend.epilogue_coeffs(jq.int8_codes, *ja, jb.int8_codes, *jbb)
    tco = tbackend.epilogue_coeffs(tq.int8_codes, *ta, tb.int8_codes, *tbb)
    for jv, tv in zip(jco, tco):
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)
    acc = jq.int8_codes.astype(jnp.float32) @ jb.int8_codes.astype(
        jnp.float32)
    np.testing.assert_allclose(
        tbackend.apply_epilogue(_t(np.asarray(acc)), *tco).numpy(),
        np.asarray(jbackend.apply_epilogue(acc, *jco)), rtol=1e-6,
        atol=1e-5)


@pytest.mark.parametrize("backend", ["simulate", "kernel"])
def test_fqt_matmul_forward_matches_jax(backend):
    from repro.core import QuantPolicy as JaxPolicy
    from repro.core import fqt_matmul as jax_fqt
    rng = np.random.RandomState(5)
    x = rng.randn(2, 7, 40).astype(np.float32)
    w = (rng.randn(40, 33) * 0.2).astype(np.float32)
    jpol = (JaxPolicy.qat() if backend == "simulate"
            else JaxPolicy.qat(backend="native", fused=True))
    want = np.asarray(jax_fqt(jnp.asarray(x), jnp.asarray(w),
                              jax.random.PRNGKey(0), jpol))
    got = fqt_matmul(_t(x), _t(w), None, QuantPolicy.qat(backend=backend))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6,
                               atol=2e-5 * np.abs(want).max())


def test_unfused_kernel_backend_runs_q8_matmul_on_cpu():
    """``qat(backend="kernel", fused=False)``: the forward's unfused int8
    GEMM runs q8_matmul's plain version and matches JAX ``native``."""
    from repro.core import QuantPolicy as JaxPolicy
    from repro.core import fqt_matmul as jax_fqt
    from repro_torch.kernels import q8_matmul
    rng = np.random.RandomState(2)
    x = rng.randn(2, 7, 40).astype(np.float32)
    w = (rng.randn(40, 33) * 0.2).astype(np.float32)
    want = np.asarray(jax_fqt(jnp.asarray(x), jnp.asarray(w),
                              jax.random.PRNGKey(0),
                              JaxPolicy.qat(backend="native")))
    before = q8_matmul.launches
    got = fqt_matmul(_t(x), _t(w), None,
                     QuantPolicy.qat(backend="kernel", fused=False))
    assert q8_matmul.launches == before
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6,
                               atol=2e-5 * np.abs(want).max())


def test_gradients_and_backward_quantizers_now_work():
    from repro_torch import prng
    from repro_torch.core import get_quantizer, QuantizerSpec
    x = torch.randn(4, 8, requires_grad=True)
    w = torch.randn(8, 3, requires_grad=True)
    for pol in (QuantPolicy.qat(), QuantPolicy.fqt("bhq", 5),
                QuantPolicy.fqt("psq", 8, backend="kernel")):
        y = fqt_matmul(x, w, prng.PRNGKey(0), pol)
        dx, dw = torch.autograd.grad(y.sum(), (x, w))
        assert dx.shape == x.shape and dw.shape == w.shape
        assert bool(torch.isfinite(dx).all() and torch.isfinite(dw).all())
    for name in ("ptq", "psq", "bhq"):
        q = get_quantizer(name).quantize(w.detach(), prng.PRNGKey(1),
                                         QuantizerSpec(name, 8),
                                         backend="simulate")
        assert q.dequant().shape == w.shape


def test_unported_paths_raise(monkeypatch):
    from repro_torch import prng
    from repro_torch.core import get_quantizer, QuantizerSpec
    from repro_torch.launch.train import main
    x = torch.randn(4, 8)
    w = torch.randn(8, 3)
    # the native backend runs (torch._int_mm; tests/test_torch_native.py)
    y = fqt_matmul(x, w, None, QuantPolicy.qat(backend="native"))
    torch.testing.assert_close(
        y, fqt_matmul(x, w, None, QuantPolicy.qat(backend="kernel")),
        rtol=1e-5, atol=1e-5)
    # the unfused PTQ/PSQ roles on the kernel backend run since the
    # quantize_sr kernels were ported (tests/test_torch_quantize_sr.py)
    for name in ("ptq", "psq"):
        q = get_quantizer(name).quantize(w, prng.PRNGKey(0),
                                         QuantizerSpec(name, 8),
                                         backend="kernel")
        assert q.dequant().shape == w.shape
        xr = x.clone().requires_grad_()
        y = fqt_matmul(xr, w, prng.PRNGKey(0),
                       QuantPolicy.fqt(name, 8, backend="kernel",
                                       fused=False))
        y.sum().backward()
        assert bool(torch.isfinite(xr.grad).all())
    # checkpoints (tests/test_torch_checkpoint.py) and meshes
    # (tests/test_torch_dist_*.py) are ported; a mesh needs a process group
    for k in ("MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="init_method"):
        main(["--device", "cpu", "--steps", "1", "--mesh", "2x2"])
    assert QuantPolicy.fqt("bhq", 5).resolve("x").agrad.name == "bhq"
