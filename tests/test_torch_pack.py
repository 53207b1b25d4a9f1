"""The sub-byte weight path's modules on the CPU, held against the JAX
package: bit-plane packing and ``PackedTensor``, the two packed GEMMs'
plain versions (what a CPU tensor runs) against the Pallas kernels in
interpret mode and their XLA twins, the ``int4w``/``binary``/``ternary``
quantizers, and ``fqt_matmul`` through them (forward and ``jax.grad``).

Tolerances: codes, packed bytes and column sums are integers and equal
exactly; scales and zeros of ``ptq_det`` packs equal exactly (both divide
as IEEE division does).  ``binary``/``ternary`` take their range from
float32 sums (``mean|w|``, the TWN threshold), which the two packages
reduce in different orders: their scale and zero are held to 4 ulps
(rtol 5e-7), their codes exactly.  GEMM outputs: the port and the Pallas
kernel accumulate the integer code GEMM exactly, the XLA twin in float32
(exact for K <= 1024), and only the order of the float epilogue's sums
differs: rtol 2e-6 plus an atol of 2e-5 relative to the output's scale.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import backend as jbackend  # noqa: E402
from repro.core import fqt_matmul as jax_fqt  # noqa: E402
from repro.core import quantize_ptq_det as jax_ptq_det  # noqa: E402
from repro.core.registry import GemmQuantConfig as JaxCfg  # noqa: E402
from repro.core.registry import QuantizerSpec as JaxSpec  # noqa: E402
from repro.core.registry import get_quantizer as jax_quantizer  # noqa: E402
from repro.kernels import pack as jpack  # noqa: E402
from repro.kernels.fused_fqt import (  # noqa: E402
    fused_qlhs_packed_matmul as pallas_qlhs_packed,
    fused_qlhs_packed_matmul_xla)
from repro.kernels.q4_matmul import (  # noqa: E402
    packed_matmul as pallas_packed, packed_matmul_xla)
from repro.serve.engine import _pack_leaf as jax_pack_leaf  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import backend as tbackend  # noqa: E402
from repro_torch.core import fqt_matmul, quantize_ptq_det  # noqa: E402
from repro_torch.core.registry import (GemmQuantConfig,  # noqa: E402
                                       QuantizerSpec, get_quantizer)
from repro_torch.interop import packed_from_jax  # noqa: E402
from repro_torch.kernels import pack, splitk  # noqa: E402
from repro_torch.kernels import (fused_qlhs_packed_matmul,  # noqa: E402
                                 fused_qlhs_packed_matmul_plain,
                                 packed_matmul, packed_matmul_plain)
from repro_torch.serve.engine import _pack_leaf  # noqa: E402
from torch_one_thread import one_intra_op_thread  # noqa: E402,F401

BITS = (1, 2, 4, 8)
SHAPES = [(1, 1), (3, 5), (33, 65), (67, 17), (130, 2)]
# (M, K, N), K not a multiple of any ppb > 1 but 130's 2
GEMMS = [(33, 67, 130), (1, 130, 49), (9, 33, 17)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want):
    atol = 2e-5 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=atol)


def _codes(rng, bits, shape):
    return rng.randint(0, 1 << bits, shape).astype(np.uint8)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("shape", SHAPES + [(3, 2, 11, 5)])
def test_pack_unpack_bit_identical(bits, shape):
    codes = _codes(np.random.RandomState(bits * 100 + shape[-2]), bits,
                   shape)
    jp = np.asarray(jpack.pack_codes(jnp.asarray(codes), bits))
    tp = pack.pack_codes(_t(codes), bits)
    assert tp.dtype == torch.uint8
    np.testing.assert_array_equal(tp.numpy(), jp)
    k = shape[-2]
    np.testing.assert_array_equal(pack.unpack_codes(tp, bits, k).numpy(),
                                  codes)
    np.testing.assert_array_equal(
        pack.unpack_tile(tp, bits).numpy(),
        np.asarray(jpack.unpack_tile(jnp.asarray(jp), bits)))
    assert pack.packed_nbytes(shape, bits) == jpack.packed_nbytes(shape,
                                                                  bits)
    with pytest.raises(ValueError):
        pack.unpack_codes(tp, bits, tp.shape[-2] * (8 // bits) + 1)


def test_pack_widths_and_overflow_bounds():
    assert pack.PACK_WIDTHS == jpack.PACK_WIDTHS
    for b in (3, 5, 0):
        with pytest.raises(ValueError):
            pack.codes_per_byte(b)
    for lhs in (8, 4, 2, 1):
        for rhs in (8, 4, 2, 1):
            assert (pack.max_safe_k_packed(lhs, rhs)
                    == jpack.max_safe_k_packed(lhs, rhs))


@pytest.mark.parametrize("bits", BITS)
def test_packed_tensor_properties(bits):
    """``pack_qtensor`` of the same ``ptq_det`` codes in both packages:
    every property, and the stored column sums against JAX's
    ``sum(int8_codes, axis=-2)``."""
    rng = np.random.RandomState(bits)
    w = rng.randn(37, 11).astype(np.float32)
    qb = 2 if bits == 1 else bits           # ptq_det needs >= 2 bits
    jq = jax_ptq_det(jnp.asarray(w), qb)
    if bits == 1:                            # a sign plane instead
        jq = jq.__class__(codes=(jq.codes > 1).astype(jnp.uint8),
                          scale=jq.scale, zero=jq.zero, bits=1,
                          shape=jq.shape)
    jpt = jpack.pack_qtensor(jq)
    tq = quantize_ptq_det(_t(w), qb)
    if bits == 1:
        tq = tq.__class__(codes=(tq.codes > 1).to(torch.uint8),
                          scale=tq.scale, zero=tq.zero, bits=1,
                          shape=tq.shape)
    tpt = pack.pack_qtensor(tq)
    np.testing.assert_array_equal(tpt.packed.numpy(), np.asarray(jpt.packed))
    assert tpt.shape == jpt.shape and tpt.ndim == jpt.ndim
    assert tpt.kdim == jpt.kdim == 37 and tpt.int8_offset == jpt.int8_offset
    np.testing.assert_array_equal(tpt.codes.numpy(), np.asarray(jpt.codes))
    np.testing.assert_array_equal(tpt.int8_codes.numpy(),
                                  np.asarray(jpt.int8_codes))
    np.testing.assert_array_equal(tpt.dequant().numpy(),
                                  np.asarray(jpt.dequant()))
    np.testing.assert_array_equal(
        tpt.colsum.numpy(),
        np.asarray(jnp.sum(jpt.int8_codes.astype(jnp.int32), axis=-2)))
    assert tpt.nbytes == jpt.nbytes + 4 * 11          # + the int32 colsum
    moved = tpt.to("cpu")
    assert torch.equal(moved.packed, tpt.packed) and moved.bits == bits
    with pytest.raises(IndexError):
        tpt[0]


@pytest.mark.parametrize("bits", (8, 4, 2))
def test_stacked_pack_per_layer(bits):
    """The engine's stacked pack against JAX ``_pack_leaf`` and against
    per-layer ``quantize_ptq_det``, bit for bit (scales through
    ``range_scale``); ``pt[i]`` is layer ``i`` with a (1, 1) affine pair."""
    rng = np.random.RandomState(10 + bits)
    w = (rng.randn(3, 33, 17) * np.array([1.0, 0.1, 3.0])[:, None, None]
         ).astype(np.float32)
    jpt = jax_pack_leaf(jnp.asarray(w), bits)
    tpt = _pack_leaf(_t(w), bits)
    conv = packed_from_jax(jax.tree.map(np.asarray, jpt), "cpu")
    for got in (tpt, conv):
        np.testing.assert_array_equal(got.packed.numpy(),
                                      np.asarray(jpt.packed))
        np.testing.assert_array_equal(got.scale.numpy(),
                                      np.asarray(jpt.scale))
        np.testing.assert_array_equal(got.zero.numpy(), np.asarray(jpt.zero))
        np.testing.assert_array_equal(got.colsum.numpy(),
                                      tpt.colsum.numpy())
    assert tpt.shape == (3, 33, 17) and tpt.scale.shape == (3, 1, 1)
    for i in range(3):
        layer = tpt[i]
        ref = quantize_ptq_det(_t(w[i]), bits)
        assert layer.scale.shape == (1, 1) and layer.kdim == 33
        assert layer.shape == (33, 17)
        assert layer.scale.item() == ref.scale.item()
        assert layer.zero.item() == ref.zero.item()
        np.testing.assert_array_equal(layer.codes.numpy(), ref.codes.numpy())
        np.testing.assert_array_equal(
            layer.colsum.numpy(),
            np.asarray(jnp.sum(jpt.int8_codes[i].astype(jnp.int32), axis=0)))


def _packed_gemm_case(M, K, N, wbits, seed):
    """Activation codes and a packed ptq_det weight (a sign plane at 1 bit)
    with the epilogue vectors as JAX ``_packed_gemm`` builds them."""
    rng = np.random.RandomState(seed)
    x = jnp.asarray(rng.randn(M, K).astype(np.float32))
    w = jnp.asarray(rng.randn(K, N).astype(np.float32))
    if wbits == 1:
        jpt = jax_quantizer("binary").quantize(
            w, None, JaxSpec.of("binary"), backend="native")
    else:
        jpt = jpack.pack_qtensor(jax_ptq_det(w, wbits))
    aq = jax_ptq_det(x, 8)
    a8 = aq.int8_codes.reshape(M, K)
    aa, ba = jbackend.affine_factors(aq.scale, aq.zero, 8)
    ab, bb = jbackend.affine_factors(jpt.scale, jpt.zero, wbits)
    coeffs = jbackend.epilogue_coeffs(a8, aa, ba, jpt.int8_codes, ab, bb)
    return x, a8, jpt, coeffs


@pytest.mark.parametrize("wbits", BITS)
@pytest.mark.parametrize("mkn", GEMMS)
def test_packed_matmul_plain_vs_pallas_and_xla(wbits, mkn):
    _packed_matmul_vs_jax(wbits, mkn)


def _packed_matmul_vs_jax(wbits, mkn):
    M, K, N = mkn
    _, a8, jpt, coeffs = _packed_gemm_case(M, K, N, wbits, M + K + wbits)
    kw = dict(wbits=wbits, kdim=K)
    want_pl = np.asarray(pallas_packed(a8, jpt.packed, *coeffs, **kw,
                                       interpret=True))
    want_xla = np.asarray(packed_matmul_xla(a8, jpt.packed, *coeffs, **kw))
    targs = [_t(a8), _t(jpt.packed)] + [_t(c) for c in coeffs]
    before = packed_matmul.launches
    got = packed_matmul(*targs, **kw).numpy()
    assert packed_matmul.launches == before          # the plain version ran
    _close(got, want_pl)
    _close(got, want_xla)
    np.testing.assert_array_equal(packed_matmul_plain(*targs, **kw).numpy(),
                                  got)


@pytest.mark.parametrize("wbits", BITS)
@pytest.mark.parametrize("mkn", GEMMS)
def test_fused_qlhs_packed_plain_vs_pallas_and_xla(wbits, mkn):
    """The operands as JAX ``fused_fqt_fwd`` builds them; ``u`` from the
    port's stored column sums equals JAX's from the unpacked codes."""
    _fused_qlhs_packed_vs_jax(wbits, mkn)


def _fused_qlhs_packed_vs_jax(wbits, mkn):
    M, K, N = mkn
    x, _, jpt, _ = _packed_gemm_case(M, K, N, wbits, 3 * M + K + wbits)
    zero, scale = jbackend._ptq_range(x, 8)
    sa = jnp.broadcast_to(scale, (M, 1))
    za = jnp.broadcast_to(zero, (M, 1))
    ab, bb = jbackend.affine_factors(jpt.scale, jpt.zero, wbits)
    colsum = jnp.sum(jpt.int8_codes.astype(jnp.int32), axis=0)
    u = ab * colsum.astype(jnp.float32) + float(K) * bb
    args = (x, sa, za, jpt.packed, ab, bb, u)
    want_pl = np.asarray(pallas_qlhs_packed(*args, bits=8, wbits=wbits,
                                            interpret=True))
    want_xla = np.asarray(fused_qlhs_packed_matmul_xla(*args, bits=8,
                                                       wbits=wbits))
    tpt = packed_from_jax(jax.tree.map(np.asarray, jpt), "cpu")
    np.testing.assert_array_equal(tpt.colsum.numpy(), np.asarray(colsum))
    tu = tbackend._packed_scalars(tpt)[0] * tpt.colsum.to(torch.float32) \
        + float(K) * tbackend._packed_scalars(tpt)[1]
    np.testing.assert_array_equal(tu.numpy(), np.asarray(u))
    targs = [_t(a) for a in args]
    got = fused_qlhs_packed_matmul(*targs, bits=8, wbits=wbits).numpy()
    _close(got, want_pl)
    _close(got, want_xla)
    np.testing.assert_array_equal(
        fused_qlhs_packed_matmul_plain(*targs, bits=8, wbits=wbits).numpy(),
        got)


@pytest.mark.parametrize("wbits", BITS)
def test_packed_plain_versions_match_jax_across_a_slice_boundary(wbits):
    """At (8, 300, 72) both packed kernels' decode-tile plans cut K into
    slices (kernels/splitk.py): the plain versions against the Pallas
    kernels in interpret mode and their XLA twins there, at every width
    (the kernels are held to the plain versions on the card)."""
    M, K, N = 8, 300, 72
    for lib in splitk.PACKED_LIBS:
        p = splitk.plan(splitk.packed_tile(lib, M, wbits), M, N, K)
        assert p.splits > 1 and p.slices[0][1] < K
    _packed_matmul_vs_jax(wbits, (M, K, N))
    _fused_qlhs_packed_vs_jax(wbits, (M, K, N))


def test_packed_wrappers_refuse_bad_operands():
    x8 = torch.zeros((2, 9), dtype=torch.int8)
    v2, v3 = torch.zeros(2), torch.zeros(3)
    good = torch.zeros((5, 3), dtype=torch.uint8)          # ceil(9/2) rows
    packed_matmul(x8, good, v2, v3, v2, v3, v2, v3, wbits=4, kdim=9)
    with pytest.raises(ValueError, match="packed rows"):
        packed_matmul(x8, torch.zeros((4, 3), dtype=torch.uint8), v2, v3,
                      v2, v3, v2, v3, wbits=4, kdim=9)
    with pytest.raises(ValueError, match="not packable"):
        packed_matmul(x8, good, v2, v3, v2, v3, v2, v3, wbits=3, kdim=9)
    k_bad = pack.max_safe_k_packed(8, 8) + 1
    with pytest.raises(ValueError, match="overflows"):
        packed_matmul(torch.zeros((1, k_bad), dtype=torch.int8),
                      torch.zeros((k_bad, 1), dtype=torch.uint8),
                      *([torch.zeros(1)] * 6), wbits=8, kdim=k_bad)
    xf, s = torch.zeros((2, 9)), torch.ones((2, 1))
    with pytest.raises(ValueError, match="packed rows"):
        fused_qlhs_packed_matmul(xf, s, s, torch.zeros((9, 3),
                                 dtype=torch.uint8), torch.tensor(1.0),
                                 torch.tensor(0.0), v3, bits=8, wbits=2)
    with pytest.raises(ValueError, match="overflows"):
        fused_qlhs_packed_matmul(torch.zeros((1, k_bad)), s[:1], s[:1],
                                 torch.zeros((k_bad, 1), dtype=torch.uint8),
                                 torch.tensor(1.0), torch.tensor(0.0),
                                 torch.zeros(1), bits=8, wbits=8)


QUANTIZERS = ["int4w:4", "int4w:2", "binary:1", "ternary:2"]


@pytest.mark.parametrize("spec", QUANTIZERS)
def test_packed_quantizers_match_jax(spec):
    rng = np.random.RandomState(len(spec))
    w = rng.randn(45, 19).astype(np.float32)
    jpt = jax_quantizer(spec.split(":")[0]).quantize(
        jnp.asarray(w), None, JaxSpec.of(spec), backend="native")
    q = get_quantizer(spec.split(":")[0])
    assert q.packed_weights and not q.stochastic
    tpt = q.quantize(_t(w), None, QuantizerSpec.of(spec), backend="kernel")
    assert isinstance(tpt, pack.PackedTensor) and tpt.bits == jpt.bits
    np.testing.assert_array_equal(tpt.packed.numpy(), np.asarray(jpt.packed))
    exact = spec.startswith("int4w")
    rtol = 0 if exact else 5e-7
    np.testing.assert_allclose(tpt.scale.numpy(), np.asarray(jpt.scale),
                               rtol=rtol, atol=0)
    np.testing.assert_allclose(tpt.zero.numpy(), np.asarray(jpt.zero),
                               rtol=rtol, atol=0)


def test_packed_quantizers_refuse_other_widths():
    for spec in ("int4w:8", "binary:2", "ternary:4"):
        with pytest.raises(ValueError):
            get_quantizer(spec.split(":")[0]).quantize(
                torch.zeros((4, 4)), None, QuantizerSpec.of(spec),
                backend="kernel")


@pytest.mark.parametrize("spec", ["int4w:4", "binary:1", "ternary:2"])
@pytest.mark.parametrize("fused", [True, False])
def test_fqt_matmul_packed_quantizer_grads_match_jax(spec, fused):
    """y, dX and dW through a packed weight quantizer at (9, 33) x (33,
    17), FQT with PTQ wgrad and PSQ agrad from a shared key: the port's
    ``kernel`` backend (plain versions) against ``jax.grad`` of JAX's
    ``native`` twins, fused (``fused_qlhs_packed_matmul`` forward) and
    unfused (``packed_matmul`` forward)."""
    rng = np.random.RandomState(2)
    x = rng.randn(9, 33).astype(np.float32)
    w = rng.randn(33, 17).astype(np.float32)
    gy = (rng.randn(9, 17) * 1e-2).astype(np.float32)
    roles = dict(fwd_act="ptq_det:8", fwd_weight=spec, wgrad="ptq:8",
                 agrad="psq:8")
    jcfg = JaxCfg(**{r: JaxSpec.of(v) for r, v in roles.items()},
                  backend="native", fused=fused)
    tcfg = GemmQuantConfig(**{r: QuantizerSpec.of(v)
                              for r, v in roles.items()},
                           backend="kernel", fused=fused)

    def jloss(x_, w_):
        y_ = jax_fqt(x_, w_, jax.random.PRNGKey(0), jcfg, "l0")
        return jnp.sum(y_ * gy), y_
    (_, jy), (jdx, jdw) = jax.value_and_grad(jloss, (0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w))
    xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
    y = fqt_matmul(xt, wt, prng.PRNGKey(0), tcfg, "l0")
    tdx, tdw = torch.autograd.grad((y * _t(gy)).sum(), (xt, wt))
    _close(y.detach().numpy(), np.asarray(jy))
    _close(tdx.numpy(), np.asarray(jdx))
    _close(tdw.numpy(), np.asarray(jdw))


@pytest.mark.parametrize("wbits", (8, 4, 2))
@pytest.mark.parametrize("mode", ["simulate", "fused", "unfused"])
def test_prepacked_forward_matches_jax(wbits, mode):
    """``fqt_matmul`` with a weight packed at load (the engine's path):
    the port's ``simulate``/``kernel`` against JAX's ``simulate``/
    ``native``."""
    rng = np.random.RandomState(3 + wbits)
    x = rng.randn(2, 9, 33).astype(np.float32)
    w = rng.randn(33, 17).astype(np.float32)
    wspec = {8: "ptq_det:8", 4: "int4w:4", 2: "int4w:2"}[wbits]
    kw = dict(fwd_act="ptq_det:8", fwd_weight=wspec)
    jb, tb = (("simulate", "simulate") if mode == "simulate"
              else ("native", "kernel"))
    fused = None if mode == "simulate" else mode == "fused"
    jcfg = JaxCfg(**{r: JaxSpec.of(v) for r, v in kw.items()}, backend=jb,
                  fused=fused)
    tcfg = GemmQuantConfig(**{r: QuantizerSpec.of(v) for r, v in kw.items()},
                           backend=tb, fused=fused)
    jpt = jpack.pack_qtensor(jax_ptq_det(jnp.asarray(w), wbits))
    want = np.asarray(jax_fqt(jnp.asarray(x), jpt, None, jcfg, "l0"))
    tpt = pack.pack_qtensor(quantize_ptq_det(_t(w), wbits))
    got = fqt_matmul(_t(x), tpt, None, tcfg, "l0")
    assert got.shape == (2, 9, 17)
    _close(got.numpy(), want)
