"""The port's standalone kernel ops, ``generate`` and the small core surface
against the JAX package on the CPU.

``kernels/ops.py``: ``fused_qlinear`` (per-row SR activations through
``quantize_sr_rows``, per-tensor deterministic weights, ``q8_matmul``) with
its codes and scales bit-identical to the reference's and ``y`` at float32
round-off, the reference run as tests/test_kernels.py runs it (Pallas in
interpret mode); ``fused_qlinear_bwd`` under ``ptq``, ``psq`` and ``bhq``
likewise; ``fused_quantize_psq``/``ptq``.  On the CPU the wrappers run the
kernels' plain versions, which is also what ``use_kernels=False`` runs.
``generate`` (reference test tests/test_serve.py:357): the reference's
greedy tokens, and its ``eos_id`` early stop.  ``kv_cache_bytes_per_row``
and the ``EXACT`` / ``QAT`` / ``FQT8_BHQ`` presets as the reference
defines them.
"""

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch.serve import generate as jax_generate  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
import repro_torch.core as core  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from torch_one_thread import one_intra_op_thread  # noqa: E402,F401


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-6,
                               atol=2e-5 * float(np.abs(want).max()))


def _operands(mkn, seed):
    M, K, N = mkn
    rng = np.random.RandomState(seed)
    x = rng.randn(M, K).astype(np.float32)
    w = (rng.randn(K, N) * 0.2).astype(np.float32)
    g = rng.randn(M, N).astype(np.float32)
    return x, w, g


@pytest.mark.parametrize("mkn", [(16, 32, 16), (33, 50, 9)])
def test_fused_qlinear_matches_reference(mkn):
    x, w, _ = _operands(mkn, 7)
    jy, jaux = jax.jit(functools.partial(jops.fused_qlinear, interpret=True))(
        jnp.asarray(x), jnp.asarray(w), jax.random.PRNGKey(7))
    for use_kernels in (True, False):
        y, aux = ops.fused_qlinear(torch.from_numpy(x), torch.from_numpy(w),
                                   prng.PRNGKey(7), use_kernels=use_kernels)
        for name in ("cx", "cw", "sx", "sw"):
            np.testing.assert_array_equal(
                aux[name].numpy().reshape(np.shape(jaux[name])),
                np.asarray(jaux[name]), err_msg=name)
        _close(y.numpy(), jy)
    exact = x @ w
    assert np.abs(y.numpy() - exact).max() / np.abs(exact).max() < 0.05


@pytest.mark.parametrize("quant", ["ptq", "psq", "bhq"])
def test_fused_qlinear_bwd_matches_reference(quant):
    x, w, g = _operands((33, 17, 9), 11)
    kb = jax.random.fold_in(jax.random.PRNGKey(11), 3)
    jdw, jdx = jax.jit(functools.partial(
        jops.fused_qlinear_bwd, grad_quantizer=quant, bhq_block=16,
        interpret=True))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(g), kb)
    hi, lo = (int(v) for v in np.asarray(kb).astype(np.uint64))
    dw, dx = ops.fused_qlinear_bwd(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(g),
        prng.PRNGKey((hi << 32) | lo), grad_quantizer=quant, bhq_block=16)
    assert dw.shape == (17, 9) and dx.shape == (33, 17)
    _close(dw.numpy(), jdw)
    _close(dx.numpy(), jdx)


@pytest.mark.parametrize("bits", [4, 8])
def test_fused_quantize_psq_and_ptq_match_reference(bits):
    _, _, g = _operands((32, 16, 64), 9)
    for jfn, fn in ((jops.fused_quantize_psq, ops.fused_quantize_psq),
                    (jops.fused_quantize_ptq, ops.fused_quantize_ptq)):
        want = jax.jit(functools.partial(jfn, bits=bits, interpret=True))(
            jnp.asarray(g), jax.random.PRNGKey(100))
        got = fn(torch.from_numpy(g), prng.PRNGKey(100), bits)
        _close(got.numpy(), want)


@pytest.fixture(scope="module")
def statquant():
    jcfg = jax_config("statquant-tx", smoke=True)
    jmodel = jax_build(jcfg)
    jp = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config("statquant-tx", smoke=True)
    return (jmodel, jp, build_model(cfg),
            params_from_jax(jax.tree.map(np.asarray, jp), "cpu"), cfg)


def test_generate_matches_reference_and_stops_at_eos(statquant):
    jmodel, jp, model, params, cfg = statquant
    B, T = 2, 8
    toks = np.array(jax.random.randint(jax.random.PRNGKey(5), (B, T), 0,
                                       cfg.vocab_size))
    want = np.asarray(jax_generate(jmodel, jp, {"tokens": jnp.asarray(toks)},
                                   jcore.QuantPolicy.qat(), max_new=8,
                                   max_seq=T + 9))
    batch = {"tokens": torch.from_numpy(toks)}
    pol = core.QuantPolicy.qat()
    free = generate(model, params, batch, pol, max_new=8, max_seq=T + 9)
    assert free.shape == (B, 8)
    np.testing.assert_array_equal(free.numpy(), want)
    eos = int(free[0, 2])
    stopped = generate(model, params, batch, pol, max_new=8, max_seq=T + 9,
                       eos_id=eos)
    assert stopped.shape[1] <= 8
    row = stopped[0].numpy()
    hit = np.where(row == eos)[0]
    assert hit.size > 0 and (row[hit[0]:] == eos).all()
    # a row stops at its first EOS; before it, the free run's tokens
    np.testing.assert_array_equal(row[:hit[0] + 1], free[0, :hit[0] + 1])


def test_generate_refuses_an_unported_family():
    """Every family is ported: ``generate`` runs a whisper-medium batch
    from ``make_batch_for`` (``frames`` and prompt ``tokens``; decode
    steps feed tokens), whose first token is the prefill's greedy one
    (its tokens against the reference's: tests/test_torch_encdec.py); the
    decoder LM's entry points refuse the encoder-decoder's config."""
    from repro_torch.data import make_batch_for
    from repro_torch.models import lm
    cfg = get_config("whisper-medium", smoke=True)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    batch = make_batch_for(cfg, 2, 6)
    prompt = {k: batch[k] for k in ("frames", "tokens")}
    out = generate(model, params, prompt, core.QAT, max_new=3, max_seq=10)
    assert out.shape == (2, 3)
    assert bool(((out >= 0) & (out < cfg.vocab_size)).all())
    logits, _ = model.prefill(params, prompt, core.QAT, 10)
    assert torch.equal(out[:, 0], logits[:, -1, :cfg.vocab_size].argmax(-1))
    with pytest.raises(ValueError, match="models/encdec.py"):
        lm.init_lm_cache(cfg, 2, 10)


@pytest.mark.parametrize("d_flat", [1, 64, 1024, 2050])
def test_kv_cache_bytes_per_row_matches_reference(d_flat):
    for quantized in (True, False):
        for dtype_bytes in (2, 4):
            assert (core.kv_cache_bytes_per_row(d_flat, quantized,
                                                dtype_bytes)
                    == jcore.kv_cache_bytes_per_row(d_flat, quantized,
                                                    dtype_bytes))


@pytest.mark.parametrize("name", ["EXACT", "QAT", "FQT8_BHQ"])
def test_policy_presets_match_reference(name):
    got, want = getattr(core, name), getattr(jcore, name)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    for path in ("layers.attn.wq", "layers.moe.expert.up", "lm_head"):
        assert got.resolve(path).describe() == want.resolve(path).describe()
