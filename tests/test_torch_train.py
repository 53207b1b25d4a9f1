"""The port's training plumbing on the CPU: synthetic data and ``randint``
bit-identical to the JAX package, the optimizers and schedule against the
reference's (float32 round-off), the training CLI, and the options that
belong to later slices raising."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import optim as jax_optim  # noqa: E402
from repro.data import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro_torch import optim, prng  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import QuantPolicy  # noqa: E402
from repro_torch.data import SyntheticLM, make_batch_for  # noqa: E402
from repro_torch.engine import Engine, make_step_fn  # noqa: E402
from repro_torch.launch.train import main  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from torch_one_thread import one_intra_op_thread  # noqa: E402,F401


@pytest.mark.parametrize("lo,hi", [(0, 10_000), (0, 509), (-5, 70_000),
                                   (3, 3), (9, 2), (0, 2 ** 31 - 1),
                                   (-2 ** 31 + 5, 2 ** 31 - 1)])
def test_randint_bit_identical(lo, hi):
    for seed in (0, 11, 2 ** 32 - 3):
        want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed),
                                             (4, 33), lo, hi))
        got = prng.randint(prng.PRNGKey(seed), (4, 33), lo, hi)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("vocab,seq,batch", [(509, 16, 4), (10_000, 64, 8)])
def test_synthetic_batches_bit_identical(vocab, seq, batch):
    for seed, step, host in ((0, 0, 0), (3, 7, 1), (0, 123, 0)):
        want = JaxSyntheticLM(vocab, seq, batch, seed).batch(step, host)
        got = SyntheticLM(vocab, seq, batch, seed).batch(step, host)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))


def _tree(rng):
    return {"a": rng.randn(3, 5).astype(np.float32),
            "b": {"w": rng.randn(7).astype(np.float32),
                  "g": rng.randn(2, 2).astype(np.float32)}}


@pytest.mark.parametrize("name", ["adamw", "sgd"])
def test_optimizers_match_reference(name):
    rng = np.random.RandomState(0)
    params, jopt = _tree(rng), getattr(jax_optim, name)()
    opt = getattr(optim, name)()
    jp = jax.tree.map(jnp.asarray, params)
    tp = optim.tree_map(torch.from_numpy, jax.tree.map(np.copy, params))
    js, ts = jopt.init(jp), opt.init(tp)
    for step in range(3):
        grads = _tree(rng)
        lr = 3e-3 * (step + 1)
        jp, js = jopt.apply(jp, jax.tree.map(jnp.asarray, grads), js, lr)
        tp, ts = opt.apply(tp, optim.tree_map(torch.from_numpy, grads), ts,
                           lr)
    for a, b in zip(jax.tree.leaves(jp), optim.tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-7)


def test_schedule_and_clip_match_reference():
    jlr, tlr = jax_optim.cosine_schedule(3e-3, 50, 5), \
        optim.cosine_schedule(3e-3, 50, 5)
    for s in (0, 1, 4, 5, 6, 27, 49, 50, 80):
        np.testing.assert_allclose(tlr(s), float(jlr(s)), rtol=1e-6)
    grads = _tree(np.random.RandomState(1))
    for max_norm in (0.5, 100.0):
        jg, jn = jax_optim.clip_by_global_norm(
            jax.tree.map(jnp.asarray, grads), max_norm)
        tg, tn = optim.clip_by_global_norm(
            optim.tree_map(torch.from_numpy, grads), max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for a, b in zip(jax.tree.leaves(jg), optim.tree_leaves(tg)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)


def _gemm_keys(monkeypatch, modules, run):
    """(path, key words) of every quantized GEMM ``run`` makes, in order,
    spying on the ``fqt_matmul`` the layer modules call."""
    calls = []
    for mod in modules:
        real = mod.fqt_matmul

        def spy(x, w, key, policy, path="", _real=real):
            calls.append((path, np.asarray(key).astype(np.int64).tolist()))
            return _real(x, w, key, policy, path=path)
        monkeypatch.setattr(mod, "fqt_matmul", spy)
    run()
    monkeypatch.undo()
    return calls


@pytest.mark.parametrize("loss_chunks", [1, 4])
def test_lm_loss_keys_and_grads_match_reference(monkeypatch, loss_chunks):
    """The training loss of reduced statquant-tx against the reference's
    from the same parameters, batch and key: every quantized GEMM gets
    the same PRNG key (layer ``split``, per-site ``fold_in`` tags, the
    head's per-chunk ``fold_in``), and under ``exact`` the loss and every
    gradient (padded-vocab CE, chunked head) agree to float32 round-off.
    (Under FQT one activation code that round-off flips moves the SR noise
    of a whole row, so gradients are held elementwise only here.)"""
    import dataclasses

    import repro.layers.common as jax_common
    import repro.layers.embeddings as jax_embeddings
    import repro_torch.layers.common as common
    import repro_torch.layers.embeddings as embeddings
    from repro.configs import get_config as jax_config
    from repro.core import QuantPolicy as JaxPolicy
    from repro.models import build_model as jax_build
    from repro_torch.interop import params_from_jax
    # unrolled so that the reference's keys are concrete in eager mode
    jcfg = dataclasses.replace(jax_config("statquant-tx", smoke=True),
                               unroll_scan=True)
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    batch = JaxSyntheticLM(jcfg.vocab_size, 16, 4).batch(0)
    model = build_model(get_config("statquant-tx", smoke=True))
    params = optim.tree_map(lambda t: t.requires_grad_(), params_from_jax(
        jax.tree.map(np.asarray, jparams), "cpu"))
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    fqt = dict(loss_chunks=loss_chunks)
    want = _gemm_keys(monkeypatch, (jax_common, jax_embeddings), lambda:
                      jmodel.loss(jparams, batch, jax.random.PRNGKey(5),
                                  JaxPolicy.fqt("psq", 8), **fqt))
    got = _gemm_keys(monkeypatch, (common, embeddings), lambda:
                     model.loss(params, tbatch, prng.PRNGKey(5),
                                QuantPolicy.fqt("psq", 8), **fqt))
    assert len(got) == 2 * 6 + loss_chunks
    assert got == want

    def jloss(p):
        return jmodel.loss(p, batch, jax.random.PRNGKey(5),
                           JaxPolicy.exact(), **fqt)[0]
    jl, jgrads = jax.jit(jax.value_and_grad(jloss))(jparams)
    loss, _ = model.loss(params, tbatch, prng.PRNGKey(5),
                         QuantPolicy.exact(), **fqt)
    grads = torch.autograd.grad(loss, optim.tree_leaves(params))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    for g, jg in zip(grads, jax.tree.leaves(jgrads)):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=2e-6,
                                   atol=2e-5 * np.abs(jg).max())


def test_train_cli_runs_on_cpu(capsys):
    history = main(["--device", "cpu", "--steps", "2", "--batch", "2",
                    "--seq", "16", "--backend", "kernel"])
    assert [s for s, _ in history] == [0, 1]
    assert all(np.isfinite(loss) for _, loss in history)
    out = capsys.readouterr().out
    assert "[engine] step     0" in out and "[engine] step     1" in out


def test_accumulation_and_override_run_on_cpu(capsys):
    history = main(["--device", "cpu", "--steps", "1", "--batch", "4",
                    "--seq", "8", "--accum", "2", "--quant", "psq",
                    "--override", "lm_head=exact"])
    assert len(history) == 1 and np.isfinite(history[0][1])
    assert "lm_head" in capsys.readouterr().out


def test_unported_training_options_raise(monkeypatch):
    # --ckpt-dir and --override-file are ported
    # (tests/test_torch_checkpoint.py, tests/test_torch_policy_surface.py);
    # --mesh and compress_axis are (tests/test_torch_dist_*.py) but need a
    # process group and a mesh
    for k in ("MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="init_method"):
        main(["--device", "cpu", "--steps", "1", "--mesh", "2x2"])
    cfg = get_config("statquant-tx", smoke=True)
    with pytest.raises(ValueError, match="needs a mesh"):
        make_step_fn(build_model(cfg), QuantPolicy.fqt(), None, None,
                     compress_axis="data")
    # the audio family is ported (tests/test_torch_encdec.py): its batch
    # carries the stub frontend's frames (B, enc_seq, d)
    wcfg = get_config("whisper-medium", smoke=True)
    wbatch = make_batch_for(wcfg, 2, 8)
    assert sorted(wbatch) == ["frames", "labels", "tokens"]
    assert wbatch["frames"].shape == (2, wcfg.enc_seq, wcfg.d_model)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cfg, QuantPolicy.fqt(), steps=1, batch_size=2, seq_len=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--steps", "1"])
