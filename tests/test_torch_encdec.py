"""The audio family (whisper-medium: encoder-decoder, cross-attention, stub
frames) in the port against the JAX package on the CPU, at the reduced
config (2 encoder + 2 decoder layers, d 64, ``enc_seq`` 16), on the
reference's parameters (``interop.params_from_jax``) and inputs made from
a seed with numpy.

* ``sinusoidal_positions`` at (1,500, 1,024): within 1.2e-7 absolute (an
  ulp at 1.0).  The powers and angles are the reference's bit for bit;
  XLA's float32 ``sin``/``cos`` round about an ulp apart from PyTorch's
  (the largest gap measured is 5.96e-8);
* ``make_batch_for``: tokens and labels equal, ``frames`` (B, enc_seq, d)
  within 0.02 x 1e-6 (``prng.normal``, ROADMAP queue 3);
* under ``exact`` and ``qat`` (the port on its ``kernel`` backend's plain
  versions, the reference on its ``native`` fused twins): ``encdec_loss``,
  prefill (logits and both caches), 4 decode steps each from the
  reference's cache, and ``generate``'s tokens equal to the reference's
  greedy chain, at the cross-backend tolerance (rtol 1e-3, atol 5e-3) or
  parted at a code flip that ``torch_family_ref.assert_forward_matches``
  explains; ``fqt(psq, 8)``'s forward equals ``qat``'s bit for bit; under
  ``exact`` also a prefill with ``last_pos`` (logits and both caches) and
  a decode step with per-slot positions, at float32 round-off;
* the training path's GEMM keys: the self-attention and the
  cross-attention of each decoder layer draw under different keys (the
  port's twin of ``tests/test_soundness.py``'s SND002 case), and every
  layer GEMM's key is the reference's (``tests/test_torch_encdec_train.py``);
* ``Model.quant_paths`` and ``input_specs`` (frames for train and
  prefill, the encdec cache for decode) equal the reference's in shape
  and dtype; ``build_model``'s entry points; the decoder LM's entry points
  refuse the config;
* an encdec checkpoint written by each package restores in the other,
  leaf for leaf; the training CLI runs the family with ``--accum 2``
  (``frames`` split along the batch).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import CheckpointManager as JaxCkpt  # noqa: E402
from repro.data import make_batch_for as jax_batch  # noqa: E402
from repro.engine.state import abstract_train_state  # noqa: E402
from repro.layers.embeddings import (  # noqa: E402
    sinusoidal_positions as jax_sinusoidal)
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core import QuantPolicy  # noqa: E402
from repro_torch.data import make_batch_for  # noqa: E402
from repro_torch.engine import Engine, TrainState  # noqa: E402
from repro_torch.layers import sinusoidal_positions  # noqa: E402
from repro_torch.models import encdec, lm  # noqa: E402
from repro_torch.optim import tree_leaves  # noqa: E402
from torch_family_ref import (_t, assert_forward_matches,  # noqa: E402
                              check_forward_paths, close_round_off, family,
                              port_forward, to_port)
from torch_one_thread import one_intra_op_thread  # noqa: E402,F401

ARCH = "whisper-medium"
B, T, MAX = 2, 8, 16


def _inputs(seed=0):
    cfg = family(ARCH).cfg
    rng = np.random.RandomState(seed)
    return {"frames": (rng.randn(B, cfg.enc_seq, cfg.d_model) * 0.02).astype(
                np.float32),
            "tokens": rng.randint(0, cfg.vocab_size, (B, T)).astype(np.int32),
            "labels": rng.randint(0, cfg.vocab_size, (B, T)).astype(
                np.int32)}


def test_sinusoidal_positions_match_reference():
    want = np.asarray(jax.jit(lambda: jax_sinusoidal(1500, 1024))())
    got = sinusoidal_positions(1500, 1024)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    gap = float(np.abs(got.numpy() - want).max())
    assert gap <= 1.2e-7, gap


def test_make_batch_for_frames_match_reference():
    fam = family(ARCH)
    ref = jax.jit(lambda: jax_batch(fam.jcfg, 2, 8, step=1, seed=3))()
    mine = make_batch_for(fam.cfg, 2, 8, step=1, seed=3)
    assert sorted(mine) == sorted(ref) == ["frames", "labels", "tokens"]
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(mine[k].numpy(), np.asarray(ref[k]))
    assert mine["frames"].shape == (2, fam.cfg.enc_seq, fam.cfg.d_model)
    assert mine["frames"].dtype == torch.float32
    np.testing.assert_allclose(mine["frames"].numpy(),
                               np.asarray(ref["frames"]), rtol=0,
                               atol=0.02 * 1e-6)


@pytest.mark.parametrize("pol", ["exact", "qat"])
def test_forward_paths_match_reference(pol):
    """Loss, prefill, 4 decode steps and ``generate`` under ``pol`` (and
    ``fqt(psq, 8)`` under ``qat``); under ``exact`` also a prefill with
    ``last_pos`` and a decode step with per-slot positions."""
    fam = family(ARCH)
    x = _inputs()
    check_forward_paths(fam, pol, x, T, MAX)
    if pol == "qat":
        return
    prompt = {k: v for k, v in x.items() if k != "labels"}
    last = np.array([T - 1, T - 4], np.int32)
    (tlog, tcache), pcalls = port_forward(lambda q: fam.m.prefill(
        fam.p, {k: _t(v) for k, v in prompt.items()}, q, MAX,
        last_pos=_t(last)), pol)
    (jlog, jcache), rcalls = fam.run_ref(
        "prefill_last", pol, lambda m, q, p, b, lp: m.prefill(
            p, b, q, MAX, last_pos=lp),
        fam.jp, {k: jnp.asarray(v) for k, v in prompt.items()},
        jnp.asarray(last))
    assert_forward_matches(tlog.numpy(), jlog, pcalls, rcalls, pol,
                           "prefill at last_pos")
    close_round_off(tlog.numpy(), jlog)
    assert tlog.shape == (B, 1, fam.cfg.padded_vocab)
    assert int(tcache["index"]) == T
    for side in ("self_kv", "cross_kv"):
        for s in ("k", "v"):
            close_round_off(tcache[side][s].numpy(), jcache[side][s])
    # one decode step with per-slot positions, from the reference's cache
    posn = np.array([T, T - 3], np.int32)
    tok = jlog[:, -1, :fam.cfg.vocab_size].argmax(-1)[:, None].astype(
        np.int32)
    (tlog, tc), pcalls = port_forward(lambda q: fam.m.decode(
        fam.p, to_port(jcache), {"tokens": _t(tok)}, q,
        positions=_t(posn)), pol)
    (jlog, jc), rcalls = fam.run_ref(
        "decode_slots", pol, lambda m, q, p, c, b, pos: m.decode(
            p, c, b, q, positions=pos),
        fam.jp, jax.tree.map(jnp.asarray, jcache),
        {"tokens": jnp.asarray(tok)}, jnp.asarray(posn))
    assert_forward_matches(tlog.numpy(), jlog, pcalls, rcalls, pol,
                           "decode at per-slot positions")
    close_round_off(tlog.numpy(), jlog)
    close_round_off(tc["self_kv"]["k"].numpy(), jc["self_kv"]["k"])
    np.testing.assert_array_equal(tc["index"].numpy(), posn + 1)


def test_self_and_cross_attention_keys_differ():
    """The training loss keys each decoder layer's self-attention with
    ``fold_in(lk, 1)`` and its cross-attention with ``fold_in(lk, 2)``:
    no key of one is a key of the other or of the MLP (``lk``)."""
    import repro_torch.layers.common as common
    fam = family(ARCH)
    seen = []
    real = common.fqt_matmul

    def spy(x, w, key, policy, path=""):
        seen.append((path, tuple(key.tolist())))
        return real(x, w, key, policy, path=path)
    common.fqt_matmul = spy
    try:
        fam.m.loss(fam.p, {k: _t(v) for k, v in _inputs().items()},
                   prng.PRNGKey(3), QuantPolicy.fqt("psq", 8,
                                                    backend="kernel"))
    finally:
        common.fqt_matmul = real
    cfg = fam.cfg
    assert len(seen) == 6 * cfg.enc_layers + 10 * cfg.n_layers
    dec = [s for s in seen if s[0].startswith("decoder.")]
    for i in range(cfg.n_layers):
        layer = dec[10 * i:10 * (i + 1)]
        keys = {m: {k for p, k in layer if f".{m}." in p}
                for m in ("self_attn", "cross_attn", "mlp")}
        assert [len(keys[m]) for m in keys] == [4, 4, 2]
        assert not keys["self_attn"] & keys["cross_attn"]
        assert not (keys["self_attn"] | keys["cross_attn"]) & keys["mlp"]


def test_model_api_quant_paths_and_input_specs_match_reference():
    """``build_model`` routes the audio family to ``models/encdec.py``
    (no int8 cache, paged decode or page pool); the decoder LM's entry
    points refuse it; ``quant_paths`` and ``input_specs`` (meta tensors)
    equal the reference's at full size."""
    from repro.configs import SHAPES as JAX_SHAPES
    from repro.configs import get_config as jax_config
    from repro.models import build_model as jax_build
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.models import build_model
    cfg = get_config(ARCH)
    model = build_model(cfg)
    assert (model.init_cache_quant, model.paged_decode,
            model.init_paged_pool) == (None, None, None)
    assert model.init_params is encdec.init_encdec_params
    assert model.init_cache is encdec.init_encdec_cache
    with pytest.raises(ValueError, match="models/encdec.py"):
        lm.lm_decode({}, {}, {}, QuantPolicy.exact(), cfg)
    with pytest.raises(ValueError, match="models/encdec.py"):
        lm.init_lm_params(None, cfg)
    jmodel = jax_build(jax_config(ARCH))
    assert model.quant_paths() == jmodel.quant_paths()

    def specs(tree, leaf):
        return sorted((jax.tree_util.keystr(k), v)
                      for k, v in jax.tree_util.tree_flatten_with_path(
                          jax.tree.map(leaf, tree, is_leaf=lambda t:
                                       isinstance(t, torch.Tensor)),
                          is_leaf=lambda t: isinstance(t, tuple))[0])
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        got = specs(model.input_specs(SHAPES[name]), lambda t: (
            tuple(t.shape), str(t.dtype).replace("torch.", "")))
        want = specs(jmodel.input_specs(JAX_SHAPES[name]), lambda t: (
            tuple(t.shape), str(t.dtype)))
        assert got == want, name
    meta = specs(model.init(0, device="meta"), lambda t: tuple(t.shape))
    want = specs(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0)),
                 lambda t: tuple(t.shape))
    assert meta == want
    assert dict(meta)["['pos_embed']"] == (encdec.MAX_DECODER_POS,
                                           cfg.d_model)


def _assert_leaves_equal(ref, mine):
    rl, ml = jax.tree.leaves(ref), tree_leaves(mine)
    assert len(rl) == len(ml) > 0
    for r, m in zip(rl, ml):
        np.testing.assert_array_equal(np.asarray(r), m.numpy())


def test_checkpoints_cross_both_ways(tmp_path):
    """The reference's encdec train state restores in the port, and the
    port's (after one step) in the reference, every leaf equal."""
    fam = family(ARCH)
    jstate = fam.jstate
    JaxCkpt(str(tmp_path / "jax")).save(0, jstate.as_dict(),
                                        asynchronous=False)

    def engine(d, **kw):
        return Engine(fam.cfg, QuantPolicy.fqt("psq", 8, backend="kernel"),
                      steps=1, batch_size=2, seq_len=8, log_fn=None,
                      device="cpu", ckpt_dir=str(tmp_path / d), **kw)
    got = engine("jax").restore_state(0)
    _assert_leaves_equal(jstate.params, got.params)
    _assert_leaves_equal(jstate.opt_state["m"], got.opt_state["m"])
    assert torch.equal(got.rng, TrainState.from_checkpoint_tree(
        jax.tree.map(np.asarray, jstate.as_dict())).rng)

    peng = engine("port", ckpt_every=1)
    peng.run()
    target = abstract_train_state(fam.jm, jax_adamw(), 0).as_dict()
    jtree = JaxCkpt(str(tmp_path / "port")).restore(1, target)
    pst = peng.state
    _assert_leaves_equal(jtree["params"], pst.params)
    _assert_leaves_equal(jtree["opt"]["m"], pst.opt_state["m"])
    _assert_leaves_equal(jtree["opt"]["v"], pst.opt_state["v"])
    assert int(jtree["step"]) == 1
    assert (CheckpointManager(str(tmp_path / "port")).load_meta(1)["keys"]
            == JaxCkpt(str(tmp_path / "jax")).load_meta(0)["keys"])


def test_cli_trains_whisper_with_accumulation(capsys):
    """``launch/train.py --arch whisper-medium`` on the CPU, 2 steps of
    ``fqt(psq, 8)`` with ``--accum 2``: finite losses."""
    from repro_torch.launch.train import main
    history = main(["--device", "cpu", "--arch", ARCH, "--steps", "2",
                    "--batch", "4", "--seq", "8", "--accum", "2",
                    "--quant", "psq", "--backend", "kernel"])
    assert [s for s, _ in history] == [0, 1]
    assert all(np.isfinite(loss) for _, loss in history)
    assert "[engine] step     1" in capsys.readouterr().out
