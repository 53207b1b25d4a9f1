"""The Mamba2 hybrid family (zamba2-2.7b: Mamba2 layers with one shared
attention block) in the port against the JAX package on the CPU, at the
reduced config (4 Mamba2 layers in 2 outer blocks of 2, each followed by
the shared block; d_state 16, head dim 16).

* ``mamba2_layer`` under ``exact`` at T = 16 (one SSD chunk, shorter than
  128) and T = 256 (two chunks, so the inter-chunk recurrence runs), from
  zeros and from a carried state; ``mamba2_decode_step`` from the
  prefill's state: outputs and states (SSM state, both conv tails) to
  float32 round-off; the chunked form against the recurrence stepped
  token by token; a length over 128 that is no whole number of chunks is
  refused;
* the model under ``exact`` and ``qat`` (and ``fqt(psq, 8)``, whose
  forward is ``qat``'s bit for bit): ``lm_loss``, ``lm_prefill`` (logits
  and the cache: Mamba2 states ``(n_outer, period, ...)`` and the shared
  block's KV ``(n_outer, ...)`` padded to ``max_seq``), 4 decode steps and
  ``generate``'s greedy tokens (``torch_family_ref.check_forward_paths``);
  its refusal of the int8 cache and page pool is held in
  tests/test_torch_rwkv.py;
* checkpoints: a train state written by the port restores in the
  reference leaf for leaf (the two-level stack, ``fuse`` and ``shared``),
  and the reverse.

The training steps are in tests/test_torch_mamba2_train.py.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import CheckpointManager as JaxCkpt  # noqa: E402
from repro.engine.state import abstract_train_state  # noqa: E402
from repro.layers import mamba2_decode_step as jax_step  # noqa: E402
from repro.layers import mamba2_layer as jax_layer  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core import QuantPolicy  # noqa: E402
from repro_torch.engine import Engine  # noqa: E402
from repro_torch.layers import mamba2_decode_step, mamba2_layer  # noqa: E402
from repro_torch.models.lm import layer_view  # noqa: E402
from repro_torch.optim import tree_leaves  # noqa: E402
from torch_family_ref import (POLICIES, _t, check_forward_paths,  # noqa: E402
                              close_round_off, family, to_port)
from torch_one_thread import one_intra_op_thread  # noqa: E402,F401

ARCH = "zamba2-2.7b"
B = 2


def _layer_pair(o=0, i=1):
    fam = family(ARCH)
    jlp = jax.tree.map(lambda a: a[o, i], fam.jp["layers"])
    return fam, jlp, layer_view(layer_view(fam.p["layers"], o), i)


def _close_tree(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        close_round_off(got[k].numpy(), want[k])


def test_init_draws_the_reference_leaves():
    """The port's own init: the reference's leaves and shapes (the
    two-level stack, ``fuse``, ``shared``), and its deterministic
    ``A_log``, ``D`` and ``dt_bias`` to float32 round-off."""
    fam = family(ARCH)
    mine = fam.m.init(1, device="cpu")
    assert jax.tree.map(np.shape, fam.jp) == jax.tree.map(
        lambda t: tuple(t.shape), mine)
    for name in ("A_log", "D", "dt_bias"):
        close_round_off(mine["layers"][name].numpy(),
                        fam.jp["layers"][name])


@pytest.mark.parametrize("T", [16, 256])
def test_mamba2_layer_matches_reference(T):
    """From zeros, then a second segment from the carried state, then 3
    decode steps from that state."""
    fam, jlp, lp = _layer_pair()
    cfg, jcfg = fam.cfg, fam.jcfg
    jpol, pol = (f() for f in POLICIES["exact"])
    key = jax.random.PRNGKey(0)
    layer = jax.jit(lambda h, st: jax_layer(jlp, h, key, jpol, jcfg,
                                            state=st))
    step = jax.jit(lambda h, st: jax_step(jlp, h, st, key, jpol, jcfg))
    rng = np.random.RandomState(T)
    x1, x2 = (rng.randn(B, T, cfg.d_model).astype(np.float32)
              for _ in range(2))
    jh, jst = jax.tree.map(np.asarray, jax.jit(
        lambda h: jax_layer(jlp, h, key, jpol, jcfg))(x1))
    h, st = mamba2_layer(lp, _t(x1), None, pol, cfg)
    close_round_off(h.numpy(), jh)
    _close_tree(st, jst)
    h, st = mamba2_layer(lp, _t(x2), None, pol, cfg, state=to_port(jst))
    jh, jst = jax.tree.map(np.asarray, layer(x2, jst))
    close_round_off(h.numpy(), jh)
    _close_tree(st, jst)
    for _ in range(3):
        xt = rng.randn(B, 1, cfg.d_model).astype(np.float32)
        h, st = mamba2_decode_step(lp, _t(xt), to_port(jst), None, pol, cfg)
        jh, jst = jax.tree.map(np.asarray, step(xt, jst))
        close_round_off(h.numpy(), jh)
        _close_tree(st, jst)


def test_chunked_form_is_the_recurrence_and_refuses_partial_chunks():
    """Two SSD chunks (T = 256) against the exact recurrence stepped token
    by token (same outputs and state, to the round-off of the two
    summation orders); T = 200 is refused."""
    fam, _, lp = _layer_pair()
    cfg, pol = fam.cfg, QuantPolicy.exact()
    x = _t(np.random.RandomState(2).randn(1, 256, cfg.d_model).astype(
        np.float32))
    h, st = mamba2_layer(lp, x, None, pol, cfg)
    state = {k: torch.zeros_like(v) for k, v in st.items()}
    outs = []
    for t in range(x.shape[1]):
        y, state = mamba2_decode_step(lp, x[:, t:t + 1], state, None, pol,
                                      cfg)
        outs.append(y)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), h.numpy(),
                               rtol=1e-4, atol=1e-4)
    for k in st:
        np.testing.assert_allclose(state[k].numpy(), st[k].numpy(),
                                   rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="whole number of 128-token"):
        mamba2_layer(lp, x[:, :200], None, pol, cfg)


@pytest.mark.parametrize("pol", ["exact", "qat"])
def test_forward_paths_match_reference(pol):
    fam = family(ARCH)
    rng = np.random.RandomState(3)
    T = 16
    x = {"tokens": rng.randint(0, fam.cfg.vocab_size, (B, T)).astype(
             np.int32),
         "labels": rng.randint(0, fam.cfg.vocab_size, (B, T)).astype(
             np.int32)}
    check_forward_paths(fam, pol, x, T, T + 8)


def _assert_leaves_equal(ref, mine):
    rl, ml = jax.tree.leaves(ref), tree_leaves(mine)
    assert len(rl) == len(ml) > 0
    for r, m in zip(rl, ml):
        assert r.shape == tuple(m.shape)
        np.testing.assert_array_equal(np.asarray(r), m.numpy())


def test_checkpoints_cross_both_ways(tmp_path):
    """The reference's hybrid train state restores in the port, and the
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
    _assert_leaves_equal(jstate.opt_state["v"], got.opt_state["v"])
    assert tuple(got.params["layers"]["A_log"].shape) == (2, 2, 8)
    assert tuple(got.params["fuse"]["w"].shape) == (2, 128, 64)

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
