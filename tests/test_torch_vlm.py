"""The VLM family (qwen2-vl-2b: M-RoPE, stub vision embeddings) in the
port against the JAX package on the CPU, at the reduced config.

* ``apply_mrope`` at head dims 16 and 128 with distinct (t, h, w)
  positions, to float32 round-off; the section bounds (2, 5) and (16, 40);
* ``prng.normal`` against ``jax.random.normal``: within 1e-6 absolute
  (XLA's float32 ``erf_inv`` polynomial rounds about an ulp apart from
  PyTorch's ``log1p``), at least 90% of draws equal; ``make_batch_for``:
  labels and positions equal, ``embeds`` within 0.02 of that;
* under ``exact`` and ``qat`` (the port on its ``kernel`` backend's plain
  versions, the reference on its ``native`` fused twins), on stub
  embeddings with a patch grid's positions:
  ``lm_loss``, ``lm_prefill`` (logits and cache), 4 ``lm_decode`` steps,
  ``generate``'s greedy tokens (equal to the reference's chain of
  prefill and decode steps fed each token's embedding, as its
  ``generate`` runs them), and under ``qat`` 4 decode steps on the int8
  cache and ``lm_paged_decode`` (two chunks of 4), at the
  cross-backend tolerance, or parted at a quantizer's code flip that
  ``torch_family_ref.assert_forward_matches`` explains, each decode step
  from the reference's cache.  ``fqt(psq, 8)``'s forward quantizers are
  ``qat``'s, and the port's outputs under it equal its ``qat`` outputs
  bit for bit on every one of those paths;
* one ``fqt(psq, 8)`` training step from the reference's state, every
  layer GEMM under the reference's key; one ``exact`` step with
  ``accum_steps=2``, whose microbatches split ``positions`` (3, B, T)
  along B.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.data import make_batch_for as jax_batch  # noqa: E402
from repro.layers.embeddings import apply_mrope as jax_mrope  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.data import make_batch_for  # noqa: E402
from repro_torch.engine import split_microbatches  # noqa: E402
from repro_torch.layers import apply_mrope  # noqa: E402
from repro_torch.layers.embeddings import mrope_bounds  # noqa: E402
from torch_family_ref import (_t, assert_forward_matches,  # noqa: E402
                              check_forward_paths, close_round_off, family,
                              one_step, port_forward, to_port)
from torch_one_thread import one_intra_op_thread  # noqa: E402,F401

ARCH = "qwen2-vl-2b"
B, T, MAX = 2, 16, 24


def _grid_positions(b, t):
    """(3, b, t) M-RoPE positions: two frames of a 2 x 2 patch grid, then
    text, whose three axes advance together past the grid's largest."""
    pos = np.zeros((3, t), np.int64)
    for i in range(min(8, t)):
        pos[:, i] = (i // 4, (i % 4) // 2, i % 2)
    for j, i in enumerate(range(8, t)):
        pos[:, i] = 2 + j
    return np.broadcast_to(pos[:, None], (3, b, t)).astype(np.int32)


def _inputs(seed=0):
    fam = family(ARCH)
    rng = np.random.RandomState(seed)
    return {"embeds": (rng.randn(B, T, fam.cfg.d_model) * 0.02).astype(
                np.float32),
            "positions": _grid_positions(B, T),
            "labels": rng.randint(0, fam.cfg.vocab_size, (B, T)).astype(
                np.int32)}


@pytest.mark.parametrize("hd", [16, 128])
def test_apply_mrope_matches_reference(hd):
    rng = np.random.RandomState(hd)
    x = rng.randn(2, 5, 3, hd).astype(np.float32)
    pos = rng.randint(0, 300, (3, 2, 5)).astype(np.int32)
    want = jax.jit(lambda x, p: jax_mrope(x, p, 1e6))(x, pos)
    close_round_off(apply_mrope(_t(x), _t(pos), 1e6).numpy(), want)
    assert mrope_bounds(hd // 2) == {16: [2, 5], 128: [16, 40]}[hd]


def test_normal_and_make_batch_for_match_reference():
    want = np.asarray(jax.jit(lambda: jax.random.normal(jax.random.fold_in(
        jax.random.PRNGKey(11), 3), (1 << 14,)))())
    got = prng.normal(prng.fold_in(prng.PRNGKey(11), 3), (1 << 14,)).numpy()
    assert float(np.abs(got - want).max()) <= 1e-6
    assert float(np.mean(got == want)) >= 0.9
    cfg = family(ARCH).cfg
    ref = jax.jit(lambda: jax_batch(family(ARCH).jcfg, 2, 8, step=1,
                                    seed=3))()
    mine = make_batch_for(cfg, 2, 8, step=1, seed=3)
    assert sorted(mine) == sorted(ref) == ["embeds", "labels", "positions"]
    np.testing.assert_array_equal(mine["labels"].numpy(),
                                  np.asarray(ref["labels"]))
    np.testing.assert_array_equal(mine["positions"].numpy(),
                                  np.asarray(ref["positions"]))
    assert mine["embeds"].dtype == torch.float32
    np.testing.assert_allclose(mine["embeds"].numpy(),
                               np.asarray(ref["embeds"]), rtol=0,
                               atol=0.02 * 1e-6)


@pytest.mark.parametrize("pol", ["exact", "qat"])
def test_forward_paths_match_reference(pol):
    """Loss, prefill, decode and ``generate`` under ``pol`` (and, for
    ``qat``, ``fqt(psq, 8)``); under ``qat``, the serving policy, also the
    int8-cache decode and the paged decode."""
    fam = family(ARCH)
    x = _inputs()
    check_forward_paths(fam, pol, x, T, MAX)
    if pol == "exact":
        return

    # the int8 cache: 4 steps from an empty cache, per-slot positions
    jq = jax.tree.map(np.asarray, fam.jm.init_cache_quant(fam.jcfg, B, 8))
    assert jax.tree.map(np.shape, jq) == jax.tree.map(
        lambda t: tuple(t.shape),
        fam.m.init_cache_quant(fam.cfg, B, 8, device="cpu"))
    start = np.array([0, 3])
    for step in range(4):
        e = x["embeds"][:, step:step + 1]
        (tlog, tq), pcalls = port_forward(lambda q: fam.m.decode(
            fam.p, to_port(jq), {"embeds": _t(e)}, q,
            positions=_t(start + step), kv_quant=True), pol)
        (jlog, jq), rcalls = fam.run_ref(
            "qdecode", pol, lambda m, q, p, c, b, pos: m.decode(
                p, c, b, q, positions=pos, kv_quant=True),
            fam.jp, jax.tree.map(jnp.asarray, jq),
            {"embeds": jnp.asarray(e)}, jnp.asarray(start + step, jnp.int32))
        assert_forward_matches(tlog.numpy(), jlog, pcalls, rcalls, pol,
                               f"int8 decode {step}",
                               kv=(tq["kv"], jq["kv"]))

    # paged: two chunks of 4 stub embeddings, pages of 4
    jpool = jax.tree.map(np.asarray, fam.jm.init_paged_pool(fam.jcfg, 9, 4))
    table = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    for lo in (0, 4):
        e = x["embeds"][:, lo:lo + 4]
        st = np.full((B,), lo, np.int32)
        (tlog, tpool), pcalls = port_forward(lambda q: fam.m.paged_decode(
            fam.p, to_port(jpool), {"embeds": _t(e)}, q, _t(table),
            _t(st)), pol)
        (jlog, jpool), rcalls = fam.run_ref(
            "paged", pol, lambda m, q, p, pool, b, tb_, s: m.paged_decode(
                p, pool, b, q, tb_, s),
            fam.jp, jax.tree.map(jnp.asarray, jpool),
            {"embeds": jnp.asarray(e)}, jnp.asarray(table), jnp.asarray(st))
        assert_forward_matches(tlog.numpy(), jlog, pcalls, rcalls, pol,
                               f"paged chunk at {lo}", kv=(tpool, jpool))


def test_train_step_psq8_matches_reference():
    cfg = family(ARCH).cfg
    one_step(ARCH, "psq", 8, n_layer_gemms=cfg.n_layers * 7)


def test_accum2_step_splits_positions_along_batch():
    """``split_microbatches`` splits ``positions`` (3, B, T) along B (and
    names the leaf and dim it cannot split); the ``exact`` accum-2 step
    gives the reference's loss and gradient norm."""
    batch = make_batch_for(family(ARCH).cfg, 4, 6)
    parts = split_microbatches(batch, 2)
    assert [p["positions"].shape for p in parts] == [(3, 2, 6)] * 2
    assert [p["embeds"].shape[0] for p in parts] == [2, 2]
    assert torch.equal(torch.cat([p["positions"] for p in parts], 1),
                       batch["positions"])
    with pytest.raises(ValueError, match="'positions' dim 1"):
        split_microbatches({"positions": batch["positions"][:, :3]}, 2)
    one_step(ARCH, "exact", 0, accum_steps=2)


@pytest.mark.parametrize("arch", [ARCH, "zamba2-2.7b", "rwkv6-1.6b"])
def test_quant_paths_and_input_specs_match_the_reference(arch):
    """``Model.quant_paths`` equal the reference's; ``input_specs`` (meta
    tensors: a VLM's ``embeds``/``positions``, the recurrent families'
    caches) the reference's shapes and dtypes at full size."""
    from repro.configs import SHAPES as JAX_SHAPES
    from repro.configs import get_config as jax_config
    from repro.models import build_model as jax_build
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.models import build_model
    model = build_model(get_config(arch))
    jmodel = jax_build(jax_config(arch))
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
        assert got == want, (arch, name)
