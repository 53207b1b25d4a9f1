"""The MoE family in the port against the JAX package on the CPU.

At the reduced configs of granite-moe-1b-a400m and olmoe-1b-7b (4 experts
top-2, d_ff 32), with the same parameters (``interop.params_from_jax``)
and inputs made from a numpy seed:

* ``moe_block``: routing (``top_i``, position within the expert, ``keep``)
  identical, output and load-balance loss at float32 round-off under
  ``exact``, ``qat`` and ``fqt(psq, 8)`` (the port on its ``kernel``
  backend's plain versions, the reference on its ``native`` fused twins);
  a router whose columns tie, an all-zero router (every token ties, two
  experts overflow, two receive nothing) and a capacity small enough to
  drop tokens, each routed and computed as the reference does;
* training: under ``exact`` the loss, ``aux`` and every gradient at
  float32 round-off (the quantized steps are in
  tests/test_torch_moe_train.py); the engine and the CLI;
* serving: greedy tokens of the dense and paged engines, with fp32
  weights and at ``weight_bits=4`` (its packed expert leaves bit for
  bit), equal to the JAX engine's; ``generate`` and the CLI;
* checkpoints: either package restores the other's MoE train state leaf
  for leaf.

The two reduced configs differ only in their names and sources, so the
reference's side of each comparison is computed once per config without
them.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.layers.common as jax_common  # noqa: E402
import repro_torch.layers.common as common  # noqa: E402
from repro.checkpoint import CheckpointManager as JaxCkpt  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import QuantPolicy as JaxPolicy  # noqa: E402
from repro.data import make_batch_for as jax_batch  # noqa: E402
from repro.engine import init_train_state as jax_init  # noqa: E402
from repro.engine.state import abstract_train_state  # noqa: E402
from repro.layers import moe as jax_moe  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import QuantPolicy  # noqa: E402
from repro_torch.data import make_batch_for  # noqa: E402
from repro_torch.engine import Engine, TrainState  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.kernels import PackedTensor  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.layers import moe  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import tree_leaves, tree_map  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from torch_one_thread import one_intra_op_thread  # noqa: E402,F401

ARCHS = ("granite-moe-1b-a400m", "olmoe-1b-7b")
RTOL, ATOL = 1e-3, 5e-3
_REF = {}          # reference results, keyed by (config without name, what)


def _reference(cfg, what, fn):
    """``fn()`` once per (config without its name and source, ``what``)."""
    key = (dataclasses.replace(cfg, name="", source=""), what)
    if key not in _REF:
        _REF[key] = fn()
    return _REF[key]


def _within(got, want):
    return abs(got - want) <= ATOL + RTOL * abs(want)


def _close(got, want):
    """float32 round-off: the repo's kernel-level tolerance."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-6,
                               atol=2e-5 * float(np.abs(want).max()))


def _params(arch):
    """(JAX params, the port's copy on the CPU)."""
    jcfg = jax_config(arch, smoke=True)
    jp = _reference(jcfg, "params",
                    lambda: jax_build(jcfg).init(jax.random.PRNGKey(0)))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


# ---------------------------------------------------------------------------
# moe_block
# ---------------------------------------------------------------------------

POLICIES = {
    "exact": (lambda: JaxPolicy.exact(), lambda: QuantPolicy.exact()),
    "qat": (lambda: JaxPolicy.qat(backend="native", fused=True),
            lambda: QuantPolicy.qat(backend="kernel")),
    "fqt_psq8": (lambda: JaxPolicy.fqt("psq", 8, backend="native",
                                       fused=True),
                 lambda: QuantPolicy.fqt("psq", 8, backend="kernel")),
}


def _jax_route(probs, K, C):
    """The reference's routing (``repro.layers.moe.moe_block``) on
    ``probs``: top-K by ``jax.lax.top_k``, positions by the token-major
    cumulative count."""
    E = probs.shape[-1]
    top_p, top_i = jax.lax.top_k(jnp.asarray(probs), K)
    flat_e = top_i.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(onehot, axis=0) - 1,
                              flat_e[:, None], axis=1)[:, 0]
    return np.asarray(top_i), np.asarray(pos), np.asarray(pos < C)


def _block_pair(arch, pol, router=None, capacity=None):
    """Run both packages' ``moe_block`` (layer 0's parameters, optionally
    another router kernel or capacity factor) on the same input; return
    the two (y, aux), both routings and the config."""
    jp, tp = _params(arch)
    jcfg, cfg = jax_config(arch, smoke=True), get_config(arch, smoke=True)
    if capacity is not None:
        jcfg = dataclasses.replace(jcfg, moe_capacity=capacity)
        cfg = dataclasses.replace(cfg, moe_capacity=capacity)
    jlp = jax.tree.map(lambda a: a[0], jp["layers"]["moe"])
    if router is not None:
        jlp = {**jlp, "router": {"w": jnp.asarray(router)}}
    tlp = params_from_jax(jax.tree.map(np.asarray, jlp), "cpu")
    x = np.random.RandomState(3).randn(2, 8, cfg.d_model).astype(np.float32)
    jpol, tpol = (f() for f in POLICIES[pol])
    N = x.shape[0] * x.shape[1]
    C = moe.expert_capacity(N, cfg)
    assert C == jax_moe.expert_capacity(N, jcfg)

    def run(p, x):
        y, aux = jax_moe.moe_block(p, x, jax.random.PRNGKey(4), jpol, jcfg)
        logits = jax_common.dense(p["router"], x.reshape(N, -1),
                                  jax.random.PRNGKey(4), jpol, 0x20,
                                  "moe.router")
        return y, aux, jax.nn.softmax(logits.astype(jnp.float32), -1)

    def ref():
        jitted = _reference(jcfg, ("jit", pol), lambda: jax.jit(run))
        y, aux, probs = jitted(jlp, x)
        return (np.asarray(y), float(aux),
                _jax_route(probs, jcfg.moe_topk, C))
    jy, jaux, jroute = _reference(
        jcfg, ("block", pol, None if router is None else router.tobytes()),
        ref)
    y, aux = moe.moe_block(tlp, torch.from_numpy(x), prng.PRNGKey(4), tpol,
                           cfg)
    logits = common.dense(tlp["router"], torch.from_numpy(x).reshape(N, -1),
                          prng.PRNGKey(4), tpol, 0x20, "moe.router")
    _, top_i, pos, keep, _ = moe.moe_route(
        torch.softmax(logits, dim=-1), cfg.moe_topk, C)
    route = (top_i.numpy(), pos.numpy(), keep.numpy())
    return (y.numpy(), float(aux)), (jy, jaux), route, jroute, cfg


def _assert_routes(route, jroute):
    for got, want, what in zip(route, jroute, ("top_i", "pos", "keep")):
        np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("pol", list(POLICIES))
def test_moe_block_matches_reference(arch, pol):
    (y, aux), (jy, jaux), route, jroute, _ = _block_pair(arch, pol)
    _assert_routes(route, jroute)
    _close(y, jy)
    np.testing.assert_allclose(aux, jaux, rtol=2e-6)


@pytest.mark.parametrize("pol", list(POLICIES))
def test_tied_router_columns_route_lower_expert_first(pol):
    """Experts 1 and 2 get identical router columns, so their logits (and
    probabilities) tie exactly for every token: the lower index ranks
    first, as ``jax.lax.top_k`` ranks it, also where the tie straddles the
    top-K boundary (1 kept, 2 not)."""
    jp, _ = _params(ARCHS[0])
    w = np.array(jp["layers"]["moe"]["router"]["w"][0])
    w[:, 2] = w[:, 1]
    (y, aux), (jy, jaux), route, jroute, _ = _block_pair(ARCHS[0], pol,
                                                         router=w)
    _assert_routes(route, jroute)
    top_i = route[0]
    assert np.array_equal(top_i[top_i[:, 1] == 2], np.tile([1, 2], (
        int(np.sum(top_i[:, 1] == 2)), 1)))
    assert not np.any(top_i[:, 0] == 2)
    assert np.any(top_i[:, 1] == 1) and np.any(top_i[:, 1] == 2)
    _close(y, jy)
    np.testing.assert_allclose(aux, jaux, rtol=2e-6)


@pytest.mark.parametrize("pol", list(POLICIES))
def test_all_tied_router_overflows_and_leaves_experts_empty(pol):
    """A zero router: every probability ties, every token routes to
    experts 0 and 1, which overflow their capacity (the later tokens of
    the token-major order dropped), and experts 2 and 3 run on all-zero
    buffers (``range_scale``'s clamp)."""
    jp, _ = _params(ARCHS[0])
    w = np.zeros_like(np.asarray(jp["layers"]["moe"]["router"]["w"][0]))
    (y, aux), (jy, jaux), route, jroute, cfg = _block_pair(ARCHS[0], pol,
                                                           router=w)
    _assert_routes(route, jroute)
    top_i, pos, keep = route
    assert set(np.unique(top_i)) == {0, 1}
    assert not keep.all() and keep.any()
    _close(y, jy)
    np.testing.assert_allclose(aux, jaux, rtol=2e-6)


@pytest.mark.parametrize("pol", ["exact", "fqt_psq8"])
def test_capacity_overflow_drops_the_same_tokens(pol):
    (y, aux), (jy, jaux), route, jroute, cfg = _block_pair(
        ARCHS[0], pol, capacity=0.5)
    _assert_routes(route, jroute)
    assert not route[2].all()
    _close(y, jy)
    np.testing.assert_allclose(aux, jaux, rtol=2e-6)


def test_moe_block_without_key_draws_nothing():
    """Serving passes ``key=None``: no split, the forward as with a key."""
    jp, _ = _params(ARCHS[0])
    cfg = get_config(ARCHS[0], smoke=True)
    lp = params_from_jax(jax.tree.map(lambda a: np.asarray(a)[0],
                                      jp["layers"]["moe"]), "cpu")
    x = torch.from_numpy(np.random.RandomState(5).randn(
        1, 5, cfg.d_model).astype(np.float32))
    pol = QuantPolicy.qat(backend="kernel")
    y0, a0 = moe.moe_block(lp, x, None, pol, cfg)
    y1, a1 = moe.moe_block(lp, x, prng.PRNGKey(9), pol, cfg)
    assert torch.equal(y0, y1) and torch.equal(a0, a1)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_exact_loss_aux_and_grads_match_reference(arch):
    """Under ``exact``: the loss (with ``0.01 * aux / n_layers``), ``aux``
    and every gradient (router through the routing weights and the aux
    loss, experts through dispatch and combine) at float32 round-off."""
    jp, tp = _params(arch)
    jcfg, cfg = jax_config(arch, smoke=True), get_config(arch, smoke=True)
    jmodel, model = jax_build(jcfg), build_model(cfg)
    batch = jax_batch(jcfg, 4, 16, step=0)

    def ref():
        def f(p):
            return jmodel.loss(p, batch, jax.random.PRNGKey(5),
                               JaxPolicy.exact())
        (l, m), g = jax.jit(jax.value_and_grad(f, has_aux=True))(jp)
        return float(l), float(m["aux"]), jax.tree.map(np.asarray, g)
    jl, jaux, jgrads = _reference(jcfg, "exact_grads", ref)
    params = tree_map(lambda t: t.requires_grad_(), tp)
    leaves = tree_leaves(params)
    loss, mets = model.loss(params, make_batch_for(cfg, 4, 16, step=0),
                            prng.PRNGKey(5), QuantPolicy.exact())
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), jl, rtol=1e-6)
    np.testing.assert_allclose(float(mets["aux"].detach()), jaux, rtol=1e-6)
    assert mets["ce"] is loss
    jleaves = jax.tree.leaves(jgrads)
    assert len(grads) == len(jleaves)
    for g, jg in zip(grads, jleaves):
        np.testing.assert_allclose(g.numpy(), jg, rtol=2e-6,
                                   atol=2e-5 * np.abs(jg).max())


def test_engine_and_cli_train_moe(capsys):
    from repro_torch.launch.train import main
    history = main(["--device", "cpu", "--arch", "olmoe-1b-7b", "--steps",
                    "2", "--batch", "2", "--seq", "8", "--quant", "psq",
                    "--backend", "kernel"])
    assert [s for s, _ in history] == [0, 1]
    assert all(np.isfinite(loss) for _, loss in history)
    assert "[engine] step     1" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _drive(eng, prompts, max_new=5):
    for p in prompts:
        eng.submit(p, max_new=max_new)
    out = eng.run()
    return {r: out[r].tokens for r in sorted(out)}


# port engine -> (the JAX engine it is held to, its options): a one-token
# paged step is the dense engine's step arithmetically (whole-prompt
# prefill), in both packages, so the fp32-weight engines share the JAX
# dense engine and the 4-bit ones the JAX paged 4-bit engine
SERVE = {"dense": ("fp32", {}),
         "paged": ("fp32", dict(paged=True, page_size=4)),
         "w4": ("w4", dict(weight_bits=4)),
         "w4_paged": ("w4", dict(weight_bits=4, paged=True, page_size=4))}
JAX_SERVE = {"fp32": {}, "w4": dict(weight_bits=4, paged=True, page_size=4)}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", list(SERVE))
def test_engine_greedy_tokens_equal_jax(arch, kind):
    """Prompts of one bucket, more requests than slots, greedy: the JAX
    engine's tokens under ``qat(native)``; at 4 bits every expert leaf
    packs to the reference's codes, scales and zeros (one pair a layer and
    expert)."""
    jp, tp = _params(arch)
    jcfg, cfg = jax_config(arch, smoke=True), get_config(arch, smoke=True)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist()
               for n in (5, 7, 6, 8)]
    base = dict(slots=2, max_seq=16, kv_quant=True, seed=0)
    ref_kind, opts = SERVE[kind]

    def ref():
        je = JaxEngine(jcfg, jp, policy=JaxPolicy.qat(backend="native",
                                                      fused=True),
                       **base, **JAX_SERVE[ref_kind])
        leaf = je.params["layers"]["moe"]["experts"]["down"]["w"]
        return _drive(je, prompts), jax.tree.map(np.asarray, leaf)
    want, jleaf = _reference(jcfg, ("engine", ref_kind), ref)
    te = ServeEngine(cfg, tp, policy=QuantPolicy.qat(backend="kernel"),
                     device="cpu", **base, **opts)
    assert _drive(te, prompts) == want
    if ref_kind == "w4":
        leaf = te.params["layers"]["moe"]["experts"]["down"]["w"]
        assert isinstance(leaf, PackedTensor)
        assert leaf.scale.shape == (cfg.n_layers, cfg.moe_experts, 1, 1)
        np.testing.assert_array_equal(leaf.packed.numpy(), jleaf.packed)
        np.testing.assert_array_equal(leaf.scale.numpy(), jleaf.scale)
        np.testing.assert_array_equal(leaf.zero.numpy(), jleaf.zero)
    if opts.get("paged"):
        te.check_invariants()


def test_generate_and_serve_cli_run_moe(capsys):
    from repro_torch.launch.serve import main
    cfg = get_config(ARCHS[0], smoke=True)
    _, tp = _params(ARCHS[0])
    toks = torch.ones((2, 6), dtype=torch.int32)
    out = generate(build_model(cfg), tp, {"tokens": toks},
                   QuantPolicy.qat(backend="kernel"), max_new=3, max_seq=10)
    assert out.shape == (2, 3)
    assert bool(((out >= 0) & (out < cfg.padded_vocab)).all())
    done = main(["--device", "cpu", "--requests", "2", "--max-new", "2",
                 "--arch", "granite-moe-1b-a400m", "--paged"])
    assert len(done) == 2
    assert "[serve] 2 requests" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _assert_leaves_equal(ref, mine):
    rl, ml = jax.tree.leaves(ref), tree_leaves(mine)
    assert len(rl) == len(ml) > 0
    for r, m in zip(rl, ml):
        np.testing.assert_array_equal(np.asarray(r), m.numpy())


def test_checkpoints_cross_both_ways(tmp_path):
    """The reference's MoE train state restores in the port, and the
    port's (after one step) in the reference, every leaf equal."""
    arch = ARCHS[0]
    jcfg, cfg = jax_config(arch, smoke=True), get_config(arch, smoke=True)
    jmodel = jax_build(jcfg)
    jstate = jax_init(jmodel, jax_adamw(), 0)
    JaxCkpt(str(tmp_path / "jax")).save(0, jstate.as_dict(),
                                        asynchronous=False)

    def engine(d, **kw):
        return Engine(cfg, QuantPolicy.fqt("psq", 8, backend="kernel"),
                      steps=1, batch_size=2, seq_len=8, log_fn=None,
                      device="cpu", ckpt_dir=str(tmp_path / d), **kw)
    got = engine("jax").restore_state(0)
    _assert_leaves_equal(jstate.params, got.params)
    _assert_leaves_equal(jstate.opt_state["m"], got.opt_state["m"])
    assert torch.equal(got.rng, TrainState.from_checkpoint_tree(
        jax.tree.map(np.asarray, jstate.as_dict())).rng)

    peng = engine("port", ckpt_every=1)
    peng.run()
    target = abstract_train_state(jmodel, jax_adamw(), 0).as_dict()
    jtree = JaxCkpt(str(tmp_path / "port")).restore(1, target)
    pst = peng.state
    _assert_leaves_equal(jtree["params"], pst.params)
    _assert_leaves_equal(jtree["opt"]["m"], pst.opt_state["m"])
    _assert_leaves_equal(jtree["opt"]["v"], pst.opt_state["v"])
    assert int(jtree["step"]) == 1
    assert (CheckpointManager(str(tmp_path / "port")).load_meta(1)["keys"]
            == JaxCkpt(str(tmp_path / "jax")).load_meta(0)["keys"])
