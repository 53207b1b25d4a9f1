"""Checkpoints of the port (``repro_torch.checkpoint``, the engine's save
and resume) against the JAX package's.

The manager's contract mirrors ``tests/test_checkpoint.py``.  Across the
packages, on reduced statquant-tx (batch 4 x 16 tokens): a checkpoint the
reference's ``Engine`` writes restores in the port with every leaf
exactly equal to the reference's own restore, and the port continues the
run within the repo's cross-backend tolerance of the reference's own
continuation (rtol 1e-3 / atol 5e-3, as ``tests/test_torch_train_steps.py``:
the port on its ``kernel`` backend's plain versions, the reference on its
``native`` fused twins).  The other way, the reference restores the
port's checkpoint with every leaf exactly equal to the port's state and
continues it within the same tolerance of the port, and the two
packages' ``meta.msgpack`` agree on keys, shapes and dtypes.  Within the
port, a resumed or preempted run equals the uninterrupted one bit for
bit (``torch.equal`` on every leaf).
"""

import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import CheckpointManager as JaxCkpt  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import QuantPolicy as JaxPolicy  # noqa: E402
from repro.engine import Engine as JaxEngine  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import QuantPolicy  # noqa: E402
from repro_torch.data import make_batch_for  # noqa: E402
from repro_torch.engine import Engine, TrainState  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.optim import tree_leaves  # noqa: E402
from repro_torch.runtime import PreemptionHandler  # noqa: E402
from torch_one_thread import one_intra_op_thread  # noqa: E402,F401

RTOL, ATOL = 1e-3, 5e-3


def _within(got, want):
    return abs(got - want) <= ATOL + RTOL * abs(want)


# ---------------------------------------------------------------------------
# the manager's contract (tests/test_checkpoint.py)
# ---------------------------------------------------------------------------

def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(4, 8, generator=g),
                       "layers": {"ln": torch.ones(3)}},
            "opt": {"mu": {"w": torch.zeros(4, 8),
                           "layers": {"ln": torch.zeros(3)}}},
            "step": np.asarray(7, np.int32)}


def _assert_tree_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_roundtrip(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    tree = _tree()
    ckpt.save(10, tree)
    assert ckpt.latest_step() == 10
    out = ckpt.restore(10, tree)
    _assert_tree_equal(out, tree)
    assert isinstance(out["params"]["w"], torch.Tensor)
    assert isinstance(out["step"], np.ndarray)


def test_async_save_and_wait(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    tree = _tree(1)
    ckpt.save(1, tree, asynchronous=True)
    ckpt.wait()
    assert ckpt.latest_step() == 1
    out = ckpt.restore(1, tree)
    assert torch.equal(out["params"]["w"], tree["params"]["w"])
    assert len(ckpt.stats["snapshot_s"]) == len(ckpt.stats["write_s"]) == 1


def test_prune_keeps_latest(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ckpt.save(s, _tree(s))
    assert ckpt.all_steps() == [3, 4]


def test_atomicity_no_tmp_left(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(5, _tree())
    names = os.listdir(str(tmp_path))
    assert not any(n.endswith(".tmp") for n in names)
    assert "step_5" in names
    assert ckpt.nbytes(5) > 4 * (32 + 3 + 32 + 3 + 1)


def test_restore_shape_mismatch_raises(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, {"w": torch.zeros(2, 2)})
    with pytest.raises(ValueError):
        ckpt.restore(1, {"w": torch.zeros(3, 3)})


def test_restore_missing_leaf_raises(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, {"w": torch.zeros(2, 2)})
    with pytest.raises(KeyError):
        ckpt.restore(1, {"w": torch.zeros(2, 2), "extra": torch.zeros(1)})


def test_meta(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(3, _tree(), extra={"lr": 0.1})
    meta = ckpt.load_meta(3)
    assert meta["step"] == 3 and meta["lr"] == pytest.approx(0.1)
    assert meta["keys"][0] == "opt\x1fmu\x1flayers\x1fln"
    assert meta["dtypes"]["step"] == "int32"


def test_async_snapshot_is_not_aliased(tmp_path):
    """The optimizer updates tensors in place: a CPU tensor's ``.numpy()``
    shares its memory, so the snapshot must copy before ``save`` returns.
    Mutating the tree right after an asynchronous save leaves the
    checkpoint with the values at the save."""
    ckpt = CheckpointManager(str(tmp_path))
    tree = _tree(2)
    before = tree["params"]["w"].clone()
    ckpt.save(1, tree, asynchronous=True)
    tree["params"]["w"].add_(1.0)
    ckpt.wait()
    out = ckpt.restore(1, tree)
    assert torch.equal(out["params"]["w"], before)


def test_async_engine_save_holds_the_pre_step_state(tmp_path):
    """An engine's asynchronous save at step 2 followed at once by step 3
    (which updates params and moments in place) holds step 2's state."""
    eng = _engine(steps=3, ckpt_dir=str(tmp_path), ckpt_every=2)
    ref = _engine(steps=2)
    ref.run()
    eng.run()
    assert eng.ckpt.all_steps() == [2]
    got = eng.restore_state(2)
    _assert_states_equal(got, ref.state)
    assert not torch.equal(tree_leaves(eng.state.params)[0],
                           tree_leaves(got.params)[0])


# ---------------------------------------------------------------------------
# resume within the port (tests/test_engine.py, tests/test_checkpoint.py)
# ---------------------------------------------------------------------------

def _engine(batch_fn=None, **kw):
    cfg = get_config("statquant-tx", smoke=True)
    pol = QuantPolicy.fqt("bhq", 5, bhq_block=16, backend="kernel")
    args = dict(steps=6, batch_size=4, seq_len=16, log_every=100,
                log_fn=None, batch_fn=batch_fn, device="cpu")
    args.update(kw)
    return Engine(cfg, pol, **args)


def _recording_batch_fn(log):
    cfg = get_config("statquant-tx", smoke=True)

    def fn(step):
        log.append(step)
        return make_batch_for(cfg, 4, 16, step=step, seed=0)
    return fn


def _assert_states_equal(a: TrainState, b: TrainState):
    for name, x, y in (("params", a.params, b.params),
                       ("m", a.opt_state["m"], b.opt_state["m"]),
                       ("v", a.opt_state["v"], b.opt_state["v"])):
        lx, ly = tree_leaves(x), tree_leaves(y)
        assert len(lx) == len(ly)
        for i, (p, q) in enumerate(zip(lx, ly)):
            assert torch.equal(p, q), f"{name} leaf {i}"
    assert a.step == b.step and a.opt_state["t"] == b.opt_state["t"]
    assert torch.equal(a.rng, b.rng)


@pytest.fixture(scope="module")
def uninterrupted():
    """6 uninterrupted steps: (engine, history, batches read)."""
    rec = []
    eng = _engine(_recording_batch_fn(rec))
    return eng, eng.run(), rec


def test_resume_is_bit_identical_and_data_continuous(tmp_path,
                                                     uninterrupted):
    """run-6-steps == run-3-save + restore-run-3, bit for bit: losses,
    parameters, moments, step and rng; the loader continues at batch 3."""
    rec_b1, rec_b2 = [], []
    full_eng, full, rec_a = uninterrupted
    e1 = _engine(_recording_batch_fn(rec_b1), ckpt_dir=str(tmp_path),
                 ckpt_every=3)
    h1 = e1.run(steps=3)
    e2 = _engine(_recording_batch_fn(rec_b2), ckpt_dir=str(tmp_path),
                 ckpt_every=100)
    h2 = e2.run()
    assert full == h1 + h2
    assert [s for s, _ in h1 + h2] == list(range(6))
    assert rec_a[:6] == list(range(6))
    assert rec_b1[:3] == [0, 1, 2]
    assert rec_b2[:3] == [3, 4, 5] and min(rec_b2) == 3
    _assert_states_equal(e2.state, full_eng.state)


def test_preempted_run_resumes_to_the_same_state(tmp_path, uninterrupted):
    """``request_stop`` after step 4 checkpoints synchronously (step 4 is
    not a ``ckpt_every`` step) and stops; a new engine resumes to step 6
    with the uninterrupted run's leaves."""
    full_eng, full, _ = uninterrupted
    prm = PreemptionHandler()
    msgs = []

    def log(m):
        msgs.append(m)
        if "step     3" in m:
            prm.request_stop()
    e1 = _engine(ckpt_dir=str(tmp_path), ckpt_every=3, preemption=prm,
                 log_every=1, log_fn=log)
    h1 = e1.run()
    assert [s for s, _ in h1] == [0, 1, 2, 3]
    assert e1.ckpt.all_steps() == [3, 4]
    assert any("preempted at step 4" in m for m in msgs)
    e2 = _engine(ckpt_dir=str(tmp_path), ckpt_every=100)
    h2 = e2.run()
    assert h1 + h2 == full
    _assert_states_equal(e2.state, full_eng.state)


def test_train_resume_after_preemption(tmp_path):
    """tests/test_checkpoint.py's end-to-end case through ``train_loop``."""
    cfg = get_config("statquant-tx", smoke=True)
    pol = QuantPolicy.fqt("psq", 6, backend="kernel")

    class StopAt(PreemptionHandler):
        def __init__(self, at):
            super().__init__()
            self.at = at
            self.count = 0

        @property
        def should_stop(self):
            self.count += 1
            return self.count >= self.at

    train_loop(cfg, pol, steps=20, batch_size=2, seq_len=8,
               ckpt_dir=str(tmp_path), ckpt_every=5, preemption=StopAt(4),
               log_fn=lambda *a: None, device="cpu")
    step1 = CheckpointManager(str(tmp_path)).latest_step()
    assert step1 is not None and step1 >= 4
    _, _, hist = train_loop(cfg, pol, steps=10, batch_size=2, seq_len=8,
                            ckpt_dir=str(tmp_path), ckpt_every=100,
                            log_fn=lambda *a: None, device="cpu")
    assert hist[0][0] == step1 and hist[-1][0] == 9


def test_legacy_checkpoint_migrates(tmp_path):
    """A pre-engine checkpoint ({params, opt} only) resumes: step comes from
    the checkpoint index, the rng stream restarts at ``fold_in(PRNGKey(
    seed), step)``, as the reference's."""
    from repro_torch import prng
    e = _engine()
    st = e.init_state()
    CheckpointManager(str(tmp_path)).save(
        2, {"params": st.params, "opt": st.opt_state})
    msgs = []
    e2 = _engine(ckpt_dir=str(tmp_path), log_fn=msgs.append)
    restored = e2.restore_state()
    assert restored.step == 2 and restored.opt_state["t"] == 0
    assert torch.equal(restored.rng, prng.fold_in(prng.PRNGKey(0), 2))
    h = e2.run(steps=4)
    assert [s for s, _ in h] == [2, 3]
    assert e2.state.step == 4
    assert any("legacy checkpoint" in m for m in msgs)


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

def _jax_engine(ckpt_dir, steps, ckpt_every):
    return JaxEngine(jax_config("statquant-tx", smoke=True),
                     JaxPolicy.fqt("psq", 8, backend="native", fused=True),
                     steps=steps, batch_size=4, seq_len=16, log_every=100,
                     ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, log_fn=None)


def _port_engine(ckpt_dir, steps, ckpt_every):
    return Engine(get_config("statquant-tx", smoke=True),
                  QuantPolicy.fqt("psq", 8, backend="kernel"), steps=steps,
                  batch_size=4, seq_len=16, log_every=100, ckpt_dir=ckpt_dir,
                  ckpt_every=ckpt_every, log_fn=None, device="cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference trains 4 steps checkpointing at 2 and 4 (dir ``jax``);
    the port trains 2 steps checkpointing at 2 (dir ``port``)."""
    jdir = str(tmp_path_factory.mktemp("jax"))
    pdir = str(tmp_path_factory.mktemp("port"))
    jeng = _jax_engine(jdir, 4, 2)
    jhist = jeng.run()
    peng = _port_engine(pdir, 2, 2)
    peng.run()
    return dict(jdir=jdir, pdir=pdir, jhist=jhist, jeng=jeng, peng=peng)


def _jax_target():
    from repro.engine.state import abstract_train_state
    from repro.models import build_model as jax_build
    from repro.optim import adamw as jax_adamw
    ab = abstract_train_state(jax_build(jax_config("statquant-tx",
                                                   smoke=True)),
                              jax_adamw(), 0)
    return ab.as_dict()


def test_reference_checkpoint_restores_in_the_port(runs):
    """Every leaf the port restores from the reference's step-2 checkpoint
    equals the reference's own restore of it exactly, ``step`` and ``rng``
    included; then the port continues to step 4 within the cross-backend
    tolerance of the reference's own steps 2 and 3."""
    jtree = JaxCkpt(runs["jdir"]).restore(2, _jax_target())
    peng = _port_engine(runs["jdir"], 4, 100)
    state = peng.restore_state(2)
    want = TrainState.from_checkpoint_tree(
        jax.tree.map(np.asarray, jtree))
    for name, got, ref in (("params", state.params, jtree["params"]),
                           ("m", state.opt_state["m"], jtree["opt"]["m"]),
                           ("v", state.opt_state["v"], jtree["opt"]["v"])):
        gl, rl = tree_leaves(got), jax.tree.leaves(ref)
        assert len(gl) == len(rl) > 0
        for i, (g, r) in enumerate(zip(gl, rl)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                          err_msg=f"{name} leaf {i}")
    assert state.step == want.step == 2 and state.opt_state["t"] == 2
    assert torch.equal(state.rng, want.rng)
    np.testing.assert_array_equal(state.rng.numpy().astype(np.uint32),
                                  np.asarray(jtree["rng"]))
    peng.state = state
    hist = peng.run()
    assert [s for s, _ in hist] == [2, 3]
    for (s, got), (_, want_loss) in zip(hist, runs["jhist"][2:]):
        assert _within(got, want_loss), (s, got, want_loss)


def test_port_checkpoint_restores_in_the_reference(runs):
    """The reference restores the port's step-2 checkpoint with every leaf
    exactly equal to the port's state and in its own dtypes, and its
    ``Engine`` resumes it: steps 2 and 3 within the cross-backend
    tolerance of the port's continuation."""
    peng = runs["peng"]
    jtree = JaxCkpt(runs["pdir"]).restore(2, _jax_target())
    pst = peng.state
    for name, got, ref in (("params", jtree["params"], pst.params),
                           ("m", jtree["opt"]["m"], pst.opt_state["m"]),
                           ("v", jtree["opt"]["v"], pst.opt_state["v"])):
        gl, rl = jax.tree.leaves(got), tree_leaves(ref)
        assert len(gl) == len(rl) > 0
        for i, (g, r) in enumerate(zip(gl, rl)):
            np.testing.assert_array_equal(np.asarray(g), r.numpy(),
                                          err_msg=f"{name} leaf {i}")
    assert jtree["step"].dtype == jax.numpy.int32 and int(jtree["step"]) == 2
    assert jtree["opt"]["t"].dtype == jax.numpy.int32
    assert jtree["rng"].dtype == jax.numpy.uint32
    np.testing.assert_array_equal(np.asarray(jtree["rng"]),
                                  pst.rng.numpy().astype(np.uint32))
    # the reference's engine (its step compiled already) resumes the
    # port's checkpoint through its own restore_state
    jeng = runs["jeng"]
    jeng.ckpt, jeng.ckpt_every = JaxCkpt(runs["pdir"]), 100
    jeng.state = jeng.restore_state()
    jhist = jeng.run()
    phist = _port_engine(runs["pdir"], 4, 100).run()
    assert [s for s, _ in jhist] == [s for s, _ in phist] == [2, 3]
    for (s, got), (_, want) in zip(phist, jhist):
        assert _within(got, want), (s, got, want)


def test_meta_matches_the_reference(runs):
    """The port's ``meta.msgpack`` names, shapes and types every leaf as
    the reference's does for the same state (same config, optimizer and
    step)."""
    jmeta = JaxCkpt(runs["jdir"]).load_meta(2)
    pmeta = CheckpointManager(runs["pdir"]).load_meta(2)
    for field in ("keys", "shapes", "dtypes", "step", "data_step"):
        assert pmeta[field] == jmeta[field], field
    assert pmeta["dtypes"]["rng"] == "uint32"
    assert pmeta["dtypes"]["step"] == pmeta["dtypes"]["opt\x1ft"] == "int32"
