"""Serving from a training checkpoint in the port
(``ServeEngine.from_checkpoint``, ``launch/serve.py --ckpt-dir``).

On reduced statquant-tx: an engine built from a checkpoint the port's
``Engine`` wrote (dense lanes, ``paged=True``, and ``weight_bits=4``)
emits exactly the greedy tokens of the same engine built from the trained
parameters in memory; an engine built from a checkpoint the JAX package
wrote emits the greedy tokens of the reference's own
``from_checkpoint`` engine, at equal pool size and submission order
(per-tensor ``Q_f`` couples co-resident slots).  Both launchers run from
a checkpoint directory on the CPU.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.checkpoint import CheckpointManager as JaxCkpt  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import QuantPolicy as JaxPolicy  # noqa: E402
from repro.engine import init_train_state as jax_init  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.serve import ServeEngine as JaxServe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import QuantPolicy  # noqa: E402
from repro_torch.engine import Engine  # noqa: E402
from repro_torch.serve import PagedServeEngine, ServeEngine  # noqa: E402
from torch_one_thread import one_intra_op_thread  # noqa: E402,F401

ARCH = "statquant-tx"


def _workload(vocab):
    rng = np.random.RandomState(1)
    return [rng.randint(0, vocab, int(rng.randint(2, 12))) for _ in range(5)]


def _serve(eng, prompts):
    for p in prompts:
        eng.submit(p, max_new=6)
    return {rid: c.tokens for rid, c in eng.run().items()}


@pytest.fixture(scope="module")
def port_ckpt(tmp_path_factory):
    """The port trains 2 steps and checkpoints at step 2."""
    d = str(tmp_path_factory.mktemp("port"))
    eng = Engine(get_config(ARCH, smoke=True),
                 QuantPolicy.fqt("psq", 8, backend="kernel"), steps=2,
                 batch_size=4, seq_len=16, ckpt_dir=d, ckpt_every=2,
                 log_fn=None, device="cpu")
    eng.run()
    return d, eng.state.params


@pytest.mark.parametrize("form", ["dense", "paged", "w4"])
def test_from_checkpoint_serves_the_in_memory_tokens(port_ckpt, form):
    d, params = port_ckpt
    cfg = get_config(ARCH, smoke=True)
    kw = dict(policy=QuantPolicy.qat(backend="kernel"), slots=3, max_seq=32,
              kv_quant=True, seed=0, device="cpu")
    kw.update({"dense": {}, "paged": dict(paged=True, page_size=4),
               "w4": dict(weight_bits=4)}[form])
    loaded = ServeEngine.from_checkpoint(cfg, d, **kw)
    direct = ServeEngine(cfg, params, **kw)
    assert type(loaded) is type(direct)
    assert isinstance(loaded, PagedServeEngine) == (form == "paged")
    if form == "w4":
        assert loaded.params["lm_head"]["w"].bits == 4
    else:
        for name in ("embed", "lm_head"):
            for k, v in direct.params[name].items():
                assert torch.equal(loaded.params[name][k], v), (name, k)
    prompts = _workload(cfg.vocab_size)
    got, want = _serve(loaded, prompts), _serve(direct, prompts)
    assert got == want


def test_reference_checkpoint_serves_the_reference_tokens(tmp_path):
    """A ``TrainState`` checkpoint the JAX package wrote (its manager, a
    state from its own ``init_train_state``): the port's engine from it
    emits the greedy tokens of the reference's own ``from_checkpoint``
    engine (``qat`` on its ``native`` fused twins), 3 slots, the same
    submissions."""
    jcfg = jax_config(ARCH, smoke=True)
    model = jax_build(jcfg)
    state = jax_init(model, jax_adamw(), 3)
    JaxCkpt(str(tmp_path)).save(2, state.as_dict())
    je = JaxServe.from_checkpoint(
        jcfg, str(tmp_path), policy=JaxPolicy.qat(backend="native",
                                                  fused=True),
        slots=3, max_seq=32, kv_quant=True, seed=0)
    te = ServeEngine.from_checkpoint(
        get_config(ARCH, smoke=True), str(tmp_path),
        policy=QuantPolicy.qat(backend="kernel"), slots=3, max_seq=32,
        kv_quant=True, seed=0, device="cpu")
    prompts = _workload(jcfg.vocab_size)
    want = _serve(je, prompts)
    assert _serve(te, prompts) == want


def test_empty_directory_is_refused(tmp_path):
    cfg = get_config(ARCH, smoke=True)
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        ServeEngine.from_checkpoint(cfg, str(tmp_path), device="cpu")
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        ServeEngine.from_checkpoint(cfg, str(tmp_path / "absent"),
                                    device="cpu")
    assert not (tmp_path / "absent").exists()


def test_launchers_run_from_a_checkpoint(port_ckpt, capsys):
    """``launch/train.py --ckpt-dir`` resumes the port's step-2 checkpoint
    and trains steps 2 and 3; ``launch/serve.py --ckpt-dir`` serves it,
    dense and paged."""
    import shutil
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import main as train_main
    d, _ = port_ckpt
    work = d + "_train"
    shutil.copytree(d, work)
    hist = train_main(["--device", "cpu", "--steps", "4", "--batch", "4",
                       "--seq", "16", "--quant", "psq", "--grad-bits", "8",
                       "--backend", "kernel", "--ckpt-dir", work])
    assert [s for s, _ in hist] == [2, 3]
    assert "resumed from step 2" in capsys.readouterr().out
    for extra in ([], ["--paged", "--page-size", "4"]):
        done = serve_main(["--device", "cpu", "--ckpt-dir", d, "--requests",
                           "2", "--max-new", "3"] + extra)
        assert len(done) == 2
        assert "params from the checkpoint" in capsys.readouterr().out
