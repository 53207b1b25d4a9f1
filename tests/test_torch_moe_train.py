"""One FQT training step of the MoE family in the port against the JAX
package on the CPU.

From the reference's initial state of granite-moe-1b-a400m's reduced
config (4 experts top-2; olmoe-1b-7b's reduced config is the same model),
carried into the port (``interop.train_state_from_jax``), both packages
take one AdamW step on the same batch under ``fqt(psq, 8)`` and
``fqt(bhq, 5)``: the port on its ``kernel`` backend (the kernels' plain
versions here).  Every quantized GEMM of the layers gets the reference's
PRNG key (its experts run under ``vmap``, so their keys are recorded at run
time); loss, ``aux`` and the gradient norm agree to the repo's
cross-backend tolerance, rtol 1e-3 / atol 5e-3; the new rng and step are
equal.  (Split from tests/test_torch_moe.py: the reference's step takes
most of this file's time to compile.)
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.layers.common as jax_common  # noqa: E402
import repro_torch.layers.common as common  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import QuantPolicy as JaxPolicy  # noqa: E402
from repro.data import make_batch_for as jax_batch  # noqa: E402
from repro.engine import init_train_state as jax_init  # noqa: E402
from repro.engine import make_step_fn as jax_make_step  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.optim import cosine_schedule as jax_cosine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import QuantPolicy  # noqa: E402
from repro_torch.data import make_batch_for  # noqa: E402
from repro_torch.engine import make_step_fn  # noqa: E402
from repro_torch.interop import train_state_from_jax  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import adamw, cosine_schedule, tree_leaves  # noqa: E402
from torch_one_thread import one_intra_op_thread  # noqa: E402,F401

ARCH = "granite-moe-1b-a400m"
RTOL, ATOL = 1e-3, 5e-3



@functools.lru_cache(maxsize=None)
def _reference_start():
    """The reference's model, initial train state (``init_train_state``
    under ``jax.jit``: one compile instead of an eager run of every op)
    and first batch, shared by both policies."""
    jcfg = jax_config(ARCH, smoke=True)
    jmodel = jax_build(jcfg)
    jstate = jax.jit(lambda: jax_init(jmodel, jax_adamw(), 0))()
    return jmodel, jstate, jax_batch(jcfg, 4, 16, step=0)


def _within(got, want):
    return abs(got - want) <= ATOL + RTOL * abs(want)


def _port_keys(monkeypatch, run):
    calls = []
    real = common.fqt_matmul

    def spy(x, w, key, policy, path=""):
        calls.append((path, np.asarray(key).astype(np.int64).tolist()))
        return real(x, w, key, policy, path=path)
    monkeypatch.setattr(common, "fqt_matmul", spy)
    out = run()
    monkeypatch.undo()
    return out, sorted(calls)


def _jax_keys(monkeypatch, run):
    """The reference's (path, key) of every layer GEMM, recorded at run
    time (``jax.debug.callback``: its experts run under ``vmap``)."""
    calls = []
    real = jax_common.fqt_matmul

    def spy(x, w, key, policy, path=""):
        jax.debug.callback(lambda k, path=path: calls.append(
            (path, np.asarray(k).astype(np.int64).tolist())), key)
        return real(x, w, key, policy, path=path)
    monkeypatch.setattr(jax_common, "fqt_matmul", spy)
    out = jax.block_until_ready(run())
    monkeypatch.undo()
    return out, sorted(calls)


@pytest.mark.parametrize("quant,bits", [("psq", 8), ("bhq", 5)])
def test_one_step_from_a_carried_state(quant, bits, monkeypatch):
    """One AdamW step of granite-moe's reduced config from the reference's
    initial state: every quantized layer GEMM (attention, router, each
    expert's gate/up/down) draws under the reference's key; loss, ``aux``
    and gradient norm within the cross-backend tolerance of the
    reference's ``native`` fused twins (PSQ) or its ``simulate`` backend
    (5-bit BHQ; the gradient norm within it of either backend, whose own
    gap nears the tolerance); the new rng and step equal."""
    kw = dict(bhq_block=32) if quant == "bhq" else {}
    cfg = get_config(ARCH, smoke=True)
    jmodel, jstate, jbatch = _reference_start()

    def jax_step(backend):
        pol = JaxPolicy.fqt(quant, bits, backend=backend, **kw,
                            **(dict(fused=True) if backend == "native"
                               else {}))
        return jax.jit(jax_make_step(jmodel, pol, jax_adamw(),
                                     jax_cosine(3e-3, 10, 1), remat=False))
    # 5-bit BHQ against the reference's simulate backend first (its
    # native one parts from it by 0.0155 of a 0.018 tolerance here)
    backends = ["native", "simulate"][::-1 if quant == "bhq" else 1]
    (jnext, jm), want = _jax_keys(monkeypatch, lambda: jax_step(
        backends[0])(jstate, jbatch))
    step = make_step_fn(build_model(cfg),
                        QuantPolicy.fqt(quant, bits, backend="kernel", **kw),
                        adamw(), cosine_schedule(3e-3, 10, 1), remat=False)
    state = train_state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    (state, mets), got = _port_keys(monkeypatch, lambda: step(
        state, make_batch_for(cfg, 4, 16, step=0)))
    assert len(got) == cfg.n_layers * (4 + 1 + 3 * cfg.moe_experts)
    assert got == want
    for name in ("loss", "aux"):
        assert _within(float(mets[name]), float(jm[name])), (
            name, float(mets[name]), float(jm[name]))
    gnorm, ref_gnorms = float(mets["grad_norm"]), [float(jm["grad_norm"])]
    if quant == "bhq" and not _within(gnorm, ref_gnorms[0]):
        # the reference's own envelope (tests/test_torch_train_steps.py):
        # a float32 round-off code flip regroups BHQ rows
        _, om = jax_step(backends[1])(jstate, jbatch)
        ref_gnorms.append(float(om["grad_norm"]))
    assert any(_within(gnorm, g) for g in ref_gnorms), (gnorm, ref_gnorms)
    assert state.step == int(jnext.step) == 1
    np.testing.assert_array_equal(state.rng.numpy(),
                                  np.asarray(jnext.rng).astype(np.int64))
    assert all(torch.isfinite(t).all() for t in tree_leaves(state.params))
