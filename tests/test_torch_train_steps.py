"""Three FQT training steps of reduced statquant-tx in the port against the
JAX package, from a carried state.

Before every step the reference's state (parameters, AdamW moments and
count, step, rng) is carried into the port (``interop.train_state_from_jax``)
and both take the step on the same batch: the port on its ``kernel``
backend (the kernels' plain versions on the CPU), the reference on its
``native`` fused twins.  Loss and gradient norm are held to the repo's
cross-backend tolerance, rtol 1e-3 / atol 5e-3; the new rng and the step
counts must be equal.

The update itself is held at float32 round-off.  Quantized gradients part
from the reference's by whole-code flips, so the port's new parameters and
AdamW moments are held against the reference's own clip, schedule and
AdamW applied to the gradients the port's step clipped (recorded on their
way in).  Under ``exact`` there is no code to flip: there the loss, the
gradient norm and the moments of the whole step, with and without
gradient accumulation, are held against the reference's step at float32
round-off.  Its parameters are not: AdamW divides by ``sqrt(v) + eps``,
so a gradient entry a few ``eps`` from zero turns its float32 round-off
into a visible part of the update (1.4e-6 on an update of 3e-3 here).

Under 5-bit BHQ the gradient norm is held against the reference's own
envelope: the nearest of its ``native`` fused and ``simulate`` backends.
float32 round-off in the unquantized ops (norms, softmax, GELU) flips an
occasional activation code under the per-tensor ``Q_f``; under BHQ that
regroups rows and draws other SR noise for them, which moves the gradient
norm by up to 0.3%, and the reference's two backends part by as much
(9.8588 vs 9.8892 at step 1 here), beyond the tolerance.  The port lands
within the tolerance of one of them at every step.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import QuantPolicy as JaxPolicy  # noqa: E402
from repro.data import make_batch_for as jax_batch  # noqa: E402
from repro.engine import init_train_state as jax_init  # noqa: E402
from repro.engine import make_step_fn as jax_make_step  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.optim import clip_by_global_norm as jax_clip  # noqa: E402
from repro.optim import cosine_schedule as jax_cosine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import QuantPolicy  # noqa: E402
from repro_torch.data import make_batch_for  # noqa: E402
import repro_torch.engine.step as tstep  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.engine import make_step_fn  # noqa: E402
from repro_torch.interop import train_state_from_jax  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import adamw, cosine_schedule  # noqa: E402

RTOL, ATOL = 1e-3, 5e-3


# float32 round-off of one step's update, against the leaf's largest entry
STATE_RTOL = 1e-5


def _within(got, want):
    return abs(got - want) <= ATOL + RTOL * abs(want)


def _record_clipped_grads(monkeypatch) -> list:
    """Record, as numpy trees, the gradients each port step clips."""
    seen = []
    clip = tstep.clip_by_global_norm

    def spy(grads, max_norm):
        seen.append(optim.tree_map(lambda g: g.detach().numpy().copy(),
                                   grads))
        return clip(grads, max_norm)
    monkeypatch.setattr(tstep, "clip_by_global_norm", spy)
    return seen


def _reference_update(jstate, grads, lr_fn):
    """The reference step's clip, schedule and AdamW on ``grads``."""
    grads, _ = jax_clip(jax.tree.map(jnp.asarray, grads), 1.0)
    return jax_adamw().apply(jstate.params, grads, jstate.opt_state,
                             lr_fn(jstate.step))


def _assert_state(state, params, opt_state, what):
    """The port's params (unless ``params`` is None) and AdamW m/v equal
    the reference's to float32 round-off, leaf by leaf (atol scaled to the
    leaf's largest entry)."""
    for name, got, want in (("params", state.params, params),
                            ("m", state.opt_state["m"], opt_state["m"]),
                            ("v", state.opt_state["v"], opt_state["v"])):
        if want is None:
            continue
        gl, wl = optim.tree_leaves(got), jax.tree.leaves(want)
        assert len(gl) == len(wl)
        for i, (g, w) in enumerate(zip(gl, wl)):
            w = np.asarray(w)
            np.testing.assert_allclose(
                g.numpy(), w, rtol=STATE_RTOL,
                atol=STATE_RTOL * float(np.abs(w).max()),
                err_msg=f"{what}: {name} leaf {i}")
    assert state.opt_state["t"] == int(opt_state["t"])


@pytest.mark.parametrize("quant,bits", [("psq", 8), ("bhq", 5)])
def test_three_steps_from_a_carried_state(quant, bits, monkeypatch):
    kw = dict(bhq_block=32) if quant == "bhq" else {}
    lr_fn = jax_cosine(3e-3, 10, 1)
    grads_seen = _record_clipped_grads(monkeypatch)
    jcfg = jax_config("statquant-tx", smoke=True)
    jmodel = jax_build(jcfg)
    refs = {"native": JaxPolicy.fqt(quant, bits, backend="native",
                                    fused=True, **kw)}
    if quant == "bhq":
        refs["simulate"] = JaxPolicy.fqt(quant, bits, **kw)
    jsteps = {name: jax.jit(jax_make_step(jmodel, pol, jax_adamw(), lr_fn,
                                          remat=False))
              for name, pol in refs.items()}
    cfg = get_config("statquant-tx", smoke=True)
    step = make_step_fn(build_model(cfg),
                        QuantPolicy.fqt(quant, bits, backend="kernel", **kw),
                        adamw(), cosine_schedule(3e-3, 10, 1), remat=False)
    jstate = jax_init(jmodel, jax_adamw(), 0)
    for s in range(3):
        jbatch = jax_batch(jcfg, 4, 16, step=s)
        batch = make_batch_for(cfg, 4, 16, step=s)
        state = train_state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
        state, mets = step(state, batch)
        outs = {name: f(jstate, jbatch) for name, f in jsteps.items()}
        jnext, jm = outs["native"]
        loss, gnorm = float(mets["loss"]), float(mets["grad_norm"])
        assert _within(loss, float(jm["loss"])), (s, loss, float(jm["loss"]))
        ref_gnorms = [float(m["grad_norm"]) for _, m in outs.values()]
        assert any(_within(gnorm, g) for g in ref_gnorms), (s, gnorm,
                                                            ref_gnorms)
        if quant == "psq":
            assert _within(gnorm, ref_gnorms[0]), (s, gnorm, ref_gnorms)
        assert mets["lr"] == float(jm["lr"])
        assert state.step == int(jnext.step) == s + 1
        assert state.opt_state["t"] == int(jnext.opt_state["t"])
        np.testing.assert_array_equal(
            state.rng.numpy(), np.asarray(jnext.rng).astype(np.int64))
        assert len(grads_seen) == s + 1
        _assert_state(state, *_reference_update(jstate, grads_seen[s], lr_fn),
                      f"step {s}")
        jstate = jnext


@pytest.mark.parametrize("accum", [1, 2])
def test_exact_steps_match_the_reference_state(accum, monkeypatch):
    """No quantizer: two whole steps from a carried state, with a learning
    rate above 0 from the first: loss, gradient norm and AdamW moments
    (the gradients, with the microbatch accumulation) equal the
    reference's step at float32 round-off, and the parameters equal the
    reference's update of the port's own gradients."""
    lr_fn = jax_cosine(3e-3, 10, 0)
    grads_seen = _record_clipped_grads(monkeypatch)
    jcfg = jax_config("statquant-tx", smoke=True)
    jmodel = jax_build(jcfg)
    jstep = jax.jit(jax_make_step(jmodel, JaxPolicy.exact(), jax_adamw(),
                                  lr_fn, remat=False, accum_steps=accum))
    cfg = get_config("statquant-tx", smoke=True)
    step = make_step_fn(build_model(cfg), QuantPolicy.exact(), adamw(),
                        cosine_schedule(3e-3, 10, 0), remat=False,
                        accum_steps=accum)
    jstate = jax_init(jmodel, jax_adamw(), 0)
    for s in range(2):
        state = train_state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
        state, mets = step(state, make_batch_for(cfg, 4, 16, step=s))
        jnext, jm = jstep(jstate, jax_batch(jcfg, 4, 16, step=s))
        np.testing.assert_allclose(float(mets["loss"]), float(jm["loss"]),
                                   rtol=STATE_RTOL)
        np.testing.assert_allclose(float(mets["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=STATE_RTOL)
        assert mets["lr"] == float(jm["lr"]) > 0
        _assert_state(state, None, jnext.opt_state, f"step {s}")
        _assert_state(state, *_reference_update(jstate, grads_seen[s], lr_fn),
                      f"step {s}")
        jstate = jnext


def test_accumulated_fqt_step_from_a_carried_state(monkeypatch):
    """Two microbatches under fqt(psq, 8), each with its own
    ``fold_in(base, i)`` key: loss and gradient norm within the
    cross-backend tolerance of the reference's accumulated step, and the
    update at float32 round-off from the port's own gradients."""
    lr_fn = jax_cosine(3e-3, 10, 0)
    grads_seen = _record_clipped_grads(monkeypatch)
    jcfg = jax_config("statquant-tx", smoke=True)
    jmodel = jax_build(jcfg)
    jstep = jax.jit(jax_make_step(
        jmodel, JaxPolicy.fqt("psq", 8, backend="native", fused=True),
        jax_adamw(), lr_fn, remat=False, accum_steps=2))
    cfg = get_config("statquant-tx", smoke=True)
    step = make_step_fn(build_model(cfg),
                        QuantPolicy.fqt("psq", 8, backend="kernel"), adamw(),
                        cosine_schedule(3e-3, 10, 0), remat=False,
                        accum_steps=2)
    jstate = jax_init(jmodel, jax_adamw(), 0)
    state = train_state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    state, mets = step(state, make_batch_for(cfg, 4, 16, step=0))
    jnext, jm = jstep(jstate, jax_batch(jcfg, 4, 16, step=0))
    assert _within(float(mets["loss"]), float(jm["loss"]))
    assert _within(float(mets["grad_norm"]), float(jm["grad_norm"]))
    assert len(grads_seen) == 1
    _assert_state(state, *_reference_update(jstate, grads_seen[0], lr_fn),
                  "accumulated step")
    np.testing.assert_array_equal(
        state.rng.numpy(), np.asarray(jnext.rng).astype(np.int64))
