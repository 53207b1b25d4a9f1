"""The port's ``native`` backend end to end against the JAX package's:
reduced statquant-tx serving under ``qat(native)`` with the int8 KV cache
and 4-bit packed weights (unpacked for ``torch._int_mm``) emits the
reference engine's greedy tokens (the same parameters, 3 slots, the same
submissions), and training steps from a carried reference state keep the
loss and gradient norm within the repo's cross-backend tolerance (rtol
1e-3 / atol 5e-3) of the reference's ``native`` step.  The fp32-weight and
BHQ GEMMs are held one by one in tests/test_torch_native.py."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import QuantPolicy as JaxPolicy  # noqa: E402
from repro.data import make_batch_for as jax_batch  # noqa: E402
from repro.engine import init_train_state as jax_init  # noqa: E402
from repro.engine import make_step_fn as jax_make_step  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.optim import cosine_schedule as jax_cosine  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import QuantPolicy  # noqa: E402
from repro_torch.data import make_batch_for  # noqa: E402
from repro_torch.engine import make_step_fn  # noqa: E402
from repro_torch.interop import (params_from_jax,  # noqa: E402
                                 train_state_from_jax)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import adamw, cosine_schedule  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

RTOL, ATOL = 1e-3, 5e-3


def test_native_serving_tokens_equal_the_reference():
    """Reduced statquant-tx under ``qat(native)`` with the int8 KV cache
    and 4-bit packed weights: greedy tokens equal the reference engine's
    at 3 slots and the same submissions."""
    bits = 4
    jcfg = jax_config("statquant-tx", smoke=True)
    jp = jax_build(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    je = JaxEngine(jcfg, jp, policy=JaxPolicy.qat(backend="native"),
                   slots=3, max_seq=32, kv_quant=True, seed=0,
                   weight_bits=bits)
    te = ServeEngine(get_config("statquant-tx", smoke=True), tp,
                     policy=QuantPolicy.qat(backend="native"), slots=3,
                     max_seq=32, kv_quant=True, seed=0, weight_bits=bits,
                     device="cpu")
    rng = np.random.RandomState(1)
    for _ in range(5):
        p = rng.randint(0, jcfg.vocab_size, int(rng.randint(2, 12)))
        je.submit(p, max_new=6)
        te.submit(p, max_new=6)
    want, got = je.run(), te.run()
    assert {r: c.tokens for r, c in got.items()} == \
        {r: c.tokens for r, c in want.items()}


def test_native_training_steps_match_the_reference():
    """Two steps of reduced statquant-tx under ``fqt(psq, 8)`` on
    ``native`` from a carried reference state: loss and gradient norm
    within the cross-backend tolerance of the reference's ``native`` step,
    the same rng and step.  (BHQ on ``native`` is held GEMM by GEMM in
    tests/test_torch_native.py.)"""
    lr_fn = jax_cosine(3e-3, 10, 1)
    jcfg = jax_config("statquant-tx", smoke=True)
    jmodel = jax_build(jcfg)
    jstep = jax.jit(jax_make_step(
        jmodel, JaxPolicy.fqt("psq", 8, backend="native"), jax_adamw(),
        lr_fn, remat=False))
    cfg = get_config("statquant-tx", smoke=True)
    step = make_step_fn(build_model(cfg),
                        QuantPolicy.fqt("psq", 8, backend="native"),
                        adamw(), cosine_schedule(3e-3, 10, 1), remat=False)
    jstate = jax_init(jmodel, jax_adamw(), 0)
    for s in range(2):
        state = train_state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
        state, mets = step(state, make_batch_for(cfg, 4, 16, step=s))
        jnext, jm = jstep(jstate, jax_batch(jcfg, 4, 16, step=s))
        for got, want in ((float(mets["loss"]), float(jm["loss"])),
                          (float(mets["grad_norm"]), float(jm["grad_norm"]))):
            assert abs(got - want) <= ATOL + RTOL * abs(want), (s, got, want)
        assert state.step == int(jnext.step) == s + 1
        np.testing.assert_array_equal(
            state.rng.numpy(), np.asarray(jnext.rng).astype(np.int64))
        jstate = jnext
