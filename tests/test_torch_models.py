"""The port's dense LM on the CPU against the JAX package: the copied
configs, and ``lm_prefill``/``lm_decode`` logits on the reduced
statquant-tx and granite-3-2b configs, held to the repo's cross-backend
tolerance (rtol 1e-3 / atol 5e-3) under ``exact`` and the serving policy
(``qat`` on JAX's fused ``native`` path against the port's ``kernel``
backend, whose plain versions run on the CPU)."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from test_torch_layers import ARCHS, MODEL_TOL, POLICIES, _np, _t  # noqa: E402
from test_torch_layers import models  # noqa: E402,F401  (fixture)
from repro_torch.configs import get_config  # noqa: E402


def test_configs_are_a_faithful_copy():
    from repro.configs import ALL_NAMES
    for name in ALL_NAMES:
        for smoke in (False, True):
            assert get_config(name, smoke=smoke).__dict__ == \
                jax_config(name, smoke=smoke).__dict__


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("pol", list(POLICIES))
def test_lm_prefill_and_decode_logits(models, arch, pol):
    jcfg, jm, jp, tcfg, tm, tp = models[arch]
    jpol, tpol = POLICIES[pol]
    toks = np.random.RandomState(4).randint(0, jcfg.vocab_size, (2, 9))
    last = np.array([8, 4])
    jlog, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jpol,
                         max_seq=16, last_pos=jnp.asarray(last, jnp.int32))
    tlog, tcache = tm.prefill(tp, {"tokens": _t(toks.astype(np.int64))},
                              tpol, max_seq=16, last_pos=_t(last))
    np.testing.assert_allclose(tlog.numpy(), _np(jlog), **MODEL_TOL)
    assert tcache["kv"]["k"].shape == (jcfg.n_layers, 2, 16,
                                       jcfg.n_kv_heads * jcfg.hd)
    jc = jm.init_cache_quant(jcfg, 2, 16)
    tc = tm.init_cache_quant(tcfg, 2, 16, device="cpu")
    pos = np.array([0, 5])
    for step in range(2):
        tk = toks[:, step:step + 1]
        jlog, jc = jm.decode(jp, jc, {"tokens": jnp.asarray(tk, jnp.int32)},
                             jpol, positions=jnp.asarray(pos + step,
                                                         jnp.int32),
                             kv_quant=True)
        tlog, tc = tm.decode(tp, tc, {"tokens": _t(tk.astype(np.int64))},
                             tpol, positions=_t(pos + step), kv_quant=True)
        np.testing.assert_allclose(tlog.numpy(), _np(jlog), **MODEL_TOL)
    np.testing.assert_array_equal(tc["index"].numpy(), pos + 2)
