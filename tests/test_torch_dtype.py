"""Activation and cache dtypes in the port against the JAX package.

* ``Model.input_specs(shape, dtype)`` for every arch x ``shape_grid``
  cell, at full size, in bfloat16 and float32: the same tree of inputs
  and caches, leaf by leaf in shape and dtype, as the reference's
  ``input_specs`` (its caches from ``jax.eval_shape``);
* bfloat16 activations and caches at the reduced dense (granite-3-2b)
  and audio (whisper-medium) configs: the training loss under
  ``fqt(psq, 8)``, the prefill's logits and two decode steps under
  ``qat``, the port's ``kernel`` backend (its plain versions on the CPU)
  against the reference's ``native`` one, from the same parameters and
  inputs; the caches stay bfloat16.

The tolerance: logits within ``LOGIT_ATOL`` = 0.125 and the loss within
``LOSS_ATOL`` = 5e-3.  A bfloat16 logit near 4 has an ulp of 2^-5, and
the reference's own two backends part by as much in bfloat16: at the
reduced whisper-medium config ``native`` and ``simulate`` differ by
0.0625 in the prefill's logits and 3.3e-3 in the loss (the same inputs,
on the CPU).  Each side rounds its stream to bfloat16 after other ops
(XLA fuses several before it rounds), so their logits part by a few
ulps.  The float32 path is held to float32 round-off by the existing
model tests, unchanged.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import QuantPolicy as JaxPolicy  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs import (ARCH_NAMES, get_config,  # noqa: E402
                                 shape_grid)
from repro_torch.core import QuantPolicy  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from torch_one_thread import one_intra_op_thread  # noqa: E402,F401

LOGIT_ATOL = 0.125
LOSS_ATOL = 5e-3
_DT = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32,
       torch.int32: jnp.int32, torch.int64: jnp.int32}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_input_specs_equal_the_reference(arch, dtype):
    jm = jax_build(jax_config(arch))
    m = build_model(get_config(arch))
    for shape in shape_grid(get_config(arch)):
        want = _leaves(jm.input_specs(shape, dtype=_DT[dtype]))
        got = _leaves(m.input_specs(shape, dtype=dtype))
        assert sorted(got) == sorted(want), (arch, shape.name)
        for path, w in want.items():
            g = got[path]
            assert g.device.type == "meta"
            assert tuple(g.shape) == tuple(w.shape), (shape.name, path)
            assert _DT[g.dtype] == w.dtype, (shape.name, path, g.dtype)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", params=["granite-3-2b", "whisper-medium"])
def pair(request):
    arch = request.param
    jcfg = jax_config(arch, smoke=True)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    p = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    rs = np.random.RandomState(3)
    toks = rs.randint(0, jcfg.vocab_size, (2, 9))
    labels = rs.randint(0, jcfg.vocab_size, (2, 9))
    jb = {"tokens": jnp.asarray(toks, jnp.int32),
          "labels": jnp.asarray(labels, jnp.int32)}
    b = {"tokens": _t(toks), "labels": _t(labels)}
    if jcfg.family == "audio":
        fr = rs.standard_normal((2, jcfg.enc_seq, jcfg.d_model))
        jb["frames"] = jnp.asarray(fr.astype(np.float32))
        b["frames"] = _t(fr.astype(np.float32))
    return jcfg, jm, jp, build_model(get_config(arch, smoke=True)), p, jb, b


def test_bf16_loss_matches_reference(pair):
    jcfg, jm, jp, m, p, jb, b = pair
    jpol = JaxPolicy.fqt("psq", 8, backend="native")
    want = jax.jit(lambda params, batch: jm.loss(
        params, batch, jax.random.PRNGKey(1), jpol,
        dtype=jnp.bfloat16)[0])(jp, jb)
    got, _ = m.loss(p, b, prng.PRNGKey(1),
                    QuantPolicy.fqt("psq", 8, backend="kernel"),
                    dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= LOSS_ATOL


def test_bf16_prefill_and_decode_match_reference(pair):
    jcfg, jm, jp, m, p, jb, b = pair
    jpol, pol = JaxPolicy.qat(backend="native"), QuantPolicy.qat(
        backend="kernel")
    jpre = {k: v for k, v in jb.items() if k != "labels"}
    pre = {k: v for k, v in b.items() if k != "labels"}
    jlog, jcache = jax.jit(lambda params, batch: jm.prefill(
        params, batch, jpol, max_seq=12, dtype=jnp.bfloat16))(jp, jpre)
    log, cache = m.prefill(p, pre, pol, max_seq=12, dtype=torch.bfloat16)
    assert log.dtype == torch.bfloat16
    kv = cache["self_kv" if jcfg.family == "audio" else "kv"]
    assert kv["k"].dtype == torch.bfloat16
    np.testing.assert_allclose(log.float().numpy(),
                               np.asarray(jlog.astype(jnp.float32)),
                               rtol=0, atol=LOGIT_ATOL)
    jdec = jax.jit(lambda params, c, batch: jm.decode(params, c, batch,
                                                      jpol))
    toks = b["tokens"].numpy()
    for s in range(2):
        tk = toks[:, s:s + 1]
        jlog, jcache = jdec(jp, jcache, {"tokens": jnp.asarray(tk,
                                                              jnp.int32)})
        log, cache = m.decode(p, cache, {"tokens": _t(tk)}, pol)
        assert log.dtype == torch.bfloat16
        np.testing.assert_allclose(log.float().numpy(),
                                   np.asarray(jlog.astype(jnp.float32)),
                                   rtol=0, atol=LOGIT_ATOL)
    assert int(cache["index"]) == 9 + 2
