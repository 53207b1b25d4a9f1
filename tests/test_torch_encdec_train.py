"""Training of the audio family (whisper-medium's reduced config) in the
port against the JAX package on the CPU.

* ``encdec_loss`` and every gradient under ``exact`` on the reference's
  parameters, at float32 round-off (rtol 2e-6, atol 2e-5 of the leaf's
  largest entry), but the key projections' biases, whose gradient is
  zero in exact arithmetic: there both packages' round-off stays below
  1e-6 of the largest gradient entry; the cross-attention's K/V gradient
  flows into the encoder;
* from the reference's initial state (``interop.train_state_from_jax``),
  one AdamW step on the reference's batch in both packages under
  ``fqt(psq, 8)`` and ``fqt(bhq, 5)`` (the reference on its ``simulate``
  backend, whose step compiles faster than the ``native`` fused twins'
  and whose gradient norms agree with theirs to 1e-5 under psq8 and
  0.09% under bhq5 here): every layer GEMM under the
  reference's key (32 of them: 6 an encoder layer, 10 a decoder layer),
  loss at the cross-backend tolerance (rtol 1e-3, atol 5e-3), the new rng
  and step equal; the gradient norm at that tolerance under ``fqt(psq,
  8)`` and within 3% under ``fqt(bhq, 5)``, where the reduced config's
  quantized gradient is chaotic under float32 round-off: random relative
  perturbations of the parameters of 1e-7 move the port's 5-bit BHQ
  gradient norm by up to 2.4% (4.952 to 5.073) and its 8-bit PSQ norm by
  up to 0.3% (per-tensor forward codes flip, and a flipped code regroups
  BHQ's rows); the port's norm is 4.9520 against the reference's 4.9409
  (``simulate``) and 4.9453 (``native``).
(Split from tests/test_torch_encdec.py: the reference's step compiles
take most of this file's time.)
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import QuantPolicy as JaxPolicy  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import QuantPolicy  # noqa: E402
from repro_torch.optim import tree_leaves, tree_map  # noqa: E402
from torch_family_ref import _t, family, one_step  # noqa: E402
from torch_one_thread import one_intra_op_thread  # noqa: E402,F401

ARCH = "whisper-medium"


def _layer_gemms():
    cfg = family(ARCH).cfg
    return 6 * cfg.enc_layers + 10 * cfg.n_layers


def test_exact_loss_and_grads_match_reference():
    fam = family(ARCH)
    rng = np.random.RandomState(1)
    cfg = fam.cfg
    x = {"frames": (rng.randn(2, cfg.enc_seq, cfg.d_model) * 0.02).astype(
             np.float32),
         "tokens": rng.randint(0, cfg.vocab_size, (2, 8)).astype(np.int32),
         "labels": rng.randint(0, cfg.vocab_size, (2, 8)).astype(np.int32)}

    def f(p, b):
        return fam.jm.loss(p, b, jax.random.PRNGKey(5), JaxPolicy.exact())[0]
    jl, jg = jax.jit(jax.value_and_grad(f))(fam.jp, x)
    params = tree_map(lambda t: t.clone().requires_grad_(), fam.p)
    leaves = tree_leaves(params)
    loss, mets = fam.m.loss(params, {k: _t(v) for k, v in x.items()},
                            prng.PRNGKey(5), QuantPolicy.exact())
    assert mets["ce"] is loss
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    named = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jg))[0]
    assert len(grads) == len(named)
    peak = max(float(np.abs(w).max()) for _, w in named)
    for g, (path, want) in zip(grads, named):
        name = jax.tree_util.keystr(path)
        if name.endswith("['wk']['b']"):
            # zero in exact arithmetic (a key bias shifts every score of a
            # query alike); both packages leave round-off there
            assert max(float(g.abs().max()),
                       float(np.abs(want).max())) <= 1e-6 * peak, name
            continue
        np.testing.assert_allclose(g.numpy(), want, rtol=2e-6,
                                   atol=2e-5 * np.abs(want).max(),
                                   err_msg=name)
    # the encoder's output reaches the loss only through the
    # cross-attention's K/V, and its weights learn
    enc_wq = params["enc_layers"]["attn"]["wq"]["w"]
    i = next(i for i, t in enumerate(leaves) if t is enc_wq)
    assert float(grads[i].abs().max()) > 0


@pytest.mark.parametrize("quant,bits", [("psq", 8), ("bhq", 5)])
def test_train_step_matches_reference(quant, bits):
    one_step(ARCH, quant, bits, backend="simulate",
             n_layer_gemms=_layer_gemms(),
             gnorm_rtol=0.03 if quant == "bhq" else None)
