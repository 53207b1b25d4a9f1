"""Per-layer recomputation (``remat``) in the port's training step.

The step with ``remat=True`` recomputes each layer's forward in the
backward (``models.lm.remat_call``: non-reentrant
``torch.utils.checkpoint``).  Its forward quantizers are deterministic and
its SR bits are drawn once, in the backward, from the layer's key, so the
step must equal the step that stores its activations bit for bit: loss,
gradient norm and every updated parameter.  Held under ``fqt(psq, 8)``
and ``fqt(bhq, 5)`` at the reduced statquant-tx (the paper's model), and
under ``fqt(psq, 8)`` at the reduced hybrid (an outer block recomputed
whole), RWKV6 and encoder-decoder configs.  Also: the forward GEMMs of
the layers run twice, the head's once, and the tensors kept for the
backward outside the recomputed layers are fewer bytes than the stored
step keeps.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import QuantPolicy  # noqa: E402
from repro_torch.data.synthetic import make_batch_for  # noqa: E402
from repro_torch.engine import init_train_state, make_step_fn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import sgd, tree_leaves  # noqa: E402
from torch_one_thread import one_intra_op_thread  # noqa: E402,F401

CASES = [("statquant-tx", "psq", 8), ("statquant-tx", "bhq", 5),
         ("zamba2-2.7b", "psq", 8), ("rwkv6-1.6b", "psq", 8),
         ("whisper-medium", "psq", 8)]


def _step(arch, quant, bits, remat, loss_chunks=1):
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    opt = sgd(0.9)
    state = init_train_state(model, opt, seed=0, device="cpu")
    pol = QuantPolicy.fqt(quant, bits, backend="kernel", bhq_block=16)
    step = make_step_fn(model, pol, opt, lambda s: 1e-2, remat=remat,
                        loss_kwargs={"loss_chunks": loss_chunks})
    new, mets = step(state, make_batch_for(cfg, 4, 16, seed=1))
    return mets, tree_leaves(new.params)


@pytest.mark.parametrize("arch,quant,bits", CASES)
def test_remat_step_equals_stored_step(arch, quant, bits):
    m0, p0 = _step(arch, quant, bits, remat=False, loss_chunks=4)
    m1, p1 = _step(arch, quant, bits, remat=True, loss_chunks=4)
    assert torch.equal(m0["loss"], m1["loss"])
    assert torch.equal(m0["grad_norm"], m1["grad_norm"])
    assert len(p0) == len(p1)
    for a, b in zip(p0, p1):
        assert torch.equal(a, b)


def test_remat_recomputes_the_layers_and_keeps_less():
    """The backward runs each layer's forward GEMMs again but its last
    (``fc2``: the backward reads its input, not its output, so the
    recomputation stops before it, as XLA leaves it out of the reference's
    rematerialized forward), and the head's not at all."""
    import repro_torch.core.fqt as fqt
    from torch.autograd.graph import saved_tensors_hooks
    cfg = get_config("statquant-tx", smoke=True)
    calls, kept = [], []
    orig = fqt._fqt_gemm

    def counted(c, res, dtype, n):
        calls.append(n)
        return orig(c, res, dtype, n)

    def pack(t):
        kept.append(t.untyped_storage().nbytes())
        return t
    fqt._fqt_gemm = counted
    try:
        out = {}
        for remat in (False, True):
            calls.clear()
            kept.clear()
            with saved_tensors_hooks(pack, lambda t: t):
                _step("statquant-tx", "psq", 8, remat)
            out[remat] = (len(calls), sum(kept))
    finally:
        fqt._fqt_gemm = orig
    (stored, b0), (remat, b1) = out[False], out[True]
    # per layer wq wk wv wo fc1 fc2, and the head
    assert stored == 6 * cfg.n_layers + 1
    assert remat == stored + 5 * cfg.n_layers
    assert b1 < b0
