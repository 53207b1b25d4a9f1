"""End-to-end behaviour of the port: the paper's claims at smoke scale.

A twin of tests/test_system.py on the port alone (no JAX), at the
reference's scale (reduced statquant-tx, batch 4 x 16 tokens, the same
step counts, learning rates and seeds) and thresholds, on the port's
``kernel`` backend (the kernels' plain versions on the CPU):

  * exact, QAT and FQT@8 (BHQ) all learn, and FQT@8 tracks QAT
    (Table 1, 8-bit rows; Theorem 1 at small eta);
  * at 3 bits BHQ's gradient variance is below PTQ's, on a gradient
    snapshot from the port's own training loop, and BHQ training stays in
    PTQ's loss ballpark or better (Table 1, low-bit rows);
  * the trained model generates;
  * training is deterministic given the seed.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch import prng  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (QuantPolicy, quantize_bhq_stoch,  # noqa: E402
                              quantize_ptq_stoch)
from repro_torch.core.theory import empirical_mean_and_variance  # noqa: E402
from repro_torch.data import make_batch_for  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.layers import apply_norm, embed, lm_head  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from torch_one_thread import one_intra_op_thread  # noqa: E402,F401

CFG = get_config("statquant-tx", smoke=True)



def _train(policy, steps, seed=0, lr=3e-3):
    return train_loop(CFG, policy, steps=steps, batch_size=4, seq_len=16,
                      lr=lr, log_every=5, seed=seed, log_fn=None,
                      device="cpu")


def _final_loss(policy, steps=40, seed=0, lr=4e-3):
    _, _, hist = _train(policy, steps, seed, lr)
    return hist[0][1], hist[-1][1]


def test_exact_and_qat_and_fqt8_all_learn():
    first_e, last_e = _final_loss(QuantPolicy.exact())
    first_q, last_q = _final_loss(QuantPolicy.qat(backend="kernel"))
    first_f, last_f = _final_loss(QuantPolicy.fqt("bhq", 8, bhq_block=16,
                                                  backend="kernel"))
    assert last_e < first_e - 0.2
    assert last_q < first_q - 0.2
    assert last_f < first_f - 0.2
    assert last_f < last_q + 0.4, (last_f, last_q)


def _logits_grad_snapshot(steps=10, batch=4, seq=16, seed=0):
    """Train briefly under QAT, then the gradient of the loss at the
    logits on a fresh batch (softmax - onehot, the tensor ``Q_b2``
    quantizes at the head): the reference's ``grad_snapshot``."""
    pol = QuantPolicy.qat(backend="kernel")
    params, _, _ = _train(pol, steps, seed)
    b = make_batch_for(CFG, batch, seq, step=steps + 1, seed=seed)
    key = prng.PRNGKey(seed)
    with torch.no_grad():
        h = embed(params["embed"], b["tokens"])
        pos = torch.arange(seq).expand(batch, seq)
        h, _, _ = lm._forward_seq(params, h, key, pol, CFG, pos,
                                  want_cache=False)
        h = apply_norm(params["final_norm"], h, CFG.norm)
        logits = lm_head(params["lm_head"], h, key, pol)
    logits.requires_grad_()
    loss = lm.cross_entropy(logits, b["labels"], CFG.vocab_size)
    (g,) = torch.autograd.grad(loss, logits)
    return g.reshape(-1, g.shape[-1])


def test_low_bit_bhq_beats_ptq():
    g = _logits_grad_snapshot()
    _, v_ptq = empirical_mean_and_variance(
        lambda x, k: quantize_ptq_stoch(x, k, 3).dequant(), g,
        prng.PRNGKey(0), 128)
    _, v_bhq = empirical_mean_and_variance(
        lambda x, k: quantize_bhq_stoch(x, k, 3, block_rows=64).dequant(),
        g, prng.PRNGKey(0), 128)
    assert float(v_bhq) < float(v_ptq), (float(v_bhq), float(v_ptq))
    losses = {}
    for quant in ("ptq", "bhq"):
        _, last = _final_loss(QuantPolicy.fqt(quant, 3, bhq_block=16,
                                              backend="kernel"), steps=60)
        losses[quant] = last
    assert losses["bhq"] <= losses["ptq"] + 0.5, losses


def test_trained_model_generates():
    params, _, _ = _train(QuantPolicy.fqt("psq", 6, backend="kernel"), 20)
    batch = {"tokens": torch.ones((2, 8), dtype=torch.int32)}
    toks = generate(build_model(CFG), params, batch,
                    QuantPolicy.qat(backend="kernel"), max_new=4,
                    max_seq=16)
    assert toks.shape == (2, 4)
    assert bool(((toks >= 0) & (toks < CFG.padded_vocab)).all())


def test_deterministic_training_given_seed():
    pol = QuantPolicy.fqt("bhq", 6, bhq_block=16, backend="kernel")
    _, a = _final_loss(pol, steps=10, seed=5)
    _, b = _final_loss(pol, steps=10, seed=5)
    assert a == b
