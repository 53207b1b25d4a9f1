"""Training steps of the Mamba2 hybrid family (zamba2-2.7b's reduced
config) in the port against the JAX package on the CPU.

From the reference's initial state (``interop.train_state_from_jax``),
both packages take one AdamW step on the reference's batch: under
``exact`` (loss and gradient norm at the cross-backend tolerance, rtol
1e-3 / atol 5e-3: the shared block's gradient sums its two uses), under
``fqt(psq, 8)`` against the reference's ``native`` fused twins and under
``fqt(bhq, 5)`` against its ``simulate`` backend, every layer GEMM under
the reference's key (the shared block's keys differ per use: each outer
block's last split), loss at the tolerance, the new rng and step equal.
The quantized steps' gradient norms are held within 5%: random relative
perturbations of the parameters of 1e-7 move the port's loss by up to
1.1e-3 and its gradient norm by up to 0.2% under ``fqt(psq, 8)`` and
4.7% under ``fqt(bhq, 5)`` (per-tensor forward codes flip, and a flipped
code regroups BHQ's rows), and the reference's own ``native`` and
``simulate`` backends part by 1.2% under 5-bit BHQ (25.85 vs 25.53).
(Split from tests/test_torch_mamba2.py: the reference's steps take most
of this file's time to compile.)
"""

import pytest

torch = pytest.importorskip("torch")

from torch_family_ref import family, one_step  # noqa: E402
from torch_one_thread import one_intra_op_thread  # noqa: E402,F401

ARCH = "zamba2-2.7b"


def _layer_gemms():
    """Layer GEMMs a step runs: 5 a Mamba2 layer, and per outer block the
    fuse and the shared block's 4 attention and 3 MLP projections."""
    cfg = family(ARCH).cfg
    return cfg.n_layers * 5 + cfg.n_layers // cfg.hybrid_period * 8


def test_train_step_exact_matches_reference():
    one_step(ARCH, "exact", 0)


@pytest.mark.parametrize("quant,bits,backend", [("psq", 8, "native"),
                                                ("bhq", 5, "simulate")])
def test_train_step_matches_reference(quant, bits, backend):
    one_step(ARCH, quant, bits, backend=backend,
             n_layer_gemms=_layer_gemms(), gnorm_rtol=0.05)
