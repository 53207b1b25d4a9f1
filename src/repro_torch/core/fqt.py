"""Fully-Quantized-Training matmul (paper Eq. 3), forward only.

Port of ``repro.core.fqt`` for the serving slice.  For a linear layer
``Y = X @ W`` the forward is ``Y = Q_f(X) @ Q_theta(W)`` with deterministic
per-tensor quantizers.  The backward of Eq. 6 (``torch.autograd.Function``
with the stochastic quantizers and the backward kernels) comes with the
training slice; until then :func:`fqt_matmul` refuses inputs that require a
gradient rather than differentiate through the wrong rule.

On the ``kernel`` backend the activation quantize runs inside the GEMM
(``fused_fqt_fwd``); ``simulate`` quantize-dequantizes both operands and
runs an fp32 matmul.
"""

from __future__ import annotations

from typing import Union

import torch

from .backend import fused_fqt_fwd, qt_gemm
from .policy import QuantPolicy
from .registry import TRAINING_SLICE, GemmQuantConfig, QuantizerSpec, \
    get_quantizer

__all__ = ["fqt_matmul"]


def _fused_roles(cfg: GemmQuantConfig):
    """(fwd, wgrad, agrad) eligibility for the fused kernels.

    ``cfg.fused`` is the knob (None = auto: on for the kernel backend); a
    role only fuses when the fused kernels implement its quantizer — the
    deterministic-PTQ forward, per-tensor stochastic-PTQ wgrad, PTQ/PSQ
    agrad.
    """
    if cfg.backend == "simulate" or not cfg.quantize_fwd:
        return False, False, False
    on = cfg.fused if cfg.fused is not None else (cfg.backend == "kernel")
    if not on:
        return False, False, False
    fwd = cfg.fwd_act.name == "ptq_det" and cfg.fwd_weight.name == "ptq_det"
    wg = fwd and cfg.wgrad is not None and cfg.wgrad.name == "ptq"
    ag = cfg.agrad is not None and cfg.agrad.name in ("ptq", "psq")
    return fwd, wg, ag


def _quantize_role(spec: QuantizerSpec, x2d: torch.Tensor, key,
                   cfg: GemmQuantConfig):
    """Registry dispatch for one tensor role."""
    q = get_quantizer(spec.name)
    if key is None and q.stochastic:
        raise ValueError(
            f"quantizer {spec.name!r} is stochastic and cannot serve a "
            f"forward role (fwd_act/fwd_weight must be deterministic, "
            f"e.g. 'ptq_det')")
    return q.quantize(x2d, key, spec, backend=cfg.backend)


def _fqt_fwd(cfg: GemmQuantConfig, x: torch.Tensor, w: torch.Tensor):
    lead = x.shape[:-1]
    dtype = x.dtype
    # quantizer math in fp32 regardless of activation dtype
    x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
    wq = _quantize_role(cfg.fwd_weight, w.to(torch.float32), None, cfg)
    f_fwd, _, _ = _fused_roles(cfg)
    if f_fwd:
        y, _, _ = fused_fqt_fwd(x2, wq, cfg.fwd_act.bits or 8,
                                backend=cfg.backend)
    else:
        xq = _quantize_role(cfg.fwd_act, x2, None, cfg)          # Q_f
        y = qt_gemm(xq, wq, backend=cfg.backend)
    return y.reshape(*lead, w.shape[-1]).to(dtype)


def fqt_matmul(x: torch.Tensor, w: torch.Tensor, key,
               policy: Union[QuantPolicy, GemmQuantConfig],
               path: str = "") -> torch.Tensor:
    """``x @ w`` under the given quantization policy, forward only.

    x: (..., K) activations; w: (K, N) weights; key: PRNG key for the
    backward quantizers (unused by this forward-only slice; ``None`` is
    accepted).  ``policy`` is a :class:`QuantPolicy`, resolved against
    ``path``, or an already-resolved :class:`GemmQuantConfig`.
    """
    del key                              # consumed by the backward only
    if x.requires_grad or w.requires_grad:
        raise NotImplementedError(
            f"fqt_matmul is forward-only in this port; gradients through it "
            f"come with {TRAINING_SLICE}")
    if isinstance(policy, QuantPolicy):
        if not policy.enabled:
            return x @ w
        cfg = policy.resolve(path)           # validated at resolution
    else:
        cfg = policy.validate()
    if not cfg.quantize_fwd:                 # layer pinned exact
        return x @ w
    return _fqt_fwd(cfg, x, w)
