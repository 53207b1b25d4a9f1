"""Fully-Quantized-Training matmul (paper Eq. 3/5/6).

Port of ``repro.core.fqt``: the paper's computational primitive as a
``torch.autograd.Function`` (the reference's ``custom_vjp``).  For a
linear layer ``Y = X @ W``:

  forward   (Eq. 3):  ``Y = Q_f(X) @ Q_theta(W)``          (deterministic PTQ)
  backward  (Eq. 6, with the gradient bifurcation of App. E):
      ``dW = Q_f(X)^T @ Q_b1(dY)``   Q_b1 = stochastic per-tensor PTQ
      ``dX = Q_b2(dY) @ Q_theta(W)^T``  Q_b2 in {PTQ, PSQ, BHQ}

Each role's quantizer comes from the registry through the resolved
:class:`~repro_torch.core.registry.GemmQuantConfig`.  A ``None`` backward
role computes that gradient from the dequantized forward operands; both
``None`` is exactly QAT (Eq. 4).  The backward derives its keys as
``split(fold_in(key, 0x5151))`` -> (wgrad, agrad), as the reference does.
STE (Eq. 4): the backward differentiates through the quantized operands,
no gradient flows into the quantizers.

On the ``kernel`` backend the fused roles run the fused CUDA kernels: the
forward quantize inside ``fused_qlhs_matmul``, the PTQ wgrad inside
``fused_qboth_tn_matmul``, the PTQ/PSQ agrad inside
``fused_qlhs_matmul(trans_b=True)``; BHQ's agrad quantizes in PyTorch and
runs ``q8_matmul``.  ``simulate`` quantize-dequantizes and runs fp32
matmuls.  dW comes back in fp32, dX in the stream dtype.
"""

from __future__ import annotations

from typing import Union

import torch

from .. import prng
from .backend import (fused_fqt_dw, fused_fqt_dx, fused_fqt_fwd, qt_gemm,
                      qt_gemm_nt, qt_gemm_tn, requantize_det)
from .policy import QuantPolicy
from .registry import GemmQuantConfig, QuantizerSpec, get_quantizer

__all__ = ["fqt_matmul"]


def _fused_roles(cfg: GemmQuantConfig):
    """(fwd, wgrad, agrad) eligibility for the fused kernels.

    ``cfg.fused`` is the knob (None = auto: on for the kernel backend); a
    role only fuses when the fused kernels implement its quantizer — the
    deterministic-PTQ forward, per-tensor stochastic-PTQ wgrad, PTQ/PSQ
    agrad; the fused wgrad also needs the fused forward's residuals.
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
            f"quantizer {spec.name!r} is stochastic and needs a PRNG key "
            f"(fwd_act/fwd_weight must be deterministic, e.g. 'ptq_det'; "
            f"the backward roles draw from the key given to fqt_matmul)")
    return q.quantize(x2d, key, spec, backend=cfg.backend)


def _fqt_fwd(cfg: GemmQuantConfig, x: torch.Tensor, w: torch.Tensor):
    """(y, residuals) of the forward GEMM."""
    lead = x.shape[:-1]
    # quantizer math in fp32 regardless of activation dtype
    x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
    wq = _quantize_role(cfg.fwd_weight, w.to(torch.float32), None, cfg)
    f_fwd, _, _ = _fused_roles(cfg)
    if f_fwd:
        # Q_f inside the GEMM: residuals (x2, scale, zero); the backward
        # rematerializes the codes deterministically
        y, sx, zx = fused_fqt_fwd(x2, wq, cfg.fwd_act.bits or 8,
                                  backend=cfg.backend)
        xres = (x2, sx, zx)
    else:
        xres = _quantize_role(cfg.fwd_act, x2, None, cfg)         # Q_f
        y = qt_gemm(xres, wq, backend=cfg.backend)
    return y.reshape(*lead, w.shape[-1]).to(x.dtype), (xres, wq, lead)


def _fqt_bwd(cfg: GemmQuantConfig, res, key, g: torch.Tensor):
    """(dx, dw) of the backward GEMMs."""
    xres, wq, lead = res
    dtype = g.dtype                  # cotangent dtype == stream dtype
    g2 = g.reshape(-1, g.shape[-1]).to(torch.float32)
    f_fwd, f_wg, f_ag = _fused_roles(cfg)
    bits_act = (cfg.fwd_act.bits or 8) if cfg.quantize_fwd else 8

    def xq_remat():
        if f_fwd:
            x2, sx, zx = xres
            return requantize_det(x2, sx, zx, bits_act)
        return xres

    if cfg.wgrad is None and cfg.agrad is None:
        # QAT (Eq. 4): full-precision gradient through quantized operands
        dw = xq_remat().dequant().T @ g2
        dx = g2 @ wq.dequant().T
    else:
        if key is None:
            raise ValueError(f"the FQT backward ({cfg.describe()}) needs a "
                             f"PRNG key; fqt_matmul was given None")
        k1, k2 = prng.split(prng.fold_in(key, 0x5151))
        if cfg.wgrad is None:
            dw = xq_remat().dequant().T @ g2
        elif f_wg:
            x2, sx, zx = xres
            dw = fused_fqt_dw(x2, sx, zx, bits_act, g2, k1,
                              cfg.wgrad.bits or 8, backend=cfg.backend)
        else:
            gq1 = _quantize_role(cfg.wgrad, g2, k1, cfg)           # Q_b1
            dw = qt_gemm_tn(xq_remat(), gq1, backend=cfg.backend)
        if cfg.agrad is None:
            dx = g2 @ wq.dequant().T
        elif f_ag:
            dx = fused_fqt_dx(g2, k2, cfg.agrad, wq, backend=cfg.backend)
        else:
            gq2 = _quantize_role(cfg.agrad, g2, k2, cfg)           # Q_b2
            dx = qt_gemm_nt(gq2, wq, backend=cfg.backend)
    return dx.reshape(*lead, -1).to(dtype), dw


class _FQT(torch.autograd.Function):
    """``x @ w`` quantized by ``cfg``: Eq. 3 forward, Eq. 6 backward."""

    @staticmethod
    def forward(ctx, x, w, key, cfg):
        y, res = _fqt_fwd(cfg, x, w)
        ctx.cfg, ctx.res, ctx.key = cfg, res, key
        return y

    @staticmethod
    def backward(ctx, g):
        dx, dw = _fqt_bwd(ctx.cfg, ctx.res, ctx.key, g)
        ctx.res = None                    # free the residuals now
        return dx, dw, None, None


def fqt_matmul(x: torch.Tensor, w: torch.Tensor, key,
               policy: Union[QuantPolicy, GemmQuantConfig],
               path: str = "") -> torch.Tensor:
    """``x @ w`` under the given quantization policy, differentiable.

    x: (..., K) activations; w: (K, N) weights; key: PRNG key (a
    ``prng`` key, kept on the CPU) consumed by the backward's stochastic
    quantizers (``None`` is fine for the forward and for QAT).  ``policy``
    is a :class:`QuantPolicy`, resolved against ``path``, or an
    already-resolved :class:`GemmQuantConfig`.
    """
    if isinstance(policy, QuantPolicy):
        if not policy.enabled:
            return x @ w
        cfg = policy.resolve(path)           # validated at resolution
    else:
        cfg = policy.validate()
    if not cfg.quantize_fwd:                 # layer pinned exact
        return x @ w
    return _FQT.apply(x, w, key, cfg)
