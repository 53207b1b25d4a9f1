"""Standalone wrappers wiring the kernels to the paper's quantizer algebra.

Port of ``repro.kernels.ops``.  The affine-epilogue algebra lives in one
place, ``core/backend.py`` (``affine_factors`` / ``epilogue_coeffs``);
these wrappers only choose operands and kernels.  ``fused_qlinear`` is the
standalone forward (per-row stochastic activation quantize, per-tensor
deterministic weights, the int8 GEMM); ``fused_qlinear_bwd`` the two
backward GEMMs of Eq. 6 in the same standalone form.  The training path
itself runs through ``core.fqt.fqt_matmul``.

Each wrapper runs on the device of its tensors: on the card the CUDA
kernels launch, on the CPU their plain versions run.  This module is not
imported by ``repro_torch.kernels``: it depends on ``core/backend.py``,
which imports the kernel modules, so ``from repro_torch.kernels.ops
import ...``.
"""

from __future__ import annotations

import torch

from .. import prng
from ..core.backend import (affine_factors, epilogue_coeffs, qt_gemm_nt,
                            qt_gemm_tn, quantize_sr_rows_qt,
                            quantize_sr_tensor_qt)
from ..core.bhq import quantize_bhq_stoch
from ..core.quantizers import quantize_ptq_det
from .q8_matmul import q8_matmul, q8_matmul_plain
from .quantize_sr import quantize_sr_rows, quantize_sr_rows_plain

__all__ = ["fused_qlinear", "fused_qlinear_bwd", "fused_quantize_psq",
           "fused_quantize_ptq"]


def fused_qlinear(x: torch.Tensor, w: torch.Tensor, key, act_bits: int = 8,
                  weight_bits: int = 8, use_kernels: bool = True):
    """Forward FQT linear through the kernels.

    1. per-row (PSQ-style) stochastic quantize of x -> int8 codes
       (``quantize_sr_rows``, SR bits ``prng.bits(key, (M, K))``)
    2. per-tensor deterministic quantize of w -> int8 codes
       (round-half-even)
    3. the int8 GEMM with the affine epilogue (``q8_matmul``) -> f32

    ``use_kernels=False`` runs both kernels' plain versions (also on the
    card).  Returns ``(y, {"cx", "cw", "sx", "sw"})``.
    """
    M, K = x.shape
    K2, N = w.shape
    if K != K2:
        raise ValueError(f"fused_qlinear: contraction mismatch — x "
                         f"{tuple(x.shape)} vs w {tuple(w.shape)}")
    rbits = prng.bits(key, (M, K), x.device)
    sr_rows = quantize_sr_rows if use_kernels else quantize_sr_rows_plain
    cx, sx, zx = sr_rows(x.contiguous(), rbits, act_bits)

    wq = quantize_ptq_det(w, weight_bits)
    cw, sw = wq.int8_codes, wq.scale
    ax, bx = affine_factors(sx, zx, act_bits)           # per-row (M, 1)
    aw, bw = affine_factors(sw, wq.zero, weight_bits)   # per-tensor scalars
    coeffs = epilogue_coeffs(cx, ax, bx, cw, aw, bw)
    gemm = q8_matmul if use_kernels else q8_matmul_plain
    y = gemm(cx, cw, *(c.contiguous() for c in coeffs))
    return y, {"cx": cx, "cw": cw, "sx": sx, "sw": sw}


def fused_qlinear_bwd(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                      key, act_bits: int = 8, weight_bits: int = 8,
                      wgrad_bits: int = 8, grad_bits: int = 8,
                      grad_quantizer: str = "psq", bhq_block: int = 1024):
    """Both backward GEMMs of Eq. 6 through the kernels::

        dW = Q_f(X)^T @ Q_b1(dY)      (Q_b1: per-tensor SR quantize)
        dX = Q_b2(dY) @ Q_theta(W)^T  (Q_b2: ptq | psq SR quantize / bhq)

    ``key`` splits once into the two roles' keys.  The GEMMs run on the
    ``kernel`` backend (``q8_matmul``), the PTQ and PSQ quantizers through
    the ``quantize_sr`` kernels.  Returns ``(dw, dx)``."""
    k1, k2 = prng.split(key)
    xq = quantize_ptq_det(x, act_bits)
    wq = quantize_ptq_det(w, weight_bits)
    gq1 = quantize_sr_tensor_qt(g, k1, wgrad_bits)
    if grad_quantizer == "ptq":
        gq2 = quantize_sr_tensor_qt(g, k2, grad_bits)
    elif grad_quantizer == "psq":
        gq2 = quantize_sr_rows_qt(g, k2, grad_bits)
    else:
        gq2 = quantize_bhq_stoch(g, k2, grad_bits, block_rows=bhq_block)
    dw = qt_gemm_tn(xq, gq1, backend="kernel")
    dx = qt_gemm_nt(gq2, wq, backend="kernel")
    return dw, dx


def fused_quantize_psq(g: torch.Tensor, key, bits: int) -> torch.Tensor:
    """PSQ gradient quantize through ``quantize_sr_rows``, dequantized."""
    return quantize_sr_rows_qt(g, key, bits).dequant()


def fused_quantize_ptq(g: torch.Tensor, key, bits: int) -> torch.Tensor:
    """PTQ gradient quantize through ``quantize_sr_tensor``, dequantized."""
    return quantize_sr_tensor_qt(g, key, bits).dequant()
