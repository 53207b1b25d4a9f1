"""Quantized-GEMM execution backends: simulate | native | kernel.

Port of ``repro.core.backend`` for the serving slice.  The affine-epilogue
algebra that turns an integer GEMM accumulator back into real values lives
here, once.  Writing each affine operand over shifted-signed codes,

    A-hat_ik = alpha_a,i * a8_ik + beta_a,i     (per-row or per-tensor)
    B-hat_kj = alpha_b   * b8_kj + beta_b       (per-tensor)

the exact product expands into

    (A-hat B-hat)_ij = acc_ij*rs_i*cs_j + r2_i*u_j + a_i + b_j

    rs_i = alpha_a,i                   cs_j = alpha_b
    r2_i = beta_a,i                    u_j  = alpha_b*colsum(b8)_j + K*beta_b
    a_i  = alpha_a,i*beta_b*rowsum(a8)_i          b_j = bias (free slot)

Backends:

  ``simulate``  quantize-dequantize fp32 matmul — the paper's GPU simulation
  ``kernel``    the fused quantize->GEMM->epilogue CUDA kernel
                (kernels/fused_fqt.py; its plain version on the CPU)
  ``native``    the unfused int8 GEMM (``q8_matmul``): training slice
"""

from __future__ import annotations

import torch

from ..kernels.fused_fqt import fused_qlhs_matmul
from .quantizers import QTensor, tensor_min_max
from .registry import BACKENDS, TRAINING_SLICE

__all__ = ["BACKENDS", "affine_factors", "epilogue_coeffs", "apply_epilogue",
           "qt_gemm", "fused_fqt_fwd"]

_EPS = 1e-12        # matches core/quantizers._EPS — one zero-range guard


def affine_factors(scale, zero, bits: int):
    """(alpha, beta) with ``x-hat = alpha*c8 + beta`` for shifted codes c8:
    ``alpha = 1/scale``, ``beta = 2^(b-1)/scale + zero``."""
    off = 1 << (bits - 1)
    alpha = 1.0 / torch.as_tensor(scale, dtype=torch.float32)
    beta = off * alpha + torch.as_tensor(zero, dtype=torch.float32,
                                         device=alpha.device)
    return alpha, beta


def _vec(v, n: int, device) -> torch.Tensor:
    """Normalize a scalar / (n,) / (n,1) coefficient to a (n,) f32 vector."""
    v = torch.as_tensor(v, dtype=torch.float32, device=device).reshape(-1)
    return v if v.shape[0] == n else v.expand(n)


def epilogue_coeffs(a8: torch.Tensor, alpha_a, beta_a, b8: torch.Tensor,
                    alpha_b, beta_b, bias=None):
    """The epilogue coefficient vectors (rs, cs, r2, u, a, b) for a8 (M, K)
    shifted codes with per-row or per-tensor factors and b8 (K, N) with
    per-tensor factors; ``bias`` fills the free b_j slot."""
    m, kdim = a8.shape
    n = b8.shape[1]
    dev = a8.device
    alpha_b = torch.as_tensor(alpha_b, dtype=torch.float32,
                              device=dev).reshape(())
    beta_b = torch.as_tensor(beta_b, dtype=torch.float32, device=dev).reshape(())
    rowsum = a8.to(torch.int32).sum(dim=1).to(torch.float32)
    colsum = b8.to(torch.int32).sum(dim=0).to(torch.float32)
    rs = _vec(alpha_a, m, dev)
    r2 = _vec(beta_a, m, dev)
    cs = alpha_b.expand(n)
    u = alpha_b * colsum + float(kdim) * beta_b
    a = rs * beta_b * rowsum
    b = (torch.zeros((n,), dtype=torch.float32, device=dev) if bias is None
         else _vec(bias, n, dev))
    return rs, cs, r2, u, a, b


def apply_epilogue(acc: torch.Tensor, rs, cs, r2, u, a, b) -> torch.Tensor:
    """out[i,j] = acc[i,j]*rs_i*cs_j + r2_i*u_j + a_i + b_j (f32)."""
    return (acc * rs[:, None] * cs[None, :]
            + r2[:, None] * u[None, :] + a[:, None] + b[None, :])


def _codes_dequant2d(qt: QTensor) -> torch.Tensor:
    d = qt.dequant()
    return d.reshape(-1, d.shape[-1])


def qt_gemm(aq: QTensor, bq: QTensor, *, backend: str) -> torch.Tensor:
    """Forward GEMM ``A-hat @ B-hat`` (Eq. 3: ``Q_f(X) @ Q_theta(W)``) from
    two quantized operands.  The unfused int8 GEMM of the ``native`` and
    ``kernel`` backends comes with the training slice."""
    if backend == "simulate":
        return _codes_dequant2d(aq) @ _codes_dequant2d(bq)
    if backend in BACKENDS:
        raise NotImplementedError(
            f"the unfused int8 GEMM of backend {backend!r} comes with "
            f"{TRAINING_SLICE}")
    raise ValueError(f"unknown backend {backend!r}; expected one of "
                     f"{BACKENDS}")


def _ptq_range(x2: torch.Tensor, bits: int):
    """Per-tensor (zero, scale) exactly as ``quantize_ptq_det``."""
    B = float((1 << bits) - 1)
    zero, hi = tensor_min_max(x2)
    scale = B / torch.clamp_min(hi - zero, _EPS)
    return zero, scale


def fused_fqt_fwd(x2: torch.Tensor, wq: QTensor, bits_act: int, *,
                  backend: str):
    """Forward Eq. 3 ``Q_f(x2) @ W-hat`` with Q_f fused into the GEMM.

    Returns (y, scale_x, zero_x) — the scale/zero are the residuals the
    backward will rematerialize the activation codes from."""
    if backend != "kernel":
        if backend in BACKENDS:
            raise NotImplementedError(
                f"the fused forward of backend {backend!r} comes with "
                f"{TRAINING_SLICE}")
        raise ValueError(f"unknown fused backend {backend!r}; expected "
                         f"'kernel'")
    M, K = x2.shape
    zero, scale = _ptq_range(x2, bits_act)
    sa = scale.reshape(1, 1).expand(M, 1).contiguous()
    za = zero.reshape(1, 1).expand(M, 1).contiguous()
    w8 = wq.int8_codes.reshape(-1, wq.shape[-1])
    alpha_b, beta_b = affine_factors(wq.scale, wq.zero, wq.bits)
    colsum = w8.to(torch.int32).sum(dim=0).to(torch.float32)
    u = alpha_b * colsum + float(K) * beta_b
    y = fused_qlhs_matmul(x2.contiguous(), sa, za, None, w8, alpha_b, beta_b,
                          u, bits=bits_act)
    return y, scale, zero
