"""Fused quantize -> int8 GEMM -> affine epilogue.

Port of ``repro.kernels.fused_fqt.fused_qlhs_matmul`` (the Pallas kernel
``_qlhs_kernel``): ``Q(xf) @ B-hat`` with the LHS quantized inside the GEMM,
so no int8 activation codes reach device memory.  On the card the forward
mode (``trans_b=False``, deterministic rounding) runs the hand-written CUDA
kernel ``csrc/fused_qlhs.cu``; on the CPU every mode runs
:func:`fused_qlhs_matmul_plain`, the same arithmetic in PyTorch.  The
activation-grad mode (``trans_b=True``) and stochastic rounding from
``rbits`` run on the card with the training slice.

Quantization uses the formulas of ``core/quantizers.py``: deterministic
``round(t)`` (half to even) or ``floor(t + rbits * 2^-32)``, clip to
``[0, 2^b-1]``, shift by ``-2^(b-1)``; scales and zeros come in from
outside.  The epilogue is

    out_ij = acc_ij*(alpha_a*alpha_b) + beta_a*u_j + (alpha_a*beta_b)*rsum_i

with ``alpha_a = 1/scale_i``, ``beta_a = 2^(b-1)*alpha_a + zero_i`` and
``acc``/``rsum`` the exact integer code GEMM and row sum.  The plain
version evaluates the code GEMM in float64, which is exact for any K the
models reach (products <= 2^14, sums far below 2^53), so it equals the
kernel's int32 accumulation.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .build import load_function
from .checks import check_bits, check_tensor

__all__ = ["fused_qlhs_matmul", "fused_qlhs_matmul_plain"]

_U32_TO_UNIT = 1.0 / 4294967296.0          # bits * 2^-32, the one SR rule

# xf, scale_a, zero_a, w8, alpha_b, beta_b, u, out, M, N, K, bits, stream
_ARGTYPES = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,)

_TRAINING_SLICE = ("the training slice of the port (dX mode and stochastic "
                   "rounding of fused_qlhs_matmul on the card)")


def _shape_nk(xf: torch.Tensor, y8: torch.Tensor, trans_b: bool, who: str):
    N, Kb = (y8.shape if trans_b else y8.shape[::-1])
    if Kb != xf.shape[-1]:
        raise ValueError(
            f"{who}: contraction mismatch — xf {tuple(xf.shape)} vs y8 "
            f"{tuple(y8.shape)} (trans_b={trans_b})")
    return N, Kb


def fused_qlhs_matmul_plain(xf: torch.Tensor, scale_a: torch.Tensor,
                            zero_a: torch.Tensor,
                            rbits: Optional[torch.Tensor], y8: torch.Tensor,
                            alpha_b, beta_b, u_vec: torch.Tensor, *,
                            bits: int, trans_b: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_qlhs_matmul`, every mode."""
    check_bits("fused_qlhs_matmul_plain", bits)
    _shape_nk(xf, y8, trans_b, "fused_qlhs_matmul_plain")
    nbins = float((1 << bits) - 1)
    off = float(1 << (bits - 1))
    M = xf.shape[0]
    scale_a = scale_a.reshape(M, 1)
    zero_a = zero_a.reshape(M, 1)
    t = scale_a * (xf.to(torch.float32) - zero_a)
    if rbits is None:
        q = torch.round(t)
    else:
        q = torch.floor(t + rbits.to(torch.float32) * _U32_TO_UNIT)
    c = torch.clamp(q, 0.0, nbins) - off
    w = y8.to(torch.float64)
    acc = (c.to(torch.float64) @ (w.T if trans_b else w)).to(torch.float32)
    rsum = c.to(torch.float64).sum(dim=1, keepdim=True).to(torch.float32)
    alpha_a = 1.0 / scale_a
    beta_a = off * alpha_a + zero_a
    ab = torch.as_tensor(alpha_b, dtype=torch.float32, device=xf.device)
    bb = torch.as_tensor(beta_b, dtype=torch.float32, device=xf.device)
    a_i = (alpha_a * bb) * rsum
    return acc * (alpha_a * ab) + beta_a * u_vec.reshape(1, -1) + a_i


def fused_qlhs_matmul(xf: torch.Tensor, scale_a: torch.Tensor,
                      zero_a: torch.Tensor, rbits: Optional[torch.Tensor],
                      y8: torch.Tensor, alpha_b, beta_b, u_vec: torch.Tensor,
                      *, bits: int, trans_b: bool = False) -> torch.Tensor:
    """``Q(xf) @ B-hat`` (or ``@ B-hat.T``) with the quantize fused in.

    xf: (M, K) f32; scale_a/zero_a: (M, 1) per-row (a per-tensor scalar
    broadcast to (M, 1)); rbits: (M, K) uint32 values (int64) for SR or
    ``None`` for round-to-nearest; y8: shifted int8 RHS codes, (K, N) or —
    ``trans_b=True`` — (N, K); alpha_b/beta_b: the RHS's scalar affine
    factors (0-d tensors on the card, so no launch waits on the host);
    u_vec: (N,) ``alpha_b * colsum(y8) + K * beta_b``.  Returns (M, N) f32.

    On a CUDA tensor this launches the kernel (counted in
    ``fused_qlhs_matmul.launches``); on a CPU tensor it runs the plain
    version."""
    check_bits("fused_qlhs_matmul", bits)
    N, K = _shape_nk(xf, y8, trans_b, "fused_qlhs_matmul")
    if xf.device.type == "cpu":
        return fused_qlhs_matmul_plain(xf, scale_a, zero_a, rbits, y8,
                                       alpha_b, beta_b, u_vec, bits=bits,
                                       trans_b=trans_b)
    if trans_b or rbits is not None:
        raise NotImplementedError(
            f"fused_qlhs_matmul(trans_b={trans_b}, rbits="
            f"{'given' if rbits is not None else None}) on the card comes "
            f"with {_TRAINING_SLICE}")
    M = xf.shape[0]
    dev = xf.device
    name = "fused_qlhs_matmul"
    check_tensor(name, "xf", xf, torch.float32, (M, K))
    check_tensor(name, "scale_a", scale_a, torch.float32, (M, 1), dev)
    check_tensor(name, "zero_a", zero_a, torch.float32, (M, 1), dev)
    check_tensor(name, "y8", y8, torch.int8, (K, N), dev)
    check_tensor(name, "alpha_b", alpha_b, torch.float32, (), dev)
    check_tensor(name, "beta_b", beta_b, torch.float32, (), dev)
    check_tensor(name, "u_vec", u_vec, torch.float32, (N,), dev)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    fn = load_function("fused_qlhs", "fused_qlhs_fwd", _ARGTYPES)
    err = fn(xf.data_ptr(), scale_a.data_ptr(), zero_a.data_ptr(),
             y8.data_ptr(), alpha_b.data_ptr(), beta_b.data_ptr(),
             u_vec.data_ptr(), out.data_ptr(), M, N, K, bits,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_qlhs_matmul: kernel launch failed with "
                           f"CUDA error {err} at (M, K, N) = ({M}, {K}, {N})")
    fused_qlhs_matmul.launches += 1
    return out


fused_qlhs_matmul.launches = 0
