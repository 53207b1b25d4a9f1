"""Fused quantize -> int8 GEMM -> affine epilogue, the FQT step's GEMMs.

Port of ``repro.kernels.fused_fqt``: two kernel families, each a
hand-written CUDA kernel on the card with its plain PyTorch version beside
it, used on CPU tensors.

``fused_qlhs_matmul`` (Pallas ``_qlhs_kernel``, ``csrc/fused_qlhs.cu``)
    ``Q(xf) @ B-hat`` with the LHS quantized inside the GEMM, so no int8
    codes of it reach device memory.  ``trans_b=False`` is the forward
    ``Q_f(X) @ Q_theta(W)``; ``trans_b=True`` reads the weight codes
    transposed for the activation grad ``Q_b2(dY) @ Q_theta(W).T`` (PTQ or
    PSQ ``Q_b2``, per-row scale/zero as (M, 1), stochastic rounding from
    ``rbits``).
``fused_qboth_tn_matmul`` (Pallas ``_qboth_tn_kernel``,
    ``csrc/fused_qboth_tn.cu``)
    the weight grad ``Q_f(X).T @ Q_b1(dY)``: both operands quantized in
    the K sweep (deterministic A, stochastic B, both per-tensor),
    contracting over their storage rows.

Quantization uses the formulas of ``core/quantizers.py``: deterministic
``round(t)`` (half to even) or ``floor(t + rbits * 2^-32)``, clip to
``[0, 2^b-1]``, shift by ``-2^(b-1)``; scales and zeros come in from
outside.  SR bits are uint32 values held in int64, as ``prng.bits`` draws
them; the kernels take that int64 buffer as it is and read each entry's
low 32 bits as unsigned (modulo 2^32: values >= 2^31 never saturate), so
no wrapper converts or copies them.  The plain versions
evaluate the code GEMM in float64, which is exact for any K the models
reach (products <= 2^14, sums far below 2^53), so they equal the kernels'
int32 accumulation.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .build import load_function
from .checks import check_bits, check_tensor

__all__ = ["fused_qlhs_matmul", "fused_qlhs_matmul_plain",
           "fused_qboth_tn_matmul", "fused_qboth_tn_matmul_plain"]

_U32_TO_UNIT = 1.0 / 4294967296.0          # bits * 2^-32, the one SR rule

# xf, scale_a, zero_a, rbits, y8, alpha_b, beta_b, u, out, M, N, K, bits,
# trans_b, stream
_QLHS_ARGTYPES = ((ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 5
                  + (ctypes.c_void_p,))
# af, scale_a, zero_a, bf, scale_b, zero_b, rbits, a_vec, out, M, N, K,
# bits_a, bits_b, stream
_QBOTH_ARGTYPES = ((ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 5
                   + (ctypes.c_void_p,))


def _shape_nk(xf: torch.Tensor, y8: torch.Tensor, trans_b: bool, who: str):
    N, Kb = (y8.shape if trans_b else y8.shape[::-1])
    if Kb != xf.shape[-1]:
        raise ValueError(
            f"{who}: contraction mismatch — xf {tuple(xf.shape)} vs y8 "
            f"{tuple(y8.shape)} (trans_b={trans_b})")
    return N, Kb


def _sr_unit(rbits: torch.Tensor) -> torch.Tensor:
    """U[0, 1) from uint32 bits: round-to-nearest float32, times 2^-32."""
    return rbits.to(torch.float32) * _U32_TO_UNIT


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
    q = torch.round(t) if rbits is None else torch.floor(t + _sr_unit(rbits))
    c = (torch.clamp(q, 0.0, nbins) - off).to(torch.float64)
    w = y8.to(torch.float64)
    acc = (c @ (w.T if trans_b else w)).to(torch.float32)
    rsum = c.sum(dim=1, keepdim=True).to(torch.float32)
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

    On a CUDA tensor this launches the kernel and counts the launch in
    ``fused_qlhs_matmul.launches`` (and, for ``trans_b=True``, in
    ``fused_qlhs_matmul.launches_dx`` too); on a CPU tensor it runs the
    plain version."""
    check_bits("fused_qlhs_matmul", bits)
    N, K = _shape_nk(xf, y8, trans_b, "fused_qlhs_matmul")
    if xf.device.type == "cpu":
        return fused_qlhs_matmul_plain(xf, scale_a, zero_a, rbits, y8,
                                       alpha_b, beta_b, u_vec, bits=bits,
                                       trans_b=trans_b)
    M = xf.shape[0]
    dev = xf.device
    name = "fused_qlhs_matmul"
    check_tensor(name, "xf", xf, torch.float32, (M, K))
    check_tensor(name, "scale_a", scale_a, torch.float32, (M, 1), dev)
    check_tensor(name, "zero_a", zero_a, torch.float32, (M, 1), dev)
    if rbits is not None:
        check_tensor(name, "rbits", rbits, torch.int64, (M, K), dev)
    check_tensor(name, "y8", y8, torch.int8, (N, K) if trans_b else (K, N),
                 dev)
    check_tensor(name, "alpha_b", alpha_b, torch.float32, (), dev)
    check_tensor(name, "beta_b", beta_b, torch.float32, (), dev)
    check_tensor(name, "u_vec", u_vec, torch.float32, (N,), dev)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    fn = load_function("fused_qlhs", "fused_qlhs", _QLHS_ARGTYPES)
    err = fn(xf.data_ptr(), scale_a.data_ptr(), zero_a.data_ptr(),
             None if rbits is None else rbits.data_ptr(), y8.data_ptr(),
             alpha_b.data_ptr(), beta_b.data_ptr(), u_vec.data_ptr(),
             out.data_ptr(), M, N, K, bits, int(trans_b),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_qlhs_matmul: kernel launch failed with "
                           f"CUDA error {err} at (M, K, N) = ({M}, {K}, {N}), "
                           f"trans_b={trans_b}")
    fused_qlhs_matmul.launches += 1
    if trans_b:
        fused_qlhs_matmul.launches_dx += 1
    return out


fused_qlhs_matmul.launches = 0
fused_qlhs_matmul.launches_dx = 0


def _qboth_shapes(af: torch.Tensor, bf: torch.Tensor, who: str):
    if af.dim() != 2 or bf.dim() != 2 or af.shape[0] != bf.shape[0]:
        raise ValueError(
            f"{who}: contraction mismatch — af {tuple(af.shape)} vs bf "
            f"{tuple(bf.shape)} (both contract over storage rows)")
    return af.shape[0], af.shape[1], bf.shape[1]


def fused_qboth_tn_matmul_plain(af: torch.Tensor, scale_a, zero_a,
                                bf: torch.Tensor, scale_b, zero_b,
                                rbits: torch.Tensor, a_vec: torch.Tensor, *,
                                bits_a: int, bits_b: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_qboth_tn_matmul`."""
    check_bits("fused_qboth_tn_matmul_plain", bits_a)
    check_bits("fused_qboth_tn_matmul_plain", bits_b)
    K, _, _ = _qboth_shapes(af, bf, "fused_qboth_tn_matmul_plain")
    nbins_a = float((1 << bits_a) - 1)
    off_a = float(1 << (bits_a - 1))
    nbins_b = float((1 << bits_b) - 1)
    off_b = float(1 << (bits_b - 1))
    f32 = dict(dtype=torch.float32, device=af.device)
    sa, za = torch.as_tensor(scale_a, **f32), torch.as_tensor(zero_a, **f32)
    sb, zb = torch.as_tensor(scale_b, **f32), torch.as_tensor(zero_b, **f32)
    ca = torch.clamp(torch.round(sa * (af.to(torch.float32) - za)),
                     0.0, nbins_a) - off_a
    cb = torch.clamp(torch.floor(sb * (bf.to(torch.float32) - zb)
                                 + _sr_unit(rbits)), 0.0, nbins_b) - off_b
    cb64 = cb.to(torch.float64)
    acc = (ca.to(torch.float64).T @ cb64).to(torch.float32)
    alpha_a = 1.0 / sa
    beta_a = off_a * alpha_a + za
    alpha_b = 1.0 / sb
    beta_b = off_b * alpha_b + zb
    u_j = alpha_b * cb64.sum(dim=0).to(torch.float32) + float(K) * beta_b
    return acc * (alpha_a * alpha_b) + beta_a * u_j[None, :] + a_vec[:, None]


def fused_qboth_tn_matmul(af: torch.Tensor, scale_a, zero_a,
                          bf: torch.Tensor, scale_b, zero_b,
                          rbits: torch.Tensor, a_vec: torch.Tensor, *,
                          bits_a: int, bits_b: int) -> torch.Tensor:
    """``Q_det(af).T @ Q_sr(bf)`` with both quantizes fused into the K sweep.

    af: (K, M) f32 (the GEMM contracts over the K storage rows); bf: (K, N)
    f32; scale/zero: per-tensor scalars computed on the inputs (0-d f32
    tensors on the card); rbits: (K, N) uint32 values (int64) for B's SR;
    a_vec: (M,) ``alpha_a * beta_b * colsum(ca8)``, computed outside (the
    kernel's A tile never holds a whole column).  Returns (M, N) f32.

    On a CUDA tensor this launches the kernel (counted in
    ``fused_qboth_tn_matmul.launches``); on a CPU tensor it runs the plain
    version."""
    check_bits("fused_qboth_tn_matmul", bits_a)
    check_bits("fused_qboth_tn_matmul", bits_b)
    K, M, N = _qboth_shapes(af, bf, "fused_qboth_tn_matmul")
    if af.device.type == "cpu":
        return fused_qboth_tn_matmul_plain(af, scale_a, zero_a, bf, scale_b,
                                           zero_b, rbits, a_vec,
                                           bits_a=bits_a, bits_b=bits_b)
    dev = af.device
    name = "fused_qboth_tn_matmul"
    check_tensor(name, "af", af, torch.float32, (K, M))
    check_tensor(name, "bf", bf, torch.float32, (K, N), dev)
    for sname, s in (("scale_a", scale_a), ("zero_a", zero_a),
                     ("scale_b", scale_b), ("zero_b", zero_b)):
        check_tensor(name, sname, s, torch.float32, (), dev)
    check_tensor(name, "rbits", rbits, torch.int64, (K, N), dev)
    check_tensor(name, "a_vec", a_vec, torch.float32, (M,), dev)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    fn = load_function("fused_qboth_tn", "fused_qboth_tn", _QBOTH_ARGTYPES)
    err = fn(af.data_ptr(), scale_a.data_ptr(), zero_a.data_ptr(),
             bf.data_ptr(), scale_b.data_ptr(), zero_b.data_ptr(),
             rbits.data_ptr(), a_vec.data_ptr(), out.data_ptr(), M, N, K,
             bits_a, bits_b, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_qboth_tn_matmul: kernel launch failed "
                           f"with CUDA error {err} at (K, M, N) = "
                           f"({K}, {M}, {N})")
    fused_qboth_tn_matmul.launches += 1
    return out


fused_qboth_tn_matmul.launches = 0
