"""Quantized-GEMM execution backends: simulate | native | kernel.

Port of ``repro.core.backend``.  The affine-epilogue algebra that turns an
integer GEMM accumulator back into real values lives here, once.  Writing
each affine operand over shifted-signed codes,

    A-hat_ik = alpha_a,i * a8_ik + beta_a,i     (per-row or per-tensor)
    B-hat_kj = alpha_b   * b8_kj + beta_b       (per-tensor)

the exact product expands into

    (A-hat B-hat)_ij = acc_ij*rs_i*cs_j + r2_i*u_j + a_i + b_j

    rs_i = alpha_a,i                   cs_j = alpha_b
    r2_i = beta_a,i                    u_j  = alpha_b*colsum(b8)_j + K*beta_b
    a_i  = alpha_a,i*beta_b*rowsum(a8)_i          b_j = bias (free slot)

so one epilogue form serves the forward GEMM (Eq. 3) and both backward
GEMMs (Eq. 6).  Backends:

  ``simulate``  quantize-dequantize fp32 matmul — the paper's GPU simulation
  ``kernel``    the hand-written CUDA kernels (their plain versions on the
                CPU): the fused quantize->GEMM->epilogue kernels of
                ``kernels/fused_fqt.py`` for the fused roles, ``q8_matmul``
                for the unfused GEMMs (the BHQ activation grad, and every
                GEMM of an unfused role), whose PTQ/PSQ operands the
                ``quantize_sr`` kernels quantize; against a bit-packed
                weight (:class:`~repro_torch.kernels.pack.PackedTensor`) the
                forward runs ``fused_qlhs_packed_matmul`` (fused) or
                ``packed_matmul`` (unfused), which stream the packed bytes
  ``native``    ``torch._int_mm`` on the same int8 codes (the reference's
                XLA ``dot_general(int8, int8 -> int32)``) + the epilogue as
                torch ops; a packed weight is unpacked first, as the
                reference's ``packed_matmul_xla`` does.  Every role runs
                unfused (the library product has no quantize to fuse), so
                ``fused=True`` has no effect there.  On CUDA the operands
                of ``_int_mm`` are zero-padded to multiples of 32 and the
                product sliced back (``padded_int_mm``).

SR bits are ``prng.bits(key, shape)`` drawn on the operand's device, the
same draw the unfused quantizers make for that key, so the fused and
unfused paths and the reference give bit-identical codes.  Inside a
data-parallel step (``sharding/data.py``) the bits of a batch-spanning
operand start at the rank's global flat index and the per-tensor ranges
are the whole batch's
(``tensor_min_max``), so each rank quantizes its rows as the flat step
does.
"""

from __future__ import annotations

from typing import Union

import torch

from .. import prng
from ..sharding import data
from ..kernels.codes import int_mm, padded_int_mm
from ..kernels.fused_fqt import (fused_qboth_tn_matmul, fused_qlhs_matmul,
                                 fused_qlhs_packed_matmul)
from ..kernels.pack import PackedTensor
from ..kernels.q4_matmul import packed_matmul
from ..kernels.q8_matmul import q8_matmul
from ..kernels.quantize_sr import quantize_sr_rows, quantize_sr_tensor
from .bhq import BHQTensor
from .quantizers import QTensor, range_scale, tensor_min_max
from .registry import BACKENDS

__all__ = ["BACKENDS", "affine_factors", "epilogue_coeffs", "apply_epilogue",
           "int_mm", "padded_int_mm", "q8_gemm", "qt_gemm", "qt_gemm_tn",
           "qt_gemm_nt", "quantize_sr_rows_qt", "quantize_sr_tensor_qt",
           "requantize_det", "fused_fqt_fwd", "fused_fqt_dx", "fused_fqt_dw",
           "dw_operands"]


def _check_backend(backend: str, what: str) -> None:
    """Raise unless ``backend`` is ``kernel``, the only one that runs
    ``what`` (``simulate`` and ``native`` never reach it)."""
    if backend != "kernel":
        raise ValueError(f"{what} runs on the 'kernel' backend only, not "
                         f"{backend!r} (backends: {BACKENDS})")


# ---------------------------------------------------------------------------
# The affine-epilogue algebra (single source)
# ---------------------------------------------------------------------------

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
                    alpha_b, beta_b, bias=None, colsum=None):
    """The epilogue coefficient vectors (rs, cs, r2, u, a, b) for a8 (M, K)
    shifted codes with per-row or per-tensor factors and b8 (K, N) with
    per-tensor factors; ``bias`` fills the free b_j slot.  ``colsum``: b8's
    int32 column sums when the caller holds them (a packed weight's), in
    which case ``b8`` is not read."""
    m, kdim = a8.shape
    dev = a8.device
    alpha_b = torch.as_tensor(alpha_b, dtype=torch.float32,
                              device=dev).reshape(())
    beta_b = torch.as_tensor(beta_b, dtype=torch.float32, device=dev).reshape(())
    rowsum = a8.to(torch.int32).sum(dim=1).to(torch.float32)
    if colsum is None:
        colsum = b8.to(torch.int32).sum(dim=0)
    colsum = colsum.to(torch.float32)
    n = colsum.shape[0]
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


# ---------------------------------------------------------------------------
# Code-level GEMM dispatch
# ---------------------------------------------------------------------------

def q8_gemm(a8: torch.Tensor, alpha_a, beta_a, b8: torch.Tensor, alpha_b,
            beta_b, *, backend: str, bias=None) -> torch.Tensor:
    """fp32 value of ``A-hat @ B-hat`` from shifted int8 codes through
    ``q8_matmul`` (``kernel``) or ``torch._int_mm`` (``native``).  ``b8``
    may be the transpose of a contiguous tensor (the kernel reads it
    K-major); ``a8`` is made contiguous."""
    coeffs = epilogue_coeffs(a8, alpha_a, beta_a, b8, alpha_b, beta_b, bias)
    if backend == "native":
        acc = int_mm(a8, b8).to(torch.float32)
        return apply_epilogue(acc, *coeffs)
    _check_backend(backend, "the unfused int8 GEMM")
    return q8_matmul(a8.contiguous(), b8, *(c.contiguous() for c in coeffs))


# ---------------------------------------------------------------------------
# QTensor-level GEMMs — the three GEMMs of the FQT step
# ---------------------------------------------------------------------------

def _codes2d(qt: QTensor) -> torch.Tensor:
    return qt.int8_codes.reshape(-1, qt.shape[-1])


def _codes_dequant2d(qt) -> torch.Tensor:
    d = qt.dequant()
    return d.reshape(-1, d.shape[-1])


def qt_gemm(aq: QTensor, bq: Union[QTensor, PackedTensor], *,
            backend: str) -> torch.Tensor:
    """Forward GEMM ``A-hat @ B-hat`` (Eq. 3: ``Q_f(X) @ Q_theta(W)``) from
    two quantized operands; a :class:`PackedTensor` B stays packed and runs
    through ``packed_matmul`` (``simulate`` dequantizes either)."""
    if backend == "simulate":
        return _codes_dequant2d(aq) @ _codes_dequant2d(bq)
    if isinstance(bq, PackedTensor):
        return _packed_gemm(aq, bq, backend=backend)
    alpha_a, beta_a = affine_factors(aq.scale, aq.zero, aq.bits)
    alpha_b, beta_b = affine_factors(bq.scale, bq.zero, bq.bits)
    return q8_gemm(_codes2d(aq), alpha_a, beta_a, _codes2d(bq),
                   alpha_b, beta_b, backend=backend)


def _packed_scalars(pt: PackedTensor):
    """A per-layer packed weight's (alpha_b, beta_b) as 0-d tensors (a slice
    of a stacked tensor carries (1, 1) scale and zero)."""
    return affine_factors(pt.scale.reshape(()), pt.zero.reshape(()), pt.bits)


def _packed_gemm(aq: QTensor, pt: PackedTensor, *, backend: str,
                 bias=None) -> torch.Tensor:
    """``A-hat @ B-hat`` with the B codes bit-packed, through
    ``packed_matmul``.  The epilogue's ``u`` takes the unpacked codes'
    column sums from ``pt.colsum`` (computed once at pack time), so no
    unpacked weight is made here.  ``native`` unpacks the codes and runs
    ``torch._int_mm``, as the reference's ``packed_matmul_xla``."""
    a8 = _codes2d(aq)
    alpha_a, beta_a = affine_factors(aq.scale, aq.zero, aq.bits)
    alpha_b, beta_b = _packed_scalars(pt)
    coeffs = epilogue_coeffs(a8, alpha_a, beta_a, None, alpha_b, beta_b,
                             bias, colsum=pt.colsum.reshape(-1))
    if backend == "native":
        w8 = pt.int8_codes.reshape(-1, pt.shape[-1])
        acc = int_mm(a8, w8).to(torch.float32)
        return apply_epilogue(acc, *coeffs)
    _check_backend(backend, "the packed GEMM")
    packed2d = pt.packed.reshape(-1, pt.packed.shape[-1])
    return packed_matmul(a8.contiguous(), packed2d,
                         *(c.contiguous() for c in coeffs), wbits=pt.bits,
                         kdim=pt.kdim)


def qt_gemm_tn(aq: QTensor, bq: QTensor, *, backend: str) -> torch.Tensor:
    """Weight-grad GEMM ``A-hat.T @ B-hat`` (``Q_f(X).T @ Q_b1(dY)``), both
    operands per-tensor."""
    if backend == "simulate":
        return _codes_dequant2d(aq).T @ _codes_dequant2d(bq)
    alpha_a, beta_a = affine_factors(aq.scale, aq.zero, aq.bits)
    alpha_b, beta_b = affine_factors(bq.scale, bq.zero, bq.bits)
    return q8_gemm(_codes2d(aq).T, alpha_a, beta_a, _codes2d(bq),
                   alpha_b, beta_b, backend=backend)


def qt_gemm_nt(aq: Union[QTensor, BHQTensor],
               bq: Union[QTensor, PackedTensor], *,
               backend: str) -> torch.Tensor:
    """Activation-grad GEMM ``A-hat @ B-hat.T`` (``Q_b2(dY) @ Q_theta(W).T``).

    ``aq`` may be per-row (PSQ), per-tensor (PTQ) or a :class:`BHQTensor`:
    for BHQ the ``S^{-1}`` epilogue commutes with the right-matmul,
    ``Q_b(g) @ B-hat.T = S^{-1}((codes + Z) @ B-hat.T)``, so the int GEMM
    runs on raw codes and ``dequant_epilogue`` mixes the output rows.
    ``B-hat.T`` stays a view of the weight codes (read K-major); a
    :class:`PackedTensor` B unpacks transiently here (its ``int8_codes``):
    the dX contraction runs over the packed layout's column axis, which the
    packed kernels do not cover."""
    if backend == "simulate":
        a = aq.dequant()
        return a.reshape(-1, a.shape[-1]) @ _codes_dequant2d(bq).T
    bt8 = _codes2d(bq).T
    alpha_b, beta_b = affine_factors(bq.scale, bq.zero, bq.bits)
    if isinstance(aq, BHQTensor):
        nb, blk, _ = aq.codes.shape
        a8 = aq.int8_codes.reshape(nb * blk, -1)
        # Householder-domain value = codes + zero: alpha = 1, beta = off + zero
        beta_a = float(aq.int8_offset) + aq.zero.reshape(nb * blk)
        t = q8_gemm(a8, 1.0, beta_a, bt8, alpha_b, beta_b, backend=backend)
        t = t.reshape(nb, blk, -1)
        # ragged inputs carry zero-padding rows in the last block
        return aq.dequant_epilogue(t).reshape(nb * blk, -1)[:aq.n_rows]
    alpha_a, beta_a = affine_factors(aq.scale, aq.zero, aq.bits)
    return q8_gemm(_codes2d(aq), alpha_a, beta_a, bt8, alpha_b, beta_b,
                   backend=backend)


# ---------------------------------------------------------------------------
# Unfused backward quantizers (the quantize_sr kernels -> canonical QTensor)
# ---------------------------------------------------------------------------

def _sr_bits(key, g2: torch.Tensor) -> torch.Tensor:
    """The SR bits of ``g2``: ``prng.bits`` over its shape, from the
    rank's global flat index when ``g2`` spans the batch in a data group
    (``sharding.data``)."""
    return prng.bits(key, g2.shape, g2.device, data.sr_offset(g2.numel()))


def quantize_sr_rows_qt(x2d: torch.Tensor, key, bits: int) -> QTensor:
    """PSQ stochastic quantize through the ``quantize_sr_rows`` kernel.

    Bit-identical to ``quantize_psq_stoch(x2d, key, bits)``: both draw the
    SR uniforms as ``prng.bits(key, shape) * 2^-32``."""
    rbits = _sr_bits(key, x2d)
    c8, scale, zero = quantize_sr_rows(x2d.contiguous(), rbits, bits)
    return QTensor.from_int8(c8, scale, zero, bits, x2d.shape)


def quantize_sr_tensor_qt(x2d: torch.Tensor, key, bits: int) -> QTensor:
    """PTQ stochastic quantize through the ``quantize_sr_tensor`` kernel;
    bit-identical to ``quantize_ptq_stoch(x2d, key, bits)``.  Inside a
    data group the kernel takes the group's range (``lo_hi``) instead of
    reducing its own."""
    rbits = _sr_bits(key, x2d)
    lo_hi = None
    if data.current() is not None:
        lo_hi = torch.stack(tensor_min_max(x2d))
    c8, scale, zero = quantize_sr_tensor(x2d.contiguous(), rbits, bits,
                                         lo_hi)
    return QTensor.from_int8(c8, scale, zero, bits, x2d.shape)


# ---------------------------------------------------------------------------
# Fully-fused FQT GEMMs (kernels/fused_fqt.py dispatch)
#
# The fused forward never materializes the activation's int8 codes, so its
# residuals are (x2, scale, zero); the backward rematerializes the codes
# deterministically when it needs them (``requantize_det``).
# ---------------------------------------------------------------------------

def _ptq_range(x2: torch.Tensor, bits: int):
    """Per-tensor (zero, scale) exactly as ``quantize_ptq_det``/``_stoch``."""
    B = float((1 << bits) - 1)
    zero, hi = tensor_min_max(x2)
    scale = range_scale(B, hi - zero)
    return zero, scale


def requantize_det(x2: torch.Tensor, scale, zero, bits: int) -> QTensor:
    """Rebuild the deterministic-PTQ QTensor from saved (scale, zero):
    bit-identical to ``quantize_ptq_det(x2, bits)`` when they came from it."""
    B = (1 << bits) - 1
    codes = torch.clamp(torch.round(scale * (x2 - zero)), 0, B).to(
        torch.uint8)
    return QTensor(codes=codes, scale=torch.as_tensor(scale),
                   zero=torch.as_tensor(zero), bits=bits,
                   shape=tuple(x2.shape))


def fused_fqt_fwd(x2: torch.Tensor, wq: Union[QTensor, PackedTensor],
                  bits_act: int, *, backend: str, zero_scale=None):
    """Forward Eq. 3 ``Q_f(x2) @ W-hat`` with Q_f fused into the GEMM; a
    :class:`PackedTensor` weight stays packed (``fused_qlhs_packed_matmul``,
    ``u`` from its stored column sums).  ``zero_scale``: ``x2``'s range
    as :func:`_ptq_range` gives it, when already taken.

    Returns (y, scale_x, zero_x) — the scale/zero are the residuals the
    backward rematerializes the activation codes from."""
    _check_backend(backend, "the fused forward")
    args, scale, zero = fwd_operands(x2, wq, bits_act, zero_scale)
    if isinstance(wq, PackedTensor):
        y = fused_qlhs_packed_matmul(*args, bits=bits_act, wbits=wq.bits)
    else:
        y = fused_qlhs_matmul(*args, bits=bits_act)
    return y, scale, zero


def fwd_operands(x2: torch.Tensor, wq: Union[QTensor, PackedTensor],
                 bits_act: int, zero_scale=None):
    """The arguments of the fused forward, ``(x2, scale_a, zero_a, b,
    alpha_b, beta_b, u)`` with ``b`` the packed weight for a
    :class:`PackedTensor` (``fused_qlhs_packed_matmul``) or ``None`` and
    the int8 codes (``fused_qlhs_matmul``'s ``rbits`` and ``b8``), and
    x2's per-tensor (scale, zero)."""
    M, K = x2.shape
    zero, scale = (_ptq_range(x2, bits_act) if zero_scale is None
                   else zero_scale)
    sa = scale.reshape(1, 1).expand(M, 1).contiguous()
    za = zero.reshape(1, 1).expand(M, 1).contiguous()
    if isinstance(wq, PackedTensor):
        alpha_b, beta_b = _packed_scalars(wq)
        colsum = wq.colsum.reshape(-1).to(torch.float32)
        u = alpha_b * colsum + float(K) * beta_b
        return ((x2.contiguous(), sa, za, wq.packed.reshape(-1, wq.shape[-1]),
                 alpha_b, beta_b, u), scale, zero)
    w8 = wq.int8_codes.reshape(-1, wq.shape[-1])
    alpha_b, beta_b = affine_factors(wq.scale, wq.zero, wq.bits)
    colsum = w8.to(torch.int32).sum(dim=0).to(torch.float32)
    u = alpha_b * colsum + float(K) * beta_b
    return ((x2.contiguous(), sa, za, None, w8, alpha_b, beta_b, u), scale,
            zero)


def fused_fqt_dx(g2: torch.Tensor, key, spec, wq: QTensor, *, backend: str,
                 rbits=None) -> torch.Tensor:
    """Activation-grad GEMM ``Q_b2(g2) @ W-hat.T`` (Eq. 6) with Q_b2 (PTQ
    per-tensor or PSQ per-row) fused into the K sweep of
    ``fused_qlhs_matmul(trans_b=True)``; the weight codes are read as they
    are stored.  ``rbits`` (default: ``prng.bits(key, g2.shape)``) are the
    SR bits the unfused quantizer would draw for this key."""
    _check_backend(backend, "the fused activation grad")
    if rbits is None:
        rbits = _sr_bits(key, g2)
    return fused_qlhs_matmul(*dx_operands(g2, spec, wq, rbits),
                             bits=spec.bits or 8, trans_b=True)


def dx_operands(g2: torch.Tensor, spec, wq: QTensor, rbits: torch.Tensor):
    """The arguments of ``fused_qlhs_matmul(trans_b=True)`` for the
    activation grad: ``(g2, scale_g, zero_g, rbits, w8, alpha_b, beta_b,
    u)``, g2's range per row (PSQ) or per tensor (PTQ)."""
    bits = spec.bits or 8
    B = float((1 << bits) - 1)
    M, N = g2.shape
    if spec.name == "psq":
        zg = torch.amin(g2, dim=-1, keepdim=True)
        sg = range_scale(B, torch.amax(g2, dim=-1, keepdim=True) - zg)
    else:                                   # per-tensor PTQ
        zg0, sg0 = _ptq_range(g2, bits)
        zg = zg0.reshape(1, 1).expand(M, 1).contiguous()
        sg = sg0.reshape(1, 1).expand(M, 1).contiguous()
    w8 = wq.int8_codes.reshape(-1, wq.shape[-1])          # (Kw, N) storage
    alpha_b, beta_b = affine_factors(wq.scale, wq.zero, wq.bits)
    # the B operand is w8.T: its colsum over the contraction is w8's rowsum
    rowsum = w8.to(torch.int32).sum(dim=1).to(torch.float32)
    u = alpha_b * rowsum + float(N) * beta_b              # (Kw,)
    return g2.contiguous(), sg, zg, rbits, w8, alpha_b, beta_b, u


def dw_operands(x2: torch.Tensor, scale_x, zero_x, bits_act: int,
                g2: torch.Tensor, rbits: torch.Tensor, bits_wgrad: int):
    """The arguments of ``fused_qboth_tn_matmul`` for the weight grad:
    ``(x2, scale_x, zero_x, g2, scale_g, zero_g, rbits, a_vec)``.  The
    epilogue's ``a_vec`` needs whole column sums of X's codes, which the
    kernel's K sweep never holds; it is one reduce over x2 here (no int8
    tensor kept)."""
    Bb = float((1 << bits_wgrad) - 1)
    off_a = 1 << (bits_act - 1)
    off_b = 1 << (bits_wgrad - 1)
    Ba = float((1 << bits_act) - 1)
    zg, hg = tensor_min_max(g2)
    sg = range_scale(Bb, hg - zg)
    ca = torch.clamp(torch.round(scale_x * (x2 - zero_x)), 0.0, Ba) - off_a
    alpha_a = 1.0 / scale_x
    alpha_b = 1.0 / sg
    beta_b = off_b * alpha_b + zg
    a_vec = (alpha_a * beta_b) * ca.sum(dim=0)            # (Kw,)
    return x2, scale_x, zero_x, g2, sg, zg, rbits, a_vec


def fused_fqt_dw(x2: torch.Tensor, scale_x, zero_x, bits_act: int,
                 g2: torch.Tensor, key, bits_wgrad: int, *, backend: str,
                 rbits=None) -> torch.Tensor:
    """Weight-grad GEMM ``Q_f(x2).T @ Q_b1(g2)`` (Eq. 6) with both
    quantizes fused into the K sweep of ``fused_qboth_tn_matmul``
    (deterministic X, stochastic per-tensor dY)."""
    _check_backend(backend, "the fused weight grad")
    bits_wgrad = int(bits_wgrad)
    if rbits is None:
        rbits = _sr_bits(key, g2)
    ops = dw_operands(x2.contiguous(), scale_x, zero_x, bits_act,
                      g2.contiguous(), rbits, bits_wgrad)
    return fused_qboth_tn_matmul(*ops, bits_a=bits_act, bits_b=bits_wgrad)
