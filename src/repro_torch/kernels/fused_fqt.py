"""Fused quantize -> int8 GEMM -> affine epilogue, the FQT step's GEMMs.

Port of ``repro.kernels.fused_fqt``: two kernel families, each a
hand-written CUDA kernel on the card with its plain PyTorch version beside
it, used on CPU tensors.

``fused_qlhs_matmul`` (Pallas ``_qlhs_kernel``)
    ``Q(xf) @ B-hat`` with the LHS quantized inside the GEMM, so no int8
    codes of it reach device memory.  ``trans_b=False`` is the forward
    ``Q_f(X) @ Q_theta(W)`` (``csrc/fused_qlhs_fwd.cu``: a decode tile for
    M <= 16, a wide one above); ``trans_b=True`` reads the weight codes
    transposed for the activation grad ``Q_b2(dY) @ Q_theta(W).T`` (PTQ or
    PSQ ``Q_b2``, per-row scale/zero as (M, 1), stochastic rounding from
    ``rbits``): ``csrc/fused_qlhs_dx.cu``.  Both instantiate
    ``csrc/fused_qlhs_gemm.cuh`` on the int8 tensor cores, with K split by
    ``kernels/splitk.py``.
``fused_qlhs_packed_matmul`` (Pallas ``_qlhs_packed_kernel``,
    ``csrc/fused_qlhs_packed.cu``)
    the forward ``Q_f(X) @ W-hat`` against weights bit-packed at 1, 2, 4
    or 8 bits (``kernels/pack.py``), unpacked into the tensor-core tile in
    the K sweep: ``csrc/fused_qlhs_gemm.cuh`` with B packed, on the
    forward's decode and wide tiles, K split by ``kernels/splitk.py``.
    The quantize and epilogue are the forward's, so at 8 bits it equals
    ``fused_qlhs_matmul`` on the same codes bit for bit.
``fused_qboth_tn_matmul`` (Pallas ``_qboth_tn_kernel``,
    ``csrc/fused_qboth_tn.cu``)
    the weight grad ``Q_f(X).T @ Q_b1(dY)``: both operands quantized in
    the K sweep (deterministic A, stochastic B, both per-tensor),
    contracting over their storage rows; int8 tensor cores, K split by
    ``kernels/splitk.py``.

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

from . import splitk
from .build import load_function
from .checks import check_bits, check_tensor
from .pack import codes_per_byte, max_safe_k_packed, unpack_tile

__all__ = ["fused_qlhs_matmul", "fused_qlhs_matmul_plain", "qlhs_codes",
           "qlhs_epilogue", "qboth_codes", "qboth_epilogue",
           "fused_qlhs_packed_matmul", "fused_qlhs_packed_matmul_plain",
           "fused_qboth_tn_matmul", "fused_qboth_tn_matmul_plain"]

_U32_TO_UNIT = 1.0 / 4294967296.0          # bits * 2^-32, the one SR rule

# xf, scale_a, zero_a, rbits, y8, alpha_b, beta_b, u, out, M, N, K, bits,
# mode, splits, k_span, stream
_QLHS_FWD_ARGTYPES = ((ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 7
                      + (ctypes.c_void_p,))
# xf, scale_a, zero_a, rbits, y8, alpha_b, beta_b, u, out, M, N, K, bits,
# splits, k_span, stream
_QLHS_DX_ARGTYPES = ((ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 6
                     + (ctypes.c_void_p,))
# xf, scale_a, zero_a, packed, alpha_b, beta_b, u, out, M, N, K, bits,
# mode, splits, k_span, stream
_QLHS_PACKED_ARGTYPES = ((ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 7
                         + (ctypes.c_void_p,))
# af, scale_a, zero_a, bf, scale_b, zero_b, rbits, a_vec, out, M, N, K,
# bits_a, bits_b, splits, k_span, stream
_QBOTH_ARGTYPES = ((ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 7
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
    c = qlhs_codes(xf, scale_a, zero_a, rbits, bits=bits).to(torch.float64)
    w = y8.to(torch.float64)
    acc = c @ (w.T if trans_b else w)
    return qlhs_epilogue(acc, c.sum(dim=1), scale_a, zero_a, alpha_b,
                         beta_b, u_vec, bits=bits)


def qlhs_codes(xf: torch.Tensor, scale_a: torch.Tensor, zero_a: torch.Tensor,
               rbits: Optional[torch.Tensor], *, bits: int) -> torch.Tensor:
    """The shifted codes ``Q(xf)`` (M, K) as float32: round half to even,
    or SR from ``rbits``; clip to ``[0, 2^b-1]``, shift by ``-2^(b-1)``."""
    nbins = float((1 << bits) - 1)
    M = xf.shape[0]
    t = scale_a.reshape(M, 1) * (xf.to(torch.float32) - zero_a.reshape(M, 1))
    q = torch.round(t) if rbits is None else torch.floor(t + _sr_unit(rbits))
    return torch.clamp(q, 0.0, nbins) - float(1 << (bits - 1))


def qlhs_epilogue(acc: torch.Tensor, rsum: torch.Tensor,
                  scale_a: torch.Tensor, zero_a: torch.Tensor, alpha_b,
                  beta_b, u_vec: torch.Tensor, *, bits: int) -> torch.Tensor:
    """The epilogue on the exact integer sums: ``acc`` (M, N) and the row
    code sums ``rsum`` (M,), in any dtype that holds them exactly."""
    off = float(1 << (bits - 1))
    M = acc.shape[0]
    scale_a = scale_a.reshape(M, 1)
    alpha_a = 1.0 / scale_a
    beta_a = off * alpha_a + zero_a.reshape(M, 1)
    ab = torch.as_tensor(alpha_b, dtype=torch.float32, device=acc.device)
    bb = torch.as_tensor(beta_b, dtype=torch.float32, device=acc.device)
    a_i = (alpha_a * bb) * rsum.reshape(M, 1).to(torch.float32)
    return (acc.to(torch.float32) * (alpha_a * ab)
            + beta_a * u_vec.reshape(1, -1) + a_i)


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
    ``fused_qlhs_matmul.launches_dx`` too): one device launch in either
    mode, whatever the tile and split of K (``kernels/splitk.py``).  On a
    CPU tensor it runs the plain version."""
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
    args = (xf.data_ptr(), scale_a.data_ptr(), zero_a.data_ptr(),
            None if rbits is None else rbits.data_ptr(), y8.data_ptr(),
            alpha_b.data_ptr(), beta_b.data_ptr(), u_vec.data_ptr(),
            out.data_ptr(), M, N, K, bits)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if trans_b:
        p = splitk.plan(splitk.on_card(splitk.DX_TILE), M, N, K)
        fn = load_function("fused_qlhs_dx", "fused_qlhs_dx",
                           _QLHS_DX_ARGTYPES)
        err = fn(*args, p.splits, p.k_span, stream)
    else:
        p = splitk.plan(splitk.on_card(splitk.fwd_tile(M, rbits is not None)),
                        M, N, K)
        fn = load_function("fused_qlhs_fwd", "fused_qlhs_fwd",
                           _QLHS_FWD_ARGTYPES)
        err = fn(*args, p.tile.mode, p.splits, p.k_span, stream)
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


def _check_qlhs_packed(who: str, xf, packed, bits: int, wbits: int) -> None:
    check_bits(who, bits)
    check_bits(who, wbits, lo=1)
    ppb = codes_per_byte(wbits)
    if xf.dim() != 2 or packed.dim() != 2:
        raise ValueError(f"{who}: xf {tuple(xf.shape)} and packed "
                         f"{tuple(packed.shape)} must be 2-D")
    K = xf.shape[1]
    if packed.shape[0] != -(-K // ppb):
        raise ValueError(f"{who}: packed rows {packed.shape[0]} != "
                         f"ceil({K}/{ppb}) for {wbits}-bit codes")
    safe = max_safe_k_packed(bits, wbits)
    if K > safe:
        raise ValueError(f"{who}: K={K} overflows the int32 accumulator for "
                         f"int{bits} x int{wbits} codes (max_safe_k={safe})")


def fused_qlhs_packed_matmul_plain(xf: torch.Tensor, scale_a: torch.Tensor,
                                   zero_a: torch.Tensor,
                                   packed: torch.Tensor, alpha_b, beta_b,
                                   u_vec: torch.Tensor, *, bits: int,
                                   wbits: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_qlhs_packed_matmul`: unpack
    with shifts and masks, then the forward of
    :func:`fused_qlhs_matmul_plain`."""
    _check_qlhs_packed("fused_qlhs_packed_matmul_plain", xf, packed, bits,
                       wbits)
    w8 = unpack_tile(packed, wbits)[:xf.shape[1]] - (1 << (wbits - 1))
    return fused_qlhs_matmul_plain(xf, scale_a, zero_a, None, w8, alpha_b,
                                   beta_b, u_vec, bits=bits)


def fused_qlhs_packed_matmul(xf: torch.Tensor, scale_a: torch.Tensor,
                             zero_a: torch.Tensor, packed: torch.Tensor,
                             alpha_b, beta_b, u_vec: torch.Tensor, *,
                             bits: int, wbits: int) -> torch.Tensor:
    """``Q_det(xf) @ W-hat`` with W bit-packed: the forward against weights
    packed once at load.

    xf: (M, K) f32; scale_a/zero_a: (M, 1); packed: (ceil(K/ppb), N) uint8
    at ``wbits`` in {1, 2, 4, 8} (kernels/pack.py layout); alpha_b/beta_b:
    the weight's scalar affine factors (0-d tensors on the card); u_vec:
    (N,) ``alpha_b * colsum(w8) + K * beta_b`` over the unpacked codes.
    Raises above ``max_safe_k_packed(bits, wbits)``.  Returns (M, N) f32.

    On a CUDA tensor this launches the kernel (counted in
    ``fused_qlhs_packed_matmul.launches``): one device launch, whatever the
    tile and split of K (``kernels/splitk.py``).  On a CPU tensor it runs
    the plain version."""
    name = "fused_qlhs_packed_matmul"
    _check_qlhs_packed(name, xf, packed, bits, wbits)
    if xf.device.type == "cpu":
        return fused_qlhs_packed_matmul_plain(xf, scale_a, zero_a, packed,
                                              alpha_b, beta_b, u_vec,
                                              bits=bits, wbits=wbits)
    (M, K), N = xf.shape, packed.shape[1]
    dev = xf.device
    check_tensor(name, "xf", xf, torch.float32, (M, K))
    check_tensor(name, "scale_a", scale_a, torch.float32, (M, 1), dev)
    check_tensor(name, "zero_a", zero_a, torch.float32, (M, 1), dev)
    check_tensor(name, "packed", packed, torch.uint8, tuple(packed.shape),
                 dev)
    check_tensor(name, "alpha_b", alpha_b, torch.float32, (), dev)
    check_tensor(name, "beta_b", beta_b, torch.float32, (), dev)
    check_tensor(name, "u_vec", u_vec, torch.float32, (N,), dev)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    lib = "fused_qlhs_packed"
    p = splitk.plan(splitk.on_card(splitk.packed_tile(lib, M, wbits)), M, N,
                    K)
    fn = load_function(lib, lib, _QLHS_PACKED_ARGTYPES)
    err = fn(xf.data_ptr(), scale_a.data_ptr(), zero_a.data_ptr(),
             packed.data_ptr(), alpha_b.data_ptr(), beta_b.data_ptr(),
             u_vec.data_ptr(), out.data_ptr(), M, N, K, bits, p.tile.mode,
             p.splits, p.k_span, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err} at (M, K, N) = ({M}, {K}, {N}), "
                           f"wbits={wbits}")
    fused_qlhs_packed_matmul.launches += 1
    return out


fused_qlhs_packed_matmul.launches = 0


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
    ca, cb = qboth_codes(af, scale_a, zero_a, bf, scale_b, zero_b, rbits,
                         bits_a=bits_a, bits_b=bits_b)
    cb64 = cb.to(torch.float64)
    return qboth_epilogue(ca.to(torch.float64).T @ cb64, cb64.sum(dim=0), K,
                          scale_a, zero_a, scale_b, zero_b, a_vec,
                          bits_a=bits_a, bits_b=bits_b)


def qboth_codes(af: torch.Tensor, scale_a, zero_a, bf: torch.Tensor,
                scale_b, zero_b, rbits: torch.Tensor, *, bits_a: int,
                bits_b: int):
    """The shifted codes of dW's operands as float32: ``Q_det(af)`` (K, M),
    round half to even, and ``Q_sr(bf)`` (K, N) from ``rbits``, both
    per-tensor, clipped to ``[0, 2^b-1]`` and shifted by ``-2^(b-1)``."""
    f32 = dict(dtype=torch.float32, device=af.device)
    sa, za = torch.as_tensor(scale_a, **f32), torch.as_tensor(zero_a, **f32)
    sb, zb = torch.as_tensor(scale_b, **f32), torch.as_tensor(zero_b, **f32)
    ca = torch.clamp(torch.round(sa * (af.to(torch.float32) - za)),
                     0.0, float((1 << bits_a) - 1)) - float(1 << (bits_a - 1))
    cb = torch.clamp(torch.floor(sb * (bf.to(torch.float32) - zb)
                                 + _sr_unit(rbits)),
                     0.0, float((1 << bits_b) - 1)) - float(1 << (bits_b - 1))
    return ca, cb


def qboth_epilogue(acc: torch.Tensor, csum: torch.Tensor, K: int, scale_a,
                   zero_a, scale_b, zero_b, a_vec: torch.Tensor, *,
                   bits_a: int, bits_b: int) -> torch.Tensor:
    """dW's epilogue on the exact integer sums: ``acc`` (M, N) and B's
    column code sums ``csum`` (N,), in any dtype that holds them exactly,
    over K contracted rows."""
    f32 = dict(dtype=torch.float32, device=acc.device)
    sa, za = torch.as_tensor(scale_a, **f32), torch.as_tensor(zero_a, **f32)
    sb, zb = torch.as_tensor(scale_b, **f32), torch.as_tensor(zero_b, **f32)
    alpha_a = 1.0 / sa
    beta_a = float(1 << (bits_a - 1)) * alpha_a + za
    alpha_b = 1.0 / sb
    beta_b = float(1 << (bits_b - 1)) * alpha_b + zb
    u_j = alpha_b * csum.to(torch.float32) + float(K) * beta_b
    return (acc.to(torch.float32) * (alpha_a * alpha_b)
            + beta_a * u_j[None, :] + a_vec[:, None])


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
    ``fused_qboth_tn_matmul.launches``): one device launch, whatever the
    split of K (``kernels/splitk.py``).  On a CPU tensor it runs the plain
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
    p = splitk.plan(splitk.on_card(splitk.DW_TILE), M, N, K)
    fn = load_function("fused_qboth_tn", "fused_qboth_tn", _QBOTH_ARGTYPES)
    err = fn(af.data_ptr(), scale_a.data_ptr(), zero_a.data_ptr(),
             bf.data_ptr(), scale_b.data_ptr(), zero_b.data_ptr(),
             rbits.data_ptr(), a_vec.data_ptr(), out.data_ptr(), M, N, K,
             bits_a, bits_b, p.splits, p.k_span,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_qboth_tn_matmul: kernel launch failed "
                           f"with CUDA error {err} at (K, M, N) = "
                           f"({K}, {M}, {N})")
    fused_qboth_tn_matmul.launches += 1
    return out


fused_qboth_tn_matmul.launches = 0
