"""Stochastic-rounding quantize to int8 codes: the unfused PTQ/PSQ
backward quantizers.

Port of ``repro.kernels.quantize_sr`` (the Pallas kernels
``quantize_sr_rows`` and ``quantize_sr_tensor``, with their references
``repro.kernels.ref.quantize_sr_*_ref``): the hand-written CUDA kernels of
``csrc/quantize_sr.cu`` on the card, and the ``*_plain`` versions — the
same arithmetic in PyTorch — on the CPU.  With ``B = 2^b - 1``:

    scale = B / max(hi - lo, 1e-12),  zero = lo
    codes = clip(floor(scale * (x - lo) + rbits * 2^-32), 0, B) - 2^(b-1)

``quantize_sr_rows`` takes ``lo``/``hi`` per row (PSQ), in the kernel;
``quantize_sr_tensor`` over the whole tensor (PTQ), reduced outside the
kernel by ``torch.aminmax`` as the JAX package reduces it outside its
kernel.  SR bits are uint32 values held in int64, as ``prng.bits`` draws
them; the kernels read each entry's low 32 bits.  The kernels round every
operation explicitly, so codes, scales and zeros are bit-identical to the
plain versions.
"""

from __future__ import annotations

import ctypes

import torch

from .build import load_function
from .checks import check_bits, check_tensor

__all__ = ["quantize_sr_rows", "quantize_sr_rows_plain", "quantize_sr_tensor",
           "quantize_sr_tensor_plain"]

_EPS = 1e-12
_U32_TO_UNIT = 1.0 / 4294967296.0

# x, rbits, codes, scale, zero, M, N, bits, stream
_ROWS_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 3 + (
    ctypes.c_void_p,)
# x, rbits, lo, scale, codes, n, bits, stream
_TENSOR_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_longlong, ctypes.c_int,
                                             ctypes.c_void_p)


def _check_2d(x: torch.Tensor, rbits: torch.Tensor, who: str):
    if x.dim() != 2 or tuple(rbits.shape) != tuple(x.shape):
        raise ValueError(f"{who}: x must be (M, N) with rbits of the same "
                         f"shape, got {tuple(x.shape)} and "
                         f"{tuple(rbits.shape)}")
    return x.shape


def _range_scale(bits: int, rng: torch.Tensor) -> torch.Tensor:
    """``(2^b - 1) / max(rng, 1e-12)`` with IEEE division, as the kernels
    and the reference divide (``core.quantizers.range_scale``)."""
    rng = torch.clamp_min(rng, _EPS)
    return torch.full_like(rng, float((1 << bits) - 1)) / rng


def _sr_codes(x, rbits, scale, lo, bits: int) -> torch.Tensor:
    nbins = (1 << bits) - 1
    u = rbits.to(torch.float32) * _U32_TO_UNIT
    q = torch.clamp(torch.floor(scale * (x - lo) + u), 0, nbins)
    return (q - (1 << (bits - 1))).to(torch.int8)


def quantize_sr_rows_plain(x: torch.Tensor, rbits: torch.Tensor,
                           bits: int = 8):
    """Plain PyTorch version of :func:`quantize_sr_rows`."""
    check_bits("quantize_sr_rows_plain", bits)
    _check_2d(x, rbits, "quantize_sr_rows_plain")
    lo = torch.amin(x, dim=1, keepdim=True)
    hi = torch.amax(x, dim=1, keepdim=True)
    scale = _range_scale(bits, hi - lo)
    return _sr_codes(x, rbits, scale, lo, bits), scale, lo


def quantize_sr_tensor_plain(x: torch.Tensor, rbits: torch.Tensor,
                             bits: int = 8):
    """Plain PyTorch version of :func:`quantize_sr_tensor`."""
    check_bits("quantize_sr_tensor_plain", bits)
    _check_2d(x, rbits, "quantize_sr_tensor_plain")
    lo, hi = torch.aminmax(x)
    scale = _range_scale(bits, hi - lo)
    return _sr_codes(x, rbits, scale, lo, bits), scale, lo


def quantize_sr_rows(x: torch.Tensor, rbits: torch.Tensor, bits: int = 8):
    """Per-row (PSQ) stochastic quantize.  x: (M, N) f32; rbits: (M, N)
    uint32 values in int64.  Returns ``(codes (M, N) int8 shifted by
    -2^(b-1), scale (M, 1), zero (M, 1))``, ``x ~= (codes + 2^(b-1)) /
    scale + zero``.

    On a CUDA tensor this launches the kernel (counted in
    ``quantize_sr_rows.launches``); on a CPU tensor it runs the plain
    version."""
    check_bits("quantize_sr_rows", bits)
    M, N = _check_2d(x, rbits, "quantize_sr_rows")
    if x.device.type == "cpu":
        return quantize_sr_rows_plain(x, rbits, bits)
    dev = x.device
    check_tensor("quantize_sr_rows", "x", x, torch.float32, (M, N))
    check_tensor("quantize_sr_rows", "rbits", rbits, torch.int64, (M, N), dev)
    codes = torch.empty((M, N), dtype=torch.int8, device=dev)
    scale = torch.empty((M, 1), dtype=torch.float32, device=dev)
    zero = torch.empty((M, 1), dtype=torch.float32, device=dev)
    fn = load_function("quantize_sr", "quantize_sr_rows", _ROWS_ARGTYPES)
    err = fn(x.data_ptr(), rbits.data_ptr(), codes.data_ptr(),
             scale.data_ptr(), zero.data_ptr(), M, N, bits,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"quantize_sr_rows: kernel launch failed with "
                           f"CUDA error {err} at (M, N) = ({M}, {N})")
    quantize_sr_rows.launches += 1
    return codes, scale, zero


def quantize_sr_tensor(x: torch.Tensor, rbits: torch.Tensor, bits: int = 8):
    """Per-tensor (PTQ) stochastic quantize.  x: (M, N) f32; rbits: (M, N)
    uint32 values in int64.  Returns ``(codes (M, N) int8, scale (),
    zero ())``.  The min/max is ``torch.aminmax`` over the whole tensor;
    the kernel makes the elementwise pass, reading ``zero`` and ``scale``
    on the card.

    On a CUDA tensor this launches the kernel (counted in
    ``quantize_sr_tensor.launches``); on a CPU tensor it runs the plain
    version."""
    check_bits("quantize_sr_tensor", bits)
    M, N = _check_2d(x, rbits, "quantize_sr_tensor")
    if x.device.type == "cpu":
        return quantize_sr_tensor_plain(x, rbits, bits)
    dev = x.device
    check_tensor("quantize_sr_tensor", "x", x, torch.float32, (M, N))
    check_tensor("quantize_sr_tensor", "rbits", rbits, torch.int64, (M, N),
                 dev)
    lo, hi = torch.aminmax(x)
    scale = _range_scale(bits, hi - lo)
    codes = torch.empty((M, N), dtype=torch.int8, device=dev)
    fn = load_function("quantize_sr", "quantize_sr_tensor", _TENSOR_ARGTYPES)
    err = fn(x.data_ptr(), rbits.data_ptr(), lo.data_ptr(), scale.data_ptr(),
             codes.data_ptr(), M * N, bits,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"quantize_sr_tensor: kernel launch failed with "
                           f"CUDA error {err} at (M, N) = ({M}, {N})")
    quantize_sr_tensor.launches += 1
    return codes, scale, lo


quantize_sr_rows.launches = 0
quantize_sr_tensor.launches = 0
