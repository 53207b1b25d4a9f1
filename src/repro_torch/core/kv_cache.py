"""int8-quantized KV-cache codec: per-row affine codes for serving decode.

Port of ``repro.core.kv_cache``.  One ``(scale, zero)`` pair per cached row
(PSQ's transform with deterministic rounding), codes stored shifted-signed
int8, ``x ~= (c8 + 2^(b-1)) / scale + zero``.  Dequantization dispatches on
the execution backend: ``kernel`` goes through
:func:`~repro_torch.kernels.kv_dequant.kv_dequant_rows` (the CUDA kernel on
the card), the other backends run its plain PyTorch version.
:func:`dequant_kv_rows_kv` reads a layer's K and V together: one launch of
:func:`~repro_torch.kernels.kv_dequant.kv_dequant_rows_kv` on ``kernel``,
whose kernel clamps the scales itself.
"""

from __future__ import annotations

import torch

from ..kernels.kv_dequant import (kv_dequant_rows, kv_dequant_rows_kv,
                                  kv_dequant_rows_plain)
from .quantizers import num_bins, range_scale

__all__ = ["quantize_kv_rows", "dequant_kv_rows", "dequant_kv_rows_kv",
           "kv_cache_bytes_per_row", "kv_fresh_code"]

_EPS = 1e-12


def kv_fresh_code(bits: int = 8) -> int:
    """The shifted-signed code a fresh row holds so that it dequantizes to
    exactly zero under ``(scale=1, zero=0)``: ``c8 = -2^(b-1)``."""
    return -(1 << (bits - 1))


def quantize_kv_rows(x: torch.Tensor, bits: int = 8):
    """Per-row deterministic affine quantize over the last axis.

    x: (..., D) float.  Returns ``(codes (..., D) int8 shifted-signed,
    scale (...,) f32, zero (...,) f32)``.
    """
    B = num_bins(bits)
    x = x.to(torch.float32)
    lo, hi = torch.aminmax(x, dim=-1)
    scale = range_scale(B, hi - lo)
    t = scale[..., None] * (x - lo[..., None])
    codes = torch.clamp(torch.round(t), 0.0, B) - (1 << (bits - 1))
    return codes.to(torch.int8), scale, lo


def dequant_kv_rows(codes8: torch.Tensor, scale: torch.Tensor,
                    zero: torch.Tensor, bits: int = 8, *,
                    backend: str = "simulate") -> torch.Tensor:
    """Inverse of :func:`quantize_kv_rows`, dispatched per backend.

    codes8: (..., D) int8; scale/zero: (...,).  Returns (..., D) f32.
    ``scale`` is clamped to ``_EPS`` first, so a degenerate row dequantizes
    to huge-but-finite values the position mask can hide, never inf/nan.
    """
    scale = torch.clamp_min(scale.to(torch.float32), _EPS)
    if backend == "kernel":
        d = codes8.shape[-1]
        out = kv_dequant_rows(codes8.reshape(-1, d), scale.reshape(-1, 1),
                              zero.reshape(-1, 1), bits=bits)
        return out.reshape(codes8.shape)
    return kv_dequant_rows_plain(codes8, scale[..., None], zero[..., None],
                                 bits)


def dequant_kv_rows_kv(k, v, bits: int = 8, *, backend: str = "simulate"):
    """:func:`dequant_kv_rows` of a layer's K and V.  ``k``, ``v``:
    ``(codes8 (..., D) int8, scale (...,), zero (...,))`` of equal shapes.
    Returns ``(k, v)``, each (..., D) f32, equal to two
    :func:`dequant_kv_rows` calls.  On ``kernel`` one launch reads both
    sides and clamps the scales in the kernel; the other backends clamp
    with ``torch.clamp_min`` and run the plain version per side."""
    if backend != "kernel":
        return tuple(dequant_kv_rows(*side, bits, backend=backend)
                     for side in (k, v))
    shape = k[0].shape
    d = shape[-1]
    out = kv_dequant_rows_kv(
        *((c.reshape(-1, d), s.reshape(-1, 1), z.reshape(-1, 1))
          for c, s, z in (k, v)), bits=bits)
    return tuple(o.reshape(shape) for o in out)


def kv_cache_bytes_per_row(d_flat: int, quantized: bool,
                           dtype_bytes: int = 4) -> int:
    """Device bytes one cached row costs: the resident-slot arithmetic of
    serving (an int8 row is its codes plus a float32 scale and zero)."""
    if quantized:
        return d_flat + 2 * 4
    return d_flat * dtype_bytes
