"""Per-row affine dequantization of int8 KV-cache rows.

Port of ``repro.kernels.kv_dequant`` (the Pallas kernel ``kv_dequant_rows``):
the hand-written CUDA kernel ``csrc/kv_dequant.cu`` on the card, and
:func:`kv_dequant_rows_plain` — the same arithmetic in PyTorch — on the
CPU.  Codes are shifted-signed int8 (``c8 = code - 2^(b-1)``) with
``x = (c8 + 2^(b-1)) / scale + zero``; the kernel divides with IEEE
rounding, so its output is bit-identical to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from .build import load_function
from .checks import check_bits, check_tensor

__all__ = ["kv_dequant_rows", "kv_dequant_rows_plain"]

# codes, scale, zero, out, M, N, bits, stream
_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_void_p)


def kv_dequant_rows_plain(codes8: torch.Tensor, scale: torch.Tensor,
                          zero: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Plain PyTorch version.  codes8: (M, N) int8; scale/zero: (M, 1)."""
    off = 1 << (bits - 1)
    return (codes8.to(torch.float32) + off) / scale + zero


def kv_dequant_rows(codes8: torch.Tensor, scale: torch.Tensor,
                    zero: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Dequantize per-row affine int8 codes.  codes8: (M, N) int8 shifted
    by ``-2^(b-1)``; scale/zero: (M, 1) f32.  Returns (M, N) f32.

    On a CUDA tensor this launches the kernel (and counts the launch in
    ``kv_dequant_rows.launches``); on a CPU tensor it runs the plain
    version."""
    check_bits("kv_dequant_rows", bits)
    if codes8.dim() != 2:
        raise ValueError(f"kv_dequant_rows: codes8 must be (M, N), got "
                         f"{tuple(codes8.shape)}")
    M, N = codes8.shape
    if codes8.device.type == "cpu":
        return kv_dequant_rows_plain(codes8, scale, zero, bits)
    check_tensor("kv_dequant_rows", "codes8", codes8, torch.int8, (M, N))
    check_tensor("kv_dequant_rows", "scale", scale, torch.float32, (M, 1),
                 codes8.device)
    check_tensor("kv_dequant_rows", "zero", zero, torch.float32, (M, 1),
                 codes8.device)
    out = torch.empty((M, N), dtype=torch.float32, device=codes8.device)
    fn = load_function("kv_dequant", "kv_dequant_rows", _ARGTYPES)
    err = fn(codes8.data_ptr(), scale.data_ptr(), zero.data_ptr(),
             out.data_ptr(), M, N, bits,
             torch.cuda.current_stream(codes8.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"kv_dequant_rows: kernel launch failed with CUDA "
                           f"error {err} at (M, N) = ({M}, {N})")
    kv_dequant_rows.launches += 1
    return out


kv_dequant_rows.launches = 0
