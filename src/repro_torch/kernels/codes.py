"""The exact integer GEMM of int8 codes, int32 accumulation stated.

Every plain version of a code GEMM (``q8_matmul_plain``,
``packed_matmul_plain``, the fused kernels' plain versions) and the
``native`` backend (``core/backend.py``) take their product here, so the
int32 accumulation the CUDA kernels do is the one the plain versions state
(``python -m repro_torch.analysis lint`` holds ``kernels/`` to it).  The
sums are exact up to ``max_safe_k`` (``analysis/ranges.py``): 131,071 for
int8 x int8, beyond every contraction of the models.
"""

from __future__ import annotations

import torch

__all__ = ["int_mm", "padded_int_mm"]


def int_mm(a8: torch.Tensor, b8: torch.Tensor) -> torch.Tensor:
    """The exact int32 product ``a8 @ b8`` of int8 codes through
    ``torch._int_mm``; on CUDA through :func:`padded_int_mm`."""
    if a8.device.type == "cuda":
        return padded_int_mm(a8, b8)
    if a8.device.type == "cpu":
        a8, b8 = _row_major_vector(a8), _row_major_vector(b8)
    return torch._int_mm(a8, b8)


def _row_major_vector(t: torch.Tensor) -> torch.Tensor:
    """``t``, copied to row-major strides when it has a dimension of one
    and other strides: the CPU ``_int_mm`` misreads such an operand (the
    transpose of a row or a column)."""
    if 1 in t.shape and t.stride() != (t.shape[1], 1):
        return t.clone(memory_format=torch.contiguous_format)
    return t


def padded_int_mm(a8: torch.Tensor, b8: torch.Tensor) -> torch.Tensor:
    """``torch._int_mm`` with the operands zero-padded to multiples of 32
    (M at least 32) and the result sliced back; zero codes add nothing to
    the product.  CUDA's ``_int_mm`` asks M > 16 and K, N multiples of 8,
    but cuBLASLt finds no int8 kernel for some such shapes
    (CUBLAS_STATUS_NOT_SUPPORTED at (M, K, N) = (40, 72, 136) on the
    H100)."""
    M, K = a8.shape
    N = b8.shape[1]
    Mp, Kp, Np = (max(32, -(-d // 32) * 32) for d in (M, K, N))
    if (Mp, Kp) != (M, K):
        a8 = torch.nn.functional.pad(a8, (0, Kp - K, 0, Mp - M))
    if (Kp, Np) != (K, N):
        b8 = torch.nn.functional.pad(b8, (0, Np - N, 0, Kp - K))
    return torch._int_mm(a8, b8)[:M, :N]
