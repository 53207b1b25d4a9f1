"""Argument checks shared by the kernel wrappers."""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["as_float32", "check_bits", "check_tensor"]


def check_bits(kernel: str, bits, lo: int = 2) -> int:
    """Validate a quantization bitwidth: an int in [lo, 8]."""
    if not isinstance(bits, int) or isinstance(bits, bool) or \
            not lo <= bits <= 8:
        raise ValueError(
            f"{kernel}: bits={bits!r} out of range; the int8 kernels "
            f"support bitwidths {lo}..8")
    return bits


def check_tensor(kernel: str, name: str, t: torch.Tensor,
                 dtype: torch.dtype, shape: tuple,
                 device: Optional[torch.device] = None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of this dtype and
    shape (on ``device`` when given) — what a kernel's raw pointer needs."""
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{kernel}: {name} must be a tensor, got "
                         f"{type(t).__name__}")
    if t.device.type != "cuda" or (device is not None and t.device != device):
        raise ValueError(f"{kernel}: {name} must be on "
                         f"{device or 'a CUDA device'}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{kernel}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def as_float32(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float32 (a bfloat16 operand converts exactly); a float32
    one as it is."""
    return t if t.dtype == torch.float32 else t.to(torch.float32)
