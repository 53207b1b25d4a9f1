"""Deterministic forward quantizer of the StatQuant paper (NeurIPS 2020).

Port of ``repro.core.quantizers`` for the serving slice: the per-tensor
deterministic quantizer ``Q_f``/``Q_theta`` (paper Sec. 2.1) and the
:class:`QTensor` container its codes travel in.  The stochastic backward
quantizers (PTQ, PSQ, BHQ) come with the training slice.

Codes are unsigned in ``[0, 2^b - 1]`` (uint8); the GEMM kernels consume
them shifted to signed int8, ``c8 = code - 2^(b-1)``, and
``x ~= codes / scale + zero``.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["QTensor", "num_bins", "tensor_min_max", "quantize_ptq_det"]

# Tiny epsilon guarding against zero dynamic range (constant tensors
# quantize to a single code; scale must stay finite).
_EPS = 1e-12


def num_bins(bits: int) -> int:
    """B = 2^b - 1 quantization bins (paper Sec. 3.3)."""
    return (1 << bits) - 1


@dataclasses.dataclass(frozen=True)
class QTensor:
    """Affine-quantized tensor ``x ~= codes / scale + zero``.

    ``scale``/``zero`` are 0-d tensors (per-tensor) or ``(rows, 1)``
    (per-row) and broadcast against the flattened ``codes``.
    """

    codes: torch.Tensor       # unsigned integer codes in [0, 2^b-1], uint8
    scale: torch.Tensor       # S
    zero: torch.Tensor        # Z
    bits: int
    shape: tuple

    def dequant(self) -> torch.Tensor:
        flat = self.codes.to(torch.float32) / self.scale + self.zero
        return flat.reshape(self.shape)

    @property
    def int8_codes(self) -> torch.Tensor:
        """Codes shifted to signed int8 (code - 2^(b-1))."""
        return (self.codes.to(torch.int16) - self.int8_offset).to(torch.int8)

    @property
    def int8_offset(self) -> int:
        return 1 << (self.bits - 1)

    @classmethod
    def from_int8(cls, codes8: torch.Tensor, scale, zero, bits: int,
                  shape) -> "QTensor":
        """From the kernels' shifted-signed int8 layout back to the
        canonical unsigned one."""
        off = 1 << (bits - 1)
        codes = (codes8.to(torch.int16) + off).to(torch.uint8)
        return cls(codes=codes, scale=torch.as_tensor(scale),
                   zero=torch.as_tensor(zero), bits=bits, shape=tuple(shape))


def tensor_min_max(x: torch.Tensor):
    """(min X, max X) over the whole tensor, as 0-d tensors."""
    lo, hi = torch.aminmax(x)
    return lo, hi


def quantize_ptq_det(x: torch.Tensor, bits: int = 8) -> QTensor:
    """Deterministic per-tensor quantizer (forward-pass Q_f / Q_theta).

    Round-half-to-even, as ``jnp.round``; biased in general but
    deterministic, as the framework requires for the forward pass.
    """
    B = num_bins(bits)
    zero, hi = tensor_min_max(x)
    scale = B / torch.clamp_min(hi - zero, _EPS)
    codes = torch.clamp(torch.round(scale * (x - zero)), 0, B).to(torch.uint8)
    return QTensor(codes=codes, scale=scale, zero=zero, bits=bits,
                   shape=tuple(x.shape))
