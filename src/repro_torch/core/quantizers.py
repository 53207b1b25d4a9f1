"""Quantizers of the StatQuant paper (NeurIPS 2020).

Port of ``repro.core.quantizers``: the per-tensor deterministic quantizer
``Q_f``/``Q_theta`` (paper Sec. 2.1), the stochastic per-tensor PTQ
(Sec. 3.3) and per-sample PSQ (Sec. 4.1) backward quantizers, and the
:class:`QTensor` container their codes travel in.  BHQ (Sec. 4.2) is in
:mod:`repro_torch.core.bhq`.

Stochastic rounding draws its uniforms as ``prng.bits(key, shape) *
2^-32``, the JAX package's one SR convention, so for the same key the port
and the reference emit bit-identical codes.

Codes are unsigned in ``[0, 2^b - 1]`` (uint8); the GEMM kernels consume
them shifted to signed int8, ``c8 = code - 2^(b-1)``, and
``x ~= codes / scale + zero``.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import prng

__all__ = ["QTensor", "num_bins", "tensor_min_max", "row_dynamic_range",
           "sr_uniform", "stochastic_round", "quantize_ptq_det",
           "quantize_ptq_stoch", "quantize_psq_stoch"]

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


def row_dynamic_range(x2d: torch.Tensor) -> torch.Tensor:
    """Per-row dynamic range R(x_i) for an (N, D) matrix (paper Sec. 4.1)."""
    return torch.amax(x2d, dim=-1) - torch.amin(x2d, dim=-1)


def sr_uniform(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """U[0,1) uniforms for SR, float32, derived as ``bits * 2^-32``
    (the integer-to-float conversion rounds to nearest, as XLA's)."""
    return prng.bits(key, shape, device).to(torch.float32) * \
        (1.0 / 4294967296.0)


def stochastic_round(x: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """SR(x) = floor(x + u), u ~ U[0,1): unbiased (paper Sec. 3.3)."""
    return torch.floor(x + sr_uniform(key, x.shape, x.device))


def quantize_ptq_stoch(x: torch.Tensor, key: torch.Tensor,
                       bits: int = 8) -> QTensor:
    """PTQ: stochastic per-tensor quantizer (paper Sec. 3.3),
    ``Q_b(x) = SR(S (x - Z)) / S + Z`` with Z = min x, S = B / R(x)."""
    B = num_bins(bits)
    zero, hi = tensor_min_max(x)
    scale = B / torch.clamp_min(hi - zero, _EPS)
    codes = stochastic_round(scale * (x - zero), key)
    codes = torch.clamp(codes, 0, B).to(torch.uint8)
    return QTensor(codes=codes, scale=scale, zero=zero, bits=bits,
                   shape=tuple(x.shape))


def quantize_psq_stoch(x: torch.Tensor, key: torch.Tensor,
                       bits: int = 8) -> QTensor:
    """PSQ: stochastic per-sample quantizer (paper Sec. 4.1), one scale
    ``s_i = B / R(x_i)`` and zero ``z_i = min x_i`` per row, (N, 1)."""
    B = num_bins(bits)
    rows = x.reshape(-1, x.shape[-1])
    zero = torch.amin(rows, dim=-1, keepdim=True)
    rng = torch.clamp_min(row_dynamic_range(rows)[:, None], _EPS)
    scale = B / rng
    codes = stochastic_round(scale * (rows - zero), key)
    codes = torch.clamp(codes, 0, B).to(torch.uint8)
    return QTensor(codes=codes, scale=scale, zero=zero, bits=bits,
                   shape=tuple(x.shape))
