"""Bit-plane packing for sub-byte quantized weights.

Port of ``repro.kernels.pack``.  Unsigned codes are packed along the
*contraction* axis (axis ``-2`` of a ``(K, N)`` weight) into dense uint8
bytes: 2 codes a byte at 4 bits, 4 at 2 bits, 8 at 1 bit (``ppb = 8 //
bits``); 8 bits is the identity packing.  Logical row ``k`` lives in byte
``k // ppb`` at bitfield ``bits * (k % ppb)`` (little-endian within the
byte), so each byte holds ``ppb`` consecutive K codes of one column and
the column axis is untouched.

``pack_codes`` zero-pads K up to a multiple of ``ppb`` and ``unpack_codes``
slices back.  Padding rows unpack to code 0, which is *not* the zero point
of the shifted signed layout, so the packed GEMMs mask ``row >= kdim``.
Shifts and masks run in int32: the values are below 256 (PyTorch's uint32
shifts are thin).

:class:`PackedTensor` has :class:`~repro_torch.core.quantizers.QTensor`'s
attribute surface (``int8_codes`` / ``scale`` / ``zero`` / ``bits`` /
``shape`` / ``dequant``), so backend code written against QTensor works on
packed weights; only the GEMM dispatch special-cases packing.  It also
carries ``colsum``, the int32 column sums of the shifted codes, computed
once when the tensor is built: the epilogue's ``u`` vector needs them, and
eager PyTorch would otherwise unpack every weight on every call.  This
module imports nothing of ``repro_torch.core``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["PACK_WIDTHS", "PackedTensor", "codes_per_byte", "pack_codes",
           "unpack_codes", "unpack_tile", "pack_qtensor", "packed_nbytes",
           "max_safe_k_packed"]

# Bitwidths with a whole number of codes per byte; 8 is the identity
# packing, accepted for uniformity.
PACK_WIDTHS = (1, 2, 4, 8)


def codes_per_byte(bits: int) -> int:
    """Codes packed per storage byte (8 // bits); validates ``bits``."""
    if bits not in PACK_WIDTHS:
        raise ValueError(f"bits={bits} is not packable; a byte holds a whole "
                         f"number of codes only for bits in {PACK_WIDTHS}")
    return 8 // bits


def _check_2d_plus(name: str, x: torch.Tensor) -> None:
    if x.dim() < 2:
        raise ValueError(f"{name} must have ndim >= 2 (pack axis is -2), "
                         f"got shape {tuple(x.shape)}")


def pack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack unsigned codes ``(..., K, N)`` in ``[0, 2^bits - 1]`` into uint8
    ``(..., ceil(K/ppb), N)``; K is zero-padded to a multiple of ``ppb``."""
    ppb = codes_per_byte(bits)
    _check_2d_plus("codes", codes)
    k, n = codes.shape[-2], codes.shape[-1]
    kp = -(-k // ppb) * ppb
    c = codes.to(torch.int32)
    if kp != k:
        c = torch.nn.functional.pad(c, (0, 0, 0, kp - k))
    c = c.reshape(*codes.shape[:-2], kp // ppb, ppb, n)
    out = c[..., 0, :]
    for i in range(1, ppb):
        out = out | (c[..., i, :] << (bits * i))
    return out.to(torch.uint8)


def unpack_tile(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """``(..., R, N)`` uint8 -> ``(..., R*ppb, N)`` int32 unsigned code
    values, padding rows included (callers shift and mask)."""
    ppb = codes_per_byte(bits)
    mask = (1 << bits) - 1
    v = packed.to(torch.int32)
    if ppb == 1:
        return v
    planes = [(v >> (bits * i)) & mask for i in range(ppb)]
    st = torch.stack(planes, dim=-2)                 # (..., R, ppb, N)
    return st.reshape(*packed.shape[:-2], packed.shape[-2] * ppb,
                      packed.shape[-1])


def unpack_codes(packed: torch.Tensor, bits: int, kdim: int) -> torch.Tensor:
    """Inverse of :func:`pack_codes`: ``(..., KP, N)`` -> ``(..., kdim, N)``
    uint8; rows ``kdim ..`` are padding and are sliced off."""
    ppb = codes_per_byte(bits)
    _check_2d_plus("packed", packed)
    if not 0 < kdim <= packed.shape[-2] * ppb:
        raise ValueError(f"kdim={kdim} incompatible with packed rows "
                         f"{packed.shape[-2]} at {ppb} codes/byte")
    return unpack_tile(packed, bits)[..., :kdim, :].to(torch.uint8)


def _shifted_colsum(packed: torch.Tensor, bits: int,
                    kdim: int) -> torch.Tensor:
    """int32 ``sum_k (code - 2^(bits-1))`` over the logical rows, per column
    (and per leading index, one at a time to bound the int32 temporary)."""
    if packed.dim() > 2:
        return torch.stack([_shifted_colsum(p, bits, kdim) for p in packed])
    codes = unpack_tile(packed, bits)[:kdim]
    return codes.sum(dim=0, dtype=torch.int32) - kdim * (1 << (bits - 1))


@dataclasses.dataclass(frozen=True)
class PackedTensor:
    """Bit-packed affine-quantized tensor ``x ~= codes / scale + zero``.

    ``packed`` stores ``ppb = 8 // bits`` unsigned codes a byte along the
    contraction axis; ``kdim`` is the logical K.  A stacked ``(L, K, N)``
    weight packs with a leading ``L`` axis on ``packed``, ``scale``/``zero``
    (``(L, 1, 1)``) and ``colsum`` (``(L, N)``); ``pt[i]`` is layer ``i``.
    ``colsum`` (int32 column sums of the shifted codes) is computed from
    ``packed`` when not given.
    """

    packed: torch.Tensor         # (..., ceil(kdim/ppb), N) uint8
    scale: torch.Tensor          # S     — x ~= codes / S + Z
    zero: torch.Tensor           # Z
    bits: int
    kdim: int
    colsum: Optional[torch.Tensor] = None     # (..., N) int32

    def __post_init__(self):
        if self.colsum is None:
            object.__setattr__(self, "colsum", _shifted_colsum(
                self.packed, self.bits, self.kdim))

    @property
    def shape(self) -> tuple:
        """Logical (unpacked) shape ``(..., kdim, N)``."""
        return tuple(self.packed.shape[:-2]) + (self.kdim,
                                                self.packed.shape[-1])

    @property
    def ndim(self) -> int:
        return self.packed.dim()

    @property
    def codes(self) -> torch.Tensor:
        """Unpacked unsigned codes in the canonical QTensor layout."""
        return unpack_codes(self.packed, self.bits, self.kdim)

    @property
    def int8_codes(self) -> torch.Tensor:
        """Unpacked codes shifted to signed int8 (``code - 2^(b-1)``)."""
        tile = unpack_tile(self.packed, self.bits)[..., :self.kdim, :]
        return (tile - self.int8_offset).to(torch.int8)

    @property
    def int8_offset(self) -> int:
        return 1 << (self.bits - 1)

    def dequant(self) -> torch.Tensor:
        return self.codes.to(torch.float32) / self.scale + self.zero

    @property
    def nbytes(self) -> int:
        """Resident bytes: the packed codes, the affine pair and colsum."""
        return sum(t.numel() * t.element_size() for t in
                   (self.packed, self.scale, self.zero, self.colsum))

    def __getitem__(self, i) -> "PackedTensor":
        """Layer ``i`` of a stacked tensor: scale/zero ``(1, 1)``, same
        ``kdim``."""
        if self.packed.dim() < 3:
            raise IndexError("only a stacked (L, ...) PackedTensor slices")
        return PackedTensor(self.packed[i], self.scale[i], self.zero[i],
                            self.bits, self.kdim, self.colsum[i])

    def to(self, device) -> "PackedTensor":
        return PackedTensor(*(t.to(device) for t in
                              (self.packed, self.scale, self.zero)),
                            self.bits, self.kdim, self.colsum.to(device))


def pack_qtensor(qt) -> PackedTensor:
    """Pack any QTensor-shaped object (codes/scale/zero/bits/shape) whose
    logical shape has ndim >= 2; codes are reshaped to it first."""
    shape = tuple(qt.shape)
    if len(shape) < 2:
        raise ValueError(f"cannot pack a rank-{len(shape)} tensor; the pack "
                         f"axis is the contraction axis of a (K, N) operand")
    codes = qt.codes.reshape(shape)
    return PackedTensor(packed=pack_codes(codes, qt.bits),
                        scale=torch.as_tensor(qt.scale),
                        zero=torch.as_tensor(qt.zero), bits=qt.bits,
                        kdim=shape[-2])


def packed_nbytes(shape, bits: int) -> int:
    """Code bytes for a logical ``shape`` packed at ``bits`` (no affine)."""
    ppb = codes_per_byte(bits)
    k, n = shape[-2], shape[-1]
    lead = 1
    for d in shape[:-2]:
        lead *= int(d)
    return lead * (-(-int(k) // ppb)) * int(n)


def max_safe_k_packed(lhs_bits: int, rhs_bits: int) -> int:
    """Largest contraction K with no int32 overflow for shifted-signed
    codes: the worst product is ``2^(a-1) * 2^(b-1)``, so ``K_max = (2^31 -
    1) // that``."""
    if not (1 <= lhs_bits <= 32 and 1 <= rhs_bits <= 32):
        raise ValueError(f"bits out of range: {lhs_bits}, {rhs_bits}")
    prod = (1 << (lhs_bits - 1)) * (1 << (rhs_bits - 1))
    return (2**31 - 1) // prod
