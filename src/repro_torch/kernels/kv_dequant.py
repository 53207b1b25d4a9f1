"""Per-row affine dequantization of int8 KV-cache rows.

Port of ``repro.kernels.kv_dequant`` (the Pallas kernel ``kv_dequant_rows``):
the hand-written CUDA kernel ``csrc/kv_dequant.cu`` on the card, and
:func:`kv_dequant_rows_plain` — the same arithmetic in PyTorch — on the
CPU.  Codes are shifted-signed int8 (``c8 = code - 2^(b-1)``) with
``x = (c8 + 2^(b-1)) / scale + zero``; the kernel divides with IEEE
rounding, so its output is bit-identical to the plain version.

:func:`kv_dequant_rows_kv` reads a layer's K and V in one launch and
clamps each scale to ``1e-12`` in the kernel (the cache codec's contract);
:func:`kv_dequant_rows` keeps the reference kernel's unclamped contract.
"""

from __future__ import annotations

import ctypes

import torch

from . import autotune
from .build import load_function
from .checks import check_bits, check_tensor

__all__ = ["kv_dequant_rows", "kv_dequant_rows_plain", "kv_dequant_rows_kv",
           "kv_dequant_rows_kv_plain"]

_EPS = 1e-12

# k codes, scale, zero, v codes, scale, zero, out, M, N, bits, sides,
# clamp, body, stream
_ARGTYPES = (ctypes.c_void_p,) * 7 + (ctypes.c_longlong,) + \
    (ctypes.c_int,) * 5 + (ctypes.c_void_p,)


def kv_dequant_rows_plain(codes8: torch.Tensor, scale: torch.Tensor,
                          zero: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Plain PyTorch version.  codes8: (M, N) int8; scale/zero: (M, 1)."""
    off = 1 << (bits - 1)
    return (codes8.to(torch.float32) + off) / scale + zero


def kv_dequant_rows_kv_plain(k, v, bits: int = 8):
    """Plain PyTorch version of the pair: :func:`kv_dequant_rows_plain` on
    each side, its scale clamped to ``1e-12`` first.  ``k``, ``v``:
    ``(codes8 (M, N) int8, scale (M, 1), zero (M, 1))``."""
    return tuple(kv_dequant_rows_plain(c, torch.clamp_min(s, _EPS), z, bits)
                 for c, s, z in (k, v))


def _launch(name, sides, M, N, bits, clamp, body=None):
    """One launch of the C entry ``kv_dequant`` over ``sides`` (each
    ``(codes8, scale, zero)``, already checked); returns (sides, M, N).
    ``body``: the kernel body (``csrc/kv_dequant.cu``: 0 the entry's own
    choice, 1 bulk, 2 element), by default the one ``kernels/autotune.py``
    resolves for (M, N)."""
    if body is None:
        body = autotune.lookup_tiles("kv_dequant", (M, N))
    dev = sides[0][0].device
    out = torch.empty((len(sides), M, N), dtype=torch.float32, device=dev)
    k, v = sides[0], sides[-1]
    fn = load_function("kv_dequant", "kv_dequant", _ARGTYPES)
    err = fn(*(t.data_ptr() for t in k + v), out.data_ptr(), M, N, bits,
             len(sides), clamp, body,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err} at (M, N) = ({M}, {N})")
    return out


def _check_side(name, side, tag, M, N, dev):
    codes8, scale, zero = side
    check_tensor(name, f"{tag}codes8", codes8, torch.int8, (M, N), dev)
    check_tensor(name, f"{tag}scale", scale, torch.float32, (M, 1), dev)
    check_tensor(name, f"{tag}zero", zero, torch.float32, (M, 1), dev)


def _rows(name, codes8):
    if codes8.dim() != 2:
        raise ValueError(f"{name}: codes8 must be (M, N), got "
                         f"{tuple(codes8.shape)}")
    return codes8.shape


def kv_dequant_rows(codes8: torch.Tensor, scale: torch.Tensor,
                    zero: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Dequantize per-row affine int8 codes.  codes8: (M, N) int8 shifted
    by ``-2^(b-1)``; scale/zero: (M, 1) f32.  Returns (M, N) f32.

    On a CUDA tensor this launches the kernel (and counts the launch in
    ``kv_dequant_rows.launches``); on a CPU tensor it runs the plain
    version."""
    name = "kv_dequant_rows"
    check_bits(name, bits)
    M, N = _rows(name, codes8)
    if codes8.device.type in ("cpu", "meta"):
        return kv_dequant_rows_plain(codes8, scale, zero, bits)
    _check_side(name, (codes8, scale, zero), "", M, N, codes8.device)
    out = _launch(name, [(codes8, scale, zero)], M, N, bits, clamp=0)
    kv_dequant_rows.launches += 1
    return out[0]


def kv_dequant_rows_kv(k, v, bits: int = 8):
    """Dequantize a layer's K and V rows in one launch.  ``k``, ``v``:
    ``(codes8 (M, N) int8, scale (M, 1) f32, zero (M, 1) f32)`` of equal
    shapes.  Each scale is clamped to ``1e-12`` (a degenerate row stays
    finite).  Returns ``(k (M, N) f32, v (M, N) f32)``.

    On CUDA tensors this launches the kernel once for both sides (counted
    in ``kv_dequant_rows_kv.launches``); on CPU tensors it runs
    :func:`kv_dequant_rows_kv_plain`."""
    name = "kv_dequant_rows_kv"
    check_bits(name, bits)
    M, N = _rows(name, k[0])
    if tuple(v[0].shape) != (M, N):
        raise ValueError(f"{name}: K and V codes must have equal shapes, got "
                         f"{(M, N)} and {tuple(v[0].shape)}")
    if k[0].device.type in ("cpu", "meta"):
        return kv_dequant_rows_kv_plain(k, v, bits)
    dev = k[0].device
    _check_side(name, k, "k ", M, N, dev)
    _check_side(name, v, "v ", M, N, dev)
    out = _launch(name, [tuple(k), tuple(v)], M, N, bits, clamp=1)
    kv_dequant_rows_kv.launches += 1
    return out[0], out[1]


kv_dequant_rows.launches = 0
kv_dequant_rows_kv.launches = 0
