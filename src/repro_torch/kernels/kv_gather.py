"""Block-table page gather with a fused affine dequantize.

Port of ``repro.kernels.kv_gather`` (the Pallas kernel ``kv_gather_pages``
and its XLA twin ``kv_gather_pages_xla``): the hand-written CUDA kernel
``csrc/kv_gather.cu`` on the card, and :func:`kv_gather_pages_plain` — the
same arithmetic in PyTorch — on the CPU.  The paged serving engine stores
its int8 KV cache as ``(n_pages, P, D)`` pages; a ``(B, nb)`` block table
of page ids turns them back into each lane's contiguous ``(nb*P, D)``
cache,

    out[b, j*P + p] = (codes[table[b, j], p] + 2^(b-1))
                      / max(scale[table[b, j], p], 1e-12) + zero[...]

The scale clamp keeps a degenerate page (the garbage page 0, a zero-scale
row) finite; the kernel divides with IEEE rounding, so its output is
bit-identical to the plain version.

:func:`kv_gather_pages_kv` reads a layer's K and V pools through one
table in one launch.
"""

from __future__ import annotations

import ctypes

import torch

from .build import load_function
from .checks import check_bits, check_tensor

__all__ = ["kv_gather_pages", "kv_gather_pages_plain", "kv_gather_pages_kv",
           "kv_gather_pages_kv_plain"]

_EPS = 1e-12

# k codes, scale, zero, v codes, scale, zero, table, out, B, nb, P, D,
# bits, sides, body, stream
_ARGTYPES = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 7 + (ctypes.c_void_p,)


def _shapes(codes: torch.Tensor, table: torch.Tensor, who: str):
    if codes.dim() != 3 or table.dim() != 2:
        raise ValueError(f"{who}: codes must be (n_pages, P, D) and table "
                         f"(B, nb), got {tuple(codes.shape)} and "
                         f"{tuple(table.shape)}")
    return codes.shape + table.shape


def kv_gather_pages_plain(codes: torch.Tensor, scale: torch.Tensor,
                          zero: torch.Tensor, table: torch.Tensor,
                          bits: int = 8) -> torch.Tensor:
    """Plain PyTorch version.  codes: (n_pages, P, D) int8; scale/zero:
    (n_pages, P) f32; table: (B, nb) integer page ids.  Returns
    (B, nb*P, D) f32."""
    check_bits("kv_gather_pages_plain", bits)
    _shapes(codes, table, "kv_gather_pages_plain")
    off = 1 << (bits - 1)
    idx = table.to(torch.int64)
    g = codes[idx]                                         # (B, nb, P, D)
    s = torch.clamp_min(scale.to(torch.float32), _EPS)[idx][..., None]
    z = zero[idx][..., None]
    out = (g.to(torch.float32) + off) / s + z
    B, nb, P, D = out.shape
    return out.reshape(B, nb * P, D)


def kv_gather_pages_kv_plain(k, v, table: torch.Tensor, bits: int = 8):
    """Plain PyTorch version of the pair: :func:`kv_gather_pages_plain` on
    each side.  ``k``, ``v``: ``(codes, scale, zero)`` pools."""
    return tuple(kv_gather_pages_plain(*side, table, bits) for side in (k, v))


def _launch(name, sides, table, bits, body=0):
    """One launch of the C entry ``kv_gather`` over ``sides`` (each
    ``(codes, scale, zero)``) through ``table``, every operand checked
    here; returns (sides, B, nb*P, D) f32.  ``body``: the kernel body (0
    the default; ``csrc/kv_gather.cu``), which chip_smoke.py times one
    against another."""
    n_pages, P, D, B, nb = _shapes(sides[0][0], table, name)
    dev = sides[0][0].device
    for i, (codes, scale, zero) in enumerate(sides):
        tag = ("k ", "v ")[i] if len(sides) == 2 else ""
        check_tensor(name, f"{tag}codes", codes, torch.int8, (n_pages, P, D),
                     dev)
        check_tensor(name, f"{tag}scale", scale, torch.float32, (n_pages, P),
                     dev)
        check_tensor(name, f"{tag}zero", zero, torch.float32, (n_pages, P),
                     dev)
    check_tensor(name, "table", table, torch.int32, (B, nb), dev)
    out = torch.empty((len(sides), B, nb * P, D), dtype=torch.float32,
                      device=dev)
    k, v = sides[0], sides[-1]
    fn = load_function("kv_gather", "kv_gather", _ARGTYPES)
    err = fn(*(t.data_ptr() for t in (*k, *v, table, out)), B, nb, P, D,
             bits, len(sides), body,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err} at (B, nb, P, D) = ({B}, {nb}, {P}, {D})")
    return out


def kv_gather_pages(codes: torch.Tensor, scale: torch.Tensor,
                    zero: torch.Tensor, table: torch.Tensor,
                    bits: int = 8) -> torch.Tensor:
    """Gather and dequantize paged int8 KV rows through a block table.

    codes: (n_pages, P, D) int8 shifted by ``-2^(b-1)``; scale/zero:
    (n_pages, P) f32; table: (B, nb) int32 page ids in ``[0, n_pages)``,
    in logical block order.  Returns (B, nb*P, D) f32, each lane's cache
    contiguous again.

    On a CUDA tensor this launches the kernel (counted in
    ``kv_gather_pages.launches``); on a CPU tensor it runs the plain
    version."""
    check_bits("kv_gather_pages", bits)
    _shapes(codes, table, "kv_gather_pages")
    if codes.device.type == "cpu":
        return kv_gather_pages_plain(codes, scale, zero, table, bits)
    out = _launch("kv_gather_pages", [(codes, scale, zero)], table, bits)
    kv_gather_pages.launches += 1
    return out[0]


def kv_gather_pages_kv(k, v, table: torch.Tensor, bits: int = 8):
    """Gather and dequantize a layer's K and V pools through one block
    table in one launch.  ``k``, ``v``: ``(codes (n_pages, P, D) int8,
    scale (n_pages, P) f32, zero (n_pages, P) f32)`` of equal shapes;
    ``table`` as :func:`kv_gather_pages`'s.  Returns ``(k, v)``, each
    (B, nb*P, D) f32.

    On CUDA tensors this launches the kernel once for both sides (counted
    in ``kv_gather_pages_kv.launches``); on CPU tensors it runs
    :func:`kv_gather_pages_kv_plain`."""
    name = "kv_gather_pages_kv"
    check_bits(name, bits)
    _shapes(k[0], table, name)
    if tuple(v[0].shape) != tuple(k[0].shape):
        raise ValueError(f"{name}: K and V pools must have equal shapes, got "
                         f"{tuple(k[0].shape)} and {tuple(v[0].shape)}")
    if k[0].device.type == "cpu":
        return kv_gather_pages_kv_plain(k, v, table, bits)
    out = _launch(name, [tuple(k), tuple(v)], table, bits)
    kv_gather_pages_kv.launches += 1
    return out[0], out[1]


kv_gather_pages.launches = 0
kv_gather_pages_kv.launches = 0
