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
"""

from __future__ import annotations

import ctypes

import torch

from .build import load_function
from .checks import check_bits, check_tensor

__all__ = ["kv_gather_pages", "kv_gather_pages_plain"]

_EPS = 1e-12

# codes, scale, zero, table, out, B, nb, P, D, bits, stream
_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)


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
    n_pages, P, D, B, nb = _shapes(codes, table, "kv_gather_pages")
    if codes.device.type == "cpu":
        return kv_gather_pages_plain(codes, scale, zero, table, bits)
    dev = codes.device
    name = "kv_gather_pages"
    check_tensor(name, "codes", codes, torch.int8, (n_pages, P, D))
    check_tensor(name, "scale", scale, torch.float32, (n_pages, P), dev)
    check_tensor(name, "zero", zero, torch.float32, (n_pages, P), dev)
    check_tensor(name, "table", table, torch.int32, (B, nb), dev)
    out = torch.empty((B, nb * P, D), dtype=torch.float32, device=dev)
    fn = load_function("kv_gather", "kv_gather_pages", _ARGTYPES)
    err = fn(codes.data_ptr(), scale.data_ptr(), zero.data_ptr(),
             table.data_ptr(), out.data_ptr(), B, nb, P, D, bits,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"kv_gather_pages: kernel launch failed with CUDA "
                           f"error {err} at (B, nb, P, D) = ({B}, {nb}, {P}, "
                           f"{D})")
    kv_gather_pages.launches += 1
    return out


kv_gather_pages.launches = 0
