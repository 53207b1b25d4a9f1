"""int8 x bit-packed sub-byte -> int32 GEMM with the affine epilogue.

Port of ``repro.kernels.q4_matmul``: ``q8_matmul`` with the weight operand
kept bit-packed (``kernels/pack.py`` layout, ``ppb = 8 // wbits`` codes a
byte along K) and unpacked inside the kernel's K sweep, so the packed bytes
are all a GEMM streams.  The hand-written CUDA kernel
``csrc/packed_matmul.cu`` runs on the card (the int8 tensor-core tile of
``csrc/int8_mma.cuh`` with the packed forward's tiles and packed-B stage,
K split by ``kernels/splitk.py``) and :func:`packed_matmul_plain`, the
same arithmetic in PyTorch, on the CPU.  The epilogue is ``q8_matmul``'s
term for term,

    out[i,j] = acc[i,j]*(rs_i*cs_j) + r2_i*u_j + a_i + b_j

with ``acc`` the exact integer GEMM of the shifted codes (``u``'s column sum
runs over the *unpacked* codes; ``PackedTensor.colsum`` holds it).  Packing
pads K to a multiple of ``ppb`` with code 0, which is not the shifted zero:
kernel and plain version both mask ``row >= kdim``.  The plain version
unpacks with shifts and masks and sums through ``torch._int_mm``
(``kernels/codes.py``), the kernel's int32 sum.
"""

from __future__ import annotations

import ctypes

import torch

from . import autotune
from .build import load_function
from .checks import check_bits, check_tensor
from .codes import int_mm
from .pack import codes_per_byte, max_safe_k_packed, unpack_tile
from .q8_matmul import q8_epilogue

__all__ = ["packed_matmul", "packed_matmul_plain"]

# x8, packed, rs, cs, r2, u, a, b, out, M, N, K, mode, splits, k_span,
# stream
_ARGTYPES = (ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 6 + (ctypes.c_void_p,)


def _check_packed_gemm(name: str, x8, packed, wbits: int, kdim: int) -> int:
    """Shared shape and range validation; returns codes-per-byte."""
    ppb = codes_per_byte(wbits)
    check_bits(name, wbits, lo=1)
    if x8.dim() != 2 or packed.dim() != 2 or x8.shape[1] != kdim:
        raise ValueError(f"{name}: x8 {tuple(x8.shape)} and packed "
                         f"{tuple(packed.shape)} must be 2-D with x8 (M, "
                         f"kdim={kdim})")
    if packed.shape[0] != -(-kdim // ppb):
        raise ValueError(
            f"{name}: packed rows {packed.shape[0]} != ceil({kdim}/{ppb}) "
            f"for {wbits}-bit codes")
    safe = max_safe_k_packed(8, wbits)
    if kdim > safe:
        raise ValueError(
            f"{name}: K={kdim} overflows the int32 accumulator for "
            f"int8 x int{wbits} codes (max_safe_k={safe})")
    return ppb


def packed_matmul_plain(x8, packed, rs, cs, r2, u, a, b, *, wbits: int,
                        kdim: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`packed_matmul`."""
    _check_packed_gemm("packed_matmul_plain", x8, packed, wbits, kdim)
    w = unpack_tile(packed, wbits)[:kdim] - (1 << (wbits - 1))
    return q8_epilogue(int_mm(x8, w.to(torch.int8)), rs, cs, r2, u, a, b)


def packed_matmul(x8: torch.Tensor, packed: torch.Tensor, rs: torch.Tensor,
                  cs: torch.Tensor, r2: torch.Tensor, u: torch.Tensor,
                  a: torch.Tensor, b: torch.Tensor, *, wbits: int,
                  kdim: int) -> torch.Tensor:
    """``x8 @ unpack(packed)`` in int32 with the affine epilogue, f32 out.

    x8: (M, kdim) shifted int8 codes; packed: (ceil(kdim/ppb), N) uint8 at
    ``wbits`` in {1, 2, 4, 8}; rs/r2/a: (M,) and cs/u/b: (N,) f32, all
    contiguous.  Raises above ``max_safe_k_packed(8, wbits)``.

    On a CUDA tensor this launches the kernel (counted in
    ``packed_matmul.launches``): one device launch, whatever the tile and
    split of K (``kernels/splitk.py``).  On a CPU tensor it runs the plain
    version."""
    _check_packed_gemm("packed_matmul", x8, packed, wbits, kdim)
    if x8.device.type in ("cpu", "meta"):
        return packed_matmul_plain(x8, packed, rs, cs, r2, u, a, b,
                                   wbits=wbits, kdim=kdim)
    M, N = x8.shape[0], packed.shape[1]
    dev = x8.device
    name = "packed_matmul"
    check_tensor(name, "x8", x8, torch.int8, (M, kdim))
    check_tensor(name, "packed", packed, torch.uint8, tuple(packed.shape),
                 dev)
    for vname, v, n in (("rs", rs, M), ("cs", cs, N), ("r2", r2, M),
                        ("u", u, N), ("a", a, M), ("b", b, N)):
        check_tensor(name, vname, v, torch.float32, (n,), dev)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    p = autotune.lookup_tiles("q4_matmul", (M, kdim, N),
                              autotune.WIDTH_DTYPES[wbits])
    fn = load_function(name, name, _ARGTYPES)
    err = fn(x8.data_ptr(), packed.data_ptr(), rs.data_ptr(), cs.data_ptr(),
             r2.data_ptr(), u.data_ptr(), a.data_ptr(), b.data_ptr(),
             out.data_ptr(), M, N, kdim, p.tile.mode, p.splits, p.k_span,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"packed_matmul: kernel launch failed with CUDA "
                           f"error {err} at (M, K, N) = ({M}, {kdim}, {N}), "
                           f"wbits={wbits}")
    packed_matmul.launches += 1
    return out


packed_matmul.launches = 0
