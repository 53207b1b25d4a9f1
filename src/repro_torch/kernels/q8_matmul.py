"""int8 x int8 -> int32 GEMM with the fused affine epilogue.

Port of ``repro.kernels.q8_matmul.q8_matmul`` (the Pallas kernel
``_kernel``): the hand-written CUDA kernel ``csrc/q8_matmul.cu`` (int8
tensor cores, split-K by ``kernels/splitk.py``) on the card, and
:func:`q8_matmul_plain` — the same arithmetic in PyTorch — on the CPU.
The epilogue is

    out[i,j] = acc[i,j]*(rs_i*cs_j) + r2_i*u_j + a_i + b_j

with ``acc`` the exact integer code GEMM (``core/backend.py`` derives the
coefficient vectors).  The plain version evaluates ``acc`` in float64,
exact for any K the models reach, so it equals the kernel's int32 sum.

``y8`` may be a row-major (K, N) tensor or the transpose of a row-major
(N, K) one (strides ``(1, K)``): the BHQ activation-grad GEMM passes
``w8.T``, whose contraction axis is already contiguous, and the kernel
reads it K-major without a copy.
"""

from __future__ import annotations

import ctypes

import torch

from . import splitk
from .build import load_function
from .checks import check_tensor

__all__ = ["q8_matmul", "q8_matmul_plain", "q8_epilogue"]

# x8, y8, rs, cs, r2, u, a, b, out, M, N, K, b_kmajor, splits, k_span,
# stream
_ARGTYPES = (ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 6 + (ctypes.c_void_p,)


def _shape_mkn(x8: torch.Tensor, y8: torch.Tensor, who: str):
    if x8.dim() != 2 or y8.dim() != 2 or x8.shape[1] != y8.shape[0]:
        raise ValueError(f"{who}: contraction mismatch — x8 "
                         f"{tuple(x8.shape)} vs y8 {tuple(y8.shape)}")
    return x8.shape[0], x8.shape[1], y8.shape[1]


def q8_matmul_plain(x8, y8, rs, cs, r2, u, a, b) -> torch.Tensor:
    """Plain PyTorch version.  x8: (M, K) int8; y8: (K, N) int8;
    rs/r2/a: (M,); cs/u/b: (N,) f32.  Returns (M, N) f32."""
    _shape_mkn(x8, y8, "q8_matmul_plain")
    acc = x8.to(torch.float64) @ y8.to(torch.float64)
    return q8_epilogue(acc, rs, cs, r2, u, a, b)


def q8_epilogue(acc, rs, cs, r2, u, a, b) -> torch.Tensor:
    """The epilogue on the exact integer sums ``acc`` (M, N), any dtype
    that holds them exactly: float32 once, then the reference's order."""
    acc = acc.to(torch.float32)
    return (acc * (rs[:, None] * cs[None, :]) + r2[:, None] * u[None, :]
            + a[:, None] + b[None, :])


def q8_matmul(x8: torch.Tensor, y8: torch.Tensor, rs: torch.Tensor,
              cs: torch.Tensor, r2: torch.Tensor, u: torch.Tensor,
              a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x8 @ y8`` in int32 with the affine epilogue, f32 out.

    x8: (M, K) int8, contiguous; y8: (K, N) int8, contiguous or the
    transpose of a contiguous (N, K) tensor; rs/r2/a: (M,) and cs/u/b: (N,)
    contiguous f32.

    On a CUDA tensor this launches the kernel (counted in
    ``q8_matmul.launches``): one device launch, whatever the split of K
    (``kernels/splitk.py``).  On a CPU tensor it runs the plain version."""
    M, K, N = _shape_mkn(x8, y8, "q8_matmul")
    if x8.device.type == "cpu":
        return q8_matmul_plain(x8, y8, rs, cs, r2, u, a, b)
    dev = x8.device
    name = "q8_matmul"
    check_tensor(name, "x8", x8, torch.int8, (M, K))
    k_major = not y8.is_contiguous()
    check_tensor(name, "y8" + (".T" if k_major else ""),
                 y8.T if k_major else y8, torch.int8,
                 (N, K) if k_major else (K, N), dev)
    for vname, v, n in (("rs", rs, M), ("cs", cs, N), ("r2", r2, M),
                        ("u", u, N), ("a", a, M), ("b", b, N)):
        check_tensor(name, vname, v, torch.float32, (n,), dev)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    p = splitk.plan(splitk.on_card(splitk.Q8_TILE), M, N, K)
    fn = load_function("q8_matmul", "q8_matmul", _ARGTYPES)
    err = fn(x8.data_ptr(), y8.data_ptr(), rs.data_ptr(), cs.data_ptr(),
             r2.data_ptr(), u.data_ptr(), a.data_ptr(), b.data_ptr(),
             out.data_ptr(), M, N, K, int(k_major), p.splits, p.k_span,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"q8_matmul: kernel launch failed with CUDA error "
                           f"{err} at (M, K, N) = ({M}, {K}, {N})")
    q8_matmul.launches += 1
    return out


q8_matmul.launches = 0
