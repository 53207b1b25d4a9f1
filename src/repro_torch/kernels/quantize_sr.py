"""Stochastic-rounding quantize to int8 codes: the unfused PTQ/PSQ
backward quantizers.

Port of ``repro.kernels.quantize_sr`` (the Pallas kernels
``quantize_sr_rows`` and ``quantize_sr_tensor``, with their references
``repro.kernels.ref.quantize_sr_*_ref``): the hand-written CUDA kernels of
``csrc/quantize_sr.cu`` on the card, and the ``*_plain`` versions — the
same arithmetic in PyTorch — on the CPU.  With ``B = 2^b - 1``:

    scale = B / max(hi - lo, 1e-12),  zero = lo
    codes = clip(floor(scale * (x - lo) + rbits * 2^-32), 0, B) - 2^(b-1)

``quantize_sr_rows`` takes ``lo``/``hi`` per row (PSQ), ``quantize_sr_tensor``
over the whole tensor (PTQ); both kernels reduce the range themselves, in
one launch.  ``quantize_sr_tensor`` also takes the range as an operand
(``lo_hi``, two float32 on the tensor's device): a data-parallel step
gives it the range of the whole batch (``sharding/data.py``), as the
Pallas original takes its range from outside.  SR bits are uint32 values
held in int64, as ``prng.bits`` draws them; the kernels read each
entry's low 32 bits.  The kernels round every operation explicitly, so
codes, scales and zeros are bit-identical to the plain versions.

The launch plans are pure functions of the shape and of the card's
numbers (:class:`Card`), so the CPU tests check them: :func:`rows_plan`
holds a narrow row in one block's registers or splits each row over a
thread-block cluster of 1, 2, 4 or 8 blocks,
:func:`tensor_plan` sizes the cooperative grid of the tensor mode and
its chunks.  On the card the wrappers plan with :func:`on_card` (asked of
the library once per process); on the CPU the default is :data:`H100`,
the numbers the library reported on the H100 SXM of the smoke runs.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from .build import load_function
from .checks import as_float32, check_bits, check_tensor

__all__ = ["Card", "H100", "RowsPlan", "TensorPlan", "on_card", "rows_plan",
           "stage_bytes", "tensor_plan", "quantize_sr_rows",
           "quantize_sr_rows_plain", "quantize_sr_tensor",
           "quantize_sr_tensor_plain"]

_EPS = 1e-12
_U32_TO_UNIT = 1.0 / 4294967296.0

# x, rbits, codes, scale, zero, M, N, bits, regs, cluster, stage, smem,
# stream
_ROWS_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 5 + (
    ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p)
# x, rbits, codes, scale, zero, part, range, n, bits, grid, chunk, stage,
# smem, stream
_TENSOR_ARGTYPES = (ctypes.c_void_p,) * 7 + (
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p)

REG_ROW = 1024          # rows up to this wide are held in registers (the
#                         kernel holds up to 2,044; chip_smoke.py sr_sweep)
ROW_STAGE = 16384       # x elements a rows block stages at most (64 KB)
MIN_CHUNK = 2048        # elements a tensor block takes at least
TENSOR_PER_SM = 3       # tensor blocks an SM at most (chip_smoke.py sr_sweep)
TENSOR = 8              # kernel mode of the tensor kernel (+ 1 with a rest)
ROWS_IN_REGISTERS = 10  # kernel mode of the rows kernel without a stage
_SMEM_GRANULE = 128     # bytes: the unit of a block's shared memory


@dataclasses.dataclass(frozen=True)
class Card:
    """What the plans need of the card (``quantize_sr_card``): SMs, shared
    memory an SM, a block's opt-in maximum and the system's reserve a
    block, and for each kernel mode (rows ``2 log2(C) + rest``, tensor ``8
    + rest``, rest 1 where a block's part does not fit its stage; rows in
    registers 10) its blocks an SM at no dynamic shared memory (threads
    and registers) and its static shared memory."""
    sms: int
    smem_per_sm: int
    smem_per_block: int
    reserved_per_block: int
    blocks: tuple
    static_smem: tuple

    def blocks_per_sm(self, mode: int, smem: int) -> int:
        """Blocks of ``mode`` an SM holds at ``smem`` bytes of dynamic
        shared memory (the occupancy calculator's rule)."""
        need = smem + self.static_smem[mode]
        if need > self.smem_per_block:
            return 0
        per = (-(-need // _SMEM_GRANULE) * _SMEM_GRANULE
               + self.reserved_per_block)
        return min(self.blocks[mode], self.smem_per_sm // per)

    def stage_for(self, mode: int, blocks: int) -> int:
        """The most elements a block of ``mode`` can stage (a multiple of
        4) with ``blocks`` of them on an SM; 0 if none."""
        per = self.smem_per_sm // blocks - self.reserved_per_block
        per = min(per // _SMEM_GRANULE * _SMEM_GRANULE, self.smem_per_block)
        return max(0, ((per - self.static_smem[mode]) // 4 - 8) // 4 * 4)


# NVIDIA H100 80GB HBM3 (SXM), as quantize_sr_card reported it: the rows
# kernels without a rest take 45-47 registers (5 blocks an SM), the one in
# registers 40 (6), the others 60-64 (4)
H100 = Card(sms=132, smem_per_sm=233472, smem_per_block=232448,
            reserved_per_block=1024,
            blocks=(5, 4, 5, 4, 5, 4, 5, 4, 4, 4, 6),
            static_smem=(128,) * 11)


@functools.lru_cache(maxsize=None)
def on_card() -> Card:
    """The current card's :class:`Card`, asked of the library once per
    process; raises if the library cannot say (no fallback to the
    table)."""
    fn = load_function("quantize_sr", "quantize_sr_card", (ctypes.c_void_p,))
    out = (ctypes.c_int * 26)()
    err = fn(ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"quantize_sr_card failed with CUDA error {err}")
    v = list(out)
    return Card(sms=v[0], smem_per_sm=v[1], smem_per_block=v[2],
                reserved_per_block=v[3], blocks=tuple(v[4:15]),
                static_smem=tuple(v[15:26]))


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _span(n: int, parts: int) -> int:
    """Elements a part: ceil(n / parts) up to a multiple of 4."""
    return 4 * _ceil(_ceil(n, parts), 4)


def stage_bytes(stage: int) -> int:
    """Dynamic shared memory of a block staging ``stage`` elements (up to 3
    words off the 16-byte grid)."""
    return (stage + 8) * 4 if stage > 0 else 0


def rows_mode(cluster: int, rest: bool = False) -> int:
    return 2 * (cluster.bit_length() - 1) + int(rest)


@dataclasses.dataclass(frozen=True)
class RowsPlan:
    M: int
    N: int
    cluster: int        # blocks a row (one thread-block cluster)
    span: int           # columns a block (the first up to 3 more)
    stage: int          # of them staged (the rest read twice)
    smem: int           # dynamic shared memory a block
    regs: bool = False  # a block a row held in registers (no stage)

    @property
    def staged(self) -> bool:
        return self.stage >= self.span + 4

    @property
    def mode(self) -> int:
        if self.regs:
            return ROWS_IN_REGISTERS
        return rows_mode(self.cluster, not self.staged)

    @property
    def blocks(self) -> int:
        return self.M * self.cluster


@functools.lru_cache(maxsize=None)
def rows_plan(M: int, N: int, card: Card = H100) -> RowsPlan:
    """The launch of ``quantize_sr_rows`` at (M, N): a block a row held in
    registers up to ``REG_ROW`` columns, else the fewest blocks a
    row (1, 2, 4 or 8: a portable cluster) whose share of the row fits a
    stage of ``ROW_STAGE`` elements, or what one block of the card holds
    (more blocks a row than that were slower on the H100: chip_smoke.py
    ``sr_sweep``).  A row longer than 8 stages stages its first
    ``ROW_STAGE`` a block and reads the rest twice, the second time from
    L2."""
    if N <= REG_ROW:
        return RowsPlan(M, N, 1, _span(N, 1), 0, 0, regs=True)
    limit = min(ROW_STAGE, card.stage_for(rows_mode(8, True), 1))
    c = 1
    while c < 8 and _span(N, c) + 4 > limit:
        c *= 2
    span = _span(N, c)
    stage = min(span + 4, limit)
    return RowsPlan(M, N, c, span, stage, stage_bytes(stage))


@dataclasses.dataclass(frozen=True)
class TensorPlan:
    n: int
    grid: int           # blocks, all resident at once (cooperative launch)
    chunk: int          # elements a block (a multiple of 4)
    stage: int          # of them staged (the rest read twice)
    smem: int           # dynamic shared memory a block

    @property
    def staged(self) -> bool:
        return self.stage >= self.chunk + 4

    @property
    def mode(self) -> int:
        return TENSOR + int(not self.staged)


@functools.lru_cache(maxsize=None)
def tensor_plan(n: int, card: Card = H100) -> TensorPlan:
    """The cooperative launch of ``quantize_sr_tensor`` over n elements:
    ``TENSOR_PER_SM`` blocks an SM (fewer if threads and registers allow
    fewer), at most one a ``MIN_CHUNK`` elements, each staging as much of
    its chunk as its share of the SM's shared memory holds.  A tensor
    larger than the resident blocks' shared memory (about 30 MB on the
    H100) reads the rest of each chunk twice, the second time backwards,
    from L2."""
    want = max(1, _ceil(n, MIN_CHUNK))
    for rest in (False, True):
        mode = TENSOR + int(rest)
        grid = min(min(TENSOR_PER_SM, card.blocks[mode]) * card.sms, want)
        chunk = _span(n, grid)
        stage = min(chunk + 4, card.stage_for(mode, _ceil(grid, card.sms)))
        if rest or stage == chunk + 4:
            return TensorPlan(n, grid, chunk, stage, stage_bytes(stage))


def _check_2d(x: torch.Tensor, rbits: torch.Tensor, who: str):
    if x.dim() != 2 or tuple(rbits.shape) != tuple(x.shape):
        raise ValueError(f"{who}: x must be (M, N) with rbits of the same "
                         f"shape, got {tuple(x.shape)} and "
                         f"{tuple(rbits.shape)}")
    return x.shape


def _range_scale(bits: int, rng: torch.Tensor) -> torch.Tensor:
    """``(2^b - 1) / max(rng, 1e-12)`` with IEEE division, as the kernels
    and the reference divide (``core.quantizers.range_scale``)."""
    rng = torch.clamp_min(rng, _EPS)
    return torch.full_like(rng, float((1 << bits) - 1)) / rng


def _sr_codes(x, rbits, scale, lo, bits: int) -> torch.Tensor:
    nbins = (1 << bits) - 1
    u = rbits.to(torch.float32) * _U32_TO_UNIT
    q = torch.clamp(torch.floor(scale * (x - lo) + u), 0, nbins)
    return (q - (1 << (bits - 1))).to(torch.int8)


def quantize_sr_rows_plain(x: torch.Tensor, rbits: torch.Tensor,
                           bits: int = 8):
    """Plain PyTorch version of :func:`quantize_sr_rows`."""
    check_bits("quantize_sr_rows_plain", bits)
    _check_2d(x, rbits, "quantize_sr_rows_plain")
    lo = torch.amin(x, dim=1, keepdim=True)
    hi = torch.amax(x, dim=1, keepdim=True)
    scale = _range_scale(bits, hi - lo)
    return _sr_codes(x, rbits, scale, lo, bits), scale, lo


def quantize_sr_tensor_plain(x: torch.Tensor, rbits: torch.Tensor,
                             bits: int = 8, lo_hi=None):
    """Plain PyTorch version of :func:`quantize_sr_tensor`."""
    check_bits("quantize_sr_tensor_plain", bits)
    _check_2d(x, rbits, "quantize_sr_tensor_plain")
    if lo_hi is None:
        lo, hi = torch.aminmax(x)
    else:
        _check_range(lo_hi, x, "quantize_sr_tensor_plain")
        lo, hi = lo_hi[0], lo_hi[1]
    scale = _range_scale(bits, hi - lo)
    return _sr_codes(x, rbits, scale, lo, bits), scale, lo


def _check_range(lo_hi, x, who: str):
    if (not isinstance(lo_hi, torch.Tensor) or tuple(lo_hi.shape) != (2,)
            or lo_hi.dtype != torch.float32 or lo_hi.device != x.device):
        raise ValueError(f"{who}: lo_hi must be a float32 (lo, hi) pair on "
                         f"{x.device}, got {lo_hi!r}")


def _operands(name, x, rbits):
    M, N = x.shape
    check_tensor(name, "x", x, torch.float32, (M, N))
    check_tensor(name, "rbits", rbits, torch.int64, (M, N), x.device)
    return torch.empty((M, N), dtype=torch.int8, device=x.device)


def _raise_on(name, err, M, N, plan):
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err} at (M, N) = ({M}, {N}), {plan}")


def _rows_launch(x, rbits, bits: int, plan: RowsPlan):
    """One launch of the C entry ``quantize_sr_rows`` under ``plan``
    (uncounted: chip_smoke.py forces every plan through it)."""
    M, N = x.shape
    codes = _operands("quantize_sr_rows", x, rbits)
    scale = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    zero = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    fn = load_function("quantize_sr", "quantize_sr_rows", _ROWS_ARGTYPES)
    err = fn(x.data_ptr(), rbits.data_ptr(), codes.data_ptr(),
             scale.data_ptr(), zero.data_ptr(), M, N, bits, int(plan.regs),
             plan.cluster, plan.stage, plan.smem,
             torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on("quantize_sr_rows", err, M, N, plan)
    return codes, scale, zero


def _tensor_launch(x, rbits, bits: int, plan: TensorPlan, lo_hi=None):
    """One launch of the C entry ``quantize_sr_tensor`` under ``plan``
    (uncounted, as :func:`_rows_launch`); the blocks' partial ranges go
    through a workspace of ``2 * plan.grid`` floats, unless ``lo_hi``
    gives the range."""
    M, N = x.shape
    codes = _operands("quantize_sr_tensor", x, rbits)
    if lo_hi is not None:
        _check_range(lo_hi, x, "quantize_sr_tensor")
        lo_hi = lo_hi.contiguous()
    scale = torch.empty((), dtype=torch.float32, device=x.device)
    zero = torch.empty((), dtype=torch.float32, device=x.device)
    part = torch.empty(2 * plan.grid, dtype=torch.float32, device=x.device)
    fn = load_function("quantize_sr", "quantize_sr_tensor", _TENSOR_ARGTYPES)
    err = fn(x.data_ptr(), rbits.data_ptr(), codes.data_ptr(),
             scale.data_ptr(), zero.data_ptr(), part.data_ptr(),
             None if lo_hi is None else lo_hi.data_ptr(), M * N, bits,
             plan.grid, plan.chunk, plan.stage, plan.smem,
             torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on("quantize_sr_tensor", err, M, N, plan)
    return codes, scale, zero


def quantize_sr_rows(x: torch.Tensor, rbits: torch.Tensor, bits: int = 8):
    """Per-row (PSQ) stochastic quantize.  x: (M, N) f32; rbits: (M, N)
    uint32 values in int64.  Returns ``(codes (M, N) int8 shifted by
    -2^(b-1), scale (M, 1), zero (M, 1))``, ``x ~= (codes + 2^(b-1)) /
    scale + zero``.

    On a CUDA tensor this launches the kernel once, planned by
    :func:`rows_plan` (counted in ``quantize_sr_rows.launches``); on a CPU
    tensor it runs the plain version."""
    check_bits("quantize_sr_rows", bits)
    x = as_float32(x)
    M, N = _check_2d(x, rbits, "quantize_sr_rows")
    if x.device.type in ("cpu", "meta"):
        return quantize_sr_rows_plain(x, rbits, bits)
    out = _rows_launch(x, rbits, bits, rows_plan(M, N, on_card()))
    quantize_sr_rows.launches += 1
    return out


def quantize_sr_tensor(x: torch.Tensor, rbits: torch.Tensor, bits: int = 8,
                       lo_hi=None):
    """Per-tensor (PTQ) stochastic quantize.  x: (M, N) f32; rbits: (M, N)
    uint32 values in int64.  Returns ``(codes (M, N) int8, scale (),
    zero ())``.  ``lo_hi``: the range to quantize over, a float32 ``(lo,
    hi)`` pair on x's device; by default x's own.

    On a CUDA tensor this launches the kernel once, range and codes in one
    cooperative grid planned by :func:`tensor_plan` (counted in
    ``quantize_sr_tensor.launches``); given ``lo_hi`` the grid skips its
    range reduction.  On a CPU tensor it runs the plain version."""
    check_bits("quantize_sr_tensor", bits)
    x = as_float32(x)
    M, N = _check_2d(x, rbits, "quantize_sr_tensor")
    if x.device.type in ("cpu", "meta"):
        return quantize_sr_tensor_plain(x, rbits, bits, lo_hi)
    out = _tensor_launch(x, rbits, bits, tensor_plan(M * N, on_card()),
                         lo_hi)
    quantize_sr_tensor.launches += 1
    return out


quantize_sr_rows.launches = 0
quantize_sr_tensor.launches = 0
