"""Split-K plans for the int8 tensor-core kernels (``csrc/int8_mma.cuh``).

``q8_matmul``, both entries of ``fused_qlhs_matmul`` (the forward
``csrc/fused_qlhs_fwd.cu`` and dX ``csrc/fused_qlhs_dx.cu``),
``fused_qboth_tn_matmul`` (dW) and the two packed-weight GEMMs
(``fused_qlhs_packed_matmul``, ``csrc/fused_qlhs_packed.cu``, and
``packed_matmul``, ``csrc/packed_matmul.cu``) give each block one (M
tile, N tile, K slice).  Where there are too few output tiles to fill the
H100's 132 SMs (lm_head's (512, 10240, 512) has 16 to 32; a decode GEMM at
8 slots has one row of tiles), K is cut into slices.  The slices of one
tile run as one thread-block cluster, which sums their int32 partials
exactly in distributed shared memory and applies the epilogue once: so a
tile has 1 to 8 slices (8 is the largest portable cluster), and no
workspace is needed.  The plan is a pure function of the kernel's tile
and (M, N, K), cached per shape, so the CPU tests can check it and the
wrappers hand it to the kernel as ``(splits, k_span)``.

A plan's slices are consecutive, non-empty, and ``k_span`` long (a
multiple of the tile's K step ``bk``) except the last, which ends at K.
It takes the split with the least modelled time, ``waves *
(k_steps_per_slice + reduction)``, a wave being as many blocks as the
card runs at once, and on a tie the more slices.  The cluster's
reduction costs half a K step a slice, for every tile: the split sweeps
on the card (PERF.md) showed larger clusters costing more.  A
cluster's blocks are placed within one GPC, so that number depends on the
cluster size.  Each tile's table holds it for clusters of 1 to 8 as the
kernel's library reported it (``*_capacity``:
``cudaOccupancyMaxActiveClusters``) on the H100 SXM of the smoke runs:
the CPU default, which the tests check.  On the card the wrappers plan
with :func:`on_card`, which asks the library once per process (GPC sizes
differ between dies); ``chip_smoke.py`` prints both.  At one block an SM
the dX kernel fills 132 SMs in clusters of 1 or 2 but 120 in clusters of
8 and 102 in clusters of 6.
"""

from __future__ import annotations

import dataclasses
import functools
import math

__all__ = ["SMS", "Tile", "SplitPlan", "Q8_TILE", "DX_TILE", "DW_TILE",
           "FWD_DECODE_TILE", "FWD_DECODE_SR_TILE", "FWD_WIDE_TILE",
           "FWD_WIDE_SR_TILE", "PACKED_LIBS", "PACKED_TILES", "fwd_tile",
           "packed_tile", "on_card", "plan"]

SMS = 132                       # streaming multiprocessors of an H100 SXM


@dataclasses.dataclass(frozen=True)
class Tile:
    """A kernel's block tile, as its CUDA source builds it (the library's
    ``<lib>_tile`` C function reports bm, bn, bk, threads and nacc)."""
    name: str
    lib: str                    # the library (csrc/<lib>.cu) that runs it
    mode: int                   # first argument of <lib>_capacity (and of
    #                             fused_qlhs_fwd: 2 * tile id + SR; of the
    #                             packed GEMMs: 4 * tile id + log2(wbits))
    bm: int                     # output rows a block
    bn: int                     # output columns a block
    bk: int                     # K codes a pipeline stage
    threads: int
    nacc: int                   # int32 accumulators a thread
    capacity: tuple             # blocks at once in clusters of 1..8


# csrc/q8_matmul.cu: 64 x 128, 4 warps, 4 stages of 64 codes, 3 blocks an
# SM (capacity of the K-major layout)
Q8_TILE = Tile("q8_matmul", "q8_matmul", 1, bm=64, bn=128, bk=64,
               threads=128, nacc=64,
               capacity=(396, 396, 372, 368, 345, 372, 329, 360))
# csrc/fused_qlhs_dx.cu: 32 x 512, 16 warps, 3 stages of 64 codes, 1 an SM
# (capacity with SR bits)
DX_TILE = Tile("fused_qlhs_dx", "fused_qlhs_dx", 1, bm=32, bn=512, bk=64,
               threads=512, nacc=32,
               capacity=(132, 132, 117, 120, 110, 102, 105, 120))
# csrc/fused_qboth_tn.cu: 256 x 128, 16 warps, 2 stages of 32 rows, 1 an SM
DW_TILE = Tile("fused_qboth_tn", "fused_qboth_tn", 0, bm=256, bn=128,
               bk=32, threads=512, nacc=64,
               capacity=(132, 132, 117, 120, 110, 102, 105, 120))
# csrc/fused_qlhs_fwd.cu: the decode tile (M <= 16), 16 x 256, 8 warps, 4
# stages of 64 codes, 2 an SM deterministic and 1 with SR bits in the ring;
# the wide tile, 64 x 256, 16 warps, 3 stages of 64 codes, 1 an SM
FWD_DECODE_TILE = Tile("fused_qlhs_fwd decode", "fused_qlhs_fwd", 0, bm=16,
                       bn=256, bk=64, threads=256, nacc=16,
                       capacity=(264, 264, 237, 248, 235, 234, 224, 240))
FWD_DECODE_SR_TILE = dataclasses.replace(
    FWD_DECODE_TILE, name="fused_qlhs_fwd decode SR", mode=1,
    capacity=(132, 132, 117, 120, 110, 102, 105, 120))
FWD_WIDE_TILE = Tile("fused_qlhs_fwd wide", "fused_qlhs_fwd", 2, bm=64,
                     bn=256, bk=64, threads=512, nacc=32,
                     capacity=(132, 132, 117, 120, 110, 102, 105, 120))
FWD_WIDE_SR_TILE = dataclasses.replace(
    FWD_WIDE_TILE, name="fused_qlhs_fwd wide SR", mode=3)


# csrc/fused_qlhs_packed.cu and csrc/packed_matmul.cu (tiles in
# csrc/fused_qlhs_gemm.cuh): the int8 forward's two tiles with B bit-packed
# at wbits, one tile per width: decode (M <= 16) 16 x 256, 8 warps, 4
# stages of 64 codes (steps of 128 and 256 were swept on the card and were
# no faster), wide 64 x 256, 16 warps, 3 stages of 64 codes.  The card
# reported the same capacity at every width and in both libraries: two
# blocks an SM for the decode tile (registers), one for the wide tile.
PACKED_LIBS = ("fused_qlhs_packed", "packed_matmul")
PACKED_TILES = {
    (lib, tile, w): Tile(
        f"{lib} {('decode', 'wide')[tile]} w{w}", lib,
        4 * tile + (1, 2, 4, 8).index(w), bm=(16, 64)[tile], bn=256, bk=64,
        threads=(256, 512)[tile], nacc=(16, 32)[tile],
        capacity=((264, 264, 237, 248, 235, 234, 224, 240),
                  (132, 132, 117, 120, 110, 102, 105, 120))[tile])
    for lib in PACKED_LIBS for tile in (0, 1) for w in (1, 2, 4, 8)}


def packed_tile(lib: str, M: int, wbits: int) -> Tile:
    """The tile of packed-weight GEMM ``lib`` (``fused_qlhs_packed`` or
    ``packed_matmul``) for M LHS rows at ``wbits``: decode up to 16 rows,
    wide above, as the int8 forward picks them (:func:`fwd_tile`)."""
    return PACKED_TILES[lib, 0 if M <= 16 else 1, wbits]


def fwd_tile(M: int, sr: bool) -> Tile:
    """The int8 forward's tile for M LHS rows, with SR bits or not: the
    decode tile up to 16 (a serving step's slots), the wide one above
    (prefill, training)."""
    if M <= 16:
        return FWD_DECODE_SR_TILE if sr else FWD_DECODE_TILE
    return FWD_WIDE_SR_TILE if sr else FWD_WIDE_TILE


@functools.lru_cache(maxsize=None)
def on_card(tile: Tile) -> Tile:
    """``tile`` with the capacity the current card reports for it (the
    library's ``<lib>_capacity(mode, cluster)``), asked once per process;
    raises if the library cannot say (no fallback to the table)."""
    import ctypes

    from .build import load_function
    fn = load_function(tile.lib, tile.lib + "_capacity",
                       (ctypes.c_int, ctypes.c_int))
    cap = tuple(fn(tile.mode, c) for c in range(1, 9))
    if min(cap) <= 0:
        raise RuntimeError(f"{tile.name}: {tile.lib}_capacity reported "
                           f"{cap} (a negative entry is a CUDA error)")
    return dataclasses.replace(tile, capacity=cap)


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    tile: Tile
    M: int
    N: int
    K: int
    m_tiles: int
    n_tiles: int
    splits: int                 # K slices a tile: the cluster size
    k_span: int                 # K codes a slice (the last may be shorter)

    @property
    def tiles(self) -> int:
        return self.m_tiles * self.n_tiles

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits

    @property
    def slices(self) -> list:
        """``[(k0, k1), ...]``, one half-open K range a slice."""
        return [(s * self.k_span, min(self.K, (s + 1) * self.k_span))
                for s in range(self.splits)]


@functools.lru_cache(maxsize=None)
def plan(tile: Tile, M: int, N: int, K: int) -> SplitPlan:
    """The split of K for ``tile`` at (M, N, K); see the module note."""
    m_tiles, n_tiles = -(-M // tile.bm), -(-N // tile.bn)
    tiles = m_tiles * n_tiles
    k_steps = max(1, -(-K // tile.bk))
    best = None
    for s, slots in enumerate(tile.capacity, start=1):
        per = -(-k_steps // s)
        if -(-k_steps // per) != s:
            continue                    # a slice would be empty
        waves = math.ceil(tiles * s / slots)
        cost = waves * (per + (0.5 * s if s > 1 else 0))
        if best is None or cost <= best[0]:     # a tie takes more slices
            best = (cost, s, per)
    _, splits, per = best
    k_span = per * tile.bk
    # a slice starts on a whole byte of weights packed at any width
    assert k_span % 8 == 0, (tile.name, k_span)
    return SplitPlan(tile, M, N, K, m_tiles, n_tiles, splits, k_span)
