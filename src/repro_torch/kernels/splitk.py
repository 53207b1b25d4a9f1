"""Split-K plans for the int8 tensor-core kernels (``csrc/int8_mma.cuh``).

``q8_matmul`` and the dX entry of ``fused_qlhs_matmul`` give each block one
(M tile, N tile, K slice).  At the training shapes there are too few
output tiles to fill the H100's 132 SMs (lm_head's (512, 10240, 512) has
16 to 32), so K is cut into slices.  The slices of one tile run as one
thread-block cluster, which sums their int32 partials exactly in
distributed shared memory and applies the epilogue once: so a tile has 1
to 8 slices (8 is the largest portable cluster), and no workspace is
needed.  The plan is a pure function of the kernel's tile and (M, N, K),
cached per shape, so the CPU tests can check it and the wrappers hand it
to the kernel as ``(splits, k_span)``.

A plan's slices are consecutive, non-empty, and ``k_span`` long (a
multiple of the tile's K step ``bk``) except the last, which ends at K.
It takes the split with the least modelled time, ``waves *
(k_steps_per_slice + 1/2)``, the half step standing for the in-cluster
reduction; a wave is as many blocks as the card runs at once.  A
cluster's blocks are placed within one GPC, so that number depends on the
cluster size: each tile holds it for clusters of 1 to 8, as the kernel's
library reports it (``*_capacity``: ``cudaOccupancyMaxActiveClusters``)
on the H100 SXM of the smoke runs; ``chip_smoke.py`` prints both.  At one
block an SM the dX kernel fills 132 SMs in clusters of 1 or 2 but 120 in
clusters of 8 and 102 in clusters of 6.
"""

from __future__ import annotations

import dataclasses
import functools
import math

__all__ = ["SMS", "Tile", "SplitPlan", "Q8_TILE", "DX_TILE", "plan"]

SMS = 132                       # streaming multiprocessors of an H100 SXM


@dataclasses.dataclass(frozen=True)
class Tile:
    """A kernel's block tile, as its CUDA source builds it (the source's
    ``*_tile`` C function reports bm, bn, bk, threads and nacc)."""
    name: str
    bm: int                     # output rows a block
    bn: int                     # output columns a block
    bk: int                     # K codes a pipeline stage
    threads: int
    nacc: int                   # int32 accumulators a thread
    capacity: tuple             # blocks at once in clusters of 1..8


# csrc/q8_matmul.cu: 64 x 128, 4 warps, 4 stages of 64 codes, 3 blocks an SM
Q8_TILE = Tile("q8_matmul", bm=64, bn=128, bk=64, threads=128, nacc=64,
               capacity=(396, 396, 372, 368, 345, 372, 329, 360))
# csrc/fused_qlhs_dx.cu: 32 x 512, 16 warps, 3 stages of 64 codes, 1 an SM
DX_TILE = Tile("fused_qlhs_dx", bm=32, bn=512, bk=64, threads=512, nacc=32,
               capacity=(132, 132, 117, 120, 110, 102, 105, 120))


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
        cost = waves * (per + (0.5 if s > 1 else 0))
        if best is None or cost < best[0]:
            best = (cost, s, per)
    _, splits, per = best
    return SplitPlan(tile, M, N, K, m_tiles, n_tiles, splits, per * tile.bk)
