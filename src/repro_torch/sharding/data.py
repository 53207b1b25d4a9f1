"""The data-parallel group of a training step.

A mesh step must compute the flat step's function.  The reference gets
that from GSPMD, which reduces every per-tensor range over the whole
global batch, and from partitionable threefry, which draws each
element's SR bits by its global flat index.  The port makes both
explicit: the step runs each rank's rows inside :func:`use_data_group`,
and the quantizers consult the group at their choke points:

  * per-tensor ranges (``core.quantizers.tensor_min_max``) are reduced
    over the group (:func:`global_min_max`).  Every quantized operand is
    a row shard of the batch (activations, output gradients) or
    replicated (weights), so the group's range is the flat step's;
    per-row (PSQ) ranges stay local;
  * SR bits of a batch-spanning operand are drawn at the rank's global
    flat indices (:func:`sr_offset`, ``prng.bits(..., offset=)``): the
    flattened ``(B*T, N)`` operands are row-major with the batch outermost
    and every rank holds the same number of rows, so rank ``r``'s
    elements start at ``r * numel``;
  * BHQ's row blocks of a batch-spanning operand take their global block
    indices (:func:`bhq_blocks`); a block that would straddle two ranks
    raises.

Which operands span the batch is said where they are quantized: the FQT
backward quantizes its output gradient inside :func:`batch_operand`.

The chunked head loss cuts the global batch's flattened rows into
contiguous chunks (:func:`loss_chunks`).  A chunk's head GEMM runs in a
group of its own: the ranks that hold its rows (one rank alone, or a run
of consecutive ranks, :meth:`DataGroup.split`), so its ranges are the
chunk's and its SR bits and BHQ blocks sit at the chunk's global indices.
Anywhere else (a replicated operand, such as a weight) the draws and the
blocks are the flat step's on every rank.

Outside a group (the flat step) every function here is the identity, so
the flat step's numbers do not move.  The group is a module global, not
a thread-local: autograd runs a CUDA backward on its own thread.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional

import torch

__all__ = ["DataGroup", "use_data_group", "batch_operand", "current",
           "global_min_max", "sr_offset", "bhq_blocks", "loss_chunks"]

# where the refused cases stand in ROADMAP.md
STRADDLE_ITEM = "ROADMAP.md queue 1, item 3 (open: BHQ blocks across ranks)"


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """The ranks that split a step's batch rows: the process group, this
    rank's index in it and its size.  ``group`` None is one rank alone
    (no collective); ``runs(k)``, where given, is ``(group, index)`` of
    this rank's run of ``k`` consecutive ranks, built collectively."""
    group: object
    rank: int
    size: int
    runs: Optional[Callable] = dataclasses.field(default=None,
                                                 compare=False)

    def split(self, k: int) -> "DataGroup":
        """This rank's run of ``k`` consecutive ranks of the group, as a
        group of its own."""
        if k == 1:
            return DataGroup(None, 0, 1)
        if self.runs is None or self.size % k:
            raise ValueError(f"a data group of {self.size} ranks has no "
                             f"runs of {k}")
        group, index = self.runs(k)
        return DataGroup(group, index, k)


_CURRENT: Optional[DataGroup] = None
_BATCH = False          # inside batch_operand()


@contextlib.contextmanager
def use_data_group(group: Optional[DataGroup]):
    """Run the block with ``group`` as the step's data group (``None``:
    the flat step)."""
    global _CURRENT
    prev, _CURRENT = _CURRENT, group
    try:
        yield group
    finally:
        _CURRENT = prev


_SAME = object()


@contextlib.contextmanager
def batch_operand(group=_SAME):
    """Run the block's quantizers on operands that are row shards of the
    batch: their SR draws and BHQ blocks take the rank's global indices
    (outside a data group this changes nothing); in ``group`` when given
    (as :func:`use_data_group`), else in the current group."""
    global _BATCH, _CURRENT
    prev = _BATCH, _CURRENT
    _BATCH = True
    if group is not _SAME:
        _CURRENT = group
    try:
        yield
    finally:
        _BATCH, _CURRENT = prev


def current() -> Optional[DataGroup]:
    return _CURRENT


def global_min_max(lo: torch.Tensor, hi: torch.Tensor):
    """``(lo, hi)`` reduced to the group's min and max (one MAX
    all-reduce of ``(-lo, hi)``; negation is exact).  The collective runs
    for a group of one too, so a one-rank mesh exercises it."""
    g = _CURRENT
    if g is None or g.group is None:
        return lo, hi
    import torch.distributed as dist
    t = torch.stack([-lo.reshape(()), hi.reshape(())])
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=g.group)
    return -t[0], t[1]


def sr_offset(numel: int) -> int:
    """The global flat index of this rank's first element of an operand
    of ``numel`` elements a rank: ``rank * numel`` for a batch-spanning
    operand (:func:`batch_operand`) in a data group, else 0."""
    g = _CURRENT
    return 0 if g is None or not _BATCH else g.rank * int(numel)


def bhq_blocks(n_rows: int, block_rows: int, n_blocks: int):
    """``(first, total)``: the global index of this rank's first BHQ row
    block and the batch's block count, for an operand of ``n_rows`` rows a
    rank in ``n_blocks`` local blocks.  For a batch-spanning operand
    (:func:`batch_operand`) under a group of more than one rank each
    rank's rows must be whole blocks (the grouping runs independently
    over blocks); else ``ValueError``."""
    g = _CURRENT
    if g is None or g.size == 1 or not _BATCH:
        return 0, n_blocks
    if n_rows % block_rows:
        raise ValueError(
            f"BHQ under a data group of {g.size} ranks: {n_rows} rows per "
            f"rank is not a whole number of bhq_block={block_rows} blocks, "
            f"so a block would straddle ranks ({STRADDLE_ITEM})")
    return g.rank * n_blocks, g.size * n_blocks


def loss_chunks(rows: int, n_chunks: int):
    """The loss chunks that this rank's ``rows`` flattened rows meet, as
    ``[(c, lo, hi, group)]``: global chunk ``c`` is the local rows
    ``[lo, hi)``, and its head GEMM runs in ``group`` (None: the flat
    step).  The global rows (``rows`` on each of the group's ranks, rank
    order) are cut into ``n_chunks`` contiguous chunks, as the reference
    cuts its flattened batch; None when they are not cut (``n_chunks <=
    1``, or it does not divide them).  A chunk lies on one rank, or spans
    a run of whole ranks; any other cut raises ``ValueError``."""
    g = _CURRENT
    total = rows * (1 if g is None else g.size)
    if n_chunks <= 1 or total % n_chunks:
        return None
    cs = total // n_chunks
    if g is None:
        return [(c, c * cs, (c + 1) * cs, None) for c in range(n_chunks)]
    if rows % cs == 0:
        first = g.rank * (rows // cs)
        alone = DataGroup(None, 0, 1)
        return [(first + j, j * cs, (j + 1) * cs, alone)
                for j in range(rows // cs)]
    if cs % rows == 0:
        k = cs // rows
        return [(g.rank // k, 0, rows, g.split(k))]
    raise ValueError(
        f"loss_chunks={n_chunks}: chunks of {cs} rows neither fit whole "
        f"in a rank's {rows} rows nor span whole ranks")
