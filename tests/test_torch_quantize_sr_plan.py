"""The launch plans of the port's SR quantizers (``kernels/quantize_sr.py``
``rows_plan`` and ``tensor_plan``), pure functions of the shape and the
card's numbers, checked on the CPU against the recorded H100 default:
every plan fits the card's shared memory and residency, covers every
element, and switches between staged and re-read where the plan rules
say.  Then the wrappers on CPU tensors (the plain versions, no launch
counted), and the plain versions against the JAX package's Pallas kernels
in interpret mode at the plans' boundary widths, bit for bit."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import quantize_sr as pallas_sr  # noqa: E402
from repro_torch.kernels import quantize_sr as q  # noqa: E402

# (M, N) of every backward quantize of the statquant-tx step, granite-3-2b's
# with 2048 tokens, and ragged (chip_smoke.py sr_shapes)
SR_SHAPES = ([(512, n) for n in (512, 1024, 10240)]
             + [(2048, n) for n in (2048, 512, 8192, 49408)]
             + [(33, 130), (1, 64), (16, 1), (3, 5)])
# the widths where rows_plan changes its cluster or stops staging whole
ROW_EDGES = [(q.ROW_STAGE - 4) * c + d for c in (1, 2, 4, 8) for d in (0, 1)]


def _fits(card, mode, smem):
    return smem + card.static_smem[mode] <= card.smem_per_block


@pytest.mark.parametrize("mn", SR_SHAPES + [(4, n) for n in ROW_EDGES]
                         + [(9, q.REG_ROW), (9, q.REG_ROW + 1)])
def test_rows_plan_fits_the_card_and_covers_the_row(mn):
    M, N = mn
    p = q.rows_plan(M, N)
    if N <= q.REG_ROW:
        # a block a row in registers: at most 2 quads a thread of 256
        # (the kernel's limit, 2,044 columns), whatever the row's offset on
        # the codes' 4-byte grid (up to 3)
        assert p.regs and (p.cluster, p.stage, p.smem) == (1, 0, 0)
        assert p.mode == q.ROWS_IN_REGISTERS and p.blocks == M
        assert (N + 3 + 3) // 4 <= 2 * 256
        assert q.H100.blocks_per_sm(p.mode, 0) >= 1
        return
    assert not p.regs and p.cluster in (1, 2, 4, 8)
    assert p.span % 4 == 0 and p.span * p.cluster >= N
    assert p.span * (p.cluster - 1) < N or p.cluster == 1
    assert p.blocks == M * p.cluster
    mode = p.mode
    assert mode == q.rows_mode(p.cluster, not p.staged)
    assert p.stage % 4 == 0 and 0 < p.stage <= q.ROW_STAGE
    assert p.smem == q.stage_bytes(p.stage) and _fits(q.H100, mode, p.smem)
    assert q.H100.blocks_per_sm(mode, p.smem) >= 1
    # a block's part is at most span + 1 elements from its first pair: a
    # stage of span + 4 holds it whole
    assert p.staged == (p.stage >= p.span + 4)
    assert p.staged == (q._span(N, 8) + 4 <= q.ROW_STAGE)
    if not p.staged:
        assert p.cluster == 8 and p.stage == q.ROW_STAGE


@pytest.mark.parametrize("N, cluster", [
    (512, 0), (1024, 0), (1025, 1), (2048, 1), (8192, 1), (10240, 1),
    (16380, 1), (16381, 2), (32760, 2), (49408, 4), (65520, 4),
    (65521, 8), (131040, 8)])
def test_rows_plan_at_the_training_rows(N, cluster):
    """At 512 and 2048 rows (the training steps' tokens) a row up to
    REG_ROW wide is held in registers (0 below), a wider one takes the
    fewest blocks whose share fits a stage, staged whole; granite's 49,408
    columns take 4."""
    for M in (512, 2048):
        p = q.rows_plan(M, N)
        got = (0, False) if p.regs else (p.cluster, p.staged)
        assert got == (cluster, cluster > 0), (M, p)
    p = q.rows_plan(512, 131041)
    assert (p.cluster, p.staged) == (8, False)


@pytest.mark.parametrize("n", [M * N for M, N in SR_SHAPES]
                         + [1, 4, q.MIN_CHUNK, q.MIN_CHUNK + 1, 10 ** 7])
def test_tensor_plan_is_resident_and_covers_the_tensor(n):
    p = q.tensor_plan(n)
    card = q.H100
    assert p.chunk % 4 == 0 and p.chunk >= 4
    assert p.grid * p.chunk >= n and (p.grid - 1) * p.chunk < max(n, 1)
    per_sm = min(q.TENSOR_PER_SM, card.blocks[p.mode])
    assert p.grid == min(card.sms * per_sm, max(1, -(-n // q.MIN_CHUNK)))
    # a cooperative grid: every block resident at once
    assert p.mode == q.TENSOR + (not p.staged)
    assert p.grid <= card.sms * card.blocks_per_sm(p.mode, p.smem)
    assert _fits(card, p.mode, p.smem)
    assert p.stage % 4 == 0 and 0 < p.stage <= p.chunk + 4
    assert p.smem == q.stage_bytes(p.stage)


def test_tensor_plan_stages_what_the_resident_blocks_hold():
    """Staged whole while the tensor fits the resident blocks' shared
    memory (statquant-tx's lm_head gradient, 21 MB); above (granite's
    (2048, 8192), 67 MB) each block stages its share of an SM's shared
    memory and reads the rest twice; at the boundary both ways."""
    card = q.H100
    per_sm = q.TENSOR_PER_SM
    assert q.tensor_plan(512 * 10240).staged
    big = q.tensor_plan(2048 * 8192)
    assert not big.staged and big.grid == card.sms * per_sm
    assert big.stage == card.stage_for(big.mode, per_sm)
    assert card.blocks_per_sm(big.mode, big.smem) >= per_sm
    assert card.blocks_per_sm(big.mode, q.stage_bytes(big.stage + 4)) \
        < per_sm
    grid = card.sms * per_sm
    top = grid * (big.stage - 4)
    assert q.tensor_plan(top).staged
    assert not q.tensor_plan(top + 4 * grid).staged


def test_plans_follow_the_card():
    """The plans read the card they are given: a card with half the SMs
    plans half the resident grid, one with fewer blocks an SM stages
    more a block."""
    import dataclasses
    half = dataclasses.replace(q.H100, sms=q.H100.sms // 2)
    assert q.tensor_plan(2048 * 8192, half).grid == \
        q.tensor_plan(2048 * 8192).grid // 2
    assert q.tensor_plan(512 * 512, half) == q.tensor_plan(512 * 512)
    two = dataclasses.replace(q.H100, blocks=(2,) * 11)
    assert q.tensor_plan(2048 * 8192, two).stage > \
        q.tensor_plan(2048 * 8192).stage


def _inputs(M, N, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(M, N) * 1e-3).astype(np.float32)
    x[0, -1] = 7e-3                 # the range's top in the last chunk
    x[-1, -1] = -6e-3
    rbits = rng.randint(0, 2 ** 32, (M, N), dtype=np.uint64)
    rbits.reshape(-1)[:4] = [0, 2 ** 31, 2 ** 32 - 129, 2 ** 32 - 1]
    return x, rbits.astype(np.uint32)


@pytest.mark.parametrize("mn", [(3, 2049), (1, 16381)])
@pytest.mark.parametrize("bits", [8, 4])
def test_wrappers_on_cpu_are_the_plain_versions(mn, bits):
    x, rb = _inputs(*mn, seed=sum(mn) + bits)
    tx, trb = torch.from_numpy(x), torch.from_numpy(rb.astype(np.int64))
    r0, t0 = q.quantize_sr_rows.launches, q.quantize_sr_tensor.launches
    for kern, plain in ((q.quantize_sr_rows, q.quantize_sr_rows_plain),
                        (q.quantize_sr_tensor, q.quantize_sr_tensor_plain)):
        for a, b in zip(kern(tx, trb, bits), plain(tx, trb, bits)):
            assert a.shape == b.shape and torch.equal(a, b)
    assert q.quantize_sr_rows.launches == r0
    assert q.quantize_sr_tensor.launches == t0


@pytest.mark.parametrize("mn", [(3, 2049), (1, 16381)])
def test_plain_versions_match_pallas_at_plan_boundaries(mn):
    """Widths just past a plan boundary (a second tensor chunk past 2,048
    elements; a row past one 16,384-element stage at 16,381), with
    the range's extremes in the last elements: the plain versions equal
    the Pallas kernels in interpret mode bit for bit."""
    x, rb = _inputs(*mn, seed=5)
    tx, trb = torch.from_numpy(x), torch.from_numpy(rb.astype(np.int64))
    jx, jb = jnp.asarray(x), jnp.asarray(rb)
    for got, want in (
            (q.quantize_sr_rows_plain(tx, trb, 8),
             pallas_sr.quantize_sr_rows(jx, jb, 8, bm=8, interpret=True)),
            (q.quantize_sr_tensor_plain(tx, trb, 8),
             pallas_sr.quantize_sr_tensor(jx, jb, 8, bm=8, interpret=True))):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy().reshape(-1),
                                          np.asarray(w).reshape(-1))
