"""The split-K plans of the int8 tensor-core kernels (kernels/splitk.py),
on the CPU: q8_matmul, the dX and int8-forward entries of
fused_qlhs_matmul, dW (fused_qboth_tn_matmul), and the packed-weight
GEMMs (fused_qlhs_packed_matmul, packed_matmul) at every width.

The plan is what the CUDA kernels run: its K slices must tile [0, K)
exactly, and the exact int32 sums the kernels reduce across a cluster must
equal the one-shot sums.  The plain versions evaluated slice by slice over
the plan and summed in int64 are held to the one-shot plain versions bit
for bit; at a small shape whose plan crosses a slice boundary the plain
versions are held to the JAX package's kernels (Pallas in interpret mode,
and the XLA twin of the fused kernel) to float32 round-off of the
epilogue: rtol 2e-6 plus an atol of 2e-5 times the output's scale, as in
tests/test_torch_train_kernels.py.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import backend as jbackend  # noqa: E402
from repro.kernels.fused_fqt import (  # noqa: E402
    fused_qboth_tn_matmul as pallas_qboth, fused_qboth_tn_matmul_xla,
    fused_qlhs_matmul as pallas_qlhs, fused_qlhs_matmul_xla)
from repro.kernels.q8_matmul import q8_matmul as pallas_q8  # noqa: E402
from repro_torch.core import backend as tbackend  # noqa: E402
from repro_torch.kernels import (fused_qboth_tn_matmul_plain,  # noqa: E402
                                 fused_qlhs_matmul_plain,
                                 fused_qlhs_packed_matmul_plain, pack_codes,
                                 packed_matmul_plain, q8_matmul_plain,
                                 splitk)
from repro_torch.kernels.fused_fqt import (qboth_codes,  # noqa: E402
                                           qboth_epilogue, qlhs_codes,
                                           qlhs_epilogue)
from repro_torch.kernels.pack import unpack_tile  # noqa: E402
from repro_torch.kernels.q8_matmul import q8_epilogue  # noqa: E402

TILES = [splitk.Q8_TILE, splitk.DX_TILE, splitk.DW_TILE,
         splitk.FWD_DECODE_TILE, splitk.FWD_DECODE_SR_TILE,
         splitk.FWD_WIDE_TILE, splitk.FWD_WIDE_SR_TILE,
         *splitk.PACKED_TILES.values()]
# (M, K, N): statquant-tx's training GEMMs (512 tokens; dX and BHQ dX
# (tokens, d_out, d_in), the unfused forward and dW), granite-3-2b's dX
# with 2048 tokens, a K off the 16-code grid, and ragged
SHAPES = [(512, 512, 512), (512, 1024, 512), (512, 512, 1024),
          (512, 10240, 512), (512, 512, 10240), (2048, 2048, 2048),
          (2048, 512, 2048), (2048, 8192, 2048), (2048, 2048, 8192),
          (2048, 49408, 2048), (256, 1030, 200), (33, 67, 130),
          (37, 130, 67), (1, 64, 49), (3, 5, 3), (1, 1, 1)]
# (M, K, N) of granite-3-2b's decode GEMMs at 8 slots (the forward's
# decode tile)
DECODE = [(8, 2048, 2048), (8, 2048, 512), (8, 2048, 8192), (8, 8192, 2048),
          (8, 2048, 49408)]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("mkn", SHAPES + DECODE)
@pytest.mark.parametrize("tile", TILES, ids=lambda t: t.name)
def test_plan_slices_tile_k_exactly(tile, mkn):
    """Disjoint, consecutive, non-empty, covering [0, K); every slice but
    the last a multiple of the K step; one cluster (at most 8 blocks) a
    tile; the grid is tiles x splits."""
    M, K, N = mkn
    p = splitk.plan(tile, M, N, K)
    assert p is splitk.plan(tile, M, N, K)          # cached per shape
    assert 1 <= p.splits <= 8 and p.k_span % tile.bk == 0
    sl = p.slices
    assert len(sl) == p.splits
    assert sl[0][0] == 0 and sl[-1][1] == K
    for (a0, a1), (b0, _) in zip(sl, sl[1:]):
        assert a1 == b0 and (a1 - a0) % tile.bk == 0
    assert all(k1 > k0 for k0, k1 in sl) or K == 0
    assert p.m_tiles == -(-M // tile.bm) and p.n_tiles == -(-N // tile.bn)
    assert p.blocks == p.tiles * p.splits


def test_lm_head_grid_fills_the_card():
    """At lm_head (512, 10240, 512) the K sweep no longer runs in series
    in a few dozen blocks: q8_matmul's grid reaches 132 blocks; the dX
    kernel (one block of 170 KB an SM, clusters within one GPC) fills at
    least 90% of what the H100 holds at once in clusters of its size, in
    one wave (132 blocks would take two).  Both cut the 160-step sweep
    at least six ways."""
    q8 = splitk.plan(splitk.Q8_TILE, 512, 512, 10240)
    assert q8.blocks >= splitk.SMS
    dx = splitk.plan(splitk.DX_TILE, 512, 512, 10240)
    slots = splitk.DX_TILE.capacity[dx.splits - 1]
    assert 0.9 * slots <= dx.blocks <= slots
    for p in (q8, dx):
        assert p.splits >= 6 and p.k_span <= 10240 // 6 + p.tile.bk


def test_forward_tile_follows_m():
    """The int8 forward takes the decode tile up to 16 rows (a serving
    step's slots) and the wide tile above, each planned with the capacity
    of its rounding: with SR bits in its ring the decode tile fits one
    block an SM, not two."""
    for sr, decode, wide in (
            (False, splitk.FWD_DECODE_TILE, splitk.FWD_WIDE_TILE),
            (True, splitk.FWD_DECODE_SR_TILE, splitk.FWD_WIDE_SR_TILE)):
        assert splitk.fwd_tile(1, sr) is decode
        assert splitk.fwd_tile(16, sr) is decode
        assert splitk.fwd_tile(17, sr) is wide
        assert splitk.fwd_tile(2048, sr) is wide
        assert (decode.mode, wide.mode) == (sr, 2 + sr)
        assert decode.bm == 16 and wide.bm == 64


@pytest.mark.parametrize("mkn", DECODE)
def test_decode_grids_fill_the_card(mkn):
    """The forward's decode tile at granite's decode GEMMs (8 slots): the
    MLP up-projection and lm_head put a block on each of the 132 SMs (the
    old grid ran 128 blocks at (8, 2048, 8192), one K step at a time); the
    narrower outputs, 8 or 2 tiles of 256 columns, take 8 slices, the
    largest portable cluster."""
    M, K, N = mkn
    p = splitk.plan(splitk.fwd_tile(M, False), M, N, K)
    assert p.tile is splitk.FWD_DECODE_TILE
    if N >= 8192:
        assert p.blocks >= splitk.SMS
    else:
        assert p.splits == 8


def test_dw_lm_head_grid_fills_the_card():
    """dW at lm_head (K 512 tokens, M 512, N 10240): 160 tiles of 256 x
    128 would leave a second wave of 28 blocks; the plan cuts K in two,
    320 blocks.  At the 512-wide shapes, a few tiles, the 16-step sweep is
    cut at least four ways."""
    p = splitk.plan(splitk.DW_TILE, 512, 10240, 512)
    assert p.tiles == 160 and p.splits == 2 and p.blocks >= splitk.SMS
    for mn in ((512, 512), (1024, 512), (512, 1024)):
        q = splitk.plan(splitk.DW_TILE, *mn, 512)
        assert q.splits >= 4 and q.slices[-1][1] == 512


# (tile, (M, K, N), splits): the split each plan takes where the card's
# split sweeps timed every split (PERF.md), the fastest or within 1.5 us
SWEPT = [(splitk.Q8_TILE, (512, 10240, 512), 8),
         (splitk.Q8_TILE, (512, 512, 512), 4),
         (splitk.DX_TILE, (512, 10240, 512), 6),
         (splitk.DW_TILE, (512, 512, 10240), 2),
         (splitk.FWD_DECODE_TILE, (8, 2048, 8192), 6),
         (splitk.Q8_TILE, (128, 2048, 8192), 2)]


@pytest.mark.parametrize("tile,mkn,splits", SWEPT,
                         ids=lambda v: getattr(v, "name", None))
def test_one_reduction_model_takes_the_swept_split(tile, mkn, splits):
    """Every tile prices its cluster reduction at half a K step a slice;
    at the shapes the card swept, the plan takes the split the sweep
    found fastest (or within 1.5 us of it)."""
    M, K, N = mkn
    assert splitk.plan(tile, M, N, K).splits == splits


def test_a_partial_last_wave_is_charged_its_share():
    """The first wave costs a whole wave however few its blocks; a
    partial last wave after it, the blocks it puts on the busiest SM over
    those a full wave puts there (blocks that read little a step)."""
    def w(blocks, slots):
        return splitk._waves(blocks, slots, 1.0)
    assert w(193, 264) == w(32, 396) == w(264, 264) == 1.0
    # two blocks an SM (the decode tile): a last wave of 122 blocks, one
    # on each of 122 SMs, is half a wave
    assert w(386, 264) == 1.5
    assert w(528, 264) == 2.0
    # three an SM (q8_matmul): a whole wave of three an SM takes 1.5
    # waves' time (PACE_BLOCKS), a last one of 232 blocks, two on the
    # busiest SM, one
    assert w(1024, 396) == 2 * 1.5 + 1.0
    assert w(256, 396) == w(132, 396) == 1.0
    # one an SM (dX, dW): any tail is a whole wave
    assert w(128, 120) == w(240, 120) == 2.0
    assert w(160, 132) == 2.0


def test_a_wave_that_reads_more_than_a_step_of_memory_stretches():
    """A wave whose blocks together read more than ``STEP_BYTES`` a K
    step takes proportionally longer; the partial wave's share is its
    floor."""
    step = splitk.STEP_BYTES
    assert splitk._waves(264, 264, step / 264) == 1.0
    assert splitk._waves(264, 264, 2 * step / 264) == 2.0
    # a whole wave at twice the bytes, then 122 blocks at 122 / 264 of
    # them: above the share of half a wave
    assert splitk._waves(386, 264, 2 * step / 264) == 2.0 + 2 * 122 / 264


@pytest.mark.parametrize("lib", splitk.PACKED_LIBS)
def test_partial_wave_takes_two_slices_at_decode_lm_head(lib):
    """At decode lm_head (8, 2048, 49408) w4 the card's split sweep had
    two slices faster than one: the packed forward 45.3 against 49.7 us,
    packed_matmul 42.3 against 44.6 (NVIDIA H100 80GB HBM3, 700 W).  One
    slice is one wave of 193 blocks; two are a whole wave of 264 and a
    last one of 122, one block an SM, charged half a wave: 1.5 waves of 16
    steps and a reduction against one of 32.  At 4 bits the 264 blocks
    read 2.2 MB a step, under ``STEP_BYTES``."""
    p = splitk.plan(splitk.packed_tile(lib, 8, 4), 8, 49408, 2048)
    assert (p.tiles, p.splits, p.blocks) == (193, 2, 386)


@pytest.mark.parametrize("tile", [splitk.FWD_DECODE_TILE] + [
    splitk.packed_tile(lib, 8, 8) for lib in splitk.PACKED_LIBS],
    ids=lambda t: t.name)
def test_eight_bit_decode_lm_head_takes_one_slice(tile):
    """At 8 bits two slices at decode lm_head were slower than one on the
    card: the int8 forward 65.1 against 55.3 us, the packed forward 64.7
    against 55.8, packed_matmul 63.2 against 55.5 (NVIDIA H100 80GB HBM3,
    700 W).  Their first wave of 264 blocks reads 4.3 MB a K step, more
    than ``STEP_BYTES``: it waits on memory, and one slice of 193 blocks
    (3.2 MB a step) wins."""
    p = splitk.plan(tile, 8, 49408, 2048)
    assert (p.tiles, p.splits, p.blocks) == (193, 1, 193)


@pytest.mark.parametrize("mkn", [(512, 10240, 512), (256, 1030, 200),
                                 (33, 67, 130), (37, 130, 67)])
def test_q8_plain_summed_over_the_plan_equals_one_shot(mkn):
    """The int8 products summed slice by slice in int64 over q8_matmul's
    plan, through the epilogue, equal the one-shot plain version."""
    M, K, N = mkn
    rng = np.random.RandomState(M + K + N)
    x8 = _t(rng.randint(-128, 128, (M, K)).astype(np.int8))
    y8 = _t(rng.randint(-128, 128, (K, N)).astype(np.int8))
    vec = [_t(rng.randn(n).astype(np.float32)) for n in (M, N, M, N, M, N)]
    p = splitk.plan(splitk.Q8_TILE, M, N, K)
    assert p.splits > 1
    acc = sum(x8[:, k0:k1].long() @ y8[k0:k1].long() for k0, k1 in p.slices)
    want = q8_matmul_plain(x8, y8, *vec)
    assert torch.equal(q8_epilogue(acc, *vec), want)


@pytest.mark.parametrize("mkn", [(512, 10240, 512), (256, 1030, 200),
                                 (33, 67, 130)])
@pytest.mark.parametrize("bits", [4, 8])
def test_dx_plain_summed_over_the_plan_equals_one_shot(mkn, bits):
    """dX (trans_b, SR): the codes' products and row sums summed slice by
    slice in int64 over the dX kernel's plan, through the epilogue, equal
    the one-shot plain version."""
    M, K, N = mkn
    rng = np.random.RandomState(M * 3 + K + bits)
    g = _t((rng.randn(M, K) * 1e-3).astype(np.float32))
    zero = g.amin(dim=1, keepdim=True)
    scale = float((1 << bits) - 1) / torch.clamp_min(
        g.amax(dim=1, keepdim=True) - zero, 1e-12)
    rb = _t(rng.randint(0, 2 ** 32, (M, K), dtype=np.uint64).astype(np.int64))
    w8 = _t(rng.randint(-128, 128, (N, K)).astype(np.int8))
    u = _t(rng.randn(N).astype(np.float32))
    ab, bb = torch.tensor(0.013), torch.tensor(-0.7)
    p = splitk.plan(splitk.DX_TILE, M, N, K)
    assert p.splits > 1
    c = qlhs_codes(g, scale, zero, rb, bits=bits).long()
    acc = sum(c[:, k0:k1] @ w8[:, k0:k1].long().T for k0, k1 in p.slices)
    rsum = sum(c[:, k0:k1].sum(dim=1) for k0, k1 in p.slices)
    got = qlhs_epilogue(acc, rsum, scale, zero, ab, bb, u, bits=bits)
    want = fused_qlhs_matmul_plain(g, scale, zero, rb, w8, ab, bb, u,
                                   bits=bits, trans_b=True)
    assert torch.equal(got, want)


def _close(got, want):
    atol = 2e-5 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=atol)


def test_plain_versions_match_the_jax_kernels_across_a_slice_boundary():
    """At (40, 200, 72) both plans cut K (four slices of 64 codes for
    q8_matmul, four of 64 for dX): q8_matmul_plain against the Pallas
    q8_matmul in interpret mode, and fused_qlhs_matmul_plain (trans_b, SR)
    against the Pallas fused_qlhs_matmul in interpret mode and its XLA
    twin, on the same numpy inputs and SR bits."""
    M, K, N = 40, 200, 72
    for tile in (splitk.Q8_TILE, splitk.DX_TILE):
        p = splitk.plan(tile, M, N, K)
        assert p.splits > 1 and p.slices[0][1] < K
    rng = np.random.RandomState(7)
    a8 = rng.randint(-16, 16, (M, K)).astype(np.int8)
    b8 = rng.randint(-128, 128, (K, N)).astype(np.int8)
    alpha_a = (rng.rand(M) * 0.1 + 0.01).astype(np.float32)
    beta_a = rng.randn(M).astype(np.float32)
    coeffs = jbackend.epilogue_coeffs(jnp.asarray(a8), alpha_a, beta_a,
                                      jnp.asarray(b8), np.float32(0.02),
                                      np.float32(-1.3))
    want = np.asarray(pallas_q8(jnp.asarray(a8), jnp.asarray(b8), *coeffs,
                                interpret=True))
    got = q8_matmul_plain(_t(a8), _t(b8), *[_t(np.asarray(c))
                                             for c in coeffs]).numpy()
    _close(got, want)

    g = (rng.randn(M, K) * 1e-3).astype(np.float32)
    zero = g.min(axis=1, keepdims=True)
    scale = (255.0 / np.maximum(g.max(axis=1, keepdims=True) - zero, 1e-12)
             ).astype(np.float32)
    w8 = rng.randint(-128, 128, (N, K)).astype(np.int8)
    ab, bb = np.float32(0.013), np.float32(-0.7)
    u = (ab * w8.astype(np.int64).sum(axis=1).astype(np.float32)
         + np.float32(K) * bb).astype(np.float32)
    rb = rng.randint(0, 2 ** 32, (M, K), dtype=np.uint64).astype(np.uint32)
    j = [jnp.asarray(a) for a in (g, scale, zero, rb, w8)]
    want_pl = np.asarray(pallas_qlhs(*j, ab, bb, jnp.asarray(u), bits=8,
                                     trans_b=True, interpret=True))
    want_xla = np.asarray(fused_qlhs_matmul_xla(*j, ab, bb, jnp.asarray(u),
                                                bits=8, trans_b=True))
    got = fused_qlhs_matmul_plain(
        _t(g), _t(scale), _t(zero), _t(rb.astype(np.int64)), _t(w8),
        torch.tensor(ab), torch.tensor(bb), _t(u), bits=8,
        trans_b=True).numpy()
    _close(got, want_pl)
    _close(got, want_xla)


def _dw_inputs(rng, K, M, N, bits_b):
    x = rng.randn(K, M).astype(np.float32)
    g = (rng.randn(K, N) * 1e-2).astype(np.float32)
    zx = np.float32(x.min())
    sx = np.float32(255.0 / (x.max() - x.min()))
    rb = rng.randint(0, 2 ** 32, (K, N), dtype=np.uint64).astype(np.uint32)
    ops = tbackend.dw_operands(_t(x), torch.tensor(sx), torch.tensor(zx), 8,
                               _t(g), _t(rb.astype(np.int64)), bits_b)
    return ops, rb


@pytest.mark.parametrize("kmn", [(512, 512, 512), (512, 512, 1024),
                                 (130, 33, 67)])
@pytest.mark.parametrize("bits_b", [5, 8])
def test_dw_plain_summed_over_the_plan_equals_one_shot(kmn, bits_b):
    """dW: the code products and B's column code sums summed slice by
    slice in int64 over the dW kernel's plan, through the epilogue, equal
    the one-shot plain version."""
    K, M, N = kmn
    rng = np.random.RandomState(K + M + N + bits_b)
    ops, _ = _dw_inputs(rng, K, M, N, bits_b)
    p = splitk.plan(splitk.DW_TILE, M, N, K)
    assert p.splits > 1
    ca, cb = qboth_codes(*ops[:7], bits_a=8, bits_b=bits_b)
    ca, cb = ca.long(), cb.long()
    acc = sum(ca[k0:k1].T @ cb[k0:k1] for k0, k1 in p.slices)
    csum = sum(cb[k0:k1].sum(dim=0) for k0, k1 in p.slices)
    got = qboth_epilogue(acc, csum, K, *ops[1:3], *ops[4:6], ops[7],
                         bits_a=8, bits_b=bits_b)
    want = fused_qboth_tn_matmul_plain(*ops, bits_a=8, bits_b=bits_b)
    assert torch.equal(got, want)


@pytest.mark.parametrize("mkn", [(8, 2048, 8192), (8, 1030, 200)])
@pytest.mark.parametrize("sr", [False, True])
def test_forward_plain_summed_over_the_plan_equals_one_shot(mkn, sr):
    """The int8 forward at M = 8 (the decode tile): the codes' products and
    row sums summed slice by slice in int64 over the plan, through the
    epilogue, equal the one-shot plain version, deterministic and SR."""
    M, K, N = mkn
    rng = np.random.RandomState(M + K + N + sr)
    x = _t(rng.randn(M, K).astype(np.float32))
    zero = torch.full((M, 1), float(x.min()))
    scale = torch.full((M, 1), 255.0) / (x.max() - x.min())
    rb = (_t(rng.randint(0, 2 ** 32, (M, K), dtype=np.uint64)
             .astype(np.int64)) if sr else None)
    w8 = _t(rng.randint(-128, 128, (K, N)).astype(np.int8))
    u = _t(rng.randn(N).astype(np.float32))
    ab, bb = torch.tensor(0.013), torch.tensor(-0.7)
    p = splitk.plan(splitk.fwd_tile(M, sr), M, N, K)
    assert p.splits > 1
    c = qlhs_codes(x, scale, zero, rb, bits=8).long()
    acc = sum(c[:, k0:k1] @ w8[k0:k1].long() for k0, k1 in p.slices)
    rsum = sum(c[:, k0:k1].sum(dim=1) for k0, k1 in p.slices)
    got = qlhs_epilogue(acc, rsum, scale, zero, ab, bb, u, bits=8)
    want = fused_qlhs_matmul_plain(x, scale, zero, rb, w8, ab, bb, u, bits=8)
    assert torch.equal(got, want)


@pytest.mark.parametrize("bits_b", [5, 8])
def test_dw_plain_matches_the_jax_kernels_across_slice_boundaries(bits_b):
    """At (K, M, N) = (200, 40, 72) the dW plan cuts K into seven slices
    of 32 rows: fused_qboth_tn_matmul_plain against the Pallas kernel in
    interpret mode and its XLA twin, on the same numpy inputs and SR
    bits."""
    K, M, N = 200, 40, 72
    p = splitk.plan(splitk.DW_TILE, M, N, K)
    assert p.splits > 1 and p.slices[0][1] < K
    rng = np.random.RandomState(11 + bits_b)
    ops, rb = _dw_inputs(rng, K, M, N, bits_b)
    j = [jnp.asarray(o.numpy()) for o in ops]
    j[6] = jnp.asarray(rb)                        # uint32 for JAX
    got = fused_qboth_tn_matmul_plain(*ops, bits_a=8, bits_b=bits_b).numpy()
    _close(got, np.asarray(pallas_qboth(*j, bits_a=8, bits_b=bits_b,
                                        interpret=True)))
    _close(got, np.asarray(fused_qboth_tn_matmul_xla(*j, bits_a=8,
                                                     bits_b=bits_b)))


@pytest.mark.parametrize("sr", [False, True])
def test_forward_plain_matches_the_jax_kernels_across_slice_boundaries(sr):
    """At (M, K, N) = (8, 300, 72) the decode tile's plan cuts K into
    five slices of 64 codes: the forward's plain version (per-row scale,
    deterministic or SR) against the Pallas kernel in interpret mode and
    its XLA twin."""
    M, K, N = 8, 300, 72
    p = splitk.plan(splitk.fwd_tile(M, sr), M, N, K)
    assert p.splits == 5 and p.slices[0][1] < K
    rng = np.random.RandomState(13 + sr)
    x = rng.randn(M, K).astype(np.float32)
    zero = x.min(axis=1, keepdims=True)
    scale = (255.0 / (x.max(axis=1, keepdims=True) - zero)).astype(np.float32)
    w8 = rng.randint(-128, 128, (K, N)).astype(np.int8)
    ab, bb = np.float32(0.013), np.float32(-0.7)
    u = (ab * w8.astype(np.int64).sum(axis=0).astype(np.float32)
         + np.float32(K) * bb).astype(np.float32)
    rb = (rng.randint(0, 2 ** 32, (M, K), dtype=np.uint64).astype(np.uint32)
          if sr else None)
    j = [jnp.asarray(x), jnp.asarray(scale), jnp.asarray(zero),
         None if rb is None else jnp.asarray(rb), jnp.asarray(w8)]
    got = fused_qlhs_matmul_plain(
        _t(x), _t(scale), _t(zero),
        None if rb is None else _t(rb.astype(np.int64)), _t(w8),
        torch.tensor(ab), torch.tensor(bb), _t(u), bits=8).numpy()
    _close(got, np.asarray(pallas_qlhs(*j, ab, bb, jnp.asarray(u), bits=8,
                                       interpret=True)))
    _close(got, np.asarray(fused_qlhs_matmul_xla(*j, ab, bb, jnp.asarray(u),
                                                 bits=8)))


def test_packed_tiles_follow_m_and_width():
    """Each packed GEMM takes the decode tile up to 16 rows and the wide
    tile above, one tile per width; its mode (the C entries' first
    argument) names both, 4 * tile + log2(wbits), and its K step, 64
    codes, holds whole bytes at every width."""
    for lib in splitk.PACKED_LIBS:
        for w in (1, 2, 4, 8):
            dec, wide = (splitk.packed_tile(lib, M, w) for M in (16, 17))
            assert splitk.packed_tile(lib, 1, w) is dec
            assert splitk.packed_tile(lib, 2048, w) is wide
            assert (dec.bm, wide.bm) == (16, 64) and dec.lib == lib
            assert (dec.mode, wide.mode) == ((w.bit_length() - 1),
                                             4 + (w.bit_length() - 1))
            assert dec.bk == wide.bk == 64


@pytest.mark.parametrize("mkn", [(8, 1001, 300), (40, 1001, 300),
                                 (8, 2048, 8192), (512, 512, 10240)])
@pytest.mark.parametrize("lib", splitk.PACKED_LIBS)
def test_packed_plans_cut_k_on_whole_bytes(lib, mkn):
    """At every width the packed tiles' slices start on a multiple of the
    tile's K step and of 8 codes: no packed byte straddles two slices."""
    M, K, N = mkn
    for w in (1, 2, 4, 8):
        p = splitk.plan(splitk.packed_tile(lib, M, w), M, N, K)
        for k0, _ in p.slices:
            assert k0 % p.tile.bk == 0 and k0 % 8 == 0 and k0 % (8 // w) == 0


@pytest.mark.parametrize("mkn", DECODE)
@pytest.mark.parametrize("lib", splitk.PACKED_LIBS)
def test_packed_decode_grids_fill_the_card(lib, mkn):
    """The packed GEMMs' decode tile at granite's decode GEMMs (8 slots),
    at the serving widths (8 and 4 bits): the MLP up-projection and
    lm_head put at least a block on each of the 132 SMs; the narrower
    outputs, 8 or 2 tiles of 256 columns, take 8 slices, the largest
    portable cluster."""
    M, K, N = mkn
    for w in (8, 4):
        p = splitk.plan(splitk.packed_tile(lib, M, w), M, N, K)
        if N >= 8192:
            assert p.blocks >= splitk.SMS
        else:
            assert p.splits == 8


def _packed_case(rng, M, K, N, wbits):
    codes = _t(rng.randint(0, 1 << wbits, (K, N)).astype(np.uint8))
    packed = pack_codes(codes, wbits)
    w8 = unpack_tile(packed, wbits)[:K].long() - (1 << (wbits - 1))
    return packed, w8


@pytest.mark.parametrize("M", [8, 40])
@pytest.mark.parametrize("wbits", [1, 2, 4, 8])
def test_packed_plain_summed_over_the_plan_equals_one_shot(wbits, M):
    """K = 1001, ragged at every ppb: both packed GEMMs' code products
    (and the packed forward's row code sums) summed slice by slice in
    int64 over their plans, through the epilogues, equal the one-shot
    plain versions, decode and wide tile."""
    K, N = 1001, 300
    rng = np.random.RandomState(M + wbits)
    packed, w8 = _packed_case(rng, M, K, N, wbits)
    x = _t(rng.randn(M, K).astype(np.float32))
    zero = torch.full((M, 1), float(x.min()))
    scale = torch.full((M, 1), 255.0) / (x.max() - x.min())
    u = _t(rng.randn(N).astype(np.float32))
    ab, bb = torch.tensor(0.013), torch.tensor(-0.7)
    p = splitk.plan(splitk.packed_tile("fused_qlhs_packed", M, wbits), M, N,
                    K)
    assert p.splits > 1
    c = qlhs_codes(x, scale, zero, None, bits=8).long()
    acc = sum(c[:, k0:k1] @ w8[k0:k1] for k0, k1 in p.slices)
    rsum = sum(c[:, k0:k1].sum(dim=1) for k0, k1 in p.slices)
    got = qlhs_epilogue(acc, rsum, scale, zero, ab, bb, u, bits=8)
    want = fused_qlhs_packed_matmul_plain(x, scale, zero, packed, ab, bb, u,
                                          bits=8, wbits=wbits)
    assert torch.equal(got, want)

    x8 = _t(rng.randint(-128, 128, (M, K)).astype(np.int8))
    vec = [_t(rng.randn(n).astype(np.float32)) for n in (M, N, M, N, M, N)]
    p = splitk.plan(splitk.packed_tile("packed_matmul", M, wbits), M, N, K)
    assert p.splits > 1
    acc = sum(x8[:, k0:k1].long() @ w8[k0:k1] for k0, k1 in p.slices)
    assert torch.equal(q8_epilogue(acc, *vec),
                       packed_matmul_plain(x8, packed, *vec, wbits=wbits,
                                           kdim=K))
