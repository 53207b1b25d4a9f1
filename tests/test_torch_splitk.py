"""The split-K plans of the int8 tensor-core kernels (kernels/splitk.py),
on the CPU.

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
    fused_qlhs_matmul as pallas_qlhs, fused_qlhs_matmul_xla)
from repro.kernels.q8_matmul import q8_matmul as pallas_q8  # noqa: E402
from repro_torch.kernels import (fused_qlhs_matmul_plain,  # noqa: E402
                                 q8_matmul_plain, splitk)
from repro_torch.kernels.fused_fqt import (qlhs_codes,  # noqa: E402
                                           qlhs_epilogue)
from repro_torch.kernels.q8_matmul import q8_epilogue  # noqa: E402

TILES = [splitk.Q8_TILE, splitk.DX_TILE]
# (M, K, N): statquant-tx's training GEMMs (512 tokens; dX and BHQ dX
# (tokens, d_out, d_in), the unfused forward and dW), granite-3-2b's dX
# with 2048 tokens, a K off the 16-code grid, and ragged
SHAPES = [(512, 512, 512), (512, 1024, 512), (512, 512, 1024),
          (512, 10240, 512), (512, 512, 10240), (2048, 2048, 2048),
          (2048, 512, 2048), (2048, 8192, 2048), (2048, 2048, 8192),
          (2048, 49408, 2048), (256, 1030, 200), (33, 67, 130),
          (37, 130, 67), (1, 64, 49), (3, 5, 3), (1, 1, 1)]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("mkn", SHAPES)
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
    for tile in TILES:
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
