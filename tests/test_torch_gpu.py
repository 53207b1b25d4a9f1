"""The port's CUDA kernels on the card, each against its plain PyTorch
version on the same inputs, bit for bit: ``fused_qlhs_matmul`` (the int8
forward, deterministic and SR, and its dX mode), ``fused_qboth_tn_matmul``,
``q8_matmul``, ``kv_dequant_rows`` and ``kv_gather_pages`` (each also as
the K-and-V pair in one launch, every body), ``quantize_sr_rows``/``_tensor``,
``fused_qlhs_packed_matmul`` and ``packed_matmul`` bit for bit (page-0
tables, zero scales, SR bits across all 32 bits, 1/2/4/8-bit packed
weights with ragged K, odd N, unaligned rows, full-range codes and every
split of K), short serving runs (dense, paged and from packed
weights) that must go through the serving kernels, and short training runs
(fused and unfused) that must go through the training kernels.

Run on a machine with an H100 and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_*.py

Elsewhere every test here skips (decided in the fixture, not at import).
"""

import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) with the CUDA toolkit")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _qlhs_operands(gen, M, K, N):
    from repro_torch.core import affine_factors, quantize_ptq_det
    from repro_torch.core.backend import _ptq_range
    x = torch.randn(M, K, generator=gen, device=gen.device)
    w = torch.randn(K, N, generator=gen, device=gen.device) / K ** 0.5
    wq = quantize_ptq_det(w, 8)
    ab, bb = affine_factors(wq.scale, wq.zero, 8)
    u = (ab * wq.int8_codes.to(torch.int32).sum(0).to(torch.float32)
         + float(K) * bb)
    zero, scale = _ptq_range(x, 8)
    return (x, scale.reshape(1, 1).expand(M, 1).contiguous(),
            zero.reshape(1, 1).expand(M, 1).contiguous(), None,
            wq.int8_codes, ab, bb, u)


# (M, K, N) of the int8 forward: granite-3-2b's decode GEMMs at 1, 8 and
# 16 slots (the decode tile), prefill and the training forward at 128,
# 512 and 2048 rows (the wide tile), a K off the 16-code grid, and ragged
FWD_SHAPES = [(1, 2048, 2048), (8, 2048, 512), (16, 2048, 8192),
              (8, 8192, 2048), (8, 2048, 49408), (128, 8192, 2048),
              (512, 512, 10240), (2048, 2048, 2048), (8, 1030, 200),
              (128, 1030, 200), (37, 130, 67), (37, 67, 130), (3, 5, 3)]


@pytest.mark.parametrize("mkn", FWD_SHAPES)
def test_fused_qlhs_matmul_vs_plain(cuda, mkn):
    """The int8 forward equals its plain version bit for bit,
    deterministic and with SR bits, and a second call the first."""
    from repro_torch.kernels import fused_qlhs_matmul, fused_qlhs_matmul_plain
    M, K, N = mkn
    gen = torch.Generator(device=cuda).manual_seed(sum(mkn))
    ops = _qlhs_operands(gen, *mkn)
    before = fused_qlhs_matmul.launches
    got = fused_qlhs_matmul(*ops, bits=8)
    assert fused_qlhs_matmul.launches == before + 1
    want = fused_qlhs_matmul_plain(*ops, bits=8)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(fused_qlhs_matmul(*ops, bits=8), got)
    rb = torch.randint(0, 2 ** 32, (M, K), generator=gen, device=cuda,
                       dtype=torch.int64)
    sr = ops[:3] + (rb,) + ops[4:]
    assert torch.equal(fused_qlhs_matmul(*sr, bits=8),
                       fused_qlhs_matmul_plain(*sr, bits=8))


@pytest.mark.parametrize("M", [8, 128])
def test_fused_qlhs_fwd_unaligned_rows_and_full_range_codes(cuda, M):
    """The int8 forward on LHS rows off the 16-byte grid (row views with K
    = 67 and 130), and at K = 8192 with weight codes over all of
    -128..127 (rows at the extremes) against LHS rows clipped to each end
    of the code range: the int32 accumulator's worst case, across the
    split-K reduction."""
    from repro_torch.kernels import fused_qlhs_matmul, fused_qlhs_matmul_plain
    gen = torch.Generator(device=cuda).manual_seed(M)
    for K, N in ((67, 130), (130, 72)):
        x, s, z, _, w8, ab, bb, u = _qlhs_operands(gen, M + 1, K, N)
        ops = (x[1:], s[1:].contiguous(), z[1:].contiguous(), None, w8, ab,
               bb, u)
        assert ops[0].data_ptr() % 16 != 0
        assert torch.equal(fused_qlhs_matmul(*ops, bits=8),
                           fused_qlhs_matmul_plain(*ops, bits=8))
    K, N = 8192, 512
    x, s, z, _, _, ab, bb, _ = _qlhs_operands(gen, M, K, N)
    s, z = s.clone(), z.clone()
    s[0], z[0] = 1e3, x[0].max() + 1.0        # every code clips to -128
    s[1], z[1] = 1e3, x[1].min() - 1.0        # every code clips to 127
    w8 = _extreme_codes(torch.randint(-128, 128, (N, K), generator=gen,
                                      device=cuda, dtype=torch.int8))
    w8 = w8.T.contiguous()
    u = ab * w8.to(torch.int32).sum(0).to(torch.float32) + float(K) * bb
    ops = (x, s, z, None, w8, ab, bb, u)
    assert torch.equal(fused_qlhs_matmul(*ops, bits=8),
                       fused_qlhs_matmul_plain(*ops, bits=8))


def _dx_operands(gen, M, K, N, bits):
    """fused_qlhs_matmul's dX-mode arguments as core/backend.fused_fqt_dx
    builds them under PSQ: per-row scale/zero of g (M, K), SR bits, and the
    (N, K) weight codes read transposed."""
    from repro_torch.core import affine_factors, quantize_ptq_det
    dev = gen.device
    g = torch.randn(M, K, generator=gen, device=dev) * 1e-3
    wq = quantize_ptq_det(torch.randn(N, K, generator=gen, device=dev)
                          / K ** 0.5, 8)
    w8 = wq.int8_codes
    ab, bb = affine_factors(wq.scale, wq.zero, 8)
    u = ab * w8.to(torch.int32).sum(1).to(torch.float32) + float(K) * bb
    zero = g.amin(dim=1, keepdim=True)
    scale = float((1 << bits) - 1) / torch.clamp_min(
        g.amax(dim=1, keepdim=True) - zero, 1e-12)
    rbits = torch.randint(0, 2 ** 32, (M, K), generator=gen, device=dev,
                          dtype=torch.int64)
    return (g, scale, zero, rbits, w8, ab, bb, u)


# (M, K, N) of the dX GEMMs: statquant-tx's (512 tokens), a K off the
# 16-code grid at a multi-slice split, granite-3-2b's with 2048 tokens,
# and ragged
DX_SHAPES = [(512, 512, 512), (512, 1024, 512), (512, 10240, 512),
             (256, 1030, 200), (2048, 2048, 2048), (2048, 512, 2048),
             (2048, 8192, 2048), (2048, 2048, 8192), (2048, 49408, 2048),
             (33, 67, 130), (1, 64, 49), (3, 5, 3)]


@pytest.mark.parametrize("mkn", DX_SHAPES)
@pytest.mark.parametrize("bits", [4, 8])
def test_fused_qlhs_matmul_dx_sr_vs_plain(cuda, mkn, bits):
    """The activation-grad mode (trans_b=True, SR from rbits), and SR with
    the forward layout, equal their plain versions bit for bit."""
    from repro_torch.kernels import fused_qlhs_matmul, fused_qlhs_matmul_plain
    gen = torch.Generator(device=cuda).manual_seed(sum(mkn) + bits)
    ops = _dx_operands(gen, *mkn, bits)
    before = fused_qlhs_matmul.launches_dx
    got = fused_qlhs_matmul(*ops, bits=bits, trans_b=True)
    assert fused_qlhs_matmul.launches_dx == before + 1
    want = fused_qlhs_matmul_plain(*ops, bits=bits, trans_b=True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    g, s, z, rb, w8, ab, bb, u = ops
    det = (g, s, z, None, w8, ab, bb, u)
    assert torch.equal(fused_qlhs_matmul(*det, bits=bits, trans_b=True),
                       fused_qlhs_matmul_plain(*det, bits=bits, trans_b=True))
    if mkn[0] * mkn[1] * mkn[2] > 2 ** 32:
        return                 # SR in the forward layout: the smaller shapes
    fwd = (g, s, z, rb, w8.T.contiguous(), ab, bb, u)
    assert torch.equal(fused_qlhs_matmul(*fwd, bits=bits),
                       fused_qlhs_matmul_plain(*fwd, bits=bits))
    with pytest.raises(ValueError, match="contiguous"):
        fused_qlhs_matmul(g, s, z, rb, w8.T, ab, bb, u, bits=bits)


def _extreme_codes(codes):
    """Rows and columns pinned at -128 and 127 (the int32 sum's extremes
    at the largest K) beside the random full-range codes."""
    codes[0], codes[1], codes[2] = -128, 127, -128
    return codes


@pytest.mark.parametrize("k_major", [True, False])
def test_q8_matmul_full_range_codes_at_lm_head_depth(cuda, k_major):
    """Codes over all of -128..127 on both sides at K = 10,240, with rows
    and columns at the extremes: the int32 accumulator's worst case
    (|sum| = 128 * 128 * 10240 < 2^31), across the split-K reduction."""
    from repro_torch.kernels import q8_matmul, q8_matmul_plain
    M, K, N = 512, 10240, 512
    gen = torch.Generator(device=cuda).manual_seed(11)
    x8 = _extreme_codes(torch.randint(-128, 128, (M, K), generator=gen,
                                      device=cuda, dtype=torch.int8))
    y8 = _extreme_codes(torch.randint(-128, 128, (N, K), generator=gen,
                                      device=cuda, dtype=torch.int8))
    y8 = y8.T if k_major else y8.T.contiguous()
    vec = [torch.randn(n, generator=gen, device=cuda)
           for n in (M, N, M, N, M, N)]
    got = q8_matmul(x8, y8, *vec)
    assert torch.equal(got, q8_matmul_plain(x8, y8, *vec))


@pytest.mark.parametrize("bits", [8, 4])
def test_fused_qlhs_dx_full_range_codes_at_lm_head_depth(cuda, bits):
    """dX with the LHS spanning every code of ``bits`` (rows clipped to
    each end of the range) against weight codes over all of -128..127 with
    rows at the extremes, at K = 10,240."""
    from repro_torch.kernels import fused_qlhs_matmul, fused_qlhs_matmul_plain
    M, K, N = 512, 10240, 512
    gen = torch.Generator(device=cuda).manual_seed(12 + bits)
    g, s, z, rb, _, ab, bb, _ = _dx_operands(gen, M, K, N, bits)
    s[0], z[0] = 1e3, g[0].max() + 1.0        # every code clips to -2^(b-1)
    s[1], z[1] = 1e3, g[1].min() - 1.0        # every code clips to 2^(b-1)-1
    w8 = _extreme_codes(torch.randint(-128, 128, (N, K), generator=gen,
                                      device=cuda, dtype=torch.int8))
    u = ab * w8.to(torch.int32).sum(1).to(torch.float32) + float(K) * bb
    ops = (g, s, z, rb, w8, ab, bb, u)
    got = fused_qlhs_matmul(*ops, bits=bits, trans_b=True)
    assert torch.equal(got, fused_qlhs_matmul_plain(*ops, bits=bits,
                                                    trans_b=True))


@pytest.mark.parametrize("mkn", [(512, 10240, 512), (256, 1030, 200),
                                 (33, 67, 130)])
def test_split_k_calls_repeat_bit_for_bit(cuda, mkn):
    """Two calls on the same inputs give the same bits: the split-K
    slices may land in any order, but their int32 sum and the one
    epilogue after it do not depend on it."""
    from repro_torch.kernels import fused_qlhs_matmul, q8_matmul, splitk
    M, K, N = mkn
    assert splitk.plan(splitk.Q8_TILE, M, N, K).splits > 1
    assert splitk.plan(splitk.DX_TILE, M, N, K).splits > 1
    gen = torch.Generator(device=cuda).manual_seed(sum(mkn))
    ops = _dx_operands(gen, M, K, N, 8)
    first = fused_qlhs_matmul(*ops, bits=8, trans_b=True)
    assert torch.equal(first, fused_qlhs_matmul(*ops, bits=8, trans_b=True))
    x8 = torch.randint(-128, 128, (M, K), generator=gen, device=cuda,
                       dtype=torch.int8)
    y8 = torch.randint(-128, 128, (N, K), generator=gen, device=cuda,
                       dtype=torch.int8).T
    vec = [torch.randn(n, generator=gen, device=cuda)
           for n in (M, N, M, N, M, N)]
    first = q8_matmul(x8, y8, *vec)
    assert torch.equal(first, q8_matmul(x8, y8, *vec))


def _forced_splits(tile, M, N, K):
    """Every split of K the kernels take at (M, N, K): (slices, k_span)."""
    steps = -(-K // tile.bk)
    for s in range(1, 9):
        per = -(-steps // s)
        if -(-steps // per) == s:
            yield s, per * tile.bk


def test_every_forced_split_is_bit_identical(cuda):
    """dW at lm_head (K 512, M 512, N 10240) and the int8 forward at the
    decode MLP up-projection (8, 2048, 8192), deterministic and SR,
    through their C entries with every split of K forced: each equals the
    planned call bit for bit."""
    from repro_torch.kernels import (fused_qboth_tn_matmul,
                                     fused_qlhs_matmul, splitk)
    from repro_torch.kernels.build import load_function
    from repro_torch.kernels.fused_fqt import (_QBOTH_ARGTYPES,
                                               _QLHS_FWD_ARGTYPES)
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=cuda).manual_seed(3)
    K, M, N = 512, 512, 10240
    dw = _qboth_operands(gen, K, M, N, 8, 8)
    ref = fused_qboth_tn_matmul(*dw, bits_a=8, bits_b=8)
    fn = load_function("fused_qboth_tn", "fused_qboth_tn", _QBOTH_ARGTYPES)
    for s, span in _forced_splits(splitk.DW_TILE, M, N, K):
        out = torch.empty_like(ref)
        assert fn(*[t.data_ptr() for t in dw], out.data_ptr(), M, N, K, 8,
                  8, s, span, stream) == 0
        assert torch.equal(out, ref), s
    M, K, N = 8, 2048, 8192
    fn = load_function("fused_qlhs_fwd", "fused_qlhs_fwd", _QLHS_FWD_ARGTYPES)
    for sr in (False, True):
        fwd = list(_qlhs_operands(gen, M, K, N))
        if sr:
            fwd[3] = torch.randint(0, 2 ** 32, (M, K), generator=gen,
                                   device=cuda, dtype=torch.int64)
        ref = fused_qlhs_matmul(*fwd, bits=8)
        tile = splitk.fwd_tile(M, sr)
        for s, span in _forced_splits(tile, M, N, K):
            out = torch.empty_like(ref)
            assert fn(*[0 if t is None else t.data_ptr() for t in fwd],
                      out.data_ptr(), M, N, K, 8, tile.mode, s, span,
                      stream) == 0
            assert torch.equal(out, ref), (tile.name, s)
        # a mode whose SR bit disagrees with the bits given is refused
        assert fn(*[0 if t is None else t.data_ptr() for t in fwd],
                  out.data_ptr(), M, N, K, 8, tile.mode ^ 1, 1, K,
                  stream) != 0


def test_split_plan_tiles_match_the_built_kernels(cuda):
    """kernels/splitk.py's tiles are the ones the CUDA sources build, and
    the card reports a capacity for each."""
    import ctypes
    from repro_torch.kernels import splitk
    from repro_torch.kernels.build import load_library
    tiles = (splitk.Q8_TILE, splitk.DX_TILE, splitk.DW_TILE,
             splitk.FWD_DECODE_TILE, splitk.FWD_DECODE_SR_TILE,
             splitk.FWD_WIDE_TILE, splitk.FWD_WIDE_SR_TILE,
             *splitk.PACKED_TILES.values())
    for tile in tiles:
        cfg = (ctypes.c_int * 8)()
        lib = load_library(tile.lib)
        if tile.lib in ("fused_qlhs_fwd",) + splitk.PACKED_LIBS:
            getattr(lib, tile.lib + "_tile")(tile.mode, cfg)
        else:
            getattr(lib, tile.lib + "_tile")(cfg)
        assert list(cfg)[:5] == [tile.bm, tile.bn, tile.bk, tile.threads,
                                 tile.nacc], tile.name
        card = splitk.on_card(tile)
        assert len(card.capacity) == 8 and min(card.capacity) > 0


def test_sr_bits_reach_the_kernel_unsaturated(cuda):
    """Bits at and above 2^31 (and 2^32 - 1) must round up as the plain
    version's integer-to-float cast says, not saturate."""
    from repro_torch.kernels import fused_qlhs_matmul, fused_qlhs_matmul_plain
    gen = torch.Generator(device=cuda).manual_seed(5)
    g, s, z, _, w8, ab, bb, u = _dx_operands(gen, 4, 8, 16, 8)
    rb = torch.tensor([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 31 + 1,
                       2 ** 32 - 129, 2 ** 32 - 128, 2 ** 32 - 1] * 4,
                      dtype=torch.int64, device=cuda).reshape(4, 8)
    ops = (g, s, z, rb, w8, ab, bb, u)
    assert torch.equal(fused_qlhs_matmul(*ops, bits=8, trans_b=True),
                       fused_qlhs_matmul_plain(*ops, bits=8, trans_b=True))


def _qboth_operands(gen, K, M, N, bits_a, bits_b):
    """fused_qboth_tn_matmul's arguments as core/backend.fused_fqt_dw
    builds them."""
    from repro_torch.core.backend import dw_operands
    dev = gen.device
    x = torch.randn(K, M, generator=gen, device=dev)
    g = torch.randn(K, N, generator=gen, device=dev) * 1e-3
    zx, hx = torch.aminmax(x)
    sx = float((1 << bits_a) - 1) / torch.clamp_min(hx - zx, 1e-12)
    rbits = torch.randint(0, 2 ** 32, (K, N), generator=gen, device=dev,
                          dtype=torch.int64)
    return dw_operands(x, sx, zx, bits_a, g, rbits, bits_b)


# (K, M, N) of the dW GEMMs: statquant-tx's (512 tokens; d_in, d_out),
# granite-3-2b's with 2048 tokens, and ragged
DW_SHAPES = [(512, 512, 512), (512, 512, 1024), (512, 1024, 512),
             (512, 512, 10240), (2048, 2048, 2048), (2048, 2048, 512),
             (2048, 2048, 8192), (2048, 8192, 2048), (2048, 2048, 49408),
             (33, 67, 130), (1, 64, 49), (37, 130, 67), (130, 33, 67),
             (64, 1, 49), (5, 3, 3)]


@pytest.mark.parametrize("kmn", DW_SHAPES)
@pytest.mark.parametrize("bits_b", [5, 8])
def test_fused_qboth_tn_matmul_vs_plain(cuda, kmn, bits_b):
    """dW bit for bit, and a second call bit-identical to the first."""
    from repro_torch.kernels import (fused_qboth_tn_matmul,
                                     fused_qboth_tn_matmul_plain)
    gen = torch.Generator(device=cuda).manual_seed(sum(kmn) + bits_b)
    ops = _qboth_operands(gen, *kmn, 8, bits_b)
    before = fused_qboth_tn_matmul.launches
    got = fused_qboth_tn_matmul(*ops, bits_a=8, bits_b=bits_b)
    assert fused_qboth_tn_matmul.launches == before + 1
    want = fused_qboth_tn_matmul_plain(*ops, bits_a=8, bits_b=bits_b)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(fused_qboth_tn_matmul(*ops, bits_a=8, bits_b=bits_b),
                       got)


@pytest.mark.parametrize("bits_b", [5, 8])
def test_fused_qboth_tn_full_range_codes(cuda, bits_b):
    """dW at K = 8192 tokens with columns of X and dY at the ends of their
    ranges (every code -2^(b-1) or 2^(b-1) - 1) beside random ones; then
    at widths of 67 and 130 on tensors whose first element is off the
    16-byte grid, so that no row is aligned."""
    from repro_torch.kernels import (fused_qboth_tn_matmul,
                                     fused_qboth_tn_matmul_plain)
    from repro_torch.core.backend import dw_operands
    gen = torch.Generator(device=cuda).manual_seed(20 + bits_b)
    K, M, N = 8192, 512, 512
    x = torch.randn(K, M, generator=gen, device=cuda)
    g = torch.randn(K, N, generator=gen, device=cuda) * 1e-3
    x[:, 0], x[:, 1] = x.min(), x.max()
    g[:, 0], g[:, 1] = g.min(), g.max()
    rb = torch.randint(0, 2 ** 32, (K, N), generator=gen, device=cuda,
                       dtype=torch.int64)

    def shifted(t):
        """A contiguous copy of t one element past an aligned start."""
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        return buf[1:].view(t.shape).copy_(t)

    for xs, gs, rs in ((x, g, rb),
                       (shifted(x[:, :67]), shifted(g[:, :130]),
                        shifted(rb[:, :130]))):
        zx, hx = torch.aminmax(xs)
        sx = 255.0 / torch.clamp_min(hx - zx, 1e-12)
        ops = dw_operands(xs, sx, zx, 8, gs, rs, bits_b)
        got = fused_qboth_tn_matmul(*ops, bits_a=8, bits_b=bits_b)
        assert torch.equal(got, fused_qboth_tn_matmul_plain(
            *ops, bits_a=8, bits_b=bits_b))


@pytest.mark.parametrize("mkn", DX_SHAPES + [(512, 512, 10240),
                                             (37, 130, 67), (130, 33, 67)])
@pytest.mark.parametrize("k_major", [True, False])
def test_q8_matmul_vs_plain(cuda, mkn, k_major):
    """Both layouts of y8: a contiguous (K, N) tensor and the transpose of
    a contiguous (N, K) one (the BHQ dX GEMM's w8.T)."""
    from repro_torch.kernels import q8_matmul, q8_matmul_plain
    M, K, N = mkn
    gen = torch.Generator(device=cuda).manual_seed(sum(mkn))
    x8 = torch.randint(-16, 16, (M, K), generator=gen, device=cuda,
                       dtype=torch.int8)
    y8 = torch.randint(-128, 128, (N, K) if k_major else (K, N),
                       generator=gen, device=cuda, dtype=torch.int8)
    y8 = y8.T if k_major else y8
    vec = [torch.randn(n, generator=gen, device=cuda)
           for n in (M, N, M, N, M, N)]
    before = q8_matmul.launches
    got = q8_matmul(x8, y8, *vec)
    assert q8_matmul.launches == before + 1
    want = q8_matmul_plain(x8, y8, *vec)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="contiguous"):
        q8_matmul(x8, y8[:, ::2], *vec[:1], vec[1][::2], vec[2],
                  vec[3][::2], vec[4], vec[5][::2])


@pytest.mark.parametrize("mn", [(2048, 512), (33, 130), (1, 16)])
def test_kv_dequant_rows_bit_identical(cuda, mn):
    from repro_torch.core import quantize_kv_rows
    from repro_torch.kernels import kv_dequant_rows, kv_dequant_rows_plain
    gen = torch.Generator(device=cuda).manual_seed(mn[0])
    x = torch.randn(*mn, generator=gen, device=cuda) * 3
    c, s, z = quantize_kv_rows(x)
    s, z = s[:, None].contiguous(), z[:, None].contiguous()
    got = kv_dequant_rows(c, s, z)
    assert torch.equal(got, kv_dequant_rows_plain(c, s, z))


def test_kv_dequant_rows_rows_off_the_16_byte_grid(cuda):
    """Rows of 40 codes from the second on: the vector path and the
    element-by-element tail both run, in one launch."""
    from repro_torch.core import quantize_kv_rows
    from repro_torch.kernels import kv_dequant_rows, kv_dequant_rows_plain
    gen = torch.Generator(device=cuda).manual_seed(7)
    c, s, z = quantize_kv_rows(torch.randn(9, 40, generator=gen,
                                           device=cuda))
    c, s, z = c[1:], s[1:, None].contiguous(), z[1:, None].contiguous()
    assert c.data_ptr() % 16 != 0
    assert torch.equal(kv_dequant_rows(c, s, z),
                       kv_dequant_rows_plain(c, s, z))


def test_serving_runs_through_both_kernels(cuda):
    from repro_torch.configs import get_config
    from repro_torch.kernels import fused_qlhs_matmul, kv_dequant_rows_kv
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine
    cfg = get_config("granite-3-2b", smoke=True)
    params = build_model(cfg).init(0, device="cpu")
    eng = ServeEngine(cfg, _tree_to(params, cuda), slots=2, max_seq=32,
                      kv_quant=True)
    ref = ServeEngine(cfg, params, slots=2, max_seq=32, kv_quant=True,
                      device="cpu")
    f0, k0 = fused_qlhs_matmul.launches, kv_dequant_rows_kv.launches
    for e in (eng, ref):
        e.submit([1, 2, 3], max_new=4)
        e.submit(list(range(5, 20)), max_new=4)
    got, want = eng.run(), ref.run()
    assert fused_qlhs_matmul.launches > f0
    assert kv_dequant_rows_kv.launches > k0
    assert {r: c.tokens for r, c in got.items()} == \
        {r: c.tokens for r, c in want.items()}


@pytest.mark.parametrize("quant,bits", [("psq", 8), ("bhq", 5)])
def test_training_step_runs_through_training_kernels(cuda, quant, bits):
    """One FQT step of reduced statquant-tx on the card launches each
    kernel of its policy once per quantized GEMM (13 = 2 layers x 6 + the
    head) and agrees with the same step on the CPU (plain versions) to the
    repo's cross-backend tolerance: the loss under both policies, the
    gradient norm under PSQ.  (Under 5-bit BHQ one activation code that
    float32 round-off flips between two devices regroups rows and moves the
    gradient norm by up to 0.3%; the JAX package's own backends part as
    much, tests/test_torch_train.py.)"""
    from repro_torch.configs import get_config
    from repro_torch.core import QuantPolicy
    from repro_torch.engine import init_train_state, make_step_fn
    from repro_torch.kernels import (fused_qboth_tn_matmul,
                                     fused_qlhs_matmul, q8_matmul)
    from repro_torch.models import build_model
    from repro_torch.data import make_batch_for
    from repro_torch.optim import adamw, cosine_schedule
    cfg = get_config("statquant-tx", smoke=True)
    model = build_model(cfg)
    policy = QuantPolicy.fqt(quant, bits, bhq_block=32, backend="kernel")
    step = make_step_fn(model, policy, adamw(), cosine_schedule(3e-3, 4, 1),
                        remat=False)
    batch = make_batch_for(cfg, 4, 16, step=0)
    metrics = {}
    for dev in ("cpu", "cuda"):
        state = init_train_state(model, adamw(), 0, device="cpu")
        state.params = _tree_to(state.params, dev)
        state.opt_state = {k: (v if k == "t" else _tree_to(v, dev))
                           for k, v in state.opt_state.items()}
        fused_qlhs_matmul.launches = fused_qlhs_matmul.launches_dx = 0
        fused_qboth_tn_matmul.launches = q8_matmul.launches = 0
        _, m = step(state, _tree_to(batch, dev))
        metrics[dev] = (float(m["loss"]), float(m["grad_norm"]))
    n = 13
    assert fused_qlhs_matmul.launches - fused_qlhs_matmul.launches_dx == n
    assert fused_qboth_tn_matmul.launches == n
    assert fused_qlhs_matmul.launches_dx == (n if quant == "psq" else 0)
    assert q8_matmul.launches == (n if quant == "bhq" else 0)
    (lc, gc), (lk, gk) = metrics["cpu"], metrics["cuda"]
    assert abs(lk - lc) <= 5e-3 + 1e-3 * abs(lc)
    if quant == "psq":
        assert abs(gk - gc) <= 5e-3 + 1e-3 * abs(gc)


def _pool_operands(gen, n_pages, P, D, B, nb):
    """A random int8 page pool with a zero-scale garbage page and a
    zero-scale row, and block tables that repeat pages and point at page 0
    (idle lanes, unallocated blocks)."""
    dev = gen.device
    codes = torch.randint(-128, 128, (n_pages, P, D), generator=gen,
                          device=dev, dtype=torch.int8)
    scale = torch.rand(n_pages, P, generator=gen, device=dev) * 200 + 1
    zero = torch.randn(n_pages, P, generator=gen, device=dev)
    scale[0] = 0.0
    scale[n_pages // 2, P // 2] = 0.0
    table = torch.randint(0, n_pages, (B, nb), generator=gen, device=dev,
                          dtype=torch.int32)
    table[0] = 0                               # an idle lane
    table[1, nb // 2:] = 0                     # unallocated blocks
    table[-1, 0] = table[-1, -1]               # a repeated page
    return codes, scale, zero, table


@pytest.mark.parametrize("shape", [(129, 16, 512, 8, 16), (129, 8, 512, 8, 32),
                                   (11, 3, 40, 3, 5), (7, 5, 17, 2, 3)])
@pytest.mark.parametrize("bits", [8, 4])
def test_kv_gather_pages_bit_identical(cuda, shape, bits):
    """Granite's paged shapes (P = 16 and 8, D = 512) and ragged ones (a
    page size of 3, widths off the 16-byte grid), with page-0 tables and
    zero scales: bit for bit, and finite."""
    from repro_torch.kernels import kv_gather_pages, kv_gather_pages_plain
    gen = torch.Generator(device=cuda).manual_seed(sum(shape) + bits)
    ops = _pool_operands(gen, *shape)
    before = kv_gather_pages.launches
    got = kv_gather_pages(*ops, bits=bits)
    assert kv_gather_pages.launches == before + 1
    want = kv_gather_pages_plain(*ops, bits=bits)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="int32"):
        kv_gather_pages(*ops[:3], ops[3].long(), bits=bits)


def _dense_pair(gen, M, N):
    """K and V of a dense int8 cache layer, (codes, scale (M, 1), zero
    (M, 1)) each, with zero scales in a few rows."""
    from repro_torch.core import quantize_kv_rows
    sides = []
    for _ in range(2):
        c, s, z = quantize_kv_rows(torch.randn(M, N, generator=gen,
                                               device=gen.device) * 3)
        s[::97] = 0.0
        sides.append((c, s[:, None].contiguous(), z[:, None].contiguous()))
    return sides


# the bodies of the KV kernels (csrc/kv_dequant.cu, csrc/kv_gather.cu):
# bulk, element
KV_BODIES = (1, 2)


@pytest.mark.parametrize("mn", [(2048, 512), (33, 130), (1, 16),
                                (32768, 512), (5, 20000)])
def test_kv_dequant_rows_kv_bit_identical(cuda, mn):
    """K and V in one launch equal the plain pair (scales clamped) bit for
    bit at the serving shape, ragged, tiny, a 4,096-token context of 8
    slots and rows wider than a bulk tile; every body the operands allow
    gives the same result, and the launch counts once."""
    from repro_torch.kernels import (kv_dequant, kv_dequant_rows_kv,
                                     kv_dequant_rows_kv_plain)
    gen = torch.Generator(device=cuda).manual_seed(sum(mn))
    k, v = _dense_pair(gen, *mn)
    before = kv_dequant_rows_kv.launches
    got = kv_dequant_rows_kv(k, v)
    assert kv_dequant_rows_kv.launches == before + 1
    want = kv_dequant_rows_kv_plain(k, v)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert torch.equal(g, w)
    bulk = mn[1] % 16 == 0 and mn[1] <= 16384
    for body in KV_BODIES:
        if body == 1 and not bulk:
            with pytest.raises(RuntimeError, match="CUDA error"):
                kv_dequant._launch("kv_dequant_rows_kv", [k, v], *mn, 8, 1,
                                   body)
            continue
        out = kv_dequant._launch("kv_dequant_rows_kv", [k, v], *mn, 8, 1,
                                 body)
        torch.cuda.synchronize()
        assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])


def test_kv_dequant_rows_kv_rows_off_the_16_byte_grid(cuda):
    """Rows of 40 codes from the second on (codes off the 16-byte grid):
    the element path, in one launch for both sides."""
    from repro_torch.kernels import (kv_dequant_rows_kv,
                                     kv_dequant_rows_kv_plain)
    gen = torch.Generator(device=cuda).manual_seed(9)
    k, v = ((c[1:], s[1:].contiguous(), z[1:].contiguous())
            for c, s, z in _dense_pair(gen, 9, 40))
    assert k[0].data_ptr() % 16 != 0
    for g, w in zip(kv_dequant_rows_kv(k, v), kv_dequant_rows_kv_plain(k, v)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="equal shapes"):
        kv_dequant_rows_kv(k, tuple(t[1:] for t in v))


@pytest.mark.parametrize("shape", [(129, 16, 512, 8, 16), (129, 8, 512, 8, 32),
                                   (11, 3, 40, 3, 5), (7, 5, 17, 2, 3),
                                   (2049, 16, 512, 8, 256)])
def test_kv_gather_pages_kv_bit_identical(cuda, shape):
    """K and V gathered through one table in one launch equal the plain
    pair bit for bit: granite's paged shapes (P = 16 and 8, D = 512, and a
    4,096-token context of 8 lanes from 1 + 2,048 pages) and ragged ones,
    with page-0 tables, repeated pages and zero scales; the bulk body,
    where the operands allow it, and the element path agree, and the
    launch counts once."""
    from repro_torch.kernels import (kv_gather, kv_gather_pages_kv,
                                     kv_gather_pages_kv_plain)
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    k = _pool_operands(gen, *shape)
    v = _pool_operands(gen, *shape)[:3]
    k, table = k[:3], k[3]
    before = kv_gather_pages_kv.launches
    got = kv_gather_pages_kv(k, v, table)
    assert kv_gather_pages_kv.launches == before + 1
    want = kv_gather_pages_kv_plain(k, v, table)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert torch.equal(g, w)
    n_pages, P, D = shape[:3]
    bulk = D % 16 == 0 and P % 4 == 0
    for body in KV_BODIES if bulk else KV_BODIES[1:]:
        out = kv_gather._launch("kv_gather_pages_kv", [k, v], table, 8, body)
        torch.cuda.synchronize()
        assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])
    if not bulk:
        with pytest.raises(RuntimeError, match="CUDA error"):
            kv_gather._launch("kv_gather_pages_kv", [k, v], table, 8, body=1)
    with pytest.raises(ValueError, match="int32"):
        kv_gather_pages_kv(k, v, table.long())


def _sr_operands(gen, M, N):
    """A gradient-like (M, N) with a wider and a constant row, and SR bits
    spanning all 32 bits, edge values first."""
    dev = gen.device
    x = torch.randn(M, N, generator=gen, device=dev) * 1e-3
    x[0, 0] = 5e-3
    if M > 2:
        x[2] = 0.25
    rbits = torch.randint(0, 2 ** 32, (M, N), generator=gen, device=dev,
                          dtype=torch.int64)
    edge = torch.tensor([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 31 + 1,
                         2 ** 32 - 129, 2 ** 32 - 128, 2 ** 32 - 1],
                        dtype=torch.int64, device=dev)
    flat = rbits.view(-1)
    flat[:min(8, flat.numel())] = edge[:flat.numel()]
    return x, rbits


@pytest.mark.parametrize("mn", [(512, 10240), (2048, 512), (33, 130),
                                (1, 64), (16, 1), (3, 5)])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_sr_kernels_bit_identical(cuda, mn, bits):
    """quantize_sr_rows and quantize_sr_tensor: codes, scale and zero equal
    their plain versions bit for bit, and a row view off the 16-byte grid
    takes the element-by-element path."""
    from repro_torch.kernels import (quantize_sr_rows, quantize_sr_rows_plain,
                                     quantize_sr_tensor,
                                     quantize_sr_tensor_plain)
    gen = torch.Generator(device=cuda).manual_seed(sum(mn) + bits)
    x, rb = _sr_operands(gen, *mn)
    r0, t0 = quantize_sr_rows.launches, quantize_sr_tensor.launches
    for kern, plain in ((quantize_sr_rows, quantize_sr_rows_plain),
                        (quantize_sr_tensor, quantize_sr_tensor_plain)):
        got, want = kern(x, rb, bits), plain(x, rb, bits)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.shape == w.shape and torch.equal(g, w)
        if mn[0] > 1:
            xs, rs = x[1:], rb[1:]
            for g, w in zip(kern(xs, rs, bits), plain(xs, rs, bits)):
                assert torch.equal(g, w)
    assert quantize_sr_rows.launches > r0 and quantize_sr_tensor.launches > t0
    with pytest.raises(ValueError, match="int64"):
        quantize_sr_rows(x, rb.to(torch.int32), bits)


def test_unfused_training_step_runs_through_quantize_sr(cuda):
    """One FQT step of reduced statquant-tx with every role unfused
    (``fused=False``): per quantized GEMM one quantize_sr_rows (PSQ dX
    operand), one quantize_sr_tensor (PTQ dW operand) and three q8_matmul
    (forward, dW, dX); loss and gradient norm equal to the CPU's to the
    repo's tolerance."""
    from repro_torch.configs import get_config
    from repro_torch.core import QuantPolicy
    from repro_torch.data import make_batch_for
    from repro_torch.engine import init_train_state, make_step_fn
    from repro_torch.kernels import (fused_qboth_tn_matmul,
                                     fused_qlhs_matmul, q8_matmul,
                                     quantize_sr_rows, quantize_sr_tensor)
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, cosine_schedule
    cfg = get_config("statquant-tx", smoke=True)
    model = build_model(cfg)
    policy = QuantPolicy.fqt("psq", 8, backend="kernel", fused=False)
    step = make_step_fn(model, policy, adamw(), cosine_schedule(3e-3, 4, 1),
                        remat=False)
    batch = make_batch_for(cfg, 4, 16, step=0)
    metrics = {}
    for dev in ("cpu", "cuda"):
        state = init_train_state(model, adamw(), 0, device="cpu")
        state.params = _tree_to(state.params, dev)
        state.opt_state = {k: (v if k == "t" else _tree_to(v, dev))
                           for k, v in state.opt_state.items()}
        for fn in (fused_qlhs_matmul, fused_qboth_tn_matmul, q8_matmul,
                   quantize_sr_rows, quantize_sr_tensor):
            fn.launches = 0
        _, m = step(state, _tree_to(batch, dev))
        metrics[dev] = (float(m["loss"]), float(m["grad_norm"]))
    n = 13
    assert quantize_sr_rows.launches == n
    assert quantize_sr_tensor.launches == n
    assert q8_matmul.launches == 3 * n
    assert fused_qlhs_matmul.launches == fused_qboth_tn_matmul.launches == 0
    (lc, gc), (lk, gk) = metrics["cpu"], metrics["cuda"]
    assert abs(lk - lc) <= 5e-3 + 1e-3 * abs(lc)
    assert abs(gk - gc) <= 5e-3 + 1e-3 * abs(gc)


def test_paged_serving_runs_through_kv_gather(cuda):
    """The paged engine on the card launches the K-and-V gather once per
    layer per paged forward, never a single-side gather or the dense KV
    read, and emits the tokens of the same run on the CPU (plain
    versions)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import (kv_dequant_rows, kv_dequant_rows_kv,
                                     kv_gather_pages, kv_gather_pages_kv)
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine
    cfg = get_config("granite-3-2b", smoke=True)
    params = build_model(cfg).init(0, device="cpu")
    out = {}
    kv = (kv_gather_pages, kv_gather_pages_kv, kv_dequant_rows,
          kv_dequant_rows_kv)
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(cfg, _tree_to(params, dev), slots=2, max_seq=32,
                          kv_quant=True, paged=True, page_size=8,
                          device=dev)
        for fn in kv:
            fn.launches = 0
        eng.submit([1, 2, 3], max_new=4)
        eng.submit(list(range(5, 20)), max_new=4)
        out[dev] = {r: c.tokens for r, c in eng.run().items()}
    assert kv_gather_pages_kv.launches == cfg.n_layers * eng.paged_forwards
    assert eng.paged_forwards > 0
    assert kv_gather_pages.launches == kv_dequant_rows.launches == 0
    assert kv_dequant_rows_kv.launches == 0
    assert out["cuda"] == out["cpu"]


@pytest.mark.parametrize("mkn", [(8, 2048, 8192), (128, 2048, 512),
                                 (33, 67, 130), (1, 130, 49), (3, 5, 3)])
@pytest.mark.parametrize("wbits", [1, 2, 4, 8])
def test_packed_kernels_bit_identical(cuda, mkn, wbits):
    """Both packed GEMMs against their plain versions on random codes
    (padding rows of a ragged K included), and at 8 bits the packed
    forward against ``fused_qlhs_matmul`` on the same codes."""
    from repro_torch.core import affine_factors, epilogue_coeffs
    from repro_torch.core import quantize_ptq_det
    from repro_torch.core.backend import _ptq_range
    from repro_torch.kernels import (PackedTensor, fused_qlhs_matmul,
                                     fused_qlhs_packed_matmul,
                                     fused_qlhs_packed_matmul_plain,
                                     pack_codes, packed_matmul,
                                     packed_matmul_plain)
    M, K, N = mkn
    gen = torch.Generator(device=cuda).manual_seed(sum(mkn) + wbits)
    codes = torch.randint(0, 1 << wbits, (K, N), generator=gen, device=cuda,
                          dtype=torch.int32).to(torch.uint8)
    pt = PackedTensor(pack_codes(codes, wbits),
                      torch.tensor(7.0, device=cuda),
                      torch.tensor(-0.3, device=cuda), wbits, K)
    x = torch.randn(M, K, generator=gen, device=cuda)
    ab, bb = affine_factors(pt.scale, pt.zero, wbits)
    u = ab * pt.colsum.to(torch.float32) + float(K) * bb
    zero, scale = _ptq_range(x, 8)
    sa = scale.reshape(1, 1).expand(M, 1).contiguous()
    za = zero.reshape(1, 1).expand(M, 1).contiguous()
    args = (x, sa, za, pt.packed, ab, bb, u)
    before = fused_qlhs_packed_matmul.launches
    got = fused_qlhs_packed_matmul(*args, bits=8, wbits=wbits)
    assert fused_qlhs_packed_matmul.launches == before + 1
    assert torch.equal(got, fused_qlhs_packed_matmul_plain(
        *args, bits=8, wbits=wbits))
    if wbits == 8:
        assert torch.equal(got, fused_qlhs_matmul(
            x, sa, za, None, pt.int8_codes, ab, bb, u, bits=8))
    aq = quantize_ptq_det(x, 8)
    aa, ba = affine_factors(aq.scale, aq.zero, 8)
    co = [c.contiguous() for c in epilogue_coeffs(
        aq.int8_codes, aa, ba, None, ab, bb, colsum=pt.colsum)]
    before = packed_matmul.launches
    got = packed_matmul(aq.int8_codes, pt.packed, *co, wbits=wbits, kdim=K)
    assert packed_matmul.launches == before + 1
    assert torch.equal(got, packed_matmul_plain(aq.int8_codes, pt.packed,
                                                *co, wbits=wbits, kdim=K))
    column_major = pt.packed.T.contiguous().T
    if not column_major.is_contiguous():
        with pytest.raises(ValueError, match="contiguous"):
            packed_matmul(aq.int8_codes, column_major, *co, wbits=wbits,
                          kdim=K)


@pytest.mark.parametrize("bits,fused", [(8, None), (4, None), (4, False)])
def test_packed_serving_runs_through_packed_kernels(cuda, bits, fused):
    """``ServeEngine(weight_bits=...)`` on the card: every forward GEMM
    through ``fused_qlhs_packed_matmul`` (or ``packed_matmul`` unfused),
    never the fp32-weight kernel, and the tokens of the same run on the
    CPU (plain versions)."""
    from repro_torch.configs import get_config
    from repro_torch.core import QuantPolicy
    from repro_torch.kernels import (fused_qlhs_matmul,
                                     fused_qlhs_packed_matmul, packed_matmul)
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine
    cfg = get_config("granite-3-2b", smoke=True)
    params = build_model(cfg).init(0, device="cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(cfg, _tree_to(params, dev), slots=2, max_seq=32,
                          kv_quant=True, weight_bits=bits, device=dev,
                          policy=QuantPolicy.qat(backend="kernel",
                                                 fused=fused))
        for fn in (fused_qlhs_matmul, fused_qlhs_packed_matmul,
                   packed_matmul):
            fn.launches = 0
        eng.submit([1, 2, 3], max_new=4)
        eng.submit(list(range(5, 20)), max_new=4)
        out[dev] = {r: c.tokens for r, c in eng.run().items()}
    n = 7 * cfg.n_layers + 1
    calls = n * (2 + len(eng.step_times))
    want = packed_matmul if fused is False else fused_qlhs_packed_matmul
    other = fused_qlhs_packed_matmul if fused is False else packed_matmul
    assert want.launches == calls and other.launches == 0
    assert fused_qlhs_matmul.launches == 0
    assert out["cuda"] == out["cpu"]


def _packed_operands(gen, M, K, N, wbits, codes=None):
    """Both packed GEMMs' arguments on random (or the given) unsigned
    codes packed at ``wbits``: the packed forward's (x, scale, zero,
    packed, alpha_b, beta_b, u), then packed_matmul's (x8, packed and its
    six epilogue vectors), then the PackedTensor."""
    from repro_torch.core import affine_factors, epilogue_coeffs
    from repro_torch.core import quantize_ptq_det
    from repro_torch.core.backend import _ptq_range
    from repro_torch.kernels import PackedTensor, pack_codes
    dev = gen.device
    if codes is None:
        codes = torch.randint(0, 1 << wbits, (K, N), generator=gen,
                              device=dev, dtype=torch.int32).to(torch.uint8)
    pt = PackedTensor(pack_codes(codes, wbits), torch.tensor(7.0, device=dev),
                      torch.tensor(-0.3, device=dev), wbits, K)
    x = torch.randn(M, K, generator=gen, device=dev)
    ab, bb = affine_factors(pt.scale, pt.zero, wbits)
    u = ab * pt.colsum.to(torch.float32) + float(K) * bb
    zero, scale = _ptq_range(x, 8)
    sa = scale.reshape(1, 1).expand(M, 1).contiguous()
    za = zero.reshape(1, 1).expand(M, 1).contiguous()
    aq = quantize_ptq_det(x, 8)
    aa, ba = affine_factors(aq.scale, aq.zero, 8)
    co = [c.contiguous() for c in epilogue_coeffs(
        aq.int8_codes, aa, ba, None, ab, bb, colsum=pt.colsum)]
    return ((x, sa, za, pt.packed, ab, bb, u),
            (aq.int8_codes, pt.packed, *co), pt)


# (M, K, N) of the forced-split sweep: the decode tile at granite's MLP
# up-projection, the wide tile at a K ragged at every ppb
PACKED_SPLIT_SHAPES = [(8, 2048, 8192), (128, 1001, 300)]


@pytest.mark.parametrize("wbits", [1, 2, 4, 8])
def test_every_forced_split_of_the_packed_kernels(cuda, wbits):
    """Both packed GEMMs through their C entries with every split of K
    forced, decode and wide tile: each equals the plain version bit for
    bit (the int32 sums do not depend on the split)."""
    from repro_torch.kernels import (fused_qlhs_packed_matmul_plain,
                                     packed_matmul_plain, splitk)
    from repro_torch.kernels.build import load_function
    from repro_torch.kernels.fused_fqt import _QLHS_PACKED_ARGTYPES
    from repro_torch.kernels.q4_matmul import _ARGTYPES
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=cuda).manual_seed(17 + wbits)
    for M, K, N in PACKED_SPLIT_SHAPES:
        fused, unfused, _ = _packed_operands(gen, M, K, N, wbits)
        for lib, args, want, argtypes, extra in (
                ("fused_qlhs_packed", fused,
                 fused_qlhs_packed_matmul_plain(*fused, bits=8, wbits=wbits),
                 _QLHS_PACKED_ARGTYPES, (8,)),
                ("packed_matmul", unfused,
                 packed_matmul_plain(*unfused, wbits=wbits, kdim=K),
                 _ARGTYPES, ())):
            tile = splitk.packed_tile(lib, M, wbits)
            fn = load_function(lib, lib, argtypes)
            for s, span in _forced_splits(tile, M, N, K):
                out = torch.full_like(want, float("nan"))
                assert fn(*[t.data_ptr() for t in args], out.data_ptr(), M,
                          N, K, *extra, tile.mode, s, span, stream) == 0
                assert torch.equal(out, want), (tile.name, s)
            # a split that does not cover K is refused
            assert fn(*[t.data_ptr() for t in args], out.data_ptr(), M, N,
                      K, *extra, tile.mode, 1, tile.bk, stream) != 0


def test_packed_forward_at_8_bits_equals_the_int8_forward(cuda):
    """At 8 bits (the identity pack) the packed forward equals
    ``fused_qlhs_matmul`` on the same codes, bit for bit, at every decode
    GEMM of granite-3-2b (8 slots)."""
    from repro_torch.kernels import fused_qlhs_matmul, fused_qlhs_packed_matmul
    gen = torch.Generator(device=cuda).manual_seed(8)
    for K, N in ((2048, 2048), (2048, 512), (2048, 8192), (8192, 2048),
                 (2048, 49408)):
        fused, _, pt = _packed_operands(gen, 8, K, N, 8)
        x, sa, za, _, ab, bb, u = fused
        got = fused_qlhs_packed_matmul(*fused, bits=8, wbits=8)
        want = fused_qlhs_matmul(x, sa, za, None, pt.int8_codes, ab, bb, u,
                                 bits=8)
        assert torch.equal(got, want), (K, N)


@pytest.mark.parametrize("M", [8, 128])
@pytest.mark.parametrize("wbits", [1, 2, 4, 8])
def test_packed_kernels_full_range_codes(cuda, M, wbits):
    """K = 8192, weight codes over the whole range (half the columns at
    0 or 2^w - 1 alone), LHS rows clipped to each end of the int8 range:
    the int32 accumulators' worst case, across the split-K reduction."""
    from repro_torch.kernels import (fused_qlhs_packed_matmul,
                                     fused_qlhs_packed_matmul_plain,
                                     packed_matmul, packed_matmul_plain)
    K, N = 8192, 512
    gen = torch.Generator(device=cuda).manual_seed(M + wbits)
    top = (1 << wbits) - 1
    codes = torch.randint(0, top + 1, (K, N), generator=gen, device=cuda,
                          dtype=torch.int32).to(torch.uint8)
    codes[:, : N // 4] = 0
    codes[:, N // 4: N // 2] = top
    fused, unfused, _ = _packed_operands(gen, M, K, N, wbits, codes)
    x, sa, za = fused[:3]
    sa, za = sa.clone(), za.clone()
    sa[0], za[0] = 1e3, x[0].max() + 1.0      # every code clips to -128
    sa[1], za[1] = 1e3, x[1].min() - 1.0      # every code clips to 127
    fused = (x, sa, za) + fused[3:]
    assert torch.equal(fused_qlhs_packed_matmul(*fused, bits=8, wbits=wbits),
                       fused_qlhs_packed_matmul_plain(*fused, bits=8,
                                                      wbits=wbits))
    x8 = unfused[0].clone()
    x8[0], x8[1] = -128, 127
    unfused = (x8,) + unfused[1:]
    assert torch.equal(packed_matmul(*unfused, wbits=wbits, kdim=K),
                       packed_matmul_plain(*unfused, wbits=wbits, kdim=K))


@pytest.mark.parametrize("wbits", [1, 2, 4, 8])
def test_packed_kernels_odd_n_and_unaligned_rows(cuda, wbits):
    """Odd N (packed rows off the 16-byte grid), K ragged at every ppb
    (LHS rows off it too), and operands whose first row starts one byte
    (packed, int8 codes) or one float (f32 LHS) past an aligned address."""
    from repro_torch.kernels import (fused_qlhs_packed_matmul,
                                     fused_qlhs_packed_matmul_plain,
                                     packed_matmul, packed_matmul_plain)
    gen = torch.Generator(device=cuda).manual_seed(wbits)
    for M, K, N in ((8, 1001, 131), (37, 515, 257), (130, 67, 17)):
        fused, unfused, _ = _packed_operands(gen, M, K, N, wbits)

        def shifted(t):
            buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
            v = buf[1:].view(t.shape)
            v.copy_(t)
            assert v.is_contiguous() and v.data_ptr() % 16 != 0
            return v
        fused = (shifted(fused[0]),) + fused[1:3] + (shifted(fused[3]),) \
            + fused[4:]
        unfused = (shifted(unfused[0]), shifted(unfused[1])) + unfused[2:]
        assert torch.equal(
            fused_qlhs_packed_matmul(*fused, bits=8, wbits=wbits),
            fused_qlhs_packed_matmul_plain(*fused, bits=8, wbits=wbits))
        assert torch.equal(packed_matmul(*unfused, wbits=wbits, kdim=K),
                           packed_matmul_plain(*unfused, wbits=wbits,
                                               kdim=K))


def _sr_plans(q, card, M, N):
    """Every launch plan the SR quantizers' C entries can be forced to at
    (M, N): the row held in registers where it fits, each cluster size
    with the row's share staged whole, a third of it and none; the
    tensor's planned grid, 7 blocks, one an SM and the
    card's resident grid, each chunk staged as far as the blocks' shared
    memory holds it, an eighth of it, and not at all."""
    rows, tensor = [], []
    if N <= q.REG_ROW:
        rows.append(q.RowsPlan(M, N, 1, q._span(N, 1), 0, 0, regs=True))
    for c in (1, 2, 4, 8):
        span = q._span(N, c)
        for stage in sorted({0, span + 4, max(4, span // 12 * 4)}):
            smem = q.stage_bytes(stage)
            mode = q.rows_mode(c, stage < span + 4)
            if smem + card.static_smem[mode] <= card.smem_per_block:
                rows.append(q.RowsPlan(M, N, c, span, stage, smem))
    n = M * N
    for g in sorted({q.tensor_plan(n, card).grid, 7, card.sms,
                     card.sms * min(card.blocks[q.TENSOR:])}):
        chunk, per = q._span(n, g), -(-g // card.sms)
        most = min(chunk + 4, card.stage_for(q.TENSOR + 1, per))
        for stage in sorted({0, most, min(most, max(4, chunk // 32 * 4))}):
            plan = q.TensorPlan(n, g, chunk, stage, q.stage_bytes(stage))
            if card.blocks_per_sm(plan.mode, plan.smem) >= per:
                tensor.append(plan)
    return rows, tensor


@pytest.mark.parametrize("mn", [(512, 10240), (2048, 8192), (64, 4099),
                                (7, 8191), (3, 140001), (33, 130), (16, 1)])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_sr_every_plan_bit_identical(cuda, mn, bits):
    """Both SR quantizers under every plan (forced through the C entries)
    equal their plain versions bit for bit, on the tensor and on its row
    view off the 16-byte grid, twice; the wrappers count one launch a
    call."""
    from repro_torch.kernels import quantize_sr as q
    card = q.on_card()
    gen = torch.Generator(device=cuda).manual_seed(sum(mn) + bits)
    x, rb = _sr_operands(gen, *mn)
    views = [(x, rb)] + ([(x[1:], rb[1:])] if mn[0] > 1 else [])
    for xv, rv in views:
        M, N = xv.shape
        want_r = q.quantize_sr_rows_plain(xv, rv, bits)
        want_t = q.quantize_sr_tensor_plain(xv, rv, bits)
        rows, tensor = _sr_plans(q, card, M, N)
        for launch, plans, want in ((q._rows_launch, rows, want_r),
                                    (q._tensor_launch, tensor, want_t)):
            for plan in plans:
                for _ in range(2):
                    got = launch(xv, rv, bits, plan)
                    torch.cuda.synchronize()
                    for g, w in zip(got, want):
                        assert g.shape == w.shape and torch.equal(g, w), plan
        for kern, want in ((q.quantize_sr_rows, want_r),
                           (q.quantize_sr_tensor, want_t)):
            n0 = kern.launches
            for g, w in zip(kern(xv, rv, bits), want):
                assert torch.equal(g, w)
            assert kern.launches == n0 + 1


@pytest.mark.parametrize("case", ["constant", "zeros", "extremes last"])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_sr_edge_tensors(cuda, case, bits):
    """A constant tensor (scale B / 1e-12), one of -0.0 and +0.0 only (the
    sign of a zero ``zero`` is the reduction order's, in torch.amin too),
    and one whose extremes are its last two elements (the last chunk and
    the last block)."""
    from repro_torch.kernels import quantize_sr as q
    gen = torch.Generator(device=cuda).manual_seed(bits)
    for M, N in ((512, 10240), (2048, 8192), (33, 130)):
        x, rb = _sr_operands(gen, M, N)
        if case == "constant":
            x = torch.full_like(x, 0.25)
        elif case == "zeros":
            x = torch.where(x < 0, torch.zeros_like(x).neg_(),
                            torch.zeros_like(x))
        else:
            x[-1, -1], x[-1, -2] = 1.0, -1.0
        for kern, plain in ((q.quantize_sr_rows, q.quantize_sr_rows_plain),
                            (q.quantize_sr_tensor,
                             q.quantize_sr_tensor_plain)):
            for g, w in zip(kern(x, rb, bits), plain(x, rb, bits)):
                assert torch.equal(g, w)


def _device_kernels(fn) -> int:
    """Device kernels one call of ``fn`` runs (torch.profiler, after a
    warm-up call); a session that reports none at all is repeated, twice
    at most (seen once after earlier sessions in a process; no call here
    runs none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    n = 0
    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0)
        if n:
            break
    return n


def test_quantize_sr_plans_and_launches_on_the_card(cuda):
    """The plans' occupancy model equals the card's occupancy calculator
    at every planned shared memory size, and each wrapper is one device
    kernel a call (the tensor mode reduces its range in the same
    cooperative launch)."""
    import ctypes
    from repro_torch.kernels import quantize_sr as q
    from repro_torch.kernels.build import load_function
    card = q.on_card()
    occ = load_function("quantize_sr", "quantize_sr_occupancy",
                        (ctypes.c_int, ctypes.c_int))
    for M, N in ((512, 512), (512, 10240), (2048, 8192), (2048, 49408),
                 (16, 8192), (3, 5)):
        rp, tp = q.rows_plan(M, N, card), q.tensor_plan(M * N, card)
        for plan in (rp, tp):
            assert card.blocks_per_sm(plan.mode, plan.smem) == \
                occ(plan.mode, plan.smem)
        assert tp.grid <= card.sms * occ(tp.mode, tp.smem)
    gen = torch.Generator(device=cuda).manual_seed(0)
    x, rb = _sr_operands(gen, 512, 1024)
    assert _device_kernels(lambda: q.quantize_sr_rows(x, rb, 8)) == 1
    assert _device_kernels(lambda: q.quantize_sr_tensor(x, rb, 8)) == 1


def test_unfused_ptq_step_runs_one_kernel_a_tensor_quantize(cuda,
                                                            monkeypatch):
    """A reduced statquant-tx step under ``fqt(ptq, 8)`` unfused: with the
    plain tensor quantizer swapped in, the step runs exactly (kernels of a
    plain call - 1) more device kernels for each ``quantize_sr_tensor``
    call, so each call through the wrapper is one kernel."""
    from repro_torch.configs import get_config
    from repro_torch.core import QuantPolicy
    from repro_torch.core import backend
    from repro_torch.data import make_batch_for
    from repro_torch.engine import init_train_state, make_step_fn
    from repro_torch.kernels import quantize_sr as q
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, cosine_schedule
    cfg = get_config("statquant-tx", smoke=True)
    model = build_model(cfg)
    step = make_step_fn(model, QuantPolicy.fqt("ptq", 8, backend="kernel",
                                               fused=False),
                        adamw(), cosine_schedule(3e-3, 4, 1))
    batch = _tree_to(make_batch_for(cfg, 4, 16, step=0), cuda)
    state = init_train_state(model, adamw(), 0, device="cpu")
    state.params = _tree_to(state.params, cuda)
    state.opt_state = {k: (v if k == "t" else _tree_to(v, cuda))
                       for k, v in state.opt_state.items()}
    n0 = q.quantize_sr_tensor.launches
    kernel = _device_kernels(lambda: step(state, batch))
    calls = (q.quantize_sr_tensor.launches - n0) // 2
    assert calls == 2 * 13
    gen = torch.Generator(device=cuda).manual_seed(0)
    x, rb = _sr_operands(gen, 64, 48)
    per_plain = _device_kernels(
        lambda: q.quantize_sr_tensor_plain(x, rb, 8))
    monkeypatch.setattr(backend, "quantize_sr_tensor",
                        q.quantize_sr_tensor_plain)
    plain = _device_kernels(lambda: step(state, batch))
    assert plain - kernel == calls * (per_plain - 1)


def test_checkpoint_resume_is_bit_identical_on_the_card(cuda, tmp_path):
    """Reduced statquant-tx on the kernel backend under ``fqt(bhq,5)``: 4
    steps against 2 steps, a checkpoint and a new engine resuming to 4,
    every leaf ``torch.equal`` (checkpoints restore onto the card)."""
    from repro_torch.configs import get_config
    from repro_torch.core import QuantPolicy
    from repro_torch.engine import Engine
    from repro_torch.optim import tree_leaves
    cfg = get_config("statquant-tx", smoke=True)

    def engine(**kw):
        return Engine(cfg, QuantPolicy.fqt("bhq", 5, bhq_block=32,
                                           backend="kernel"),
                      steps=4, batch_size=4, seq_len=16, log_fn=None, **kw)
    full = engine()
    h = full.run()
    e1 = engine(ckpt_dir=str(tmp_path), ckpt_every=2)
    h1 = e1.run(steps=2)
    e2 = engine(ckpt_dir=str(tmp_path), ckpt_every=100)
    h2 = e2.run()
    assert h == h1 + h2
    for tree in (lambda s: s.params, lambda s: s.opt_state["m"],
                 lambda s: s.opt_state["v"]):
        for a, b in zip(tree_leaves(tree(full.state)),
                        tree_leaves(tree(e2.state))):
            assert a.device.type == "cuda" and torch.equal(a, b)
    assert full.state.opt_state["t"] == e2.state.opt_state["t"] == 4
    assert torch.equal(full.state.rng, e2.state.rng)


def test_from_checkpoint_serves_through_the_kernels(cuda, tmp_path):
    """``ServeEngine.from_checkpoint`` (dense and paged) on the card, kernel
    backend: the in-memory engine's tokens, through the serving kernels."""
    from repro_torch.configs import get_config
    from repro_torch.core import QuantPolicy
    from repro_torch.engine import Engine
    from repro_torch.kernels import fused_qlhs_matmul
    from repro_torch.serve import ServeEngine
    cfg = get_config("statquant-tx", smoke=True)
    eng = Engine(cfg, QuantPolicy.fqt("psq", 8, backend="kernel"), steps=2,
                 batch_size=4, seq_len=16, ckpt_dir=str(tmp_path),
                 ckpt_every=2, log_fn=None)
    eng.run()
    for kw in ({}, {"paged": True, "page_size": 4}):
        outs = []
        for build in (lambda: ServeEngine.from_checkpoint(
                          cfg, str(tmp_path), slots=2, max_seq=32,
                          kv_quant=True, **kw),
                      lambda: ServeEngine(cfg, eng.state.params, slots=2,
                                          max_seq=32, kv_quant=True, **kw)):
            e = build()
            e.submit([1, 2, 3], max_new=4)
            e.submit(list(range(5, 20)), max_new=4)
            f0 = fused_qlhs_matmul.launches
            outs.append({r: c.tokens for r, c in e.run().items()})
            assert fused_qlhs_matmul.launches > f0
        assert outs[0] == outs[1]


def test_native_backend_matches_simulate_on_the_card(cuda):
    """``native`` (``torch._int_mm``, operands zero-padded to multiples of
    32) against ``simulate`` on the card: forward and both
    backward GEMMs of a ragged 33 x 17 x 9 call to float32 round-off, and a
    reduced statquant-tx step's loss and gradient norm within the repo's
    cross-backend tolerance."""
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.core import QuantPolicy, fqt_matmul
    from repro_torch.data import make_batch_for
    from repro_torch.engine import init_train_state, make_step_fn
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, cosine_schedule
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(33, 17, generator=gen, device=cuda)
    w = torch.randn(17, 9, generator=gen, device=cuda)
    g = torch.randn(33, 9, generator=gen, device=cuda)
    outs = []
    for backend in ("native", "simulate"):
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = fqt_matmul(xr, wr, prng.PRNGKey(3),
                       QuantPolicy.fqt("psq", 8, backend=backend), path="p")
        outs.append((y,) + torch.autograd.grad(y, (xr, wr), g))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()))
    cfg = get_config("statquant-tx", smoke=True)
    model = build_model(cfg)
    batch = _tree_to(make_batch_for(cfg, 4, 16, step=0), cuda)
    mets = []
    for backend in ("native", "simulate"):
        step = make_step_fn(model, QuantPolicy.fqt("psq", 8, backend=backend),
                            adamw(), cosine_schedule(3e-3, 4, 1))
        _, m = step(init_train_state(model, adamw(), 0), batch)
        mets.append((float(m["loss"]), float(m["grad_norm"])))
    for a, b in zip(*mets):
        assert abs(a - b) <= 5e-3 + 1e-3 * abs(b)


@pytest.mark.parametrize("mkn", [(512, 512, 10240), (33, 50, 9)])
def test_fused_qlinear_kernels_vs_plain(cuda, mkn):
    """``kernels/ops.py``'s standalone forward: one ``quantize_sr_rows``
    and one ``q8_matmul`` launch a call, codes, scales and ``y`` equal to
    ``use_kernels=False`` (the plain versions), and both backward GEMMs
    of ``fused_qlinear_bwd`` under ptq, psq and bhq equal to the same ops
    through the plain versions."""
    import contextlib
    import repro_torch.core.backend as backend
    from repro_torch import prng
    from repro_torch.kernels import (ops, q8_matmul, q8_matmul_plain,
                                     quantize_sr_rows, quantize_sr_rows_plain,
                                     quantize_sr_tensor_plain)
    M, K, N = mkn
    gen = torch.Generator(device=cuda).manual_seed(M + K + N)
    x = torch.randn(M, K, generator=gen, device=cuda)
    w = torch.randn(K, N, generator=gen, device=cuda) * 0.05
    g = torch.randn(M, N, generator=gen, device=cuda) * 1e-3
    q8_matmul.launches = quantize_sr_rows.launches = 0
    y, aux = ops.fused_qlinear(x, w, prng.PRNGKey(7))
    assert q8_matmul.launches == quantize_sr_rows.launches == 1
    y_p, aux_p = ops.fused_qlinear(x, w, prng.PRNGKey(7), use_kernels=False)
    assert torch.equal(y, y_p)
    assert all(torch.equal(aux[k], aux_p[k]) for k in aux)

    @contextlib.contextmanager
    def plain():
        names = {"q8_matmul": q8_matmul_plain,
                 "quantize_sr_rows": quantize_sr_rows_plain,
                 "quantize_sr_tensor": quantize_sr_tensor_plain}
        saved = {n: getattr(backend, n) for n in names}
        for n, fn in names.items():
            setattr(backend, n, fn)
        try:
            yield
        finally:
            for n, fn in saved.items():
                setattr(backend, n, fn)
    for quant in ("ptq", "psq", "bhq"):
        got = ops.fused_qlinear_bwd(x, w, g, prng.PRNGKey(3),
                                    grad_quantizer=quant, bhq_block=256)
        with plain():
            want = ops.fused_qlinear_bwd(x, w, g, prng.PRNGKey(3),
                                         grad_quantizer=quant, bhq_block=256)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), quant


def test_moe_serving_and_training_run_through_the_kernels(cuda):
    """Reduced granite-moe on the card: the dense and paged engines launch
    the int8 forward for every router and expert GEMM of every forward
    and emit the tokens of the same run on the CPU (plain versions); one
    ``fqt(psq,8)`` step launches the forward, dX and dW kernels once per
    GEMM, with the loss and ``aux`` of the CPU step within the
    cross-backend tolerance."""
    from repro_torch.configs import get_config
    from repro_torch.core import QuantPolicy
    from repro_torch.data import make_batch_for
    from repro_torch.engine import init_train_state, make_step_fn
    from repro_torch.kernels import fused_qboth_tn_matmul, fused_qlhs_matmul
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, cosine_schedule
    from repro_torch.serve import ServeEngine
    cfg = get_config("granite-moe-1b-a400m", smoke=True)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    per_fwd = cfg.n_layers * (4 + 1 + 3 * cfg.moe_experts) + 1
    for kw in ({}, dict(paged=True, page_size=8)):
        out = {}
        for dev in ("cpu", "cuda"):
            eng = ServeEngine(cfg, _tree_to(params, dev), slots=2,
                              max_seq=32, kv_quant=True, device=dev, **kw)
            fused_qlhs_matmul.launches = 0
            eng.submit([1, 2, 3], max_new=4)
            eng.submit(list(range(5, 20)), max_new=4)
            out[dev] = {r: c.tokens for r, c in eng.run().items()}
        fwd = eng.paged_forwards if kw else len(eng.step_times)
        assert fused_qlhs_matmul.launches == per_fwd * (2 + fwd)
        assert out["cuda"] == out["cpu"]
    mets = {}
    for dev in ("cpu", "cuda"):
        step = make_step_fn(model, QuantPolicy.fqt("psq", 8,
                                                   backend="kernel"),
                            adamw(), cosine_schedule(3e-3, 4, 1),
                            remat=False)
        state = init_train_state(model, adamw(), 0, device="cpu")
        state = type(state)(params=_tree_to(state.params, dev),
                            opt_state={k: (v if k == "t" else
                                           _tree_to(v, dev))
                                       for k, v in state.opt_state.items()},
                            step=state.step, rng=state.rng)
        fused_qlhs_matmul.launches = fused_qboth_tn_matmul.launches = 0
        fused_qlhs_matmul.launches_dx = 0
        _, m = step(state, _tree_to(make_batch_for(cfg, 4, 16, step=0), dev))
        mets[dev] = (float(m["loss"]), float(m["aux"]))
    assert fused_qlhs_matmul.launches == 2 * per_fwd
    assert fused_qlhs_matmul.launches_dx == per_fwd
    assert fused_qboth_tn_matmul.launches == per_fwd
    for a, b in zip(mets["cuda"], mets["cpu"]):
        assert abs(a - b) <= 5e-3 + 1e-3 * abs(b)
