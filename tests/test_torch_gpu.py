"""The port's CUDA kernels on the card, each against its plain PyTorch
version on the same inputs: the forward mode of ``fused_qlhs_matmul`` to
float32 round-off (max|d| <= 1e-6 * max|plain|; the kernel rounds every
operation explicitly, so it is expected to be exact), its dX/SR mode,
``fused_qboth_tn_matmul``, ``q8_matmul``, ``kv_dequant_rows``,
``kv_gather_pages`` and ``quantize_sr_rows``/``_tensor`` bit for bit
(page-0 tables, zero scales, SR bits across all 32 bits), short serving
runs (dense and paged) that must go through the serving kernels, and short
training runs (fused and unfused) that must go through the training
kernels.

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


@pytest.mark.parametrize("mkn", [(1, 2048, 2048), (8, 2048, 512),
                                 (128, 8192, 2048), (8, 2048, 49408),
                                 (37, 130, 67), (37, 67, 130), (3, 5, 3)])
def test_fused_qlhs_matmul_vs_plain(cuda, mkn):
    from repro_torch.kernels import fused_qlhs_matmul, fused_qlhs_matmul_plain
    gen = torch.Generator(device=cuda).manual_seed(sum(mkn))
    ops = _qlhs_operands(gen, *mkn)
    before = fused_qlhs_matmul.launches
    got = fused_qlhs_matmul(*ops, bits=8)
    assert fused_qlhs_matmul.launches == before + 1
    want = fused_qlhs_matmul_plain(*ops, bits=8)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


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


@pytest.mark.parametrize("mkn", [(512, 512, 512), (512, 1024, 512),
                                 (512, 10240, 512), (33, 67, 130),
                                 (1, 64, 49), (3, 5, 3)])
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
    fwd = (g, s, z, rb, w8.T.contiguous(), ab, bb, u)
    assert torch.equal(fused_qlhs_matmul(*fwd, bits=bits),
                       fused_qlhs_matmul_plain(*fwd, bits=bits))
    with pytest.raises(ValueError, match="contiguous"):
        fused_qlhs_matmul(g, s, z, rb, w8.T, ab, bb, u, bits=bits)


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


@pytest.mark.parametrize("kmn", [(512, 512, 512), (512, 1024, 512),
                                 (512, 512, 10240), (130, 33, 67),
                                 (64, 1, 49), (5, 3, 3)])
@pytest.mark.parametrize("bits_b", [5, 8])
def test_fused_qboth_tn_matmul_vs_plain(cuda, kmn, bits_b):
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


@pytest.mark.parametrize("mkn", [(512, 512, 512), (512, 1024, 512),
                                 (512, 10240, 512), (33, 67, 130),
                                 (1, 64, 49), (3, 5, 3)])
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
    from repro_torch.kernels import fused_qlhs_matmul, kv_dequant_rows
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine
    cfg = get_config("granite-3-2b", smoke=True)
    params = build_model(cfg).init(0, device="cpu")
    eng = ServeEngine(cfg, _tree_to(params, cuda), slots=2, max_seq=32,
                      kv_quant=True)
    ref = ServeEngine(cfg, params, slots=2, max_seq=32, kv_quant=True,
                      device="cpu")
    f0, k0 = fused_qlhs_matmul.launches, kv_dequant_rows.launches
    for e in (eng, ref):
        e.submit([1, 2, 3], max_new=4)
        e.submit(list(range(5, 20)), max_new=4)
    got, want = eng.run(), ref.run()
    assert fused_qlhs_matmul.launches > f0 and kv_dequant_rows.launches > k0
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
    step = make_step_fn(model, policy, adamw(), cosine_schedule(3e-3, 4, 1))
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
    step = make_step_fn(model, policy, adamw(), cosine_schedule(3e-3, 4, 1))
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
    """The paged engine on the card launches kv_gather_pages twice per
    layer per paged forward, never kv_dequant_rows, and emits the tokens
    of the same run on the CPU (plain versions)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import kv_dequant_rows, kv_gather_pages
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine
    cfg = get_config("granite-3-2b", smoke=True)
    params = build_model(cfg).init(0, device="cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(cfg, _tree_to(params, dev), slots=2, max_seq=32,
                          kv_quant=True, paged=True, page_size=8,
                          device=dev)
        kv_gather_pages.launches = kv_dequant_rows.launches = 0
        eng.submit([1, 2, 3], max_new=4)
        eng.submit(list(range(5, 20)), max_new=4)
        out[dev] = {r: c.tokens for r, c in eng.run().items()}
    assert kv_gather_pages.launches == 2 * cfg.n_layers * eng.paged_forwards
    assert eng.paged_forwards > 0 and kv_dequant_rows.launches == 0
    assert out["cuda"] == out["cpu"]
