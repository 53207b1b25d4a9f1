"""The port's CUDA kernels on the card, each against its plain PyTorch
version on the same inputs: ``fused_qlhs_matmul`` to float32 round-off
(max|d| <= 1e-6 * max|plain|; the kernel rounds every operation
explicitly, so it is expected to be exact), ``kv_dequant_rows`` bit for
bit, and a short serving run that must go through both kernels.

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


def test_fused_qlhs_matmul_refuses_training_modes_on_card(cuda):
    from repro_torch.kernels import fused_qlhs_matmul
    gen = torch.Generator(device=cuda).manual_seed(0)
    x, sa, za, _, w8, ab, bb, u = _qlhs_operands(gen, 4, 64, 32)
    with pytest.raises(NotImplementedError, match="training slice"):
        fused_qlhs_matmul(x, sa, za, None, w8.T.contiguous(), ab, bb,
                          torch.zeros(64, device=cuda), bits=8, trans_b=True)
    with pytest.raises(ValueError, match="contiguous"):
        fused_qlhs_matmul(x[:, ::2], sa, za, None, w8[::2], ab, bb, u,
                          bits=8)


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
