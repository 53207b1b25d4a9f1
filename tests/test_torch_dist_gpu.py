"""The distribution slice's kernels on the card (``gpu`` marker; every test
skips elsewhere, decided in the fixture): the compressed all-reduce on a
one-rank NCCL group through ``quantize_sr_rows`` against the same
exchange with the plain quantize, bit for bit, 2 launches a leaf; and
``quantize_sr_tensor`` given the tensor's own range against its in-kernel
range, and given a wider range against its plain version, bit for bit.

Run on a machine with an H100 and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_dist_gpu.py
"""

import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) with the CUDA toolkit")
    return torch.device("cuda")


@pytest.fixture
def nccl_group(cuda, tmp_path):
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed
    init_distributed("cuda", f"file://{tmp_path}/store", 0, 1)
    yield dist.group.WORLD
    dist.destroy_process_group()


def test_compressed_psum_kernel_vs_plain(nccl_group, monkeypatch):
    import repro_torch.core.compression as comp
    from repro_torch import prng
    from repro_torch.kernels import quantize_sr as q
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in ((512, 10240), (33, 7)):
        x = torch.randn(shape, generator=gen, device="cuda") * 1e-3
        key = prng.PRNGKey(5)
        q.quantize_sr_rows.launches = 0
        got = comp.compressed_psum(x, key, nccl_group, bits=8)
        assert q.quantize_sr_rows.launches == 2
        with monkeypatch.context() as m:
            m.setattr(comp, "quantize_sr_rows", q.quantize_sr_rows_plain)
            want = comp.compressed_psum(x, key, nccl_group, bits=8)
        assert torch.equal(got, want)
        # two stochastic roundings: at most a code step each, plus
        # round-off
        assert float((got - x).abs().max()) <= 2.01 * float(
            x.max() - x.min()) / 255


def test_quantize_sr_tensor_given_range(cuda):
    from repro_torch.kernels import quantize_sr as q
    gen = torch.Generator(device="cuda").manual_seed(1)
    for M, N in ((512, 512), (512, 10240), (33, 130)):
        x = torch.randn(M, N, generator=gen, device="cuda")
        rb = torch.randint(0, 2 ** 32, (M, N), generator=gen, device="cuda",
                           dtype=torch.int64)
        own = torch.stack(list(torch.aminmax(x)))
        wide = own + torch.tensor([-0.5, 0.25], device="cuda")
        for a, b in zip(q.quantize_sr_tensor(x, rb, 8),
                        q.quantize_sr_tensor(x, rb, 8, own)):
            assert torch.equal(a, b)
        for bits in (4, 8):
            for a, b in zip(q.quantize_sr_tensor(x, rb, bits, wide),
                            q.quantize_sr_tensor_plain(x, rb, bits, wide)):
                assert torch.equal(a, b)
