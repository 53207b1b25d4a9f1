"""The pieces of a data-parallel step that need no process group, in
process: SR bits drawn from an offset equal the slice of the whole draw;
under a data group (``sharding/data.py``; a group object is only needed
for the per-tensor range's all-reduce, which these quantizers do not take)
a rank's PSQ codes, fused dX and BHQ codes of a batch-spanning operand
equal the rows of the whole batch's that it holds, bit for bit, and BHQ
blocks that would straddle ranks raise, while a replicated operand
quantizes on every rank as in the flat step; the loader hands each rank its rows of every microbatch; and
``quantize_sr_tensor``'s given-range mode equals its own-range mode on the
tensor's range and the Pallas kernel (interpret mode) on a wider one, bit
for bit.
"""

import contextlib
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import prng  # noqa: E402
from repro_torch.sharding import DataGroup, use_data_group  # noqa: E402
from repro_torch.sharding import data  # noqa: E402


@contextlib.contextmanager
def _rank(r, n=2, batch=True):
    """Rank ``r`` of a data group of ``n``, quantizing a batch-spanning
    operand (``batch``) or a replicated one."""
    with use_data_group(DataGroup(group=None, rank=r, size=n)):
        if not batch:
            yield
            return
        with data.batch_operand():
            yield


def test_bits_from_an_offset_are_the_slice_of_the_whole_draw():
    key = prng.PRNGKey(11)
    whole = prng.bits(key, (12, 5))
    for r in range(4):
        part = prng.bits(key, (3, 5), offset=r * 15)
        assert torch.equal(part, whole[3 * r:3 * r + 3])


def test_rank_rows_quantize_as_the_whole_batch():
    from repro_torch.core.bhq import quantize_bhq_stoch
    from repro_torch.core.quantizers import quantize_psq_stoch
    gen = torch.Generator().manual_seed(0)
    g = torch.randn(64, 24, generator=gen)
    g[5] *= 40.0                              # an outlier row
    key = prng.PRNGKey(3)
    psq = quantize_psq_stoch(g, key, 8)
    bhq = quantize_bhq_stoch(g, key, 5, block_rows=16)
    for r in range(2):
        rows = g[32 * r:32 * (r + 1)]
        with _rank(r):
            p = quantize_psq_stoch(rows, key, 8)
            b = quantize_bhq_stoch(rows, key, 5, block_rows=16)
        assert torch.equal(p.codes, psq.codes[32 * r:32 * (r + 1)])
        assert torch.equal(b.codes, bhq.codes[2 * r:2 * r + 2])
        assert torch.equal(b.inv_perm, bhq.inv_perm[2 * r:2 * r + 2])
    with _rank(1), pytest.raises(ValueError, match=r"32 rows per rank .* "
                                                   r"bhq_block=24"):
        quantize_bhq_stoch(g[32:], key, 5, block_rows=24)
    assert data.current() is None


def test_replicated_operand_quantizes_as_the_flat_step():
    """A weight-like operand, the same on every rank: the rank's draws
    start at 0 and its BHQ blocks are local, whatever its rows."""
    from repro_torch.core.bhq import quantize_bhq_stoch
    from repro_torch.core.quantizers import quantize_psq_stoch
    gen = torch.Generator().manual_seed(2)
    w = torch.randn(40, 24, generator=gen)
    key = prng.PRNGKey(9)
    psq = quantize_psq_stoch(w, key, 8)
    bhq = quantize_bhq_stoch(w, key, 5, block_rows=24)
    for r in range(4):
        with _rank(r, 4, batch=False):
            assert data.sr_offset(w.numel()) == 0
            p = quantize_psq_stoch(w, key, 8)
            b = quantize_bhq_stoch(w, key, 5, block_rows=24)
        assert torch.equal(p.codes, psq.codes)
        assert torch.equal(b.codes, bhq.codes)
    with _rank(1, 4):
        assert data.sr_offset(w.numel()) == w.numel()


def test_rank_rows_fused_dx_as_the_whole_batch():
    """PSQ dX through ``fused_qlhs_matmul``'s plain version: per-row
    ranges, SR bits from the rank's offset."""
    from repro_torch.core.backend import fused_fqt_dx
    from repro_torch.core.quantizers import quantize_ptq_det
    from repro_torch.core.registry import QuantizerSpec
    gen = torch.Generator().manual_seed(1)
    g = torch.randn(32, 40, generator=gen)
    wq = quantize_ptq_det(torch.randn(16, 40, generator=gen), 8)
    key, spec = prng.PRNGKey(5), QuantizerSpec("psq", 8)
    whole = fused_fqt_dx(g, key, spec, wq, backend="kernel")
    for r in range(4):
        with _rank(r, 4):
            part = fused_fqt_dx(g[8 * r:8 * r + 8], key, spec, wq,
                                backend="kernel")
        assert torch.equal(part, whole[8 * r:8 * r + 8])


def test_loader_hands_each_rank_its_microbatch_rows():
    from repro_torch.data import ShardedLoader
    from repro_torch.sharding import make_plan
    batch = {"tokens": torch.arange(8 * 3).reshape(8, 3),
             "positions": torch.arange(3 * 8 * 3).reshape(3, 8, 3),
             "odd": torch.arange(5 * 2).reshape(5, 2)}
    specs = make_plan({"data": 2, "model": 1}).batch_specs(
        {k: v for k, v in batch.items()})
    assert specs["odd"] == (None, None)       # 5 rows: replicated
    parts = [ShardedLoader(lambda s: batch, specs=specs, data=(r, 2),
                           accum_steps=2).get(0) for r in range(2)]
    for i in range(2):                        # microbatch i, rank by rank
        got = torch.cat([p["tokens"][2 * i:2 * i + 2] for p in parts])
        assert torch.equal(got, batch["tokens"][4 * i:4 * i + 4])
        got = torch.cat([p["positions"][:, 2 * i:2 * i + 2] for p in parts],
                        dim=1)
        assert torch.equal(got, batch["positions"][:, 4 * i:4 * i + 4])
    assert all(torch.equal(p["odd"], batch["odd"]) for p in parts)
    with pytest.raises(ValueError, match="whole shards"):
        ShardedLoader(lambda s: batch, specs=specs, data=(0, 2),
                      accum_steps=8).get(0)


def test_quantize_sr_tensor_given_range():
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from repro.kernels.quantize_sr import _tensor_kernel
    from repro_torch.kernels.quantize_sr import quantize_sr_tensor
    rng = np.random.default_rng(4)
    x = rng.standard_normal((16, 128)).astype(np.float32)
    rb = rng.integers(0, 2 ** 32, x.shape, dtype=np.uint64).astype(np.int64)
    xt, rt = torch.from_numpy(x), torch.from_numpy(rb)
    own = torch.stack(list(torch.aminmax(xt)))
    for a, b in zip(quantize_sr_tensor(xt, rt, 8),
                    quantize_sr_tensor(xt, rt, 8, own)):
        assert torch.equal(a, b)
    spec = pl.BlockSpec((16, 128), lambda i: (0, 0))
    one = pl.BlockSpec((1, 1), lambda i: (0, 0))
    for bits, (lo, hi) in ((8, (-6.5, 5.25)), (4, (-4.0, 9.0))):
        call = pl.pallas_call(
            functools.partial(_tensor_kernel, B=(1 << bits) - 1),
            grid=(1,), in_specs=[spec, spec, one, one], out_specs=spec,
            out_shape=jax.ShapeDtypeStruct(x.shape, jnp.int8),
            interpret=True)
        want = call(jnp.asarray(x), jnp.asarray(rb.astype(np.uint32)),
                    jnp.full((1, 1), lo, jnp.float32),
                    jnp.full((1, 1), hi, jnp.float32))
        codes, scale, zero = quantize_sr_tensor(
            xt, rt, bits, torch.tensor([lo, hi], dtype=torch.float32))
        np.testing.assert_array_equal(codes.numpy(), np.asarray(want))
        assert float(zero) == lo
        assert float(scale) == np.float32((1 << bits) - 1) / np.float32(
            hi - lo)
