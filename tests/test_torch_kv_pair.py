"""The port's one-launch K and V reads on the CPU, held against the JAX
package.

On CPU tensors the pair wrappers ``kv_dequant_rows_kv`` and
``kv_gather_pages_kv`` run their plain versions; each side must equal the
reference bit for bit (IEEE division, tolerance 0): the Pallas kernel
``kv_dequant_rows`` in interpret mode behind JAX's ``dequant_kv_rows``
(scale clamp included), and the XLA twin ``kv_gather_pages_xla``.  Ragged
widths, a page size of 3, zero scales and the garbage page are among the
cases.  The pair equals two single-side calls, ``decode_attention`` and
``paged_decode_attention`` give the same outputs through the pair as one
side at a time (a cache codec registered without ``dequant_rows_kv``
included), and no launch counter moves on the CPU.
"""

import importlib

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.kv_cache import dequant_kv_rows as jax_dequant  # noqa: E402
from repro.kernels import kv_gather_pages_xla  # noqa: E402
from repro_torch import layers as tl  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (QuantPolicy, Quantizer,  # noqa: E402
                              dequant_kv_rows, dequant_kv_rows_kv,
                              quantize_kv_rows, register_quantizer)
from repro_torch.kernels import (kv_dequant_rows,  # noqa: E402
                                 kv_dequant_rows_kv, kv_gather_pages,
                                 kv_gather_pages_kv)
from repro_torch.models import build_model  # noqa: E402

_EPS = np.float32(1e-12)


def _t(a):
    return torch.from_numpy(np.array(a))


def _counts():
    return (kv_dequant_rows.launches, kv_dequant_rows_kv.launches,
            kv_gather_pages.launches, kv_gather_pages_kv.launches)


def _dense_side(rng, M, N, bits):
    """(codes (M, N) int8, scale (M,), zero (M,)) numpy, a zero scale in
    the first row and one more."""
    lo = -(1 << (bits - 1))
    codes = rng.integers(lo, -lo, (M, N)).astype(np.int8)
    scale = rng.uniform(0.5, 200.0, M).astype(np.float32)
    zero = rng.normal(size=M).astype(np.float32)
    scale[0] = scale[M // 2] = 0.0
    return codes, scale, zero


def _pool_side(rng, n_pages, P, D, bits):
    """(codes (n_pages, P, D), scale, zero (n_pages, P)) numpy: the garbage
    page 0 with zero scales, and one more zero-scale row."""
    lo = -(1 << (bits - 1))
    codes = rng.integers(lo, -lo, (n_pages, P, D)).astype(np.int8)
    scale = rng.uniform(0.5, 2.0, (n_pages, P)).astype(np.float32)
    zero = rng.normal(size=(n_pages, P)).astype(np.float32)
    scale[0] = 0.0
    scale[n_pages // 2, P // 2] = 0.0
    return codes, scale, zero


@pytest.mark.parametrize("mn", [(33, 130), (64, 512), (7, 48), (5, 40)])
@pytest.mark.parametrize("bits", [8, 4])
def test_kv_dequant_pair_matches_pallas(mn, bits):
    """Each side of the pair equals JAX's ``dequant_kv_rows`` through the
    Pallas kernel in interpret mode, and two single-side calls."""
    rng = np.random.default_rng(sum(mn) + bits)
    sides = [_dense_side(rng, *mn, bits) for _ in range(2)]
    before = _counts()
    got = kv_dequant_rows_kv(*((_t(c), _t(s[:, None]), _t(z[:, None]))
                               for c, s, z in sides), bits=bits)
    assert _counts() == before
    for (c, s, z), g in zip(sides, got):
        want = np.asarray(jax_dequant(jnp.asarray(c), jnp.asarray(s),
                                      jnp.asarray(z), bits,
                                      backend="pallas", interpret=True))
        assert g.shape == mn and g.dtype == torch.float32
        assert bool(torch.isfinite(g).all())
        np.testing.assert_array_equal(g.numpy(), want)
        single = kv_dequant_rows(_t(c), _t(np.maximum(s, _EPS)[:, None]),
                                 _t(z[:, None]), bits)
        assert torch.equal(g, single)
    assert _counts() == before


def test_dequant_kv_rows_kv_equals_two_calls_on_every_backend():
    """The codec's pair form, over the cache layout's leading axes, equals
    ``dequant_kv_rows`` a side on both backends."""
    rng = np.random.default_rng(5)
    sides = [tuple(_t(a).reshape(3, 4, *a.shape[1:])
                   for a in _dense_side(rng, 12, 40, 8)) for _ in range(2)]
    for backend in ("simulate", "kernel"):
        got = dequant_kv_rows_kv(*sides, backend=backend)
        for side, g in zip(sides, got):
            assert g.shape == (3, 4, 40)
            assert torch.equal(g, dequant_kv_rows(*side, backend=backend))


@pytest.mark.parametrize("P,D,bits", [(8, 32, 8), (16, 48, 8), (3, 40, 8),
                                      (4, 8, 4), (5, 17, 4)])
def test_kv_gather_pair_matches_reference(P, D, bits):
    """Each side of the pair equals ``kv_gather_pages_xla`` through one
    table (idle lanes, unallocated blocks, a repeated page), and a
    single-side call."""
    rng = np.random.default_rng(P * D + bits)
    n_pages, B, nb = 10, 3, 4
    sides = [_pool_side(rng, n_pages, P, D, bits) for _ in range(2)]
    table = rng.integers(0, n_pages, (B, nb)).astype(np.int32)
    table[0] = 0                           # an idle lane
    table[1, 2:] = 0                       # unallocated blocks
    table[2, 1] = table[2, 0]              # a repeated page
    before = _counts()
    t_sides = [tuple(_t(a) for a in side) for side in sides]
    got = kv_gather_pages_kv(*t_sides, _t(table), bits=bits)
    assert _counts() == before
    for side, t_side, g in zip(sides, t_sides, got):
        want = np.asarray(kv_gather_pages_xla(
            *(jnp.asarray(a) for a in side), jnp.asarray(table), bits=bits))
        assert g.shape == (B, nb * P, D)
        assert bool(torch.isfinite(g).all())
        np.testing.assert_array_equal(g.numpy(), want)
        assert torch.equal(g, kv_gather_pages(*t_side, _t(table), bits))
    assert _counts() == before


def test_pair_wrappers_refuse_unequal_sides():
    rng = np.random.default_rng(0)
    k = tuple(_t(a) for a in _dense_side(rng, 6, 32, 8))
    v = tuple(_t(a) for a in _dense_side(rng, 6, 48, 8))
    with pytest.raises(ValueError, match="equal shapes"):
        kv_dequant_rows_kv((k[0], k[1][:, None], k[2][:, None]),
                           (v[0], v[1][:, None], v[2][:, None]))
    pk = tuple(_t(a) for a in _pool_side(rng, 4, 4, 16, 8))
    pv = tuple(_t(a) for a in _pool_side(rng, 5, 4, 16, 8))
    with pytest.raises(ValueError, match="equal shapes"):
        kv_gather_pages_kv(pk, pv, torch.zeros((2, 2), dtype=torch.int32))


class _PerSideCodec(Quantizer):
    """The int8 KV codec without ``dequant_rows_kv``: read a side at a
    time through the ``quantize_rows``/``dequant_rows`` protocol."""

    name = "kv_int8_per_side"
    stochastic = False
    reads = 0

    def quantize_rows(self, x, bits: int = 8):
        return quantize_kv_rows(x, bits)

    def dequant_rows(self, codes8, scale, zero, bits: int = 8, *,
                     backend: str = "simulate"):
        type(self).reads += 1
        return dequant_kv_rows(codes8, scale, zero, bits, backend=backend)


register_quantizer(_PerSideCodec.name, _PerSideCodec(), overwrite=True)


@pytest.fixture(scope="module")
def granite():
    """The reduced granite-3-2b config and layer 0's attention params."""
    cfg = get_config("granite-3-2b", smoke=True)
    params = build_model(cfg).init(0, device="cpu")
    return cfg, {k: {n: t[0] for n, t in w.items()}
                 for k, w in params["layers"]["attn"].items()}


def _filled_cache(cfg, rng, B, S):
    cache = tl.init_kv_cache_quant(cfg, B, S)
    for side in ("k", "v"):
        rows = rng.normal(size=(B, S, cfg.n_kv_heads * cfg.hd))
        c, s, z = quantize_kv_rows(_t(rows.astype(np.float32)))
        s[0, -1] = 0.0                     # a degenerate row
        cache[side] = {"codes": c, "scale": s, "zero": z}
    return cache


@pytest.mark.parametrize("backend", ["kernel", "simulate"])
def test_decode_attention_pair_equals_per_side_codec(granite, backend):
    """One int8-KV decode step through the codec's pair and through a codec
    without it: the same output and cache, and only the second reads a
    side at a time."""
    cfg, attn = granite
    policy = QuantPolicy.qat(backend=backend)
    rng = np.random.default_rng(11)
    cache = _filled_cache(cfg, rng, 2, 8)
    x = _t(rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32))
    index = torch.tensor([3, 6])
    before = _counts()
    out = {}
    for codec in ("kv_int8", _PerSideCodec.name):
        reads = _PerSideCodec.reads
        c = {s: {n: t.clone() for n, t in side.items()}
             for s, side in cache.items()}
        out[codec] = tl.decode_attention(attn, x, c, index, None, policy,
                                         cfg, kv_quant=codec)
        n = _PerSideCodec.reads - reads
        assert n == (2 if codec == _PerSideCodec.name else 0)
    (y1, c1), (y2, c2) = out.values()
    assert torch.equal(y1, y2)
    for s in ("k", "v"):
        for n in ("codes", "scale", "zero"):
            assert torch.equal(c1[s][n], c2[s][n])
    assert bool(torch.isfinite(y1).all())
    assert _counts() == before


@pytest.mark.parametrize("backend", ["kernel", "simulate"])
@pytest.mark.parametrize("C", [1, 3])
def test_paged_decode_attention_pair_equals_per_side(granite, backend, C,
                                                     monkeypatch):
    """A paged step (decode and a 3-token slab) through the pair gather and
    through ``kv_gather_pages`` a side: the same output and pool."""
    cfg, attn = granite
    policy = QuantPolicy.qat(backend=backend)
    rng = np.random.default_rng(13 + C)
    P, n_pages = 4, 7
    pool = tl.init_paged_kv_pool(cfg, n_pages, P)
    full = _filled_cache(cfg, rng, n_pages, P)
    full["k"]["scale"][0] = 0.0            # the garbage page's rows
    for s in ("k", "v"):
        for n in ("codes", "scale", "zero"):
            pool[s][n].copy_(full[s][n])
    table = torch.tensor([[1, 2, 0], [3, 5, 6]], dtype=torch.int32)
    start = torch.tensor([5, 2])
    x = _t(rng.normal(size=(2, C, cfg.d_model)).astype(np.float32))
    attention = importlib.import_module("repro_torch.layers.attention")

    def per_side(k, v, table, bits=8):
        return tuple(kv_gather_pages(*side, table, bits) for side in (k, v))

    before = _counts()
    out = []
    for gather in (None, per_side):
        if gather is not None:
            monkeypatch.setattr(attention, "kv_gather_pages_kv", gather)
            monkeypatch.setattr(attention, "kv_gather_pages_kv_plain",
                                gather)
        p = {s: {n: t.clone() for n, t in side.items()}
             for s, side in pool.items()}
        out.append(tl.paged_decode_attention(attn, x, p, table, start, None,
                                             policy, cfg))
    (y1, p1), (y2, p2) = out
    assert torch.equal(y1, y2) and bool(torch.isfinite(y1).all())
    for s in ("k", "v"):
        for n in ("codes", "scale", "zero"):
            assert torch.equal(p1[s][n], p2[s][n])
    assert _counts() == before
