"""Paged int8 KV serving in the port on the CPU, held against the JAX
package.

  * ``kv_gather_pages_plain`` (what the wrapper runs on a CPU tensor)
    against the reference's XLA twin ``kv_gather_pages_xla``, bit for bit:
    page-0 repeats, zero scales, ragged page sizes and widths, 8 and 4
    bits.  (The reference's own Pallas-vs-twin test is slow-marked; the
    twin is held equal to the kernel there.)
  * The port's paged engine against the JAX paged engine on reduced
    statquant-tx under ``QuantPolicy.exact()``: the same tokens with
    whole-prompt prefill, chunked prefill, prefix reuse with copy-on-write,
    preemption, and speculative decode (k = 3); and the port's paged
    tokens equal to the port's dense engine's.
  * ``PagePool`` / ``PrefixCache`` refcounts and LRU, the engine's
    invariants under churn, and its refusals.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import QuantPolicy as JaxPolicy  # noqa: E402
from repro.kernels import kv_gather_pages_xla  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import QuantPolicy, kv_fresh_code  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.kernels import (kv_gather_pages,  # noqa: E402
                                 kv_gather_pages_plain)
from repro_torch.serve import (PagedServeEngine, PagePool,  # noqa: E402
                               PrefixCache, ServeEngine, greedy_accept)
from repro_torch.serve.paged import GARBAGE_PAGE  # noqa: E402
from torch_one_thread import one_intra_op_thread  # noqa: E402,F401

JCFG = jax_config("statquant-tx", smoke=True)
CFG = get_config("statquant-tx", smoke=True)
JPARAMS = jax_build(JCFG).init(jax.random.PRNGKey(0))
PARAMS = params_from_jax(jax.tree.map(np.asarray, JPARAMS), "cpu")


# ---------------------------------------------------------------------------
# kv_gather_pages: plain version vs the reference's twin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P,D,bits", [(8, 32, 8), (16, 48, 8), (3, 40, 8),
                                      (4, 8, 4), (5, 17, 4)])
def test_kv_gather_plain_matches_reference(P, D, bits):
    rng = np.random.default_rng(P * D + bits)
    n_pages, B, nb = 10, 3, 4
    lo = -(1 << (bits - 1))
    codes = rng.integers(lo, -lo, (n_pages, P, D)).astype(np.int8)
    scale = rng.uniform(0.5, 2.0, (n_pages, P)).astype(np.float32)
    zero = rng.normal(size=(n_pages, P)).astype(np.float32)
    scale[0] = 0.0                         # the garbage page: zero scales
    scale[3, 1] = 0.0
    table = rng.integers(0, n_pages, (B, nb)).astype(np.int32)
    table[0, 0] = table[1, 2] = table[2, 3] = 0
    table[2, 1] = table[2, 0]              # a page repeated in one table
    want = np.asarray(kv_gather_pages_xla(
        jnp.asarray(codes), jnp.asarray(scale), jnp.asarray(zero),
        jnp.asarray(table), bits=bits))
    args = [torch.from_numpy(a) for a in (codes, scale, zero, table)]
    got = kv_gather_pages_plain(*args, bits=bits)
    assert got.shape == (B, nb * P, D) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper runs the plain version on a CPU tensor
    assert torch.equal(kv_gather_pages(*args, bits=bits), got)


def test_fresh_pool_gathers_exact_zeros():
    from repro_torch.layers import init_paged_kv_pool
    pool = init_paged_kv_pool(CFG, 3, 4)
    assert int(pool["k"]["codes"][0, 0, 0]) == kv_fresh_code(8)
    table = torch.zeros((2, 2), dtype=torch.int32)
    out = kv_gather_pages_plain(pool["k"]["codes"], pool["k"]["scale"],
                                pool["k"]["zero"], table)
    assert float(out.abs().max()) == 0.0


# ---------------------------------------------------------------------------
# The paged engine against the JAX paged engine and the port's dense engine
# ---------------------------------------------------------------------------

def _prompts(sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(0, CFG.vocab_size, size=n)) for n in sizes]


def _cow_prompts():
    """Two prompts sharing a 13-token prefix, and two extensions of the
    first past a partial page (page size 4): prefix hits and a
    copy-on-write of the divergence page."""
    rng = np.random.default_rng(4)
    base = list(rng.integers(0, CFG.vocab_size, size=13))
    prompts = [base + list(rng.integers(0, CFG.vocab_size, size=n))
               for n in (4, 6)]
    prompts += [prompts[0] + list(rng.integers(0, CFG.vocab_size, size=n))
                for n in (3, 5)]
    return prompts


CASES = {
    "whole": (_prompts((3, 7, 5, 9), seed=1), dict(temperature=0.7)),
    "chunked": (_prompts((13, 9, 17), seed=3),
                dict(prefill_chunk=4, page_size=4)),
    "prefix_cow": (_cow_prompts(), dict(page_size=4)),
    "preemption": (_prompts((7, 12, 5), seed=5),
                   dict(max_new=10, page_size=4, pages=1 + 8,
                        prefill_chunk=4)),
    "spec": (_prompts((5, 9, 3), seed=7),
             dict(max_new=9, spec_decode=True, spec_k=3)),
}


def _drive(eng, prompts, max_new, temperature):
    for p in prompts:
        eng.submit(p, max_new=max_new, temperature=temperature, top_k=8)
    out = eng.run()
    return {r: out[r].tokens for r in sorted(out)}


def _run(engine_cls, params, policy, paged, prompts, max_new=6,
         temperature=0.0, **kw):
    extra = dict(paged=True, **kw) if paged else {}
    if engine_cls is ServeEngine:
        extra["device"] = "cpu"
    eng = engine_cls(JCFG if engine_cls is JaxEngine else CFG, params,
                     policy=policy, slots=2, max_seq=32, kv_quant=True,
                     seed=0, **extra)
    return _drive(eng, prompts, max_new, temperature), eng


@pytest.mark.parametrize("case", sorted(CASES))
def test_paged_engine_matches_jax_and_dense(case):
    prompts, kw = CASES[case]
    kw = dict(kw)
    max_new = kw.pop("max_new", 6)
    temperature = kw.pop("temperature", 0.0)
    want, _ = _run(JaxEngine, JPARAMS, JaxPolicy.exact(), True, prompts,
                   max_new, temperature, **kw)
    got, eng = _run(ServeEngine, PARAMS, QuantPolicy.exact(), True, prompts,
                    max_new, temperature, **kw)
    assert isinstance(eng, PagedServeEngine)
    eng.check_invariants()
    assert got == want
    dense, _ = _run(ServeEngine, PARAMS, QuantPolicy.exact(), False, prompts,
                    max_new, temperature)
    assert got == dense
    st = eng.pool_stats()
    if case == "prefix_cow":
        assert st["prefix_hits"] >= 2 and st["cow_copies"] >= 1
    if case == "preemption":
        assert st["preemptions"] >= 1
    if case == "spec":
        sp = eng.spec_stats
        assert sp.spec_steps > 0 and sp.emitted >= sp.spec_steps
    if case == "chunked":
        assert st["paged_forwards"] > 0


def test_paged_engine_quantized_forward_matches_dense():
    """Under ``QuantPolicy.qat`` on the ``kernel`` backend (plain versions
    here), whole-prompt prefill and one-token steps: the paged engine
    emits the dense engine's tokens, through one paged forward per decode
    step."""
    prompts = _prompts((4, 11, 2, 8, 6, 13), seed=2)
    pol = QuantPolicy.qat(backend="kernel")
    paged, eng = _run(ServeEngine, PARAMS, pol, True, prompts, 8,
                      page_size=8)
    dense, deng = _run(ServeEngine, PARAMS, pol, False, prompts, 8)
    assert paged == dense
    assert eng.paged_forwards == len(eng.step_times) == len(deng.step_times)
    eng._prefix.clear(eng.pool_host)
    assert eng.pool_host.in_use == 0


# ---------------------------------------------------------------------------
# PagePool / PrefixCache invariants and the engine's contract
# ---------------------------------------------------------------------------

def test_page_pool_refcounts():
    pool = PagePool(6, 4)
    a, b = pool.alloc(), pool.alloc()
    assert a != GARBAGE_PAGE and b != GARBAGE_PAGE and a != b
    assert pool.in_use == 2
    pool.incref(a)
    pool.decref(a)
    assert pool.in_use == 2                   # still held once
    pool.decref(a)
    assert pool.in_use == 1                   # freed
    pool.incref(GARBAGE_PAGE)                 # no-ops on the garbage page
    pool.decref(GARBAGE_PAGE)
    got = [pool.alloc() for _ in range(10)]
    assert got.count(None) == 6               # 4 real pages, then dry
    pool.check([[b]], [tuple(p for p in got if p is not None)])
    with pytest.raises(AssertionError, match="refcount drift"):
        pool.check([], [])
    with pytest.raises(ValueError, match="garbage page"):
        PagePool(1, 4)


def test_prefix_cache_lru_and_refcounts():
    pool = PagePool(10, 4)
    cache = PrefixCache(max_entries=2)
    pages = [pool.alloc() for _ in range(3)]
    cache.register((1, 2, 3, 4), (pages[0],), pool)
    cache.register((1, 2, 3, 4, 5, 6, 7, 8), (pages[0], pages[1]), pool)
    assert pool.refs[pages[0]] == 3          # owner + two entries
    m, got = cache.lookup((1, 2, 3, 4, 5, 6, 7, 8, 9))
    assert m == 8 and got == (pages[0], pages[1])
    assert cache.lookup((1, 2, 3, 4, 5))[0] == 4
    assert cache.lookup((1, 2, 3, 4))[0] == 0     # strictly shorter only
    assert cache.lookup((9, 9, 9, 9, 9))[0] == 0
    cache.register((7, 7, 7, 7), (pages[2],), pool)   # evicts the LRU
    assert len(cache.entries) == 2 and cache.evictions == 1
    # the 8-token entry was looked up least recently
    assert (1, 2, 3, 4, 5, 6, 7, 8) not in cache.entries
    assert pool.refs[pages[1]] == 1
    cache.clear(pool)
    assert pool.refs[pages[0]] == 1 and pool.refs[pages[1]] == 1
    for p in pages:
        pool.decref(p)
    assert pool.in_use == 0


def test_churn_invariants_and_refusals():
    eng = ServeEngine(CFG, PARAMS, policy=QuantPolicy.exact(), slots=3,
                      max_seq=32, kv_quant=True, seed=0, paged=True,
                      page_size=4, pages=1 + 14, prefill_chunk=8,
                      prefix_entries=4, device="cpu")
    rng = np.random.default_rng(6)
    shared = list(rng.integers(0, CFG.vocab_size, size=9))
    for _ in range(2):
        for n in (3, 6, 2, 9):
            eng.submit(shared + list(rng.integers(0, CFG.vocab_size,
                                                  size=n)), max_new=5)
        while eng.queued or eng.active_slots:
            eng.step()
            eng.check_invariants()
        assert len(eng.run()) == 4
    registry = {p for pages in eng._prefix.registered_pages() for p in pages}
    assert eng.pool_host.in_use == len(registry)
    with pytest.raises(ValueError, match="kv_quant"):
        ServeEngine(CFG, PARAMS, slots=2, max_seq=16, kv_quant=False,
                    paged=True, device="cpu")
    with pytest.raises(ValueError, match="multiple of page_size"):
        ServeEngine(CFG, PARAMS, slots=2, max_seq=18, kv_quant=True,
                    paged=True, page_size=4, device="cpu")
    small = ServeEngine(CFG, PARAMS, policy=QuantPolicy.exact(), slots=1,
                        max_seq=16, kv_quant=True, paged=True, page_size=4,
                        pages=2, device="cpu")
    small.submit(list(range(1, 12)), max_new=4)
    with pytest.raises(RuntimeError, match="page pool"):
        small.run()
    assert greedy_accept(np.array([5, 6]), np.array([5, 6, 7])) == [5, 6, 7]
    assert greedy_accept(np.array([5, 6]), np.array([5, 9, 7])) == [5, 9]
    assert greedy_accept(np.array([4, 6]), np.array([5, 6, 7])) == [5]


def test_cli_serves_paged_on_cpu(capsys):
    from repro_torch.launch.serve import main
    done = main(["--device", "cpu", "--requests", "3", "--max-new", "4",
                 "--paged", "--page-size", "4", "--prefill-chunk", "8",
                 "--spec-decode", "--spec-k", "2"])
    assert len(done) == 3 and all(len(c.tokens) == 4 for c in done.values())
    out = capsys.readouterr().out
    assert "[serve] paged:" in out and "[serve] spec:" in out
    with pytest.raises(SystemExit):
        main(["--device", "cpu", "--spec-decode"])


def test_paged_write_index_last_write_wins():
    """Rows of one step that share a pool row (a chunk's padding rows in
    unallocated blocks, all on the garbage page; idle lanes' one-token
    rows, all on page 0 row 0) all carry the last one's value, as the
    reference's in-order scatter leaves it; positions clamp to the
    table's span."""
    from repro_torch.layers import paged_write_index
    table = torch.tensor([[3, 0, 0, 0]], dtype=torch.int32)
    offs, pids, rows, src = paged_write_index(table, torch.tensor([0]), 8,
                                              5, 2)
    assert offs.tolist() == [list(range(8))]
    assert pids.tolist() == [[3, 3, 0, 0, 0, 0, 0, 0]]
    assert rows.tolist() == [[0, 1, 0, 1, 0, 1, 0, 1]]
    assert src.tolist() == [0, 1, 6, 7, 6, 7, 6, 7]
    want = np.asarray(jnp.zeros((5, 2)).at[
        jnp.asarray(pids.numpy()), jnp.asarray(rows.numpy())].set(
        jnp.arange(8.0).reshape(1, 8)))
    got = torch.zeros((5, 2))
    got[pids, rows] = torch.arange(8.0)[src].reshape(1, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    _, pids, rows, src = paged_write_index(table, torch.tensor([9]), 1, 5, 2)
    assert src.tolist() == [0] and pids.tolist() == [[0]]
    assert rows.tolist() == [[1]]
    # a live lane between two idle ones: the idle lanes write page 0 row 0
    lanes = torch.tensor([[0, 0, 0, 0], [3, 0, 0, 0], [0, 0, 0, 0]],
                         dtype=torch.int32)
    _, pids, rows, src = paged_write_index(lanes, torch.tensor([0, 1, 0]),
                                           1, 5, 2)
    assert pids.tolist() == [[0], [3], [0]] and rows.tolist() == [[0], [1],
                                                                  [0]]
    assert src.tolist() == [2, 1, 2]


def test_last_write_makes_every_scatter_order_in_order():
    """Values taken through ``last_write`` leave the same pool whichever
    of the writes to a shared target lands last (a CUDA scatter promises
    none): the in-order scatter's pool."""
    import itertools

    from repro_torch.layers.attention import last_write
    flat = torch.tensor([3, 0, 3, 1, 0, 3])
    vals = torch.arange(1.0, 7.0)
    src = last_write(flat, 5)
    assert src.tolist() == [5, 4, 5, 3, 4, 5]
    want = torch.zeros(5)
    for i in range(6):
        want[flat[i]] = vals[i]
    for perm in itertools.permutations(range(6)):
        p = torch.tensor(perm)
        got = torch.zeros(5)
        for i in p.tolist():
            got[flat[i]] = vals[src][i]
        assert torch.equal(got, want), perm
