"""The port's serving engine on the CPU: greedy tokens equal to the JAX
engine's on the reduced statquant-tx config (layernorm, gelu, qkv bias),
at equal pool size and submission order (per-tensor ``Q_f`` couples
co-resident slots, so only equal batches compare), plus the engine's
own contract: eviction, the CLI, and the slices it refuses."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import QuantPolicy as JaxPolicy  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import QuantPolicy  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402


def engine_parity(arch: str, kv_quant: bool = True):
    """Drive both engines with the same greedy workload (prompts from
    several length buckets, more requests than slots so slots are reused)
    and return the two completion dicts."""
    jcfg = jax_config(arch, smoke=True)
    jp = jax_build(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    je = JaxEngine(jcfg, jp, policy=JaxPolicy.qat(backend="native",
                                                  fused=True),
                   slots=3, max_seq=32, kv_quant=kv_quant, seed=0)
    te = ServeEngine(get_config(arch, smoke=True), tp,
                     policy=QuantPolicy.qat(backend="kernel"), slots=3,
                     max_seq=32, kv_quant=kv_quant, seed=0, device="cpu")
    rng = np.random.RandomState(1)
    for i in range(5):
        prompt = rng.randint(0, jcfg.vocab_size, int(rng.randint(2, 12)))
        je.submit(prompt, max_new=6)
        te.submit(prompt, max_new=6)
    return je.run(), te.run()


def test_engine_greedy_tokens_equal_jax_statquant():
    want, got = engine_parity("statquant-tx")
    assert sorted(got) == sorted(want)
    for rid in want:
        assert got[rid].tokens == want[rid].tokens, rid
        assert got[rid].reason == want[rid].reason


def _port_engine(**kw):
    cfg = get_config("granite-3-2b", smoke=True)
    from repro_torch.models import build_model
    params = build_model(cfg).init(0, device="cpu")
    return cfg, ServeEngine(cfg, params, device="cpu", **kw)


def test_engine_eviction_and_lane_limits():
    cfg, eng = _port_engine(slots=2, max_seq=12, kv_quant=True)
    r_long = eng.submit([5] * 10, max_new=50)     # fills its 12-row lane
    r_one = eng.submit([7, 8], max_new=1)         # done straight from prefill
    r_eos = eng.submit([9], max_new=40)
    done = eng.run()
    assert set(done) == {r_long, r_one, r_eos}
    # prefill samples 1 token at position 10, decode writes rows 10 and 11
    assert len(done[r_long].tokens) == 3 and done[r_long].reason == "length"
    assert len(done[r_one].tokens) == 1
    # the same greedy stream again, now with its 3rd token as EOS
    eos = done[r_eos].tokens[2]
    _, eng2 = _port_engine(slots=2, max_seq=12, kv_quant=True, eos_id=eos)
    eng2.submit([5] * 10, max_new=50)
    eng2.submit([7, 8], max_new=1)
    r = eng2.submit([9], max_new=40)
    out = eng2.run()[r]
    assert out.reason == "eos" and out.tokens[-1] == eos
    assert out.tokens == done[r_eos].tokens[:out.tokens.index(eos) + 1]
    with pytest.raises(ValueError, match="prompt length"):
        eng.submit([1] * 12)


def test_fp32_and_int8_caches_serve():
    for kv in (False, True):
        _, eng = _port_engine(slots=2, max_seq=16, kv_quant=kv)
        eng.submit([3, 4, 5], max_new=4)
        eng.submit([6], max_new=4, temperature=0.7, top_k=10)
        done = eng.run()
        assert all(len(c.tokens) == 4 for c in done.values())


def test_unported_engine_options_raise():
    cfg = get_config("granite-3-2b", smoke=True)
    from repro_torch.models import build_model
    params = build_model(cfg).init(0, device="cpu")
    with pytest.raises(NotImplementedError, match="paged"):
        ServeEngine(cfg, params, paged=True, device="cpu")
    with pytest.raises(NotImplementedError, match="sub-byte"):
        ServeEngine(cfg, params, weight_bits=4, device="cpu")
    with pytest.raises(NotImplementedError, match="checkpoint slice"):
        ServeEngine.from_checkpoint(cfg, "/nonexistent")
    with pytest.raises(NotImplementedError, match="not ported"):
        build_model(get_config("granite-moe-1b-a400m", smoke=True))


def test_cli_runs_on_cpu(capsys):
    from repro_torch.launch.serve import main
    done = main(["--device", "cpu", "--requests", "3", "--max-new", "3",
                 "--arch", "granite-3-2b"])
    assert len(done) == 3
    assert "[serve] 3 requests" in capsys.readouterr().out
