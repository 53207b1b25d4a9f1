"""Serving from bit-packed weights in the port on the CPU, held against the
JAX package: ``pack_dense_weights`` leaf by leaf (bit for bit, through
``interop.packed_from_jax``); ``ServeEngine(weight_bits=8|4)`` on the
``kernel`` backend (the packed kernels' plain versions here) against the
JAX engine with the same ``weight_bits`` under ``QuantPolicy.qat(backend=
"native")`` on reduced statquant-tx and granite-3-2b, greedy tokens equal,
fused and ``fused=False``; at 8 bits the port's packed engine against its
own fp32-weight engine (the same codes, so the same logits bit for bit);
the paged engine with packed weights against the JAX paged engine; the
CLI with ``--weight-bits 4``.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import QuantPolicy as JaxPolicy  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro.serve.engine import (  # noqa: E402
    pack_dense_weights as jax_pack_dense, weight_nbytes as jax_nbytes)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import QuantPolicy  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.kernels import PackedTensor  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve import (ServeEngine, pack_dense_weights,  # noqa: E402
                               weight_nbytes)

ARCHS = ("statquant-tx", "granite-3-2b")
_PARAMS = {}


def _params(arch):
    """(JAX params, the same as the port's CPU tensors), made once."""
    if arch not in _PARAMS:
        jp = jax_build(jax_config(arch, smoke=True)).init(
            jax.random.PRNGKey(0))
        _PARAMS[arch] = jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                            "cpu")
    return _PARAMS[arch]


def _prompts(vocab, sizes, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n).tolist() for n in sizes]


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


@pytest.mark.parametrize("bits", (8, 4, 2))
def test_pack_dense_weights_matches_jax(bits):
    jp, tp = _params("statquant-tx")
    jpk = jax_pack_dense(jp, bits)
    want = dict(_leaves(params_from_jax(jax.tree.map(np.asarray, jpk),
                                        "cpu")))
    got = dict(_leaves(pack_dense_weights(tp, bits)))
    assert sorted(got) == sorted(want)
    n_packed = 0
    for path, g in got.items():
        w = want[path]
        if isinstance(g, PackedTensor):
            n_packed += 1
            assert isinstance(w, PackedTensor), path
            assert (g.bits, g.kdim) == (w.bits, w.kdim) == (bits, g.kdim)
            for field in ("packed", "scale", "zero", "colsum"):
                np.testing.assert_array_equal(getattr(g, field).numpy(),
                                              getattr(w, field).numpy(),
                                              err_msg=f"{path}.{field}")
        else:
            np.testing.assert_array_equal(g.numpy(), w.numpy(), path)
    assert n_packed == 7           # q, k, v, o, fc1, fc2 stacks and lm_head
    # the port also keeps each packed weight's int32 column sums resident
    colsums = sum(g.colsum.numel() * 4 for g in got.values()
                  if isinstance(g, PackedTensor))
    assert weight_nbytes(pack_dense_weights(tp, bits)) == \
        jax_nbytes(jpk) + colsums
    with pytest.raises(ValueError, match="packable widths"):
        pack_dense_weights(tp, 3)


def _engines(arch, bits, fused, paged=False, **kw):
    jp, tp = _params(arch)
    jcfg, cfg = jax_config(arch, smoke=True), get_config(arch, smoke=True)
    extra = dict(paged=True, **kw) if paged else {}
    je = JaxEngine(jcfg, jp, policy=JaxPolicy.qat(backend="native",
                                                  fused=fused),
                   slots=3, max_seq=32, kv_quant=True, seed=0,
                   weight_bits=bits, **extra)
    te = ServeEngine(cfg, tp, policy=QuantPolicy.qat(backend="kernel",
                                                     fused=fused),
                     slots=3, max_seq=32, kv_quant=True, seed=0,
                     weight_bits=bits, device="cpu", **extra)
    return cfg, je, te


def _drive(eng, prompts, max_new=6):
    for p in prompts:
        eng.submit(p, max_new=max_new)
    out = eng.run()
    return {r: out[r].tokens for r in sorted(out)}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("bits", (8, 4))
@pytest.mark.parametrize("fused", [True, False])
def test_packed_engine_greedy_tokens_equal_jax(arch, bits, fused):
    cfg, je, te = _engines(arch, bits, fused)
    prompts = _prompts(cfg.vocab_size, (5, 7, 3, 6), seed=1)
    want, got = _drive(je, prompts), _drive(te, prompts)
    assert got == want
    assert all(isinstance(te.params["layers"]["mlp"][k]["w"], PackedTensor)
               for k in te.params["layers"]["mlp"])


def test_w8_engine_equals_the_fp32_weight_engine():
    """8-bit packing stores the codes the fp32-weight engine quantizes on
    every call, with the same affine pair and column sums: same tokens,
    and the same prefill logits bit for bit."""
    _, tp = _params("granite-3-2b")
    cfg = get_config("granite-3-2b", smoke=True)
    prompts = _prompts(cfg.vocab_size, (9, 4, 13), seed=3)
    outs = []
    for bits in (None, 8):
        eng = ServeEngine(cfg, tp, policy=QuantPolicy.qat(backend="kernel"),
                          slots=2, max_seq=32, kv_quant=True, seed=0,
                          weight_bits=bits, device="cpu")
        logits, _ = eng._prefill(np.asarray([prompts[0]]))
        outs.append((_drive(eng, prompts, 5), logits))
    assert outs[0][0] == outs[1][0]
    assert torch.equal(outs[0][1], outs[1][1])


def test_packed_paged_engine_matches_jax_and_keeps_packed_draft():
    """The paged engine with 4-bit packed weights, whole-prompt prefill:
    the JAX paged engine's tokens; its draft policy lowers only the
    activation width (the packed weights cannot be re-quantized)."""
    cfg, je, te = _engines("statquant-tx", 4, True, paged=True, page_size=4)
    prompts = _prompts(cfg.vocab_size, (6, 3, 7, 8), seed=5)
    assert _drive(te, prompts) == _drive(je, prompts)
    te.check_invariants()
    draft = te._draft_policy.resolve("layers.mlp.fc1")
    assert draft.fwd_weight.name == "int4w" and draft.fwd_act.bits == 4
    _, _, spec = _engines("statquant-tx", 4, True, paged=True, page_size=4,
                          spec_decode=True, spec_k=3)
    done = _drive(spec, prompts[:2], 5)
    assert all(len(t) == 5 for t in done.values())
    assert spec.spec_stats.spec_steps > 0


def test_cli_serves_packed_weights_on_cpu(capsys):
    from repro_torch.launch.serve import main
    done = main(["--device", "cpu", "--requests", "3", "--max-new", "3",
                 "--arch", "granite-3-2b", "--weight-bits", "4"])
    assert len(done) == 3
    out = capsys.readouterr().out
    assert "[serve] packed w4 weights:" in out and "[serve] 3 requests" in out


def test_packed_weights_param_tree_bytes():
    """Packing every dense kernel at 4 bits holds at most a quarter of the
    fp32 tree's bytes for those leaves (the JAX package's acceptance bar)."""
    cfg = get_config("statquant-tx", smoke=True)
    params = build_model(cfg).init(0, device="cpu")
    dense = sum(t.numel() * 4 for p, t in _leaves(params)
                if p.endswith("/w") and t.dim() >= 2)
    packed = sum(t.nbytes for _, t in _leaves(pack_dense_weights(params, 4))
                 if isinstance(t, PackedTensor))
    assert dense >= 4 * packed
