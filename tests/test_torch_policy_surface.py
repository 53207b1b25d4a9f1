"""The port's policy surface against the JAX package's: the precision-plan
interchange (``overrides_to_json`` / ``overrides_from_json``, read both
ways to the same ``spec_table``), ``launch/train.py --override-file``,
the legacy ``mode`` spelling, the exemption registry and its markers
(``core/exempt.py``), and ``Model.quant_paths`` / ``input_specs``."""

import contextlib
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.exempt as jax_exempt  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs.base import SHAPES as JAX_SHAPES  # noqa: E402
from repro.core import QuantPolicy as JaxPolicy  # noqa: E402
from repro.core.policy import (  # noqa: E402
    overrides_from_json as jax_from_json)
from repro.core.policy import overrides_to_json as jax_to_json  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import model_quant_paths as jax_paths  # noqa: E402
import repro_torch.core.exempt as exempt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.core import QuantPolicy, fqt_matmul  # noqa: E402
from repro_torch.core.policy import (overrides_from_json,  # noqa: E402
                                     overrides_to_json)
from repro_torch.models import build_model, model_quant_paths  # noqa: E402
from repro_torch.optim import tree_map  # noqa: E402

# a plan touching every override form: exact pins, blanket bits, partial
# and named role specs with params, the fwd shorthand
PLAN = (
    (r"lm_head", "exact"),
    (r"layers\.attn\.", 6),
    (r"layers\.mlp\.", {"agrad": ("bhq", 4, {"block_rows": 32})}),
    (r"layers\.mlp\.fc2", {"wgrad": "ptq:7", "fwd": "ptq_det:8"}),
    (r"layers\.attn\.wo", {"bits": 5, "agrad": {"name": "psq"}}),
)


def test_plans_read_both_ways_to_the_same_spec_table():
    paths = model_quant_paths(get_config("statquant-tx"))
    assert paths == jax_paths(jax_config("statquant-tx"))
    port_json = json.loads(json.dumps(overrides_to_json(PLAN)))
    jax_json = json.loads(json.dumps(jax_to_json(PLAN)))
    assert port_json == jax_json
    want = JaxPolicy.fqt("psq", 8, overrides=PLAN).spec_table(paths)
    for doc in (port_json, jax_json, {"overrides": port_json}):
        got = QuantPolicy.fqt("psq", 8, overrides=overrides_from_json(doc))
        assert got.spec_table(paths) == want
        back = JaxPolicy.fqt("psq", 8, overrides=jax_from_json(doc))
        assert back.spec_table(paths) == want
    as_dict = {p: v for p, v in PLAN}
    assert (QuantPolicy.fqt("psq", 8, overrides=overrides_from_json(as_dict))
            .spec_table(paths) == want)
    assert len({d for _, d in want}) > 3


def test_override_file_is_read_before_the_cli_overrides(tmp_path, capsys):
    from repro_torch.launch.train import main
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps({"overrides": jax_to_json(PLAN)}))
    hist = main(["--device", "cpu", "--steps", "1", "--batch", "2", "--seq",
                 "8", "--quant", "psq", "--grad-bits", "8",
                 "--override-file", str(plan), "--override",
                 "layers.attn.wo=exact"])
    assert len(hist) == 1
    out = capsys.readouterr().out
    overrides = jax_from_json(jax_to_json(PLAN)) + (("layers.attn.wo",
                                                     "exact"),)
    want = JaxPolicy.fqt("psq", 8, bhq_block=256,
                         overrides=overrides).spec_table(
        jax_paths(jax_config("statquant-tx", smoke=True)))
    for path, desc in want:
        assert f"  {path:32s} {desc}" in out
    assert f"  {'layers.attn.wo':32s} exact" in out
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps([["x", {"nope": 1}]]))
    with pytest.raises(SystemExit):
        main(["--device", "cpu", "--steps", "1", "--override-file",
              str(bad)])


def test_mode_alias_and_backend_resolution():
    for backend in ("simulate", "native", "kernel"):
        assert QuantPolicy.fqt("psq", 8, mode=backend).mode == backend
        assert QuantPolicy.qat(mode=backend).backend == backend
    assert QuantPolicy.qat(mode="native", backend="kernel").backend == \
        "kernel"
    assert QuantPolicy.qat().backend == JaxPolicy.qat().backend == "simulate"
    with pytest.raises(ValueError, match="invalid mode='tpu'"):
        QuantPolicy.qat(mode="tpu")
    with pytest.raises(ValueError, match="invalid backend='tpu'"):
        QuantPolicy.fqt("psq", 8, mode="kernel", backend="tpu")
    with pytest.raises(ValueError, match="invalid mode='tpu'"):
        JaxPolicy.qat(mode="tpu")


@pytest.mark.parametrize("call", [
    lambda m: m.fp_exempt("", "why"),
    lambda m: m.fp_exempt(3, "why"),
    lambda m: m.fp_exempt("a]b", "why"),
    lambda m: m.fp_exempt("ok", ""),
    lambda m: m.fp_exempt("ok", "  "),
    lambda m: m.quant_scope("p", "bogus", True),
    lambda m: m.quant_scope("p[0]", "fwd", True),
    lambda m: m.key_scope("p]"),
])
def test_exemption_argument_errors_match_the_reference(call):
    def err(mod):
        try:
            ctx = call(mod)
            with ctx:
                pass
        except (TypeError, ValueError) as e:
            return type(e), str(e)
        return None
    want = err(jax_exempt)
    assert want is not None
    assert err(exempt) == want


def test_registry_and_markers():
    """The attention exemption registers with the reference's reason; the
    markers appear in a profile under the reference's names, and outside
    one they cost a flag check (a no-op context)."""
    exempt.clear_exemptions()
    jax_exempt.clear_exemptions()
    cfg = get_config("statquant-tx", smoke=True)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    from repro_torch import prng
    from repro_torch.data import make_batch_for
    batch = make_batch_for(cfg, 2, 8)
    pol = QuantPolicy.fqt("psq", 8, backend="kernel",
                          overrides={"lm_head": "exact"})
    for ctx in (exempt.quant_scope("x", "fwd", True), exempt.key_scope("x"),
                exempt.quant_scope("x", "agrad", False)):
        assert isinstance(ctx, contextlib.nullcontext)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        ps = tree_map(lambda t: t.requires_grad_(), params)
        loss, _ = model.loss(ps, batch, prng.PRNGKey(1), pol, remat=False)
        loss.backward()
    names = {e.name for e in prof.events()}
    for want in ("fp[attn.sdpa]", "q[layers.attn.wq|fwd]",
                 "q[layers.mlp.fc1|wgrad]", "q[layers.mlp.fc1|agrad]",
                 "qk[layers.attn.wo]", "qfp[lm_head|fwd]"):
        assert want in names, want
    # the reference registers its attention exemption when it runs
    from repro.layers.attention import _sdpa as jax_sdpa
    q, kv = jnp.ones((1, 2, 1, 1, 4)), jnp.ones((1, 2, 1, 4))
    jax_sdpa(q, kv, kv, jnp.ones((1, 1, 1, 2, 2), bool))
    assert exempt.exemption_registry() == jax_exempt.exemption_registry()
    assert "attn.sdpa" in exempt.exemption_registry()
    for m in ("q[a|fwd]", "qfp[a.b|wgrad]", "fp[attn.sdpa]", "qk[a]"):
        assert bool(exempt.MARKER_RE.search(m)) == bool(
            jax_exempt.MARKER_RE.search(m))
        assert bool(exempt.KEY_SCOPE_RE.search(m)) == bool(
            jax_exempt.KEY_SCOPE_RE.search(m))


def test_exact_policy_runs_under_its_marker():
    x, w = torch.randn(3, 4), torch.randn(4, 2)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        y = fqt_matmul(x, w, None, QuantPolicy.exact(), path="head")
    assert torch.equal(y, x @ w)
    assert "qfp[head|fwd]" in {e.name for e in prof.events()}


def test_quant_paths_and_input_specs_match_the_reference():
    for arch in ("statquant-tx", "granite-3-2b"):
        model, jmodel = (build_model(get_config(arch, smoke=True)),
                         jax_build(jax_config(arch, smoke=True)))
        assert model.quant_paths() == jmodel.quant_paths()
        for name in ("train_4k", "prefill_32k", "decode_32k"):
            shape = SHAPES[name]
            assert vars(shape) == vars(JAX_SHAPES[name])
            got = model.input_specs(shape)
            want = jmodel.input_specs(JAX_SHAPES[name])
            gl = jax.tree_util.tree_flatten_with_path(
                jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)
                                        .replace("torch.", "")), got,
                             is_leaf=lambda t: isinstance(t, torch.Tensor)),
                is_leaf=lambda t: isinstance(t, tuple))[0]
            wl = jax.tree_util.tree_flatten_with_path(
                jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)), want),
                is_leaf=lambda t: isinstance(t, tuple))[0]
            assert gl == wl, (arch, name)
            assert all(t.device.type == "meta" for t in jax.tree.leaves(
                got, is_leaf=lambda t: isinstance(t, torch.Tensor)))
