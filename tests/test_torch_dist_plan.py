"""The port's sharding plan against the JAX package's, in process (no
ranks): for every config at full width, the train state's, a training
batch's and a decode cache's specs, path for path and spec for spec
(exact), on a ``{"data": 2, "model": 4}`` mesh and on ``{"data": 2,
"model": 3}``, where almost nothing divides and the rules fall back to
replication.  The reference's plan reads only ``mesh.shape``, so it takes
a namespace holding the mapping; the port's takes the mapping itself.
Also the production mesh shapes and the mesh constructors' refusals.
"""

import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import ALL_NAMES  # noqa: E402
from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.engine import abstract_train_state as jax_abstract  # noqa: E402
from repro.engine import state_specs as jax_state_specs  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.sharding import make_plan as jax_plan  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.engine import abstract_train_state, state_specs  # noqa: E402
from repro_torch.launch.mesh import (make_production_mesh,  # noqa: E402
                                     make_test_mesh, production_mesh_shape)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.sharding import make_plan  # noqa: E402

MESHES = [{"data": 2, "model": 4}, {"data": 2, "model": 3}]


def _jax_specs(tree) -> dict:
    return {jax.tree_util.keystr(p): tuple(s) for p, s in
            jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: isinstance(x, P))}


def _port_specs(tree, path="") -> dict:
    """Specs keyed as ``jax.tree_util.keystr`` keys the reference's."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_port_specs(tree[k], f"{path}['{k}']"))
        return out
    return {path: tuple(tree)}


@pytest.mark.parametrize("arch", ALL_NAMES)
def test_specs_equal_the_reference(arch):
    jmodel, model = jax_build(jax_config(arch)), build_model(get_config(arch))
    jstate = jax_abstract(jmodel, jax_adamw()).as_dict()
    state = abstract_train_state(model, adamw())
    jtrain = jmodel.input_specs(JAX_SHAPES["train_4k"])["batch"]
    train = model.input_specs(SHAPES["train_4k"])["batch"]
    jcache = jmodel.input_specs(JAX_SHAPES["decode_32k"])["cache"]
    cache = model.input_specs(SHAPES["decode_32k"])["cache"]
    for shape in MESHES:
        jp = jax_plan(types.SimpleNamespace(shape=dict(shape)))
        plan = make_plan(dict(shape))
        js = jax_state_specs(jp, jax_abstract(jmodel, jax_adamw()))
        pairs = [
            (_jax_specs(js.as_dict()), _port_specs(
                state_specs(plan, state).as_dict())),
            (_jax_specs(jp.batch_specs(jtrain)),
             _port_specs(plan.batch_specs(train))),
            (_jax_specs(jp.cache_specs(jcache)),
             _port_specs(plan.cache_specs(cache)))]
        for want, got in pairs:
            assert got == want, (arch, shape)
        assert len(pairs[0][1]) == len(jax.tree.leaves(jstate))


def test_production_mesh_shapes_and_refusals():
    assert production_mesh_shape() == ((16, 16), ("data", "model"))
    assert production_mesh_shape(multi_pod=True) == (
        (2, 16, 16), ("pod", "data", "model"))
    plan = make_plan({"pod": 2, "data": 16, "model": 16})
    assert plan.data_axes == ("pod", "data") and plan.dp_size == 32
    assert plan.batch_spec("/tokens", torch.empty(64, 8, device="meta")) \
        == (("pod", "data"), None)
    # no process group of the mesh's size: refused, naming both sizes
    with pytest.raises(ValueError, match="256 ranks .* got 0"):
        make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match=r"make_test_mesh\(2, 4\) needs a "
                                         r"process group of 8 ranks"):
        make_test_mesh(2, 4, device="cpu")
    with pytest.raises(ValueError, match="DeviceMesh"):
        plan.shardings({"w": ()})
