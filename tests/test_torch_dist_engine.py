"""The port's engine on meshes of 4 gloo ranks: the training CLI, elastic
restore, state placement and the refusals (``tests/torch_dist_workers.py``,
scenario ``engine``).

  * ``launch/train.py --device cpu --mesh 2x2 --accum 2`` (psq8,
    ``kernel``) runs 3 finite steps with the same losses on every rank;
  * an engine on (2, 2) checkpoints at step 2; one on (4, 1) restores it
    (every leaf equal to a flat engine's restore of the same checkpoint)
    and trains step 2 on its own mesh; the flat engine's step 2 from the
    same checkpoint is within rtol 1e-4 of it (the same state and SR
    draws: float32 reduction order only); the reference's checkpoint
    manager reads the mesh-written checkpoint into the reference's
    state, leaf for leaf equal to the port's;
  * the smoke states of granite-moe-1b-a400m and rwkv6-1.6b placed on
    (2, 2): each rank's local shard has the shape its spec gives;
  * a MoE config over the model axis alone, (1, 4), gives the flat
    step's loss bit for bit (every rank the whole batch, a data group of
    one), and so does a batch of 6 rows on (4, 1), which does not split
    over the data ranks (its spec replicates: every rank runs it whole,
    nothing is summed);
  * a MoE config under 2 data ranks raises ``NotImplementedError`` and
    BHQ blocks that would straddle ranks raise ``ValueError``, both
    naming their ROADMAP item; ``--mesh 1x2`` on 4 ranks is a usage
    error; a stochastic quantizer on a weight (``fwd_weight='psq:8'``,
    a replicated operand) raises on (2, 2) the flat engine's
    ``ValueError``.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_dist_workers import spawn  # noqa: E402


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("engine")
    return out, spawn("engine", 4, out, timeout=300)


def test_cli_runs_on_a_2x2_mesh(runs):
    _, ranks = runs
    h = ranks[0]["cli"]
    assert [s for s, _ in h] == [0, 1, 2]
    assert all(np.isfinite(l) for _, l in h)
    assert all(r["cli"] == h for r in ranks)


def test_elastic_restore_2x2_to_4x1_to_flat(runs):
    _, ranks = runs
    r0 = ranks[0]
    assert [s for s, _ in r0["h22"]] == [0, 1]
    assert [s for s, _ in r0["h41"]] == [2]
    assert all(r["step41"] == 3 and r["on_mesh41"] for r in ranks)
    a, b = r0["restored41"], r0["restored_flat"]
    assert sorted(a) == sorted(b) and len(a) > 50
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)
    np.testing.assert_allclose(r0["h41"][0][1], r0["h_flat"][0][1],
                               rtol=1e-4)


def test_mesh_checkpoint_is_read_by_the_reference(runs):
    import jax
    from repro.checkpoint import CheckpointManager
    from repro.configs import get_config
    from repro.engine import abstract_train_state
    from repro.models import build_model
    from repro.optim import adamw
    out, ranks = runs
    model = build_model(get_config("statquant-tx", smoke=True))
    target = abstract_train_state(model, adamw(), 0).as_dict()
    tree = CheckpointManager(str(out / "ckpt")).restore(2, target)
    port = ranks[0]["restored_flat"]
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    assert len(leaves) == len(port)
    for path, leaf in leaves:
        key = "/" + "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                             for k in path)
        want = np.asarray(leaf)
        if key == "/rng":
            want = want.astype(np.int64)         # the port's key words
        np.testing.assert_array_equal(np.asarray(port[key]), want,
                                      err_msg=key)


def test_family_states_place_on_the_mesh(runs):
    _, ranks = runs
    for r in ranks:
        assert r["placement_bad"] == []


def test_whole_batch_on_every_rank_is_the_flat_step(runs):
    _, ranks = runs
    for r in ranks:
        assert r["moe_1x4"] == r["moe_flat"]
        assert np.isfinite(r["moe_1x4"][0][1])
        assert r["replicated41"] == r["replicated_flat"]
        assert [s for s, _ in r["replicated41"]] == [0, 1]


def test_refusals_name_their_roadmap_item(runs):
    _, ranks = runs
    for r in ranks:
        assert r["cli_size"] == 2
        assert "granite-moe" in r["moe"] and "ROADMAP" in r["moe"]
        assert "32 rows per rank" in r["straddle"]
        assert "bhq_block=24" in r["straddle"]
        assert "ROADMAP" in r["straddle"]
        assert "stochastic" in r["stoch_weight"]
        assert r["stoch_weight"] == r["stoch_weight_flat"]
