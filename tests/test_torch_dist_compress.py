"""The compressed data-parallel all-reduce (``core/compression.py``) on 4
gloo ranks against the JAX package's under ``shard_map``.

The reference runs once, in one subprocess on 4 placeholder devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, as
``tests/test_distribution.py`` does), while the port's ranks run
(``tests/torch_dist_workers.py``, scenario ``compress``).  Held to:

  * ``compressed_psum`` of distinct per-rank leaves over a 4-rank axis:
    the output and each rank's phase-1 codes bit-identical (the codes as
    the reference's ``_quantize_chunks`` makes them from the same chunks
    and keys);
  * ``compressed_grad_allreduce`` of a replicated tree over the ``data``
    axis of (2, 2) and (4, 1) meshes: bit-identical;
  * both wire exchanges carry ``int8`` (the dtypes handed to
    ``all_to_all_single`` and the all-gather, recorded);
  * the (2, 2) engine with ``compress_axis="data"`` (reduced
    statquant-tx, ``fqt(psq,8)``, 8 x 16 tokens, accumulation 2), from the reference's initial state (its checkpoint,
    which the port's engine resumes), against the reference's engine:
    losses within rtol 2e-3 / atol 2e-3 (the reference parity test's
    trajectory tolerance).  3 steps, not 2: the warmup gives step 0 a
    learning rate of 0, so the first compressed update shows in step 2's
    loss;
  * ``compression_variance_bound``: equal to the reference's within
    float32 round-off (rtol 1e-6).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_dist_workers import compress_inputs, spawn  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

_REFERENCE = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
sys.path.insert(0, TESTS)
from torch_dist_workers import COMPRESS_FQT, COMPRESS_KW, compress_inputs
from repro.checkpoint import CheckpointManager
from repro.configs import get_config
from repro.core import QuantPolicy
from repro.core.compression import (_quantize_chunks, _shard_map,
                                    compressed_grad_allreduce,
                                    compressed_psum)
from repro.engine import Engine, init_train_state
from repro.launch.mesh import make_test_mesh
from repro.models import build_model
from repro.optim import adamw

# first the initial state (Engine's: AdamW, seed 0), for the port's
# engine to resume while this process goes on
cfg = get_config("statquant-tx", smoke=True)
state = init_train_state(build_model(cfg), adamw(), 0)
CheckpointManager(CKPT).save(0, jax.tree.map(np.asarray, state.as_dict()))

xs, tree = compress_inputs()
out = {}
mesh41, mesh22 = make_test_mesh(4, 1), make_test_mesh(2, 2)
keys = jax.random.split(jax.random.PRNGKey(2), 4)
f = jax.jit(_shard_map(
    lambda xl, kl: compressed_psum(xl[0], kl[0], "data", 8)[None],
    mesh=mesh41, in_specs=(P("data"), P("data")), out_specs=P("data")))
out["psum"] = np.asarray(f(jnp.asarray(xs), keys))
for r in range(4):
    flat = jnp.pad(jnp.asarray(xs[r]).reshape(-1), (0, (-xs[r].size) % 4))
    chunks = flat.reshape(4, -1)
    lo = jnp.min(chunks, axis=1, keepdims=True)
    hi = jnp.max(chunks, axis=1, keepdims=True)
    k1, _ = jax.random.split(jax.random.fold_in(keys[r], r))
    out[f"codes{r}"] = np.asarray(_quantize_chunks(chunks, lo, hi, k1, 8)[0])
jt = jax.tree.map(jnp.asarray, tree)
for name, mesh in (("22", mesh22), ("41", mesh41)):
    t = jax.jit(lambda tt: compressed_grad_allreduce(
        tt, mesh, "data", jax.random.PRNGKey(7), bits=8, mean=True))(jt)
    for path, leaf in jax.tree_util.tree_leaves_with_path(t):
        out["tree" + name + jax.tree_util.keystr(path)] = np.asarray(leaf)
pol = QuantPolicy.fqt(*COMPRESS_FQT)
h = Engine(cfg, pol, mesh=mesh22, compress_axis="data", **COMPRESS_KW).run()
out["engine"] = np.asarray([l for _, l in h])
np.savez(OUT, **out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's npz, the port's 4 ranks' results), run side by
    side."""
    tmp = tmp_path_factory.mktemp("compress")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    code = (f"TESTS = {str(ROOT / 'tests')!r}\n"
            f"OUT = {str(tmp / 'ref.npz')!r}\n"
            f"CKPT = {str(tmp / 'ckpt')!r}\n" + _REFERENCE)
    # the reference's stdout and stderr go to a file: a pipe nobody reads
    # while the ranks run could fill and stall it
    log = open(tmp / "ref.log", "w+")
    ref = subprocess.Popen([sys.executable, "-c", code], env=env,
                           stdout=log, stderr=subprocess.STDOUT)
    try:
        port = spawn("compress", 4, tmp / "port", timeout=240,
                     args=(tmp / "ckpt",))
        ref.wait(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
        log.seek(0)
        err = log.read()
        log.close()
    assert ref.returncode == 0, err[-3000:]
    with np.load(tmp / "ref.npz") as z:
        return dict(z), port


def test_compressed_psum_bit_identical(runs):
    ref, port = runs
    for r in range(4):
        np.testing.assert_array_equal(port[r]["psum"].numpy(),
                                      ref["psum"][r])
        # the first all-to-all carries this rank's phase-1 codes
        name, dtype, codes = port[r]["psum_wire"][0]
        assert name == "all_to_all_single" and dtype == "torch.int8"
        np.testing.assert_array_equal(codes.numpy(), ref[f"codes{r}"])


def test_compressed_grad_allreduce_bit_identical(runs):
    ref, port = runs
    for shape, name in (((2, 2), "22"), ((4, 1), "41")):
        for r in range(4):
            t = port[r][("tree", shape)]
            got = {"['a']": t["a"], "['b']['c']": t["b"]["c"],
                   "['b']['d']": t["b"]["d"]}
            for path, leaf in got.items():
                np.testing.assert_array_equal(
                    leaf.numpy(), ref["tree" + name + path],
                    err_msg=f"{shape} rank {r} {path}")


def test_wire_is_int8(runs):
    _, port = runs
    for r in range(4):
        wire = port[r]["psum_wire"]
        # per exchange: int8 codes and float32 (scale, lo) metadata
        assert [(n, d) for n, d, _ in wire] == [
            ("all_to_all_single", "torch.int8"),
            ("all_to_all_single", "torch.float32"),
            (wire[2][0], "torch.int8"), (wire[3][0], "torch.float32")]
        assert wire[2][0] in ("all_gather_single", "all_gather_into_tensor")
        big = {d for n, d in port[r]["engine_wire"]
               if n == "all_to_all_single"}
        assert big == {"torch.int8", "torch.float32"}


def test_compressed_engine_matches_reference(runs):
    ref, port = runs
    for r in range(4):
        got = [l for _, l in port[r]["engine"]]
        np.testing.assert_allclose(got, ref["engine"], rtol=2e-3, atol=2e-3)


def test_variance_bound_matches_reference():
    import jax.numpy as jnp
    from repro.core.compression import compression_variance_bound as ref_vb
    from repro_torch.core.compression import compression_variance_bound
    xs, _ = compress_inputs()
    for bits in (4, 8):
        np.testing.assert_allclose(
            float(compression_variance_bound(torch.from_numpy(xs), bits, 4)),
            float(ref_vb(jnp.asarray(xs), bits, 4)), rtol=1e-6)
