"""The port's dry run (``repro_torch.launch.dryrun``) at reduced cells.

* Flat cells (one device) of the reduced configs: ``n_params`` equal to
  the reference's (its abstract init), and the GEMM FLOPs the counter
  sees equal to the sum of ``repro.analysis.graph.iter_gemm_sites`` over
  the reference's jaxpr of the same training step (``make_step_fn`` with
  the same policy on ``native``, bfloat16 activations, 4 loss chunks),
  with ``remat`` off and on for the dense and MoE families: the port's
  recomputation stops before each layer's last GEMM, as XLA drops it.
  The audio family with ``remat`` off (the reference accepts the flag
  there and keeps every activation).  The RWKV6 and hybrid state
  math holds einsums the two libraries lower apart (an outer product is
  a ``dot_general`` in JAX, a multiply in PyTorch), so their totals are
  not compared; their quantized GEMMs are the same code as the others'.
* The RWKV6 WKV loop's meta path against the loop itself at a small
  size, both on the meta device under the counter: GEMM FLOPs, bytes and
  operation counts exactly, forward and backward; the live-bytes peak of
  the forward exactly, of the whole within a step's state.  BHQ's loop
  over row blocks likewise, its counts and peak exactly.
* Mesh cells on a fake process group of 4 ranks, in a subprocess (the
  group is process-global): the training step, a prefill and a decode
  cell on a (2, 2) mesh.  The per-rank parameter and
  optimizer bytes equal the sum of the plan's local shard sizes; the
  collectives counted are the gathers of the model-sharded leaves and
  the data group's all-reduces; the GEMM FLOPs are the flat cell's over
  the data ranks (for the training step, the reference's GEMM sites of
  the flat step over them).

``repro.launch.dryrun`` is not imported: it sets ``XLA_FLAGS`` and a
persistent compile cache when imported.
"""

import functools
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.analysis.graph import iter_gemm_sites, site_flops  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import QuantPolicy as JaxPolicy  # noqa: E402
from repro.engine import abstract_train_state as jax_abstract  # noqa: E402
from repro.engine import make_step_fn as jax_make_step  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.optim import sgd as jax_sgd  # noqa: E402
from repro_torch.configs import ShapeSpec  # noqa: E402
from repro_torch.core import QuantPolicy  # noqa: E402
from repro_torch.launch.dryrun import Counter, run_cell  # noqa: E402
from torch_one_thread import one_intra_op_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
TRAIN = ShapeSpec("train_smoke", 16, 4, "train")
CHUNKS = 4
FLOP_CASES = [("statquant-tx", "psq", 8, False),
              ("statquant-tx", "bhq", 5, True),
              ("granite-moe-1b-a400m", "psq", 8, True),
              ("whisper-medium", "psq", 8, False)]


@functools.lru_cache(maxsize=None)
def _reference(arch, quant, bits, remat):
    jm = jax_build(jax_config(arch, smoke=True))
    pol = JaxPolicy.fqt(quant, bits, backend="native", bhq_block=16)
    opt = jax_sgd(0.9)
    step = jax_make_step(jm, pol, opt, lambda s: 1e-3, remat=remat,
                         loss_kwargs={"dtype": jnp.bfloat16,
                                      "loss_chunks": CHUNKS})
    batch = jm.input_specs(TRAIN, dtype=jnp.bfloat16)["batch"]
    jaxpr = jax.make_jaxpr(step)(jax_abstract(jm, opt), batch)
    params = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    n = sum(math.prod(x.shape) for x in jax.tree.leaves(params))
    return site_flops(iter_gemm_sites(jaxpr)), n


@pytest.mark.parametrize("arch,quant,bits,remat", FLOP_CASES)
def test_flat_cell_gemm_flops_and_params_equal_reference(arch, quant, bits,
                                                         remat):
    flops, n_params = _reference(arch, quant, bits, remat)
    rec = run_cell(arch, TRAIN.name, smoke=True, shape=TRAIN, mesh=None,
                   policy=QuantPolicy.fqt(quant, bits, backend="native",
                                          bhq_block=16),
                   remat=remat, loss_chunks=CHUNKS, verbose=False)
    assert rec["n_params"] == n_params
    assert rec["per_device"]["flops"] == flops
    assert rec["n_chips"] == 1 and rec["mesh"] == "flat"
    assert rec["per_device"]["collective_bytes"] == 0
    pd = rec["per_device"]
    for key in ("bytes_accessed", "peak_bytes", "param_bytes",
                "state_bytes"):
        assert pd[key] > 0
    # the least bytes: the resident state read once, the parameters and
    # momenta written once; below the unfused count
    assert pd["bytes_min"] == (pd["resident_bytes"] + pd["param_bytes"]
                               + pd["state_bytes"])
    assert pd["bytes_min"] < pd["bytes_accessed"]
    terms = rec["roofline"]
    assert terms["memory_s"] < terms["memory_s_unfused"]
    assert terms["step_time_lb_s"] == max(
        terms["compute_s"], terms["memory_s"], terms["collective_s"])


@pytest.mark.parametrize("arch,block", [("whisper-medium", 64),
                                        ("granite-3-2b", 1024)])
def test_bhq_block_divides_each_ranks_rows(arch, block):
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.dryrun import _cell_policy
    from repro_torch.sharding import ShardingPlan
    pol = QuantPolicy.fqt("bhq", 5, backend="native", bhq_block=1024)
    cfg, shape = get_config(arch), SHAPES["train_4k"]
    plan = ShardingPlan({"data": 16, "model": 16})
    got = _cell_policy(pol, cfg, shape, plan).bhq_block
    assert got == block
    local = shape.global_batch // 16
    assert local * shape.seq_len % got == 0
    if cfg.family == "audio":
        assert local * cfg.enc_seq % got == 0
    assert _cell_policy(pol, cfg, shape, None) is pol


def _wkv_counts(T, meta_path):
    import repro_torch.layers.rwkv as rwkv
    B, H, hd = 2, 3, 4
    ins = [torch.empty((B, T, H, hd), device="meta", requires_grad=True)
           for _ in range(4)]
    ins += [torch.empty((H, hd), device="meta", requires_grad=True),
            torch.empty((B, H, hd, hd), device="meta", requires_grad=True)]
    c = Counter()
    c.resident(ins)
    orig = rwkv.meta.is_meta
    if not meta_path:
        rwkv.meta.is_meta = lambda *a: False
    try:
        with c:
            y, s = rwkv._wkv_scan(*ins)
            fwd = (c.gemm_flops, c.bytes, c.ops, c.peak_bytes)
            torch.autograd.grad((y, s), ins, (torch.empty_like(y),
                                              torch.empty_like(s)))
    finally:
        rwkv.meta.is_meta = orig
    assert tuple(y.shape) == (B, T, H, hd) and s.shape == ins[5].shape
    return fwd, (c.gemm_flops, c.bytes, c.ops, c.peak_bytes)


@pytest.mark.parametrize("T", [6, 11])
def test_wkv_meta_path_counts_the_loop(T):
    (lf, lt), (mf, mt) = _wkv_counts(T, False), _wkv_counts(T, True)
    assert mf == lf
    assert mt[:3] == lt[:3]
    # the loop frees what it kept step by step in its backward, the meta
    # path at the end of it: a few steps' state more at the peak
    state = 2 * 3 * 4 * 4 * 4                       # one (B, H, hd, hd)
    assert lt[3] <= mt[3] <= lt[3] + 4 * state


def _bhq_counts(n, blk, meta_path):
    import repro_torch.core.bhq as bhq
    from repro_torch import prng
    x = torch.empty((n, 6), device="meta")
    c = Counter()
    c.resident([x])
    orig = bhq.meta.is_meta
    if not meta_path:
        bhq.meta.is_meta = lambda *a: False
    try:
        with c:
            q = bhq.quantize_bhq_stoch(x, prng.PRNGKey(3), 5, block_rows=blk)
    finally:
        bhq.meta.is_meta = orig
    return tuple(q.codes.shape), (c.bytes, c.ops, c.peak_bytes)


@pytest.mark.parametrize("n,blk", [(37, 8), (64, 16)])
def test_bhq_meta_path_counts_the_block_loop(n, blk):
    """BHQ's per-block SR draws (a host loop over the batch's blocks) on
    the meta device: its meta path's result shape, bytes, operations and
    live-bytes peak equal the loop's."""
    assert _bhq_counts(n, blk, True) == _bhq_counts(n, blk, False)


_MESH_CODE = r"""
import json, sys
import torch
from repro_torch.configs import ShapeSpec
from repro_torch.core import QuantPolicy
from repro_torch.launch.dryrun import run_cell
pol = QuantPolicy.fqt("psq", 8, backend="native")
train = ShapeSpec("train_smoke", 16, 4, "train")
out = {"(2, 2)": run_cell("statquant-tx", "t", smoke=True, shape=train,
                          mesh=(2, 2), policy=pol, loss_chunks=4,
                          remat=False, verbose=False)}
for kind, T in (("prefill", 16), ("decode", 32)):
    shape = ShapeSpec(kind, T, 4, kind)
    for mesh in (None, (2, 2)):
        out[kind + str(mesh)] = run_cell("granite-3-2b", kind, smoke=True,
                                         shape=shape, mesh=mesh, policy=pol,
                                         verbose=False)
json.dump(out, sys.stdout)
"""


@pytest.fixture(scope="module")
def mesh_cells():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", _MESH_CODE], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout)


def _shard_bytes(arch, shape, tree_of):
    """Sum over the leaves of ``tree_of(params)`` of their local shard
    bytes under the plan over ``{"data": d, "model": m}``."""
    from repro_torch.models import build_model
    from repro_torch.sharding import ShardingPlan
    from repro_torch.configs import get_config
    from repro_torch.optim import tree_leaves
    data, model = shape
    plan = ShardingPlan({"data": data, "model": model})
    params = build_model(get_config(arch, smoke=True)).init(
        0, device="meta")
    leaves = tree_leaves(tree_of(params))
    specs = _spec_leaves(plan.param_specs(tree_of(params)))
    total, gathered, n_gathered = 0, 0, 0
    for leaf, spec in zip(leaves, specs):
        div = 1
        for e in spec:
            div *= {"data": data, "model": model}.get(e, 1) if e else 1
        total += leaf.numel() * leaf.element_size() // div
        if "model" in spec and model > 1:
            gathered += leaf.numel() * leaf.element_size()
            n_gathered += 1
    return total, gathered, n_gathered


def _spec_leaves(tree):
    """A spec tree's leaves (tuples) in ``tree_leaves``' sorted order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    return [tree]


@pytest.mark.parametrize("shape", [(2, 2)])
def test_mesh_train_cell_bytes_and_collectives(mesh_cells, shape):
    rec = mesh_cells[str(shape)]
    pd = rec["per_device"]
    want, gathered, n_gathered = _shard_bytes("statquant-tx", shape,
                                              lambda p: p)
    assert pd["param_bytes"] == want
    assert pd["state_bytes"] == want              # sgd: one momentum a leaf
    assert rec["n_chips"] == 4 and rec["mesh"] == "x".join(map(str, shape))
    counts, coll = pd["collective_counts"], pd["collectives"]
    assert counts["all-gather"] == n_gathered
    assert coll["all-gather"] == gathered
    # the gradients' sum is one all-reduce of every parameter's bytes
    full = _shard_bytes("statquant-tx", (1, 1), lambda p: p)[0]
    assert counts["all-reduce"] > 2 and coll["all-reduce"] > full
    assert counts["reduce-scatter"] == counts["all-to-all"] == 0
    assert pd["collective_bytes"] == sum(coll.values())
    # each data rank runs its rows: the flat step's GEMM FLOPs over them
    flops, _ = _reference("statquant-tx", "psq", 8, False)
    assert pd["flops"] * shape[0] == flops
    assert rec["roofline"]["collective_s"] > 0


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_mesh_serve_cells(mesh_cells, kind):
    rec, flat = mesh_cells[kind + "(2, 2)"], mesh_cells[kind + "None"]
    pd = rec["per_device"]
    want, gathered, n_gathered = _shard_bytes("granite-3-2b", (2, 2),
                                              lambda p: p)
    assert pd["param_bytes"] == want
    assert pd["flops"] * 2 == flat["per_device"]["flops"]
    assert pd["collective_counts"]["all-gather"] >= n_gathered
    if kind == "decode":
        # the cache: batch over data, the K/V width over model; the int32
        # index whole
        cache = flat["per_device"]["state_bytes"] - 4
        assert pd["state_bytes"] == cache // 4 + 4
    assert rec["useful_flops_ratio"] > 0
