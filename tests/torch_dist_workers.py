"""Rank processes of the port's multi-rank CPU tests.

:func:`spawn` starts one process a rank of a gloo process group on a
``file://`` store, each on one intra-op thread, and joins them within a
timeout (a hung collective fails the test instead of eating the suite's
limit).  Each rank runs a scenario of :data:`SCENARIOS` and leaves what
it measured in ``<out>/<scenario>.<rank>.pt``, which :func:`spawn`
returns, rank by rank.  This module imports only torch and the port, so
the ranks start without JAX.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

# the reference's parity setup (tests/test_engine.py _PARITY_CODE): the
# reduced statquant-tx, 8 x 16 tokens, accumulation 2, 3 steps
STEP_KW = dict(steps=3, batch_size=8, seq_len=16, accum_steps=2,
               log_every=100, log_fn=None, device="cpu")
BHQ_OVERRIDES = {r"lm_head": "exact", r"layers\.attn\.": 8,
                 r"layers\.mlp\.": {"agrad": ("bhq", 4)}}
PSQ_OVERRIDES = {r"lm_head": "exact", r"layers\.attn\.": 8}
# (name, quantizer, bits, overrides, backend, fused): the kernels' plain
# versions fused (the dX and dW kernels' SR offsets and given ranges) and
# unfused (the quantize_sr kernels' and the given-range tensor mode)
STEP_CONFIGS = [
    ("bhq5-simulate", "bhq", 5, BHQ_OVERRIDES, "simulate", None),
    ("bhq5-kernel", "bhq", 5, BHQ_OVERRIDES, "kernel", None),
    ("psq8-simulate", "psq", 8, PSQ_OVERRIDES, "simulate", None),
    ("psq8-kernel", "psq", 8, PSQ_OVERRIDES, "kernel", None),
    ("psq8-kernel-unfused", "psq", 8, PSQ_OVERRIDES, "kernel", False)]
MESHES = [(2, 2), (4, 1)]


def spawn(scenario: str, world: int, out: Path, timeout: float,
          args=()) -> list:
    """Run ``scenario`` on ``world`` gloo ranks; the ranks' results."""
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    store = out / f"{scenario}.store"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, scenario, str(r), str(world), str(store),
         str(out), *map(str, args)], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            left = max(1.0, deadline - time.monotonic())
            logs.append(p.communicate(timeout=left)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError(f"{scenario}: ranks still running after "
                             f"{timeout} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, logs[r][-3000:]) for r, p in enumerate(procs)
           if p.returncode != 0]
    assert not bad, bad
    return [torch.load(out / f"{scenario}.{r}.pt", weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# scenarios (run in the rank processes)
# ---------------------------------------------------------------------------

class CodeRecorder:
    """Records the codes every unfused stochastic quantizer emits (PTQ,
    PSQ and BHQ in PyTorch, and the ``quantize_sr`` kernels') while on."""

    def __init__(self):
        from repro_torch.core import backend, registry
        self.calls, self.on = [], False
        for mod, name in ((registry, "quantize_ptq_stoch"),
                          (registry, "quantize_psq_stoch"),
                          (registry, "quantize_bhq_stoch"),
                          (backend, "quantize_sr_rows_qt"),
                          (backend, "quantize_sr_tensor_qt")):
            fn = getattr(mod, name)

            def wrapped(*a, _fn=fn, _name=name, **k):
                q = _fn(*a, **k)
                if self.on:
                    self.calls.append((_name, q.codes.clone()))
                return q
            setattr(mod, name, wrapped)


def _policy(quant, bits, overrides, backend, fused):
    from repro_torch.core import QuantPolicy
    return QuantPolicy.fqt(quant, bits, bhq_block=16, backend=backend,
                           fused=fused, overrides=overrides)


def _run(engine, rec):
    """3 steps, the first with the SR codes recorded."""
    rec.on, rec.calls = True, []
    h = engine.run(steps=1)
    rec.on = False
    codes = rec.calls
    return h + engine.run(), codes


def scenario_steps(rank, world, out):
    """Each rank one flat run of STEP_CONFIGS, then every config on each
    mesh of MESHES."""
    from repro_torch.configs import get_config
    from repro_torch.engine import Engine
    from repro_torch.launch.mesh import make_test_mesh
    cfg = get_config("statquant-tx", smoke=True)
    rec = CodeRecorder()
    res = {}
    for name, *pol in STEP_CONFIGS[rank::world]:
        res[name] = _run(Engine(cfg, _policy(*pol), **STEP_KW), rec)
    for shape in MESHES:
        mesh = make_test_mesh(*shape, device="cpu")
        for name, *pol in STEP_CONFIGS:
            eng = Engine(cfg, _policy(*pol), mesh=mesh, **STEP_KW)
            res[(shape, name)] = _run(eng, rec)
    torch.save(res, Path(out) / f"steps.{rank}.pt")


# the head loss in chunks of the global batch's rows: the lm_head GEMM
# quantized (no override keeps it exact), its BHQ agrad in PyTorch, and
# every quantizer unfused; (mesh shape, loss_chunks): whole chunks on each
# rank (2x2 two a rank, 4x1 one) and a chunk over two ranks (4x1, 2)
CHUNK_CONFIGS = [("bhq5-kernel", "bhq", 5, {}, "kernel", None),
                 ("psq8-kernel-unfused", "psq", 8, {}, "kernel", False)]
CHUNK_MESHES = [((2, 2), 4), ((4, 1), 4), ((4, 1), 2)]


def scenario_chunks(rank, world, out):
    """The flat runs of CHUNK_CONFIGS at 4 and 2 loss chunks shared out
    over the ranks, then each rank every config on each (mesh,
    loss_chunks) of CHUNK_MESHES."""
    from repro_torch.configs import get_config
    from repro_torch.engine import Engine
    from repro_torch.launch.mesh import make_test_mesh
    cfg = get_config("statquant-tx", smoke=True)
    rec = CodeRecorder()
    res = {}
    flat = [(name, pol, lc) for name, *pol in CHUNK_CONFIGS
            for lc in sorted({lc for _, lc in CHUNK_MESHES})]
    for name, pol, lc in flat[rank::world]:
        res[(name, lc)] = _run(Engine(
            cfg, _policy(*pol), loss_kwargs={"loss_chunks": lc},
            **STEP_KW), rec)
    for shape, lc in CHUNK_MESHES:
        mesh = make_test_mesh(*shape, device="cpu")
        for name, *pol in CHUNK_CONFIGS:
            res[(shape, lc, name)] = _run(Engine(
                cfg, _policy(*pol), mesh=mesh,
                loss_kwargs={"loss_chunks": lc}, **STEP_KW), rec)
    torch.save(res, Path(out) / f"chunks.{rank}.pt")


# the compression scenario's inputs, made the same way on the reference side
PSUM_SHAPE = (33, 7)           # a rank's leaf: 231 elements, padded to 232
TREE_SHAPES = {"a": (5, 3), "b": {"c": (17,), "d": (2, 2, 3)}}


def compress_inputs():
    """Distinct per-rank leaves for ``compressed_psum`` (4, 33, 7) and a
    replicated tree for ``compressed_grad_allreduce``, numpy float32."""
    import numpy as np
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((4,) + PSUM_SHAPE).astype(np.float32)

    def tree(t):
        if isinstance(t, dict):
            return {k: tree(v) for k, v in t.items()}
        return rng.standard_normal(t).astype(np.float32)
    return xs, tree(TREE_SHAPES)


class WireRecorder:
    """Records the dtype (and a copy) of every tensor handed to
    ``all_to_all_single`` and the all-gather."""

    def __init__(self):
        import torch.distributed as dist
        self.calls = []
        for name in ("all_to_all_single", "all_gather_single",
                     "all_gather_into_tensor"):
            fn = getattr(dist, name, None)
            if fn is None:
                continue

            def wrapped(out, x, *a, _fn=fn, _name=name, **k):
                self.calls.append((_name, x.dtype, x.clone()))
                return _fn(out, x, *a, **k)
            setattr(dist, name, wrapped)


# the compressed engine's run: the reduced statquant-tx under fqt(psq,8)
# (the reference's XLA compile of that step is smaller than bhq5's), from
# the state checkpointed in ``ckpt`` (the reference's init); 3 steps, since
# the warmup gives step 0 a learning rate of 0
COMPRESS_FQT = ("psq", 8)
COMPRESS_KW = dict(steps=3, batch_size=8, seq_len=16, accum_steps=2,
                   log_every=100, log_fn=None)


def scenario_compress(rank, world, out, ckpt):
    """``compressed_psum`` over the 4 ranks of a (4, 1) mesh's data axis
    on distinct leaves, ``compressed_grad_allreduce`` of a replicated tree
    on (2, 2) and (4, 1), and the (2, 2) engine with
    ``compress_axis="data"`` resumed from ``ckpt`` (once it is there)."""
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.core import QuantPolicy
    from repro_torch.core.compression import (compressed_grad_allreduce,
                                              compressed_psum)
    from repro_torch.engine import Engine
    from repro_torch.launch.mesh import make_test_mesh
    xs, tree = compress_inputs()
    mesh41 = make_test_mesh(4, 1, device="cpu")
    mesh22 = make_test_mesh(2, 2, device="cpu")
    wire = WireRecorder()
    keys = prng.split(prng.PRNGKey(2), 4)
    res = {"psum": compressed_psum(torch.from_numpy(xs[rank]), keys[rank],
                                   mesh41.get_group("data"), bits=8)}
    res["psum_wire"] = [(n, str(d), t) for n, d, t in wire.calls]
    tt = {"a": torch.from_numpy(tree["a"]),
          "b": {k: torch.from_numpy(v) for k, v in tree["b"].items()}}
    for shape, mesh in (((2, 2), mesh22), ((4, 1), mesh41)):
        res[("tree", shape)] = compressed_grad_allreduce(
            tt, mesh, "data", prng.PRNGKey(7), bits=8, mean=True)
    wire.calls = []
    # the reference's process writes its initial state there first
    deadline = time.monotonic() + 240
    while not (Path(ckpt) / "step_0").is_dir():
        assert time.monotonic() < deadline, f"no checkpoint in {ckpt}"
        time.sleep(0.2)
    cfg = get_config("statquant-tx", smoke=True)
    pol = QuantPolicy.fqt(*COMPRESS_FQT)
    eng = Engine(cfg, pol, mesh=mesh22, compress_axis="data",
                 device="cpu", ckpt_dir=ckpt, **COMPRESS_KW)
    res["engine"] = eng.run()
    res["engine_wire"] = sorted({(n, str(d)) for n, d, _ in wire.calls})
    torch.save(res, Path(out) / f"compress.{rank}.pt")


def _path_leaves(tree, prefix=""):
    """``(path, leaf)`` of nested dicts (a spec tuple is a leaf)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _path_leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _full_tree(tree) -> dict:
    """``{path: leaf}`` of a state (``DTensor`` shards gathered to their
    full tensors; host values as they are)."""
    return {p: leaf.full_tensor() if hasattr(leaf, "full_tensor") else leaf
            for p, leaf in _path_leaves(tree)}


def scenario_engine(rank, world, out):
    """The CLI on a 2x2 mesh; an engine checkpointing on 2x2, restored
    onto 4x1 and flat; smoke states of two families placed on 2x2; the
    refusals."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core import QuantPolicy
    from repro_torch.engine import (Engine, abstract_train_state,
                                    init_train_state, place_state,
                                    state_shardings, state_specs)
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.train import main as train_main
    from repro_torch.models import build_model
    from repro_torch.optim import sgd
    from repro_torch.sharding import make_plan
    res = {"cli": train_main([
        "--device", "cpu", "--mesh", "2x2", "--accum", "2", "--steps", "3",
        "--batch", "8", "--seq", "16", "--quant", "psq", "--grad-bits", "8",
        "--backend", "kernel"])}

    cfg = get_config("statquant-tx", smoke=True)
    pol = QuantPolicy.fqt("bhq", 5, bhq_block=16)
    ckpt = str(Path(out) / "ckpt")
    kw = dict(steps=3, batch_size=8, seq_len=16, accum_steps=2,
              log_every=100, log_fn=None, device="cpu", ckpt_dir=ckpt,
              ckpt_every=2)
    mesh22 = make_test_mesh(2, 2, device="cpu")
    mesh41 = make_test_mesh(4, 1, device="cpu")
    res["h22"] = Engine(cfg, pol, mesh=mesh22, **kw).run(steps=2)
    e41 = Engine(cfg, pol, mesh=mesh41, **kw)
    res["restored41"] = _full_tree(e41.restore_state().as_dict())
    res["h41"] = e41.run()
    res["step41"] = e41.state.step
    res["on_mesh41"] = all(p.device_mesh is mesh41 for _, p in
                           _path_leaves(e41.state.params))
    dist.barrier()
    if rank == 0:
        flat = Engine(cfg, pol, **kw)
        res["restored_flat"] = _full_tree(flat.restore_state().as_dict())
        res["h_flat"] = flat.run()

    # a batch of 6 rows does not split over 4 data ranks: every rank runs
    # it whole and nothing is summed, the flat step's numbers
    rep_kw = dict(steps=2, batch_size=6, seq_len=16, log_fn=None,
                  device="cpu")
    res["replicated41"] = Engine(cfg, pol, mesh=mesh41, **rep_kw).run()
    res["replicated_flat"] = Engine(cfg, pol, **rep_kw).run()

    # smoke states of two more families, placed on 2x2
    plan = make_plan(mesh22)
    bad = []
    for arch in ("granite-moe-1b-a400m", "rwkv6-1.6b"):
        model = build_model(get_config(arch, smoke=True))
        opt = sgd(0.9)
        ab = abstract_train_state(model, opt)
        specs = state_specs(plan, ab).as_dict()
        placed = place_state(init_train_state(model, opt, device="cpu"),
                             state_shardings(plan, ab)).as_dict()
        spec_of = dict(_path_leaves(specs))
        for path, leaf in _path_leaves(placed):
            if path.split("/")[1] not in ("params", "opt"):
                continue                  # step, rng: host values
            spec = spec_of[path] or (None,) * leaf.dim()
            want = tuple(d // (plan.shape[a] if a else 1)
                         for d, a in zip(leaf.shape, spec))
            if tuple(leaf.to_local().shape) != want:
                bad.append((arch, path, tuple(leaf.shape), want))
    res["placement_bad"] = bad

    # MoE over the model axis alone (data = 1) runs: every rank the whole
    # batch, the flat step's numbers
    moe = get_config("granite-moe-1b-a400m", smoke=True)
    moe_kw = dict(steps=1, batch_size=4, seq_len=16, log_fn=None,
                  device="cpu")
    res["moe_1x4"] = Engine(moe, pol, mesh=make_test_mesh(1, 4,
                                                          device="cpu"),
                            **moe_kw).run()
    res["moe_flat"] = Engine(moe, pol, **moe_kw).run()

    # refusals
    try:
        train_main(["--device", "cpu", "--mesh", "1x2", "--steps", "1"])
        res["cli_size"] = None
    except SystemExit as e:
        res["cli_size"] = e.code
    try:
        Engine(moe, pol, steps=1, batch_size=8, seq_len=16, mesh=mesh22,
               log_fn=None, device="cpu")
        res["moe"] = None
    except NotImplementedError as e:
        res["moe"] = str(e)
    try:
        Engine(cfg, QuantPolicy.fqt("bhq", 5, bhq_block=24), steps=1,
               batch_size=8, seq_len=16, accum_steps=2, mesh=mesh22,
               log_fn=None, device="cpu").run()
        res["straddle"] = None
    except ValueError as e:
        res["straddle"] = str(e)
    # a stochastic quantizer on a replicated operand (a weight): refused
    # on the mesh as on the flat engine, the same error
    wpol = QuantPolicy.fqt("psq", 8, overrides={
        r"layers\.mlp\.": {"fwd_weight": "psq:8"}})
    for name, m in (("stoch_weight", mesh22), ("stoch_weight_flat", None)):
        try:
            Engine(cfg, wpol, steps=1, batch_size=8, seq_len=16, mesh=m,
                   log_fn=None, device="cpu").run()
            res[name] = None
        except ValueError as e:
            res[name] = str(e)
    torch.save(res, Path(out) / f"engine.{rank}.pt")


SCENARIOS = {"steps": scenario_steps, "compress": scenario_compress,
             "engine": scenario_engine, "chunks": scenario_chunks}


def main(argv):
    scenario, rank, world, store, out = argv[:5]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.mesh import init_distributed
    init_distributed("cpu", f"file://{store}", rank, world)
    try:
        SCENARIOS[scenario](rank, world, out, *argv[5:])
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
