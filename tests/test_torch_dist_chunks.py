"""The chunked head loss on a mesh computes the flat step's function.

The reference cuts the global batch's flattened rows into
``loss_chunks`` contiguous chunks, each chunk's head GEMM keyed
``fold_in(key, c)`` with its own per-tensor ranges.  On a mesh each data
rank runs its part of every chunk its rows meet, under the chunk's index
and in the group of the ranks that share the chunk
(``sharding.data.loss_chunks``).  The port's engine on 4 gloo ranks, on
a (2, 2) mesh at 4 chunks (two whole chunks a rank), a (4, 1) mesh at 4
(one a rank) and at 2 (a chunk over two ranks), against its flat engine
at the same chunk count: the reduced statquant-tx, 8 x 16 tokens,
accumulation 2, 3 steps, the head GEMM quantized under ``fqt(bhq, 5)``
(``bhq_block=16``) and unfused ``fqt(psq, 8)``, on the ``kernel``
backend (the kernels' plain versions on the CPU).  Held to the
tolerances of ``tests/test_torch_dist_step.py``:

  * step 0 within rtol 1e-4, the 3-step trajectory within rtol 2e-3 /
    atol 2e-3;
  * every SR code of step 0 a quantizer outside the fused kernels emits
    equal to the flat step's: the layers' codes concatenated over the
    data ranks in rank order, and each head chunk's codes concatenated
    over the ranks that hold its rows.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_dist_workers import (CHUNK_CONFIGS, CHUNK_MESHES,  # noqa: E402
                                STEP_KW, spawn)

VP = 512                     # the reduced config's padded vocabulary
ROWS = STEP_KW["batch_size"] // STEP_KW["accum_steps"] * STEP_KW["seq_len"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ranks = spawn("chunks", 4, tmp_path_factory.mktemp("chunks"),
                  timeout=300)
    flat = {}
    for r in ranks:
        flat.update({k: v for k, v in r.items() if len(k) == 2})
    return flat, ranks


def _holders(data: int, lc: int) -> dict:
    """{chunk: [data ranks holding its rows, in order]} and, per rank, its
    chunks in the order its pieces run."""
    local, cs = ROWS // data, ROWS // lc
    pieces = {}
    for d in range(data):
        if local % cs == 0:
            pieces[d] = [d * (local // cs) + j for j in range(local // cs)]
        else:
            pieces[d] = [d // (cs // local)]
    chunks = {c: [d for d in range(data) if c in pieces[d]]
              for c in range(lc)}
    return chunks, pieces


def _by_chunk(records: list, chunk_order: list, accum: int) -> dict:
    """{(microbatch, chunk): [records]} from one run's head records: each
    microbatch's backward runs its chunks last first."""
    per_mb = len(records) // accum
    k = per_mb // len(chunk_order)
    assert per_mb * accum == len(records) and k * len(chunk_order) == per_mb
    out = {}
    for mb in range(accum):
        mine = records[mb * per_mb:(mb + 1) * per_mb]
        for g, c in enumerate(reversed(chunk_order)):
            out[(mb, c)] = mine[g * k:(g + 1) * k]
    return out


@pytest.mark.parametrize("name", [c[0] for c in CHUNK_CONFIGS])
@pytest.mark.parametrize("shape,lc", CHUNK_MESHES,
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else str(v))
def test_chunked_mesh_step_equals_flat_step(runs, shape, lc, name):
    flat, runs = runs
    h_flat, codes_flat = flat[(name, lc)]
    data, model = shape
    for r in range(4):
        h_mesh, _ = runs[r][(shape, lc, name)]
        assert [s for s, _ in h_mesh] == [0, 1, 2]
        np.testing.assert_allclose(h_mesh[0][1], h_flat[0][1], rtol=1e-4)
        np.testing.assert_allclose([l for _, l in h_mesh],
                                   [l for _, l in h_flat], rtol=2e-3,
                                   atol=2e-3)
    ranks = [runs[d * model][(shape, lc, name)][1] for d in range(data)]

    def split(recs):
        return ([r for r in recs if r[1].shape[-1] != VP],
                [r for r in recs if r[1].shape[-1] == VP])
    body_flat, head_flat = split(codes_flat)
    parts = [split(c) for c in ranks]
    assert head_flat
    for j, (who, want) in enumerate(body_flat):
        assert all(p[0][j][0] == who for p in parts)
        got = torch.cat([p[0][j][1] for p in parts], dim=0)
        assert torch.equal(got, want), (j, who)
    accum = STEP_KW["accum_steps"]
    chunks, pieces = _holders(data, lc)
    flat = _by_chunk(head_flat, list(range(lc)), accum)
    mine = [_by_chunk(parts[d][1], pieces[d], accum) for d in range(data)]
    for (mb, c), want in flat.items():
        for j, (who, codes) in enumerate(want):
            got = [mine[d][(mb, c)][j] for d in chunks[c]]
            assert all(w == who for w, _ in got)
            cat = torch.cat([g for _, g in got], dim=0)
            assert torch.equal(cat, codes), (mb, c, j, who)
