"""A mesh step computes the flat step's function: the port's engine on 4
gloo ranks, on a (2, 2) and then a (4, 1) mesh, against its flat engine.

The setup is the reference parity test's (tests/test_engine.py
``_PARITY_CODE``): reduced statquant-tx, 8 x 16 tokens, accumulation 2,
3 steps, ``fqt(bhq,5)`` with ``bhq_block=16`` and its overrides; then
``fqt(psq,8)`` (``lm_head`` exact, attention at 8 bits).  Each on
``simulate`` and on ``kernel`` (the kernels' plain versions on the CPU),
fused, and ``fqt(psq,8)`` also unfused (the ``quantize_sr`` kernels and
the per-tensor quantize with a given range).  Held to, as the reference
holds its 2x2 run to its unsharded one:

  * step 0 within rtol 1e-4 (the same parameters and SR draws: float32
    reduction-order noise only);
  * the 3-step trajectory within rtol 2e-3 / atol 2e-3;
  * every SR code of step 0 that a quantizer outside the fused kernels
    emits (PTQ, PSQ, BHQ in PyTorch and the ``quantize_sr`` kernels'
    plain versions) equal to the flat step's: the data ranks' codes,
    concatenated in rank order, are the flat codes.

The port's flat engine is held to the reference elsewhere
(tests/test_torch_train_steps.py, tests/test_torch_train_kernels.py).
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_dist_workers import MESHES, STEP_CONFIGS, spawn  # noqa: E402

FUSED_ONLY = {"psq8-kernel"}     # its SR quantizers run inside the kernels


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ranks = spawn("steps", 4, tmp_path_factory.mktemp("steps"), timeout=300)
    flat = {}
    for r in ranks:
        flat.update({k: v for k, v in r.items() if isinstance(k, str)})
    return flat, ranks


@pytest.mark.parametrize("name", [c[0] for c in STEP_CONFIGS])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_mesh_step_equals_flat_step(runs, shape, name):
    flat, ranks = runs
    h_flat, codes_flat = flat[name]
    data, model = shape
    data_ranks = [d * model for d in range(data)]   # model index 0
    for r in range(4):
        h_mesh, _ = ranks[r][(shape, name)]
        assert [s for s, _ in h_mesh] == [0, 1, 2]
        np.testing.assert_allclose(h_mesh[0][1], h_flat[0][1], rtol=1e-4)
        np.testing.assert_allclose([l for _, l in h_mesh],
                                   [l for _, l in h_flat], rtol=2e-3,
                                   atol=2e-3)
    mesh_codes = [ranks[r][(shape, name)][1] for r in data_ranks]
    assert all(len(c) == len(codes_flat) for c in mesh_codes)
    assert (len(codes_flat) == 0) == (name in FUSED_ONLY)
    for j, (who, want) in enumerate(codes_flat):
        assert all(c[j][0] == who for c in mesh_codes)
        got = torch.cat([c[j][1] for c in mesh_codes], dim=0)
        assert torch.equal(got, want), (j, who)
