"""``repro_torch.launch.roofline`` against ``repro.launch.roofline``.

The formulas are the reference's; the constants are the H100's (NVIDIA's
published dense peaks at 700 W) in place of the reference's TPU ones.  So
the reference's functions, run with its ``HW`` set to the port's, must
give the port's numbers: ``model_flops``, ``roofline_terms`` by ``int8``
and by the int8 backends, and ``collective_bytes`` over the same
collectives (HLO text on the reference's side, the issued calls on the
port's).  ``simulate`` and ``exact`` take the float32 peak on the card
(the reference takes the bfloat16 one for ``simulate``).
"""

import pytest

torch = pytest.importorskip("torch")

import repro.launch.roofline as ref  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402

CASES = [(3.2e15, 1.1e12, 4_000_000), (1e9, 7.5e13, 0),
         (5e14, 1e10, 9e11)]


@pytest.fixture
def h100(monkeypatch):
    for k in ("peak_bf16", "peak_int8", "hbm_bw", "link_bw"):
        monkeypatch.setitem(ref.HW, k, roofline.HW[k])


def test_published_h100_peaks():
    hw = roofline.HW
    assert hw["peak_bf16"] == 989e12 and hw["peak_int8"] == 1979e12
    assert hw["peak_fp32"] == 67e12 and hw["hbm_bw"] == 3.35e12
    assert hw["link_bw"] == 450e9 and hw["power_limit_w"] == 700


@pytest.mark.parametrize("kind", ["train", "fwd"])
def test_model_flops(kind):
    for n, t, f in ((2_500_000_000, 1_048_576, 1.0), (7e9, 4096, 0.18)):
        assert roofline.model_flops(n, t, kind, f) == ref.model_flops(
            n, t, kind, f)


@pytest.mark.parametrize("flops,nbytes,coll", CASES)
def test_roofline_terms_match_reference(h100, flops, nbytes, coll):
    for int8 in (True, False):
        assert roofline.roofline_terms(flops, nbytes, coll, int8=int8) == \
            ref.roofline_terms(flops, nbytes, coll, int8=int8)
    for backend in ("kernel", "native"):
        want = ref.roofline_terms(flops, nbytes, coll, backend="native")
        assert roofline.roofline_terms(flops, nbytes, coll,
                                       backend=backend) == want


@pytest.mark.parametrize("backend", ["simulate", "exact"])
def test_float32_backends_take_the_fp32_peak(backend):
    t = roofline.roofline_terms(67e12, 0, 0, backend=backend)
    assert t["compute_s"] == 1.0
    assert t["compute_s_bf16peak"] == 67e12 / 989e12
    with pytest.raises(ValueError):
        roofline.peak_for_backend("pallas")


def test_collective_bytes_match_reference_on_the_same_collectives():
    hlo = "\n".join([
        "%ar = f32[64,512]{1,0} all-reduce(f32[64,512]{1,0} %x)",
        "%ar2 = bf16[8]{0} all-reduce-start(bf16[8]{0} %y)",
        "%ar2d = bf16[8]{0} all-reduce-done(bf16[8]{0} %ar2)",
        "%ag = s8[16,29]{1,0} all-gather(s8[1,29]{1,0} %z)",
        "%rs = f32[4,4]{1,0} reduce-scatter(f32[64,4]{1,0} %w)",
        "%a2a = (s8[8,29], u32[2]) all-to-all(s8[8,29] %q, u32[2] %k)",
        "%cp = f32[3]{0} collective-permute(f32[3]{0} %p)",
        "%mul = f32[64,512]{1,0} multiply(%a, %b)"])
    calls = [("all-reduce", 64 * 512 * 4), ("all-reduce", 8 * 2),
             ("all-gather", 16 * 29), ("reduce-scatter", 4 * 4 * 4),
             ("all-to-all", 8 * 29 + 2 * 4), ("collective-permute", 12)]
    assert roofline.collective_bytes(calls) == ref.collective_bytes(hlo)
    with pytest.raises(ValueError):
        roofline.collective_bytes([("gather", 4)])


def test_unfused_bytes_stay_outside_the_bound():
    t = roofline.roofline_terms(1e9, 3.35e9, 0, backend="kernel",
                                unfused_bytes=3.35e13)
    assert t["memory_s"] == 1e-3 and t["memory_s_unfused"] == 10.0
    assert t["bottleneck"] == "memory" and t["step_time_lb_s"] == 1e-3
    assert "memory_s_unfused" not in roofline.roofline_terms(1e9, 1, 0)
