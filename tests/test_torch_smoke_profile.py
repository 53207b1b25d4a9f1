"""``chip_smoke.py``'s profile aggregation (``_event_averages``) gives the
rows of torch's own ``key_averages()``: the same keys, counts and self
CPU times (to 1e-6 relative), on a CPU profile with nested ops of one
name, ``record_function`` ranges and a backward.  The device side (kernels
by correlation id) needs the card; there ``chip_smoke.py`` logs each
profile's aggregation."""

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

FIELDS = ("count", "self_cpu_time_total", "self_device_time_total",
          "device_time_total")


def _rows(events):
    return {(e.key, str(e.device_type), e.is_user_annotation): e
            for e in events}


@pytest.mark.parametrize("threads", [1, 2])
def test_event_averages_match_key_averages(threads):
    from torch.profiler import ProfilerActivity, profile, record_function
    saved = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        gen = torch.Generator().manual_seed(0)
        lin = torch.nn.Linear(16, 32)
        x = torch.randn(8, 16, generator=gen)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("fp[outer]"):
                for _ in range(5):
                    y = lin(x).softmax(-1)
                    with record_function("fp[inner]"):
                        z = (y.double().float() * 2).sum()
                    z.backward()
                    torch.empty(8, 16).copy_(x)
        got = _rows(chip_smoke._event_averages(torch, prof))
        want = _rows(prof.key_averages())
    finally:
        torch.set_num_threads(saved)
    assert set(got) == set(want)
    for key, w in want.items():
        for f in FIELDS:
            a, b = getattr(w, f), getattr(got[key], f)
            assert abs(a - b) <= 1e-6 * max(1.0, abs(a)), (key, f, a, b)
