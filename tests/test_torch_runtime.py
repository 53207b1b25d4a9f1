"""The port's fault-tolerance runtime (``repro_torch.runtime``):
preemption, straggler detection, retry and the elastic policy, as
``tests/test_runtime.py`` holds the JAX package's; and the straggler probe
in the port's ``Engine`` (``tests/test_engine.py``)."""

import signal

import pytest

torch = pytest.importorskip("torch")

from repro_torch.runtime import (ElasticController,  # noqa: E402
                                 PreemptionHandler, StragglerMonitor, retry)


def test_preemption_programmatic():
    prm = PreemptionHandler()
    assert not prm.should_stop
    prm.request_stop()
    assert prm.should_stop


def test_preemption_signal():
    prm = PreemptionHandler(install=True, signals=(signal.SIGUSR1,))
    assert not prm.should_stop
    signal.raise_signal(signal.SIGUSR1)
    assert prm.should_stop


def test_straggler_detection():
    mon = StragglerMonitor(n_hosts=4, threshold=2.0, patience=3)
    normal = [1.0, 1.0, 1.0, 1.0]
    slow = [1.0, 1.0, 1.0, 5.0]
    for _ in range(2):
        mon.record(slow)
    assert mon.stragglers() == []          # not patient enough yet
    mon.record(slow)
    assert mon.stragglers() == [3]
    mon.record(normal)                     # recovery clears the streak
    assert mon.stragglers() == []


def test_straggler_needs_consistency():
    mon = StragglerMonitor(n_hosts=3, threshold=2.0, patience=2)
    mon.record([1.0, 1.0, 9.0])
    mon.record([1.0, 9.0, 1.0])            # different host each time
    assert mon.stragglers() == []


def test_retry_succeeds_after_failures():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient")
        return "ok"

    assert retry(flaky, max_attempts=5, sleep=lambda s: None) == "ok"
    assert calls["n"] == 3


def test_retry_exhausts():
    def always():
        raise OSError("down")
    with pytest.raises(OSError):
        retry(always, max_attempts=2, sleep=lambda s: None)


def test_retry_does_not_catch_other_exceptions():
    def typo():
        raise ValueError("bug")
    with pytest.raises(ValueError):
        retry(typo, max_attempts=3, sleep=lambda s: None)


def test_elastic_controller():
    ec = ElasticController(model_parallel=16)
    plan = ec.plan_mesh(healthy_chips=256)
    assert plan == {"data": 16, "model": 16}
    # lose a host worth of chips -> shrink DP
    plan = ec.plan_mesh(healthy_chips=240)
    assert plan == {"data": 15, "model": 16}
    assert ec.should_rescale(current_dp=16, healthy_chips=240)
    assert not ec.should_rescale(current_dp=15, healthy_chips=240)
    with pytest.raises(RuntimeError):
        ec.plan_mesh(healthy_chips=8)


def test_port_keeps_its_own_copy_of_the_module():
    """The port keeps its own copy of the module: the same names, the
    same behaviour (the tests above), no import of the JAX package."""
    import repro.runtime.fault_tolerance as ref
    import repro_torch.runtime.fault_tolerance as port
    assert port.__all__ == ref.__all__
    assert port.PreemptionHandler is not ref.PreemptionHandler


def test_straggler_probe_flags_slow_host():
    """With an injected fleet-times probe (what scheduler heartbeats supply
    on a real cluster), a persistently slow host is flagged and logged."""
    from repro_torch.configs import get_config
    from repro_torch.core import QuantPolicy
    from repro_torch.engine import Engine
    msgs = []
    eng = Engine(get_config("statquant-tx", smoke=True),
                 QuantPolicy.fqt("bhq", 5, bhq_block=16, backend="kernel"),
                 steps=6, batch_size=4, seq_len=16, log_every=100,
                 straggler=StragglerMonitor(n_hosts=4, patience=2),
                 straggler_probe=lambda dt: [dt, dt, dt, dt * 10],
                 log_fn=msgs.append, device="cpu")
    eng.run(steps=3)
    assert eng.straggler.stragglers() == [3]
    assert any("stragglers: [3]" in m for m in msgs)
    assert len(eng.straggler.history) == 3
