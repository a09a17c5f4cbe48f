"""The port's SLO plane against the JAX package's: objectives and their
validation, multi-window compliance and burn, the federated source, the
burn alert on an injected latency regression, and SLO actuation (lane
shedding on the admission gate, demand protection, the actuator's ladder,
the engine-actuator loop, the follower, config resolution).

Every case of tests/test_slo.py and tests/test_slo_actuation.py runs in
both packages (``pkg``, through ``ported_cases``: the reference's own
bodies, sizes and tolerances), and the other package's counters must not
move in any of them. ``federated_source`` takes its federator as an
argument, so the port's engine is tested with the reference test's own
stand-in federator.

Cross-package case: both engines fed one numpy-seeded latency stream on
one fake clock report the same status at every tick, and both actuators
driven by them shed and restore the same lanes in the same order.
"""

from __future__ import annotations

import importlib

import numpy as np

from tests.test_torch_fetch_sched import ROOTS, SIDES, other_package_still, ported_cases

ported_cases("test_slo", globals())
ported_cases("test_slo_actuation", globals())
_other_package_still = other_package_still()


class _Clock:
    def __init__(self):
        self.now = 5000.0

    def __call__(self):
        return self.now


def test_engine_and_actuator_equal_on_seeded_stream():
    rng = np.random.default_rng(0x510)
    phases = [(30, 5.0), (30, 300.0), (20, 300.0), (60, 5.0), (60, 5.0), (60, 5.0)]
    streams = [rng.exponential(mean, n) for n, mean in phases]
    trails = {}
    for side in SIDES:
        root = ROOTS[side]
        slo = importlib.import_module(f"{root}.metrics.slo")
        registry = importlib.import_module(f"{root}.metrics.registry")
        fs = importlib.import_module(f"{root}.daemon.fetch_sched")
        clock = _Clock()
        hist = registry.Histogram("op_ms", "t", buckets=(50, 100, 500))
        reg = registry.Registry()
        reg.register(hist)
        obj = slo.SloObjective(name="demand-read-p95", metric="op_ms", threshold_ms=100.0, target=0.9,
                               window_secs=10.0, long_window_factor=3.0, burn_threshold=1.0)
        engine = slo.SloEngine([obj], source=slo.local_source(reg), clock=clock)
        gate = fs.AdmissionGate(budget=fs.MemoryBudget(8 << 20), max_concurrent=4, name=f"slo-{side}")
        act = slo.SloActuator(engine, gate=gate, clock=clock)
        trail = []
        engine.tick()
        for values in streams:
            for v in values:
                hist.observe(float(v))
            clock.now += 10
            events = engine.tick()
            st = engine.status()["objectives"][0]
            ev = act.tick()
            trail.append((
                [e.get("kind", e.get("event")) for e in events],
                {k: st[k] for k in sorted(st) if k != "name"},
                None if ev is None else (ev["action"], ev["lane"]),
                gate.lane_state(),
            ))
        trails[side] = trail
    assert trails["ref"] == trails["port"]
    assert any(t[2] and t[2][0] == "shed" for t in trails["port"])
    assert any(t[2] and t[2][0] == "restore" for t in trails["port"])
