"""The port's endurance plane (scenario/soak.py, scenario/sentinel.py)
against the JAX package's: the growth-slope fit, the leak sentinels, the
closed-loop scale-up policy, the soak loop, its epoch replay and its
config resolution.

Every case of tests/test_soak.py runs in both packages (``pkg``, through
``ported_cases``: the reference's own bodies, specs and bounds); the
port's ``SoakRunner`` and ``replay_epoch`` get ``device="cpu"``. In every
such case the other package's counters must not move.

Cross-package cases: ``replay_epoch`` of ``misc/scenarios/soak_smoke.toml``
epoch 0 gives equal epoch fingerprints (read digests and blob ids) in both
packages, and ``fit_slope`` equals the reference's on seeded series.
"""

from __future__ import annotations

import importlib
import os

import numpy as np
import pytest

from tests.test_torch_fetch_sched import ROOTS, SIDES, other_package_still, ported_cases

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ported_cases("test_soak", globals(), host=("SoakRunner", "replay_epoch"))
_other_package_still = other_package_still()


def _mod(side: str, name: str):
    return importlib.import_module(f"{ROOTS[side]}.scenario.{name}")


def test_soak_smoke_epoch0_replays_equal_in_both_packages(tmp_path):
    out = {}
    for side in SIDES:
        spec = _mod(side, "spec").load_spec(os.path.join(REPO, "misc", "scenarios", "soak_smoke.toml"))
        kw = {"device": "cpu"} if side == "port" else {}
        out[side] = _mod(side, "soak").replay_epoch(spec, 0, str(tmp_path / side), **kw)
    assert out["ref"]["ok"] and out["port"]["ok"]
    assert out["port"]["fingerprint"] == out["ref"]["fingerprint"]
    assert out["port"]["fingerprint"]["reads"] and out["port"]["fingerprint"]["blobs"]


@pytest.mark.parametrize("warmup", [0, 1, 2, 4])
def test_fit_slope_equal_on_seeded_series(warmup):
    rng = np.random.default_rng(100 + warmup)
    for n in range(0, 12):
        series = (rng.integers(0, 1 << 30, n) + np.arange(n) * rng.integers(0, 1 << 20)).tolist()
        assert _mod("port", "sentinel").fit_slope(series, warmup) == _mod("ref", "sentinel").fit_slope(series, warmup)
