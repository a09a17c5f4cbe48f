"""The port's scenario runner (scenario/orchestrator.py) against the JAX
package's.

Every case of tests/test_scenario_engine.py runs in both packages (``pkg``,
through ``ported_cases``: the reference's own bodies, specs and sizes);
the port's ``ScenarioRunner`` and ``run_scenario`` get ``device="cpu"``,
where the shard-failover arm's dict services keep their indexes and run
K3's plain version. In every such case the other package's counters must
not move.

Cross-package case: ``misc/scenarios/mini.toml`` replayed serially in both
packages gives equal fingerprints (the id-normalized metastore dump, the
per-pod read digests, the blob ids), clean audits in both, and equal
reports apart from the timings (each phase's ``wall_s``, the SLO judge's
demand p95).
"""

from __future__ import annotations

import importlib
import os

from tests.test_torch_fetch_sched import ROOTS, SIDES, other_package_still, ported_cases

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ported_cases(
    "test_scenario_engine",
    globals(),
    host=("ScenarioRunner",),
    subs=(("run_scenario(mini_spec(), pods=2)", 'run_scenario(mini_spec(), pods=2, device="cpu")'),),
)
_other_package_still = other_package_still()


def _serial_mini(side: str, tmp_path) -> tuple[dict, dict, dict]:
    spec = importlib.import_module(f"{ROOTS[side]}.scenario.spec")
    orch = importlib.import_module(f"{ROOTS[side]}.scenario.orchestrator")
    kw = {"device": "cpu"} if side == "port" else {}
    return orch.run_scenario(
        spec.load_spec(os.path.join(REPO, "misc", "scenarios", "mini.toml")),
        workdir=str(tmp_path / side), serial=True, **kw,
    )


def _without_timings(report: dict) -> dict:
    out = dict(report)
    out["phases"] = [{k: v for k, v in p.items() if k != "wall_s"} for p in report["phases"]]
    out["slo"] = {k: v for k, v in report["slo"].items() if k != "demand_p95_ms"}
    return out


def test_serial_mini_replays_equal_in_both_packages(tmp_path):
    (rep_j, fp_j, au_j), (rep_t, fp_t, au_t) = (_serial_mini(side, tmp_path) for side in SIDES)
    assert rep_j["ok"], rep_j["error"]
    assert rep_t["ok"], rep_t["error"]
    assert fp_t == fp_j
    assert fp_t["reads"] and fp_t["blobs"] and fp_t["metastore"]
    assert au_j["clean"] and au_t["clean"], (au_j["issues"], au_t["issues"])
    assert au_t == au_j
    assert set(rep_t["slo"]) == set(rep_j["slo"])
    assert [set(p) for p in rep_t["phases"]] == [set(p) for p in rep_j["phases"]]
    assert _without_timings(rep_t) == _without_timings(rep_j)
