"""Scenario engine: declarative worst-day-in-production storms.

Every per-subsystem gate in this tree (pipeline determinism, blobcache
chaos, snapshot storms, peer churn, SLO actuation) exercises ONE layer
at a time on synthesized-content corpora. A production fleet sees all of
them at once: adversarial layers, corrupt peers, and mixed
convert+deploy+remove+GC churn with daemons crashing mid-storm. This
package composes **corpus generators × fault schedules × lifecycle
phases** into one gated end-to-end run:

- :mod:`scenario.corpus` — deterministic corpus generators: real-derived
  trees from the committed Ubuntu fixture manifests (including the
  second tree for real-vs-real cross-tree dedup), plus adversarial
  inputs — all-incompressible layers, chunk-boundary-resonant CDC
  content, tiny-file floods, single huge files, and corrupt/truncated
  blob variants for the peer tier;
- :mod:`scenario.spec` — a TOML scenario spec
  (``[[scenario.phases]]``) describing the phase sequence, corpus
  bindings, fault schedule and SLO budget;
- :mod:`scenario.arrivals` and :mod:`scenario.evolution` — the soak's
  arrival process and corpus-evolution (drift) model, pure functions of
  ``(seed, epoch)``.

The runner that drives a spec (the reference's ``scenario/orchestrator.py``,
with ``soak.py`` and ``sentinel.py``) needs the snapshot control plane, the
blob cache, the peer tier and the SLO engine, which the port does not have
yet; the spec catalog lives in ``misc/scenarios/``.

Metrics: ``ntpu_scenario_*``, registered here for the runner to count
into. Config: ``[scenario]`` with ``NTPU_SCENARIO*`` env overrides.
"""

from __future__ import annotations

import os

from nydus_snapshotter_tpu_torch.metrics import registry as _metrics

_reg = _metrics.default_registry

PHASES_TOTAL = _reg.register(
    _metrics.Counter(
        "ntpu_scenario_phases_total",
        "Scenario phases executed, by lifecycle op "
        "(convert/deploy/remove/gc/crash_restart)",
        ("op",),
    )
)
RUNS_TOTAL = _reg.register(
    _metrics.Counter(
        "ntpu_scenario_runs_total",
        "Scenario runs completed, by outcome (pass/fail)",
        ("outcome",),
    )
)
FAULTS_ARMED = _reg.register(
    _metrics.Counter(
        "ntpu_scenario_faults_armed_total",
        "Failpoint arms performed by scenario fault schedules",
    )
)


class ScenarioRuntimeConfig:
    __slots__ = ("spec_dir", "report_path", "seed", "pods")

    def __init__(self, spec_dir: str, report_path: str, seed: int, pods: int):
        self.spec_dir = spec_dir
        self.report_path = report_path
        self.seed = seed
        self.pods = pods


def _global_scenario_config():
    try:
        from nydus_snapshotter_tpu_torch.config import config as _cfg

        return _cfg.get_global_config().scenario
    except Exception:
        return None


def _env_int(name: str, default: int) -> int:
    """A non-negative integer from the environment, else ``default``."""
    try:
        v = int(os.environ.get(name, ""))
        return v if v >= 0 else default
    except ValueError:
        return default


def resolve_scenario_config() -> ScenarioRuntimeConfig:
    """env (``NTPU_SCENARIO*``) > ``[scenario]`` global config > defaults."""
    sc = _global_scenario_config()
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    spec_dir = os.environ.get(
        "NTPU_SCENARIO_SPEC_DIR",
        getattr(sc, "spec_dir", "") or os.path.join(repo, "misc", "scenarios"),
    )
    report_path = os.environ.get(
        "NTPU_SCENARIO_REPORT",
        getattr(sc, "report_path", "") or os.path.join(repo, "SCENARIO_STORM_r01.json"),
    )
    return ScenarioRuntimeConfig(
        spec_dir=spec_dir,
        report_path=report_path,
        seed=_env_int("NTPU_SCENARIO_SEED", getattr(sc, "seed", 7)),
        pods=max(1, _env_int("NTPU_SCENARIO_PODS", getattr(sc, "pods", 16))),
    )
