"""The port's scenario spec, arrival and evolution models against the JAX
package's.

The spec cases of tests/test_scenario_engine.py and every case of
tests/test_scenario_arrivals.py run in both packages (``pkg``); then
parity: the repo's spec catalog parses to the same tables, and the
arrival schedules, mutation counts, generations, evolved trees and shared
fractions are equal value for value. The runner cases of
test_scenario_engine.py wait for the port's ``scenario/orchestrator.py``
(the snapshot control plane, blob cache, peer tier and SLO engine).
"""

from __future__ import annotations

import dataclasses
import json
import os
import stat
from types import SimpleNamespace

import pytest

from nydus_snapshotter_tpu import scenario as jscenario
from nydus_snapshotter_tpu.scenario import arrivals as jarrivals
from nydus_snapshotter_tpu.scenario import corpus as jcorpus
from nydus_snapshotter_tpu.scenario import evolution as jevolution
from nydus_snapshotter_tpu.scenario import spec as jspec
from nydus_snapshotter_tpu_torch import scenario as tscenario
from nydus_snapshotter_tpu_torch.metrics import registry as tregistry
from nydus_snapshotter_tpu_torch.scenario import arrivals as tarrivals
from nydus_snapshotter_tpu_torch.scenario import corpus as tcorpus
from nydus_snapshotter_tpu_torch.scenario import evolution as tevolution
from nydus_snapshotter_tpu_torch.scenario import spec as tspec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = {
    "ref": SimpleNamespace(spec=jspec, arrivals=jarrivals, corpus=jcorpus, evolution=jevolution),
    "port": SimpleNamespace(spec=tspec, arrivals=tarrivals, corpus=tcorpus, evolution=tevolution),
}


@pytest.fixture(params=["ref", "port"])
def pkg(request):
    return PKG[request.param]


MINI = """
[scenario]
name = "t"
seed = 11
pods = 3

[[scenario.corpus]]
id = "img"
kind = "compressible"
mib = 2

[[scenario.phases]]
op = "convert"
corpus = ["img"]

[[scenario.phases]]
op = "deploy"
corpus = ["img"]
layers = 3
%s

[[scenario.phases]]
op = "remove"
fraction = 1.0

[[scenario.phases]]
op = "gc"
"""


def mini_spec(p, deploy_extra: str = ""):
    return p.spec.loads(MINI % deploy_extra)


# ---------------------------------------------------------------------------
# Spec loading / validation (tests/test_scenario_engine.py TestSpec)
# ---------------------------------------------------------------------------


class TestSpec:
    def test_round_trip(self, pkg):
        s = mini_spec(pkg, 'crash = "mid"\ncorrupt_peer = true')
        assert pkg.spec.ScenarioSpec.from_dict(json.loads(json.dumps(s.to_dict()))) == s

    @pytest.mark.parametrize(
        "mutation, match",
        [
            ("[scenario]\nname = 't'", "at least one"),
            ("[scenario]\nname = 't'\nphases = []", "at least one"),
            ("[bogus]\nx = 1", "scenario"),
        ],
    )
    def test_structurally_empty_specs_rejected(self, pkg, mutation, match):
        with pytest.raises(pkg.spec.ScenarioSpecError, match=match):
            pkg.spec.loads(mutation)

    def test_unknown_keys_rejected_everywhere(self, pkg):
        base = mini_spec(pkg).to_dict()
        for path in (("scenario",), ("scenario", "corpus", 0), ("scenario", "phases", 0),
                     ("scenario", "slo")):
            d = json.loads(json.dumps(base))
            node = d
            for part in path:
                node = node[part]
            node["zap"] = 1
            with pytest.raises(pkg.spec.ScenarioSpecError, match="unknown keys"):
                pkg.spec.ScenarioSpec.from_dict(d)

    def test_unknown_op_kind_and_mode_rejected(self, pkg):
        with pytest.raises(pkg.spec.ScenarioSpecError, match="unknown op"):
            pkg.spec.loads(MINI.replace('op = "convert"', 'op = "explode"') % "")
        with pytest.raises(pkg.spec.ScenarioSpecError, match="unknown kind"):
            pkg.spec.loads(MINI.replace('kind = "compressible"', 'kind = "gold"') % "")
        with pytest.raises(pkg.spec.ScenarioSpecError, match="crash must be"):
            mini_spec(pkg, 'crash = "always"')

    def test_corpus_refs_and_duplicates_validated(self, pkg):
        d = mini_spec(pkg).to_dict()
        d["scenario"]["phases"][0]["corpus"] = ["ghost"]
        with pytest.raises(pkg.spec.ScenarioSpecError, match="ghost"):
            pkg.spec.ScenarioSpec.from_dict(d)
        d = mini_spec(pkg).to_dict()
        d["scenario"]["corpus"].append(d["scenario"]["corpus"][0])
        with pytest.raises(pkg.spec.ScenarioSpecError, match="duplicate"):
            pkg.spec.ScenarioSpec.from_dict(d)

    def test_faults_validated(self, pkg):
        d = mini_spec(pkg).to_dict()
        for fault, match in (
            ({"site": "not.a.site", "action": "error(OSError)", "phase": 0}, "unknown failpoint site"),
            ({"site": "peer.fetch", "action": "kaboom{", "phase": 0}, "bad action"),
            ({"site": "peer.fetch", "action": "error(OSError)", "phase": 99}, "out of range"),
        ):
            d["scenario"]["faults"] = [fault]
            with pytest.raises(pkg.spec.ScenarioSpecError, match=match):
                pkg.spec.ScenarioSpec.from_dict(d)

    def test_slo_threshold_must_align_to_bucket(self, pkg):
        d = mini_spec(pkg).to_dict()
        d["scenario"]["slo"]["demand_threshold_ms"] = 47.0
        with pytest.raises(pkg.spec.ScenarioSpecError, match="bucket boundary"):
            pkg.spec.ScenarioSpec.from_dict(d)

    def test_cdc_resonant_params_validated(self, pkg):
        d = mini_spec(pkg).to_dict()
        d["scenario"]["corpus"][0] = {"id": "img", "kind": "cdc_resonant", "avg_kib": 3}
        with pytest.raises(pkg.spec.ScenarioSpecError, match="power of two"):
            pkg.spec.ScenarioSpec.from_dict(d)

    def test_list_specs_surfaces_broken_files(self, pkg, tmp_path):
        (tmp_path / "good.toml").write_text(MINI % "")
        (tmp_path / "bad.toml").write_text("[scenario]\nname='x'\nphases=[]")
        listed = pkg.spec.list_specs(str(tmp_path))
        assert len(listed) == 2
        by_name = {p.rsplit("/", 1)[-1]: (s, e) for p, s, e in listed}
        assert by_name["good.toml"][0] is not None
        assert by_name["bad.toml"][0] is None and by_name["bad.toml"][1]

    def test_repo_spec_catalog_loads(self, pkg):
        listed = pkg.spec.list_specs(os.path.join(REPO, "misc", "scenarios"))
        assert listed, "misc/scenarios is empty"
        for path, s, err in listed:
            assert s is not None, f"{path}: {err}"

    def test_spec_rejects_bad_deploy_api_and_misplaced_keys(self, pkg):
        with pytest.raises(pkg.spec.ScenarioSpecError, match="deploy_api"):
            pkg.spec.loads(MINI % 'deploy_api = "rest"')
        with pytest.raises(pkg.spec.ScenarioSpecError, match="only applies to deploy"):
            pkg.spec.loads((MINI % "").replace('op = "convert"', 'op = "convert"\ndeploy_api = "grpc"', 1))
        with pytest.raises(pkg.spec.ScenarioSpecError, match="only applies to convert"):
            pkg.spec.loads(MINI % "shard_failover = true")

    def test_soci_formats_spec_validation(self, pkg):
        base = """
[scenario]
name = "v"
seed = 1
pods = 2
[[scenario.corpus]]
id = "gz"
kind = "compressible"
mib = 1
[[scenario.phases]]
op = "deploy"
corpus = ["gz"]
%s
"""
        with pytest.raises(pkg.spec.ScenarioSpecError, match="soci = true"):
            pkg.spec.loads(base % 'soci_formats = ["gzip"]')
        with pytest.raises(pkg.spec.ScenarioSpecError, match="parallel"):
            pkg.spec.loads(base % 'soci = true\nsoci_formats = ["gzip", "gzip"]')
        with pytest.raises(pkg.spec.ScenarioSpecError, match="unknown soci format"):
            pkg.spec.loads(base % 'soci = true\nsoci_formats = ["lz4"]')


def test_catalog_parses_to_the_reference_tables():
    """Every spec of misc/scenarios: the same tables in both packages."""
    d = os.path.join(REPO, "misc", "scenarios")
    ref = {p: (s.to_dict() if s else None, e) for p, s, e in jspec.list_specs(d)}
    port = {p: (s.to_dict() if s else None, e) for p, s, e in tspec.list_specs(d)}
    assert port == ref and len(port) >= 4


@pytest.mark.parametrize("extra", ["", 'crash = "mid"\ncorrupt_peer = true', "adaptive = true"])
def test_mini_spec_dicts_equal(extra):
    assert tspec.loads(MINI % extra).to_dict() == jspec.loads(MINI % extra).to_dict()


def test_scenario_runtime_config_and_metrics(monkeypatch):
    """``resolve_scenario_config`` (env > [scenario] > defaults) and the
    ``ntpu_scenario_*`` metric names, as the reference's."""
    for env in ({}, {"NTPU_SCENARIO_SEED": "5", "NTPU_SCENARIO_PODS": "0",
                     "NTPU_SCENARIO_SPEC_DIR": "/specs"}, {"NTPU_SCENARIO_SEED": "x"}):
        for k in ("NTPU_SCENARIO_SEED", "NTPU_SCENARIO_PODS", "NTPU_SCENARIO_SPEC_DIR"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        t, j = tscenario.resolve_scenario_config(), jscenario.resolve_scenario_config()
        assert [getattr(t, k) for k in t.__slots__] == [getattr(j, k) for k in j.__slots__]
    for name in ("PHASES_TOTAL", "RUNS_TOTAL", "FAULTS_ARMED"):
        t, j = getattr(tscenario, name), getattr(jscenario, name)
        assert (t.name, t.help, t.label_names) == (j.name, j.help, j.label_names)
        assert tregistry.default_registry.register(t) is t  # registered once, on import
        assert f"# TYPE {t.name} counter" in tregistry.default_registry.render()


# ---------------------------------------------------------------------------
# Arrivals and evolution (tests/test_scenario_arrivals.py)
# ---------------------------------------------------------------------------


def soak(p):
    return p.spec.SoakSpec(epochs=32, base_pods=4, diurnal_amplitude=0.5, epochs_per_day=8,
                           flash_prob=0.2, flash_factor=3.0)


class TestArrivals:
    def test_schedule_deterministic_in_seed(self, pkg):
        a = pkg.arrivals.schedule(soak(pkg), 23)
        assert a == pkg.arrivals.schedule(soak(pkg), 23)
        assert pkg.arrivals.schedule(soak(pkg), 24) != a

    def test_wave_pure_in_epoch_not_in_call_order(self, pkg):
        forward = [pkg.arrivals.wave_for(soak(pkg), 23, e) for e in range(8)]
        backward = [pkg.arrivals.wave_for(soak(pkg), 23, e) for e in reversed(range(8))]
        assert forward == list(reversed(backward))

    def test_diurnal_trough_and_peak(self, pkg):
        assert pkg.arrivals.diurnal_factor(0, 8, 0.5) == pytest.approx(0.5)
        assert pkg.arrivals.diurnal_factor(4, 8, 0.5) == pytest.approx(1.5)
        assert pkg.arrivals.diurnal_factor(3, 8, 0.0) == 1.0
        assert pkg.arrivals.diurnal_factor(3, 1, 0.9) == 1.0

    def test_flash_crowds_multiply_the_rate(self, pkg):
        sk = soak(pkg)
        ws = pkg.arrivals.schedule(sk, 23)
        flash = [w for w in ws if w.flash]
        calm = [w for w in ws if not w.flash]
        assert flash and calm
        for w in flash:
            assert w.rate == pytest.approx(sk.base_pods * w.diurnal * sk.flash_factor)
        for w in calm:
            assert w.rate == pytest.approx(sk.base_pods * w.diurnal)

    def test_flash_coin_stable_under_extra_draws(self, pkg):
        before = [pkg.arrivals.wave_for(soak(pkg), 23, e).flash for e in range(16)]
        for e in range(16):
            pkg.evolution.mutations(23, 0.5, f"/p{e}", e)
        assert before == [pkg.arrivals.wave_for(soak(pkg), 23, e).flash for e in range(16)]

    def test_pod_count_positive_and_tail_clamped(self, pkg):
        for seed in (1, 23, 999):
            for w in pkg.arrivals.schedule(soak(pkg), seed):
                assert 1 <= w.pods <= int(w.rate * 2.0) + 2

    def test_unit_draw_range_and_salt_independence(self, pkg):
        draws = [pkg.arrivals.unit_draw(23, e, "flash") for e in range(64)]
        assert all(0.0 <= d < 1.0 for d in draws)
        assert pkg.arrivals.unit_draw(23, 0, "flash") != pkg.arrivals.unit_draw(23, 0, "evolve|/etc/hosts")

    def test_wave_to_dict_round_trip_fields(self, pkg):
        w = pkg.arrivals.wave_for(soak(pkg), 23, 5)
        d = w.to_dict()
        assert d["epoch"] == 5 and d["pods"] == w.pods
        assert set(d) == {"epoch", "pods", "reads_per_pod", "flash", "diurnal", "rate"}


class TestEvolution:
    def test_mutations_deterministic_and_cumulative(self, pkg):
        a = [pkg.evolution.mutations(23, 0.3, "/usr/bin/python", e) for e in range(16)]
        assert a == [pkg.evolution.mutations(23, 0.3, "/usr/bin/python", e) for e in range(16)]
        assert a[0] == 0 and all(x <= y for x, y in zip(a, a[1:]))

    def test_mutations_monotone_in_drift_rate(self, pkg):
        for path in ("/a", "/usr/lib/libc.so", "/etc/os-release"):
            assert pkg.evolution.mutations(23, 0.1, path, 24) <= pkg.evolution.mutations(23, 0.4, path, 24)

    def test_gen_of_stacks_on_manifest_gens(self, pkg):
        manifest = pkg.corpus.load_manifest(pkg.corpus.MANIFEST_TREE2)
        base_entry = next(e for e in manifest["entries"]
                          if stat.S_ISREG(e["mode"]) and e.get("gen", 0) > 0)
        path = base_entry["path"]
        g0 = pkg.evolution.gen_of(manifest, 23, 0.0, 0)(path)
        assert g0 == base_entry["gen"], "zero drift = tree2 derivation gens"
        assert pkg.evolution.gen_of(manifest, 23, 0.5, 16)(path) >= g0

    def test_evolved_members_epoch0_identical_to_base(self, pkg):
        manifest = pkg.corpus.load_manifest(pkg.corpus.MANIFEST_TREE2)
        base = pkg.corpus.members_to_tar(pkg.corpus.manifest_members(manifest))
        assert pkg.corpus.members_to_tar(pkg.evolution.evolved_members(manifest, 23, 0.25, 0)) == base

    def test_evolved_members_deterministic_and_drifting(self, pkg):
        manifest = pkg.corpus.load_manifest(pkg.corpus.MANIFEST_TREE2)
        a = pkg.corpus.members_to_tar(pkg.evolution.evolved_members(manifest, 23, 0.25, 6))
        assert a == pkg.corpus.members_to_tar(pkg.evolution.evolved_members(manifest, 23, 0.25, 6))
        c = pkg.corpus.members_to_tar(pkg.evolution.evolved_members(manifest, 23, 0.25, 7))
        assert c != a, "another epoch of drift must change the corpus"

    def test_shared_fraction_monotone_decay(self, pkg):
        manifest = pkg.corpus.load_manifest(pkg.corpus.MANIFEST_TREE2)
        by_epoch = [pkg.evolution.shared_fraction(manifest, 23, 0.15, e) for e in (0, 2, 4, 8, 16, 32)]
        assert by_epoch[0] == pytest.approx(1.0)
        assert all(x >= y for x, y in zip(by_epoch, by_epoch[1:])) and by_epoch[-1] < 1.0
        by_rate = [pkg.evolution.shared_fraction(manifest, 23, r, 16) for r in (0.0, 0.1, 0.3, 0.6)]
        assert by_rate[0] == pytest.approx(1.0)
        assert all(x >= y for x, y in zip(by_rate, by_rate[1:]))


class TestSoakSpecTable:
    def test_round_trip(self, pkg):
        assert pkg.spec.SoakSpec.from_dict(soak(pkg).to_dict()) == soak(pkg)

    def test_defaults_and_validation(self, pkg):
        sk = pkg.spec.SoakSpec.from_dict({})
        assert sk.epochs == 6 and sk.scaleup
        with pytest.raises(Exception, match="scenario.soak"):
            pkg.spec.SoakSpec.from_dict({"bogus_key": 1})
        with pytest.raises(Exception):
            pkg.spec.SoakSpec.from_dict({"drift_rate": 1.5})
        with pytest.raises(Exception):
            pkg.spec.SoakSpec.from_dict({"epochs": 0})

    def test_frozen(self, pkg):
        with pytest.raises(dataclasses.FrozenInstanceError):
            soak(pkg).epochs = 1  # type: ignore[misc]


@pytest.mark.parametrize("seed", [1, 23, 999])
def test_schedules_equal_reference(seed):
    t = [w.to_dict() for w in tarrivals.schedule(soak(PKG["port"]), seed)]
    j = [w.to_dict() for w in jarrivals.schedule(soak(PKG["ref"]), seed)]
    assert t == j


@pytest.mark.parametrize("epoch", [0, 1, 8, 24])
def test_evolution_equal_reference(epoch):
    """Generations, evolved trees and the shared fraction of both trees
    at soak.toml's seed and drift rate, as the reference's."""
    for name in (tcorpus.MANIFEST_TREE1, tcorpus.MANIFEST_TREE2):
        manifest = tcorpus.load_manifest(name)
        assert manifest == jcorpus.load_manifest(name)
        tg, jg = tevolution.gen_of(manifest, 23, 0.08, epoch), jevolution.gen_of(manifest, 23, 0.08, epoch)
        assert [tg(e["path"]) for e in manifest["entries"]] == [jg(e["path"]) for e in manifest["entries"]]
        assert tevolution.shared_fraction(manifest, 23, 0.08, epoch) == \
            jevolution.shared_fraction(manifest, 23, 0.08, epoch)
    manifest = tcorpus.load_manifest(tcorpus.MANIFEST_TREE2)
    assert tcorpus.members_to_tar(tevolution.evolved_members(manifest, 23, 0.08, epoch)) == \
        jcorpus.members_to_tar(jevolution.evolved_members(manifest, 23, 0.08, epoch))
