"""BENCHMARK.json: names and units, cross references, the files it names."""

from __future__ import annotations

import json

import pytest

from benchmark import manifest

TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def man():
    return manifest.load()


def test_no_problems(man):
    assert manifest.problems(man) == []
    assert set(man) == TOP
    assert len(json.dumps(man)) < 64 << 10


@pytest.mark.parametrize("name,ok", [("k1_roofline_pct", True), ("device_idle_pct.convert", True),
                                     ("a b", False), ("a/b", False), ("-x", False), ("x" * 65, False)])
def test_name_rule(name, ok):
    assert bool(manifest.NAME.fullmatch(name)) is ok


@pytest.mark.parametrize("unit,ok", [("GiB/s", True), ("%", True), ("s/GiB", True),
                                     ("tokens per s", False), ("µs", False), ("x" * 17, False)])
def test_unit_rule(unit, ok):
    assert bool(manifest.UNIT.fullmatch(unit)) is ok


def test_entries_carry_only_the_contracts_keys(man):
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    assert any(m["name"] == "setup_s" for m in man["end_to_end"])


def test_every_cell_reports_enough(man):
    for w in man["workloads"]:
        e2e = [m["name"] for m in manifest.metrics_of(man, w["name"], "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.metrics_of(man, w["name"], "per_layer")


def test_configs_name_their_driver_and_reference(man):
    for c in man["configs"]:
        config = json.loads((manifest.ROOT / c["file"]).read_text())
        assert (manifest.HERE / "drivers" / f"{config['driver']}.py").is_file()
        assert (manifest.HERE / "reference" / f"{config['reference']}.py").is_file()
        assert config["digester"] in ("sha256", "blake3")
        assert config["compressor"] in ("lz4_block", "zstd", "none")
