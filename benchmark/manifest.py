"""``BENCHMARK.json`` and the files it names, found by name.

Names are checked as the benchmark's contract has them: a name is at most
64 characters of ``A-Za-z0-9_.-`` starting with a letter, digit or ``_``; a
unit 1 to 16 characters of ``A-Za-z0-9_/%.-``.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


class ManifestError(ValueError):
    pass


def load(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise ManifestError(f"no {path.name} at {root}")
    return json.loads(path.read_text())


def cell(manifest: dict, workload: str) -> tuple[dict, dict, dict]:
    """(the workload's entry, its configuration file, its traffic file)."""
    for w in manifest["workloads"]:
        if w["name"] == workload:
            break
    else:
        raise ManifestError(f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in manifest["configs"] if c["name"] == w["config"])
    config = json.loads((ROOT / entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    return w, config, traffic


def metrics_of(manifest: dict, workload: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a workload reports."""
    return [m for m in manifest[kind] if workload in m.get("workloads", [workload])]


def load_module(path: Path, name: str):
    """Import one file of the benchmark by path (metric readers carry dots
    in their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ManifestError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The reader of one per-layer metric: ``metrics/<name>.py``."""
    return load_module(HERE / "metrics" / f"{metric}.py",
                       "benchmark.metrics." + metric.replace(".", "_").replace("-", "_"))


def problems(manifest: dict) -> list[str]:
    """What in a manifest breaks the naming rules or its cross references."""
    out = []
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in manifest.get(group, []):
            names.append(e["name"])
            if not NAME.fullmatch(e["name"]):
                out.append(f"{group}: bad name {e['name']!r}")
            if "unit" in e and not UNIT.fullmatch(e["unit"]):
                out.append(f"{e['name']}: bad unit {e['unit']!r}")
    if len(names) != len(set(names)):
        out.append("a name is used twice")
    configs = {c["name"] for c in manifest.get("configs", [])}
    cells = {w["name"] for w in manifest.get("workloads", [])}
    e2e = {m["name"] for m in manifest.get("end_to_end", [])}
    for w in manifest.get("workloads", []):
        if w["config"] not in configs:
            out.append(f"{w['name']}: unknown config")
        for key in ("config", "traffic"):
            if not NAME.fullmatch(w[key]):
                out.append(f"{w['name']}: bad {key} name")
        if not (HERE / "traffic" / f"{w['traffic']}.json").is_file():
            out.append(f"{w['name']}: no traffic file")
    for m in manifest.get("per_layer", []):
        if m["moves"] not in e2e:
            out.append(f"{m['name']}: moves an unknown metric")
        if not set(m.get("workloads", [])) <= cells:
            out.append(f"{m['name']}: unknown workload")
        if not (HERE / "metrics" / f"{m['name']}.py").is_file():
            out.append(f"{m['name']}: no reader")
    for c in manifest.get("configs", []):
        for key in c.get("reduced", []):
            if not NAME.fullmatch(key):
                out.append(f"{c['name']}: bad reduced key {key!r}")
        if not (ROOT / c["file"]).is_file():
            out.append(f"{c['name']}: no file")
    return out
