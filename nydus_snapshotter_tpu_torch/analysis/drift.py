"""Drift gates: code vs the four hand-maintained catalogs.

Each gate cross-checks something the code *does* against something a
human *wrote down*, in both directions where that makes sense:

- **metrics**: every ``ntpu_*`` metric registered in code must be
  documented (docs/*.md; ``ntpu_foo_*`` prefix wildcards allowed), and
  every exactly-named documented metric must exist in code;
- **config**: every ``[section] key`` declared in ``config/config.py``
  must appear in ``docs/configure.md`` AND in the commented example
  ``misc/snapshotter/config.toml``; every ``NTPU_*`` environment
  override read anywhere in the package must be documented, and every
  exactly-named documented override must be read somewhere;
- **failpoints**: every ``failpoint.hit("site")`` literal must be in
  ``failpoint.KNOWN_SITES``; every known site must be fired somewhere in
  the tree, documented in ``docs/robustness.md``, and referenced by at
  least one test (chaos coverage);
- **trace carry**: every ``Thread(target=...)`` / ``executor.submit``
  whose target transitively opens trace spans must either capture the
  submitting context (``trace.capture``) or adopt one on the worker
  (``trace.with_context``) — otherwise the worker's spans silently
  detach into parentless roots.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Optional

from nydus_snapshotter_tpu_torch.analysis.model import Finding
from nydus_snapshotter_tpu_torch.analysis.package import PackageModel

METRIC_CTORS = {"Counter", "Gauge", "TTLGauge", "Histogram", "LazyCounter"}
_METRIC_RE = re.compile(r"ntpu_[a-z0-9_]+\*?")
_ENV_RE = re.compile(r"NTPU_[A-Z0-9_*{},]+")
_ENV_CODE_RE = re.compile(r"^NTPU_[A-Z0-9_]+$")


def _read_docs(root: str, names=None) -> str:
    out = []
    docdir = os.path.join(root, "docs")
    for fn in sorted(os.listdir(docdir)):
        if not fn.endswith(".md"):
            continue
        if names is not None and fn not in names:
            continue
        with open(os.path.join(docdir, fn), "r", encoding="utf-8") as f:
            out.append(f.read())
    return "\n".join(out)


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------


def _declared_metrics(model: PackageModel):
    """{name: (module, lineno)} for every registered ntpu_* metric."""
    found = {}
    for mm in model.modules.values():
        for node in ast.walk(mm.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else None
            )
            if name not in METRIC_CTORS or not node.args:
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                if arg.value.startswith("ntpu_"):
                    found.setdefault(arg.value, (mm.name, node.lineno))
    return found


def _native_symbols(root: str, package: str) -> set[str]:
    """``ntpu_*`` C entry names of the analysed package's native chunk
    engine (``native/chunk_engine/``) and CUDA kernels (``csrc/``) — they
    share the metric prefix in docs but are not metrics."""
    out: set[str] = set()
    pkg_dir = os.path.join(root, *package.split("."))
    for sub, exts in ((("native", "chunk_engine"), (".cpp", ".h")), (("csrc",), (".cu",))):
        ndir = os.path.join(pkg_dir, *sub)
        if not os.path.isdir(ndir):
            continue
        for fn in os.listdir(ndir):
            if fn.endswith(exts):
                with open(os.path.join(ndir, fn), "r", encoding="utf-8") as f:
                    out.update(re.findall(r"\b(ntpu_[a-z0-9_]+)\s*\(", f.read()))
    return out


def _expand_braces(tok: str) -> list[str]:
    m = re.match(r"^(.*)\{([a-z0-9_,]+)\}(.*)$", tok)
    if not m:
        return [tok]
    return [m.group(1) + part + m.group(3) for part in m.group(2).split(",")]


def find_metric_drift(model: PackageModel, root: str) -> list[Finding]:
    findings: list[Finding] = []
    declared = _declared_metrics(model)
    native = _native_symbols(root, model.package)
    text = _read_docs(root)
    exact: set[str] = set()
    prefixes: set[str] = set()
    for raw in re.findall(r"ntpu_[a-z0-9_{},]*\*?", text):
        if "{" in raw and "," not in raw:
            # ``metric{label}`` — the brace group is a label set, not an
            # alternation; the metric name is everything before it.
            raw = raw.split("{", 1)[0]
        for tok in _expand_braces(raw):
            if tok.endswith("*"):
                p = tok[:-1]
                if len(p) > len("ntpu_"):  # a bare ntpu_* covers nothing
                    prefixes.add(p)
            elif re.fullmatch(r"ntpu_[a-z0-9_]+[a-z0-9]", tok):
                # (a trailing underscore is a truncated prose prefix, not
                # a metric name)
                exact.add(tok)

    def documented(name: str) -> bool:
        return name in exact or any(name.startswith(p) for p in prefixes)

    for name, (mod, lineno) in sorted(declared.items()):
        if not documented(name):
            findings.append(
                Finding(
                    detector="drift-metrics",
                    module=mod,
                    qualname=name,
                    detail=f"undocumented:{name}",
                    message=f"metric {name} is emitted but not documented in docs/",
                    lineno=lineno,
                )
            )
    # Reverse: exactly-named doc claims must exist (prefix wildcards and
    # sub-series names a Histogram renders, _bucket/_sum/_count, excused).
    emitted = set(declared)
    series_suffixes = ("_bucket", "_sum", "_count")
    for name in sorted(exact):
        if name in emitted or any(name.startswith(p) for p in prefixes):
            continue
        if name in native or name.rstrip("_") in native:
            continue  # native engine symbol, not a metric
        if any(
            name == base + sfx for base in emitted for sfx in series_suffixes
        ):
            continue
        findings.append(
            Finding(
                detector="drift-metrics",
                module="docs",
                qualname=name,
                detail=f"stale-doc:{name}",
                message=f"docs reference metric {name}, which no code registers",
            )
        )
    return findings


# ---------------------------------------------------------------------------
# Config sections / keys / env overrides
# ---------------------------------------------------------------------------


def _config_schema(model: PackageModel):
    """{section: [keys]} + top-level keys from the SnapshotterConfig
    dataclass tree in config/config.py."""
    mm = model.modules.get(f"{model.package}.config.config")
    if mm is None:
        return {}, []
    class_fields: dict[str, list[str]] = {}
    for node in mm.tree.body:
        if not isinstance(node, ast.ClassDef):
            continue
        fields = []
        for sub in node.body:
            if isinstance(sub, ast.AnnAssign) and isinstance(sub.target, ast.Name):
                fields.append((sub.target.id, sub))
        class_fields[node.name] = fields
    sections: dict[str, list[str]] = {}
    top: list[str] = []
    for fname, node in class_fields.get("SnapshotterConfig", []):
        factory = None
        if isinstance(node.value, ast.Call):
            for kw in node.value.keywords:
                if kw.arg == "default_factory" and isinstance(kw.value, ast.Name):
                    factory = kw.value.id
        if factory and factory in class_fields:
            sections[fname] = [k for k, _ in class_fields[factory]]
        else:
            top.append(fname)
    return sections, top


def _env_vars_in_code(model: PackageModel) -> dict[str, str]:
    found: dict[str, str] = {}
    for mm in model.modules.values():
        for node in ast.walk(mm.tree):
            if (
                isinstance(node, ast.Constant)
                and isinstance(node.value, str)
                and _ENV_CODE_RE.match(node.value)
            ):
                found.setdefault(node.value, mm.name)
    return found


def _expand_env_tokens(text: str):
    """Doc-side NTPU_* mentions -> (exact names, prefix wildcards).
    Handles ``NTPU_PIPELINE_{QUEUE,BUDGET,WINDOW}_MIB`` brace groups and
    ``NTPU_TRACE*`` trailing wildcards."""
    exact: set[str] = set()
    prefixes: set[str] = set()
    for tok in _ENV_RE.findall(text):
        toks = [tok]
        m = re.match(r"^(.*)\{([A-Z0-9_,]+)\}(.*)$", tok)
        if m:
            toks = [m.group(1) + part + m.group(3) for part in m.group(2).split(",")]
        for t in toks:
            t = t.rstrip(",")
            if t.endswith("*"):
                prefixes.add(t[:-1])
            elif _ENV_CODE_RE.match(t):
                exact.add(t)
    return exact, prefixes


def find_config_drift(model: PackageModel, root: str) -> list[Finding]:
    findings: list[Finding] = []
    sections, _top = _config_schema(model)
    configure_md = _read_docs(root, names={"configure.md"})
    toml_path = os.path.join(root, "misc", "snapshotter", "config.toml")
    toml_text = ""
    if os.path.exists(toml_path):
        with open(toml_path, "r", encoding="utf-8") as f:
            toml_text = f.read()

    for section, keys in sorted(sections.items()):
        if f"[{section}]" not in configure_md:
            findings.append(
                Finding(
                    detector="drift-config",
                    module="docs/configure.md",
                    qualname=f"[{section}]",
                    detail=f"section-undocumented:{section}",
                    message=f"config section [{section}] is not documented in "
                    "docs/configure.md",
                )
            )
        if f"[{section}]" not in toml_text:
            findings.append(
                Finding(
                    detector="drift-config",
                    module="misc/snapshotter/config.toml",
                    qualname=f"[{section}]",
                    detail=f"section-missing-example:{section}",
                    message=f"config section [{section}] has no example in "
                    "misc/snapshotter/config.toml",
                )
            )
        for key in keys:
            if f"`{key}`" not in configure_md and f"{key} " not in configure_md:
                findings.append(
                    Finding(
                        detector="drift-config",
                        module="docs/configure.md",
                        qualname=f"{section}.{key}",
                        detail=f"key-undocumented:{section}.{key}",
                        message=f"config key [{section}] {key} is not documented "
                        "in docs/configure.md",
                    )
                )
            if not re.search(rf"(?m)^\s*#?\s*{re.escape(key)}\s*=", toml_text):
                findings.append(
                    Finding(
                        detector="drift-config",
                        module="misc/snapshotter/config.toml",
                        qualname=f"{section}.{key}",
                        detail=f"key-missing-example:{section}.{key}",
                        message=f"config key [{section}] {key} has no (commented) "
                        "example in misc/snapshotter/config.toml",
                    )
                )

    # NTPU_* environment overrides, both directions, against all docs.
    alldocs = _read_docs(root)
    exact, prefixes = _expand_env_tokens(alldocs)
    in_code = _env_vars_in_code(model)
    for var, mod in sorted(in_code.items()):
        if var in exact or any(var.startswith(p) for p in prefixes):
            continue
        findings.append(
            Finding(
                detector="drift-config",
                module=mod,
                qualname=var,
                detail=f"env-undocumented:{var}",
                message=f"environment override {var} is read in code but "
                "documented in no docs/*.md",
            )
        )
    for var in sorted(exact):
        if var not in in_code:
            findings.append(
                Finding(
                    detector="drift-config",
                    module="docs",
                    qualname=var,
                    detail=f"env-stale-doc:{var}",
                    message=f"docs reference environment override {var}, "
                    "which no code reads",
                )
            )
    return findings


# ---------------------------------------------------------------------------
# Failpoints
# ---------------------------------------------------------------------------


def _known_sites(model: PackageModel):
    mm = model.modules.get(f"{model.package}.failpoint")
    if mm is None:
        return []
    for node in mm.tree.body:
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id == "KNOWN_SITES"
            and isinstance(node.value, (ast.Tuple, ast.List))
        ):
            return [
                e.value
                for e in node.value.elts
                if isinstance(e, ast.Constant) and isinstance(e.value, str)
            ]
    return []


def _hit_sites(model: PackageModel):
    """{site: (module, lineno)} for every failpoint.hit("...") literal."""
    found: dict[str, tuple] = {}
    for mm in model.modules.values():
        if mm.name == f"{model.package}.failpoint":
            continue
        for node in ast.walk(mm.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if not (
                isinstance(f, ast.Attribute)
                and f.attr == "hit"
                and isinstance(f.value, ast.Name)
                and f.value.id == "failpoint"
            ):
                continue
            if node.args and isinstance(node.args[0], ast.Constant):
                found.setdefault(str(node.args[0].value), (mm.name, node.lineno))
    return found


def _tests_text(root: str) -> str:
    out = []
    tdir = os.path.join(root, "tests")
    if os.path.isdir(tdir):
        for fn in sorted(os.listdir(tdir)):
            if fn.endswith(".py"):
                with open(os.path.join(tdir, fn), "r", encoding="utf-8") as f:
                    out.append(f.read())
    # The exhaustive chaos sweep lives in tools/ and is also reachable as
    # a slow-marked test; it counts as chaos coverage.
    cm = os.path.join(root, "tools", "chaos_matrix.py")
    if os.path.exists(cm):
        with open(cm, "r", encoding="utf-8") as f:
            out.append(f.read())
    return "\n".join(out)


def find_failpoint_drift(model: PackageModel, root: str) -> list[Finding]:
    findings: list[Finding] = []
    known = _known_sites(model)
    hits = _hit_sites(model)
    robustness = _read_docs(root, names={"robustness.md"})
    tests = _tests_text(root)

    for site, (mod, lineno) in sorted(hits.items()):
        if site not in known:
            findings.append(
                Finding(
                    detector="drift-failpoints",
                    module=mod,
                    qualname=site,
                    detail=f"unregistered:{site}",
                    message=f"failpoint.hit({site!r}) fires a site missing from "
                    "failpoint.KNOWN_SITES",
                    lineno=lineno,
                )
            )
    for site in known:
        if site not in hits:
            findings.append(
                Finding(
                    detector="drift-failpoints",
                    module=f"{model.package}.failpoint",
                    qualname=site,
                    detail=f"unfired:{site}",
                    message=f"KNOWN_SITES entry {site!r} is never fired by any "
                    "failpoint.hit in the tree",
                )
            )
        if site not in robustness:
            findings.append(
                Finding(
                    detector="drift-failpoints",
                    module="docs/robustness.md",
                    qualname=site,
                    detail=f"undocumented:{site}",
                    message=f"failpoint site {site!r} is not documented in "
                    "docs/robustness.md",
                )
            )
        if site not in tests:
            findings.append(
                Finding(
                    detector="drift-failpoints",
                    module="tests",
                    qualname=site,
                    detail=f"untested:{site}",
                    message=f"failpoint site {site!r} is exercised by no test "
                    "(tests/*.py, tools/chaos_matrix.py)",
                )
            )
    return findings


# ---------------------------------------------------------------------------
# Trace-context carry across pool boundaries
# ---------------------------------------------------------------------------


def _callee_closure(model: PackageModel, start_key: str) -> set[str]:
    seen = {start_key}
    work = [start_key]
    while work:
        k = work.pop()
        fi = model.functions.get(k)
        if fi is None:
            continue
        for ref, _held, _ln in fi.calls:
            tgt = model.resolve_ref(fi, ref)
            if tgt is not None and tgt.key not in seen:
                seen.add(tgt.key)
                work.append(tgt.key)
        for name, key in fi.nested.items():
            if key not in seen:
                seen.add(key)
                work.append(key)
    return seen


def find_trace_carry_drift(model: PackageModel) -> list[Finding]:
    findings: list[Finding] = []
    opens = {"span", "start_span", "traced"}
    carries = {"capture", "with_context", "remote_context"}
    for key, fi in sorted(model.functions.items()):
        for ref, kind, lineno in fi.spawns:
            tgt = model.resolve_ref(fi, ref)
            if tgt is None:
                continue
            reach = _callee_closure(model, tgt.key)
            opens_span = any(
                model.functions[k].trace_refs & opens
                for k in reach
                if k in model.functions
            )
            if not opens_span:
                continue  # worker never touches tracing: nothing to carry
            carried = bool(fi.trace_refs & carries) or any(
                model.functions[k].trace_refs & carries
                for k in reach
                if k in model.functions
            )
            if carried:
                continue
            tname = ref[-1] if ref else "?"
            findings.append(
                Finding(
                    detector="drift-trace-carry",
                    module=fi.module,
                    qualname=fi.qualname,
                    detail=f"uncarried:{kind}:{tname}",
                    message=(
                        f"{kind} target {tname} transitively opens trace spans "
                        "but neither the submitter captures a context "
                        "(trace.capture) nor the worker adopts one "
                        "(trace.with_context) — its spans detach into new roots"
                    ),
                    lineno=lineno,
                )
            )
    return findings


def find_all_drift(model: PackageModel, root: str) -> list[Finding]:
    out = []
    out += find_metric_drift(model, root)
    out += find_config_drift(model, root)
    out += find_failpoint_drift(model, root)
    out += find_trace_carry_drift(model)
    return out
