"""The port's concurrency analyzers (analysis/{model,baseline,package,locks,
drift}.py, cmd/analyze.py) and its runtime lockset detector against the JAX
package's.

Every case of tests/test_analysis.py runs in both packages (``pkg``,
through ``ported_cases``: the reference's own planted fixtures). On the
port's side the real-tree cases analyse ``nydus_snapshotter_tpu_torch``
through ``cmd/analyze.py`` against the port's own reviewed baseline
(``analysis/baseline.toml``): zero new findings, none stale, every entry
justified. One case runs on the port alone: the reference's
``TestLocksetRuntime::test_planted_unlocked_write_race_detected`` fails
in the reference whenever Python hands its second writer thread the first
one's reused ``threading.get_ident()``, a fault the port fixed (ROADMAP
Queue C, C5); its port twin and a case that forces the ident reuse are
below.

Cross-package cases: both packages' detectors over one set of planted
fixtures give equal findings; the port's detectors over the reference
package give exactly the reference detectors' findings; the command line
gates, writes JSON and rewrites a baseline keeping its justifications.
"""

from __future__ import annotations

import importlib
import json
import os
import textwrap
import threading
import types

import pytest

from tests.test_torch_fetch_sched import ROOTS, SIDES, ported_cases

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ported_cases(
    "test_analysis",
    globals(),
    leave_out=("TestLocksetRuntime::test_planted_unlocked_write_race_detected",),
    subs=((
        'os.path.join(REPO, "tools", "analyze.py")',
        'os.path.join(REPO, "nydus_snapshotter_tpu_torch", "cmd", "analyze.py")',
    ),),
)


def _an(side: str, name: str):
    return importlib.import_module(f"{ROOTS[side]}.analysis.{name}")


# ------------------------------------------------------------- the C5 fault


@pytest.fixture
def port_rt():
    rt = _an("port", "runtime")
    rt.reset()
    rt.enable(True)
    yield rt
    rt.enable(os.environ.get("NTPU_ANALYZE", "") not in ("", "0", "off", "false"))
    rt.reset()


class TestLocksetRuntimePort:
    def test_planted_unlocked_write_race_detected(self, port_rt):
        def w():
            for _ in range(200):
                port_rt.note_write("planted.counter")

        ts = [threading.Thread(target=w) for _ in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert any(r["var"] == "planted.counter" for r in port_rt.races())

    def test_race_seen_when_the_second_thread_starts_after_the_first_joins(self, port_rt):
        """The second writer starts only after the first has ended, so Python
        usually hands it the first one's ident; the race is still seen."""
        idents = []

        def w():
            idents.append(threading.get_ident())
            port_rt.note_write("sequential.counter")

        for _ in range(2):
            t = threading.Thread(target=w)
            t.start()
            t.join()
        assert len(idents) == 2
        assert [r["var"] for r in port_rt.races()] == ["sequential.counter"]


class _ReusedIdents(types.ModuleType):
    """``threading`` as the lockset detector sees it, with every thread
    reporting one ident: Python's reuse of an ended thread's ident, forced."""

    def __init__(self):
        super().__init__("threading")

    def __getattr__(self, name):
        return getattr(threading, name)

    @staticmethod
    def get_ident():
        return 1


def test_forced_ident_reuse_hides_the_race_from_the_reference_only(monkeypatch):
    found = {}
    for side in SIDES:
        rt = _an(side, "runtime")
        monkeypatch.setattr(rt, "threading", _ReusedIdents())
        rt.reset()
        rt.enable(True)
        try:
            for _ in range(2):
                t = threading.Thread(target=rt.note_write, args=("reused.counter",))
                t.start()
                t.join()
            found[side] = [r["var"] for r in rt.races()]
        finally:
            rt.enable(os.environ.get("NTPU_ANALYZE", "") not in ("", "0", "off", "false"))
            rt.reset()
    assert found == {"ref": [], "port": ["reused.counter"]}


# ------------------------------------------------------ the static detectors

PLANTED = {
    "locks.py": """
        import queue
        import threading
        from contextlib import contextmanager

        class A:
            def __init__(self):
                self._la = threading.Lock()
                self._lb = threading.Lock()
                self._lock = threading.Lock()
                self._q = queue.Queue(maxsize=4)
                self._cv = threading.Condition()

            def one(self):
                with self._la:
                    self._grab_b()

            def _grab_b(self):
                with self._lb:
                    pass

            def two(self):
                with self._lb:
                    with self._la:
                        pass

            def boom(self):
                with self._lock:
                    self._again()

            def _again(self):
                with self._lock:
                    self._q.put(1)

            def bad_wait(self):
                with self._la:
                    with self._cv:
                        self._cv.wait()

            @contextmanager
            def txn(self):
                self._lb.acquire()
                try:
                    yield
                finally:
                    self._lb.release()

            def join_under_txn(self, fut, t):
                with self.txn():
                    fut.result()
                    t.join()
        """,
    "met.py": """
        from fixtures.metrics.registry import Counter, Gauge

        BOGUS = Counter("ntpu_bogus_total", "planted undocumented metric")
        GOOD = Gauge("ntpu_documented_bytes", "documented metric")
        """,
    "failpoint/__init__.py": """
        KNOWN_SITES = ("a.known", "b.unfired")

        def hit(site):
            pass
        """,
    "mod.py": """
        import threading

        from fixtures import failpoint, trace

        def work():
            failpoint.hit("a.known")
            failpoint.hit("c.rogue")

        def worker():
            with trace.span("fixture.op"):
                pass

        def spawn_uncarried():
            t = threading.Thread(target=worker)
            t.start()
            return t
        """,
    "config/config.py": """
        from dataclasses import dataclass, field

        @dataclass
        class FooConfig:
            mystery_knob: int = 7
            documented_knob: int = 1

        @dataclass
        class SnapshotterConfig:
            foo: FooConfig = field(default_factory=FooConfig)
            bar: FooConfig = field(default_factory=FooConfig)
        """,
    "env.py": """
        import os

        KNOB = os.environ.get("NTPU_PLANTED_KNOB", "")
        """,
}
PLANTED_DOCS = {
    "obs.md": "We export `ntpu_documented_bytes` and watch `ntpu_ghost_total`.\n",
    "configure.md": "## `[foo]`\n\n| `documented_knob` | 1 |\n\nSet `NTPU_STALE_KNOB` to...\n",
    "robustness.md": "Sites: `a.known`.\n",
}


def _planted_root(tmp_path) -> str:
    root = tmp_path / "planted"
    for rel, src in PLANTED.items():
        path = root / "fixtures" / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(src))
    (root / "fixtures" / "__init__.py").write_text("")
    (root / "docs").mkdir()
    for name, text in PLANTED_DOCS.items():
        (root / "docs" / name).write_text(text)
    (root / "misc" / "snapshotter").mkdir(parents=True)
    (root / "misc" / "snapshotter" / "config.toml").write_text("[foo]\ndocumented_knob = 1\n")
    (root / "tests").mkdir()
    (root / "tests" / "test_x.py").write_text('failpoint.inject("b.unfired", "error(OSError)")\n')
    return str(root)


def _findings(side: str, root: str, package: str) -> list[tuple]:
    model = _an(side, "package").PackageModel(root, package)
    locks, drift = _an(side, "locks"), _an(side, "drift")
    found = (locks.find_lock_order_findings(model) + locks.find_blocking_findings(model)
             + drift.find_all_drift(model, root))
    return [(f.fingerprint, f.lineno, f.severity, f.message) for f in found]


def test_planted_fixtures_give_equal_findings_in_both_packages(tmp_path):
    root = _planted_root(tmp_path)
    ref, port = (_findings(side, root, "fixtures") for side in SIDES)
    assert port == ref
    detectors = {fp.split(":", 1)[0] for fp, *_ in port}
    assert detectors == {"lock-order", "blocking-under-lock", "drift-metrics", "drift-config",
                         "drift-failpoints", "drift-trace-carry"}, detectors


def test_port_detectors_over_the_reference_package_equal_the_reference(tmp_path):
    ref, port = (_findings(side, REPO, ROOTS["ref"]) for side in SIDES)
    assert port == ref
    assert len(port) >= 18  # the reference's reviewed baseline


def test_port_detectors_read_the_analysed_package_native_symbols(tmp_path):
    """``ntpu_*`` names of the analysed package's C++ engine and CUDA kernels
    are C entries, not metrics: a doc naming one is no stale metric."""
    root = _planted_root(tmp_path)
    csrc = tmp_path / "planted" / "fixtures" / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('extern "C" int ntpu_planted_launch(void *x) { return 0; }\n')
    with open(os.path.join(root, "docs", "obs.md"), "a") as f:
        f.write("The kernel's C entry is `ntpu_planted_launch`.\n")
    model = _an("port", "package").PackageModel(root, "fixtures")
    details = {f.detail for f in _an("port", "drift").find_metric_drift(model, root)}
    assert "stale-doc:ntpu_ghost_total" in details
    assert "stale-doc:ntpu_planted_launch" not in details


# --------------------------------------------------------------- the command


def test_cli_gates_the_port_package_on_its_own_baseline(capsys):
    cli = importlib.import_module(f"{ROOTS['port']}.cmd.analyze")
    assert cli.main(["--fail-on-new", "--fail-on-stale"]) == 0
    out = capsys.readouterr().out
    assert "0 new" in out and "stale" not in out
    baseline = _an("port", "baseline").load_baseline()
    assert all(j and not j.startswith("TODO") for j in baseline.values())
    assert all(fid.split(":", 2)[1].startswith(ROOTS["port"]) or fid.split(":", 2)[1] == "docs"
               for fid in baseline), baseline


def test_cli_json_and_write_baseline(tmp_path, capsys):
    cli = importlib.import_module(f"{ROOTS['port']}.cmd.analyze")
    base = _an("port", "baseline")
    kept = dict(list(base.load_baseline().items())[:3])
    path = tmp_path / "baseline.toml"
    path.write_text(base.render_baseline(kept))
    # A partial baseline: the other findings are new, so the gate fails.
    out_json = tmp_path / "found.json"
    assert cli.main(["--baseline", str(path), "--fail-on-new", "--json", str(out_json)]) == 1
    payload = json.loads(out_json.read_text())
    assert sorted(payload["suppressed"]) == sorted(kept)
    assert payload["new"] and payload["stale_suppressions"] == []
    # Rewriting keeps the three justifications and gives every other
    # finding a TODO one for a reviewer to replace; the gate then passes.
    assert cli.main(["--baseline", str(path), "--write-baseline"]) == 0
    rewritten = base.load_baseline(str(path))
    assert {fid: j for fid, j in rewritten.items() if fid in kept} == kept
    assert {j for fid, j in rewritten.items() if fid not in kept} == {"TODO: justify or fix"}
    assert len(rewritten) == len(payload["new"]) + len(kept)
    assert cli.main(["--baseline", str(path), "--fail-on-new", "--fail-on-stale"]) == 0
    capsys.readouterr()


def test_cli_gates_the_reference_package_on_its_baseline(capsys):
    """``--package`` and ``--baseline`` point the port's command at the
    reference package and its reviewed baseline: no new finding, none
    stale."""
    cli = importlib.import_module(f"{ROOTS['port']}.cmd.analyze")
    ref_base = os.path.join(REPO, ROOTS["ref"], "analysis", "baseline.toml")
    assert cli.main(["--package", ROOTS["ref"], "--baseline", ref_base, "--fail-on-new", "--fail-on-stale"]) == 0
    assert "0 new, 18 baselined" in capsys.readouterr().out
