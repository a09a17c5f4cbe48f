"""The port's fetch scheduler against the JAX package's: the interval set,
the admission gate (lanes, tenants, per-tier byte budgets), the rolling
percentile and the hedger.

Every case of tests/test_peer_hedge.py runs in both packages (``pkg``):
``ported_cases`` compiles the reference test file a second time with its
imports of ``nydus_snapshotter_tpu`` pointed at ``nydus_snapshotter_tpu_torch``
and collects each case once per package, so both run the reference's own
bodies, sizes and tolerances. The other fetch-side parity files
(tests/test_torch_{blobcache,peer,provenance,prefetch,cache_manager,slo}.py)
use the same helper. In every such case the other package's counters must
not move: each package keeps its own metrics registry.

Cross-package cases feed both packages the same numpy-seeded inputs and
hold equal: interval-set algebra (a hypothesis case), the tier-budget and
tenant-weight grammars, and the gate's grant order under one schedule.
"""

from __future__ import annotations

import ast
import functools
import importlib
import inspect
import sys
import threading
import types
from pathlib import Path

import numpy as np
import pytest
from _pytest.assertion.rewrite import rewrite_asserts
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

SIDES = ("ref", "port")
ROOTS = {"ref": "nydus_snapshotter_tpu", "port": "nydus_snapshotter_tpu_torch"}
_TESTS = Path(__file__).resolve().parent


def port_tool(name: str) -> types.ModuleType:
    """tools/<name>.py compiled again with every ``nydus_snapshotter_tpu``
    module path pointed at the port, as ``tools.<name>__port``."""
    key = f"tools.{name}__port"
    if key in sys.modules:
        return sys.modules[key]
    path = _TESTS.parent / "tools" / f"{name}.py"
    src = path.read_text().replace(ROOTS["ref"], ROOTS["port"]).replace(ROOTS["port"] + "_torch", ROOTS["port"])
    mod = types.ModuleType(key)
    mod.__file__ = str(path)
    sys.modules[key] = mod
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


def port_twin(
    name: str,
    keep: tuple[str, ...] = (),
    host: tuple[str, ...] = (),
    twins: tuple[str, ...] = (),
    subs: tuple[tuple[str, str], ...] = (),
    tools: tuple[str, ...] = (),
) -> types.ModuleType:
    """tests/<name>.py compiled again with every ``nydus_snapshotter_tpu``
    module path pointed at the port. ``keep`` lists source fragments, as
    written in the reference file, that stay on the reference package
    (a server half the port does not have, used as a test fixture).
    ``host`` names entry points the file imports that run on the card
    unless asked otherwise: the twin calls them with ``device="cpu"``.
    ``twins`` names other test files whose helpers this one imports
    (``from tests.<twin> import ...``): those imports are pointed at the
    twins' port twins, which must already be loaded, so a helper that
    spawns a daemon spawns the port's. ``subs`` lists (fragment,
    replacement) pairs for the port twin alone: a call of a ``host``
    entry point that the file imports inside a function gets its
    ``device="cpu"`` this way. ``tools`` names modules of tools/ that the
    file imports helpers from (``from tools.<name> import ...``): the twin
    imports them from their port copies (``port_tool``)."""
    key = f"tests.{name}__port"
    if key in sys.modules:
        return sys.modules[key]
    path = _TESTS / f"{name}.py"
    src = path.read_text()
    for twin in twins:
        assert f"tests.{twin}__port" in sys.modules, f"{name}: port twin of {twin} not loaded"
        assert f"from tests.{twin} import" in src, f"{name}: imports nothing of {twin}"
        src = src.replace(f"from tests.{twin} import", f"from tests.{twin}__port import")
    for tool in tools:
        assert f"from tools.{tool} import" in src, f"{name}: imports nothing of tools/{tool}"
        port_tool(tool)
        src = src.replace(f"from tools.{tool} import", f"from tools.{tool}__port import")
    for frag, repl in subs:
        assert frag in src, f"{name}: {frag!r} not in the reference file"
        src = src.replace(frag, repl)
    held = {f"\x00{i}\x00": frag for i, frag in enumerate(keep)}
    for mark, frag in held.items():
        assert frag in src, f"{name}: {frag!r} not in the reference file"
        src = src.replace(frag, mark)
    src = src.replace(ROOTS["ref"], ROOTS["port"]).replace(ROOTS["port"] + "_torch", ROOTS["port"])
    for mark, frag in held.items():
        src = src.replace(mark, frag)
    tree = ast.parse(src, str(path))
    rewrite_asserts(tree, src.encode(), str(path))
    mod = types.ModuleType(key)
    mod.__file__ = str(path)
    sys.modules[key] = mod
    exec(compile(tree, str(path), "exec"), mod.__dict__)
    for entry in host:
        setattr(mod, entry, functools.partial(getattr(mod, entry), device="cpu"))
    return mod


def _per_package_fixture(name: str, attr: str, scope: str):
    """A fixture that hands a ``pkg`` case its package's ``attr``."""

    def fixture(request, pkg):
        return request.getfixturevalue(f"_{pkg}_{name}{attr}")

    fixture.__name__ = attr
    return pytest.fixture(scope=scope, name=attr)(fixture)


def _dispatch(mods: dict, path: tuple[str, ...], fn):
    """One collected case that runs ``path`` (a function, or a class and
    a method) from the module of the ``pkg`` it is given."""

    def case(*args, pkg, **kw):
        target = mods[pkg]
        for part in path[:-1]:
            target = getattr(target, part)()
        return getattr(target, path[-1])(**kw)

    sig = inspect.signature(fn)
    params = [p for p in sig.parameters.values()]
    params.append(inspect.Parameter("pkg", inspect.Parameter.KEYWORD_ONLY))
    case.__signature__ = sig.replace(parameters=params)
    case.__name__ = case.__qualname__ = path[-1]
    case.__doc__ = fn.__doc__
    # Module scope groups the cases by package: every reference case runs
    # before every port case, so a thread a case leaves to finish its
    # accounting cannot move the other package's counters in the next one.
    case.pytestmark = list(getattr(fn, "pytestmark", [])) + [pytest.mark.parametrize("pkg", SIDES, scope="module")]
    return case


def _class_autouse(mods: dict, cls: str, name: str, scope: str):
    """A class's autouse fixture for the collected class: each case runs the
    fixture of its own package's class (an instance of it as ``self``, its
    other arguments from the case's fixtures)."""

    def fixture(self, request):
        owner = getattr(mods[request.getfixturevalue("pkg")], cls)
        fn = vars(owner)[name]._get_wrapped_function()
        params = list(inspect.signature(fn).parameters)[1:]
        result = fn(owner(), **{p: request.getfixturevalue(p) for p in params})
        if inspect.isgenerator(result):
            yield next(result)
            next(result, None)
        else:
            yield result

    fixture.__name__ = name
    return pytest.fixture(autouse=True, scope=scope, name=name)(fixture)


def ported_cases(
    name: str,
    ns: dict,
    keep: tuple[str, ...] = (),
    host: tuple[str, ...] = (),
    leave_out: tuple[str, ...] = (),
    only: tuple[str, ...] = (),
    twins: tuple[str, ...] = (),
    subs: tuple[tuple[str, str], ...] = (),
    tools: tuple[str, ...] = (),
) -> None:
    """Collect every case of tests/<name>.py into ``ns`` once per package.
    ``leave_out`` names cases (``Class::method`` or ``function``) whose
    modules the port does not have yet; the caller's docstring says why.
    ``only``, when given, names the sole cases to collect. The reference
    file's autouse fixtures run for both packages; each of its other
    fixtures is collected under its own name and, in a case, takes the
    definition of the case's package; a class's autouse fixtures run, for
    each case of the class, from the case's package."""
    mods = {"ref": importlib.import_module(f"tests.{name}"), "port": port_twin(name, keep, host, twins, subs, tools)}
    for side, mod in mods.items():
        for attr, obj in list(vars(mod).items()):
            marker = getattr(obj, "_fixture_function_marker", None)
            if marker is not None and marker.autouse:
                fixture_name = f"_{side}_{name}{attr}"
                ns[fixture_name] = pytest.fixture(autouse=True, name=fixture_name)(obj._get_wrapped_function())
            elif marker is not None:
                fixture_name = f"_{side}_{name}{attr}"
                ns[fixture_name] = pytest.fixture(scope=marker.scope, name=fixture_name)(obj._get_wrapped_function())
                if side == "ref":
                    assert attr not in ns, f"fixture {attr} collected twice"
                    ns[attr] = _per_package_fixture(name, attr, marker.scope)
    left = set(leave_out)

    def wanted(case: str) -> bool:
        return case not in left and (not only or case in only)

    # The reference file's module-level marks (a skip condition) hold for
    # every case collected from it.
    module_marks = getattr(mods["ref"], "pytestmark", [])
    module_marks = list(module_marks) if isinstance(module_marks, list) else [module_marks]
    for attr, obj in list(vars(mods["ref"]).items()):
        if attr.startswith("Test") and inspect.isclass(obj) and obj.__module__ == mods["ref"].__name__:
            body = {
                m: _dispatch(mods, (attr, m), fn)
                for m, fn in vars(obj).items()
                if m.startswith("test") and inspect.isfunction(fn) and wanted(f"{attr}::{m}")
            }
            if body:
                for m, fn in vars(obj).items():
                    marker = getattr(fn, "_fixture_function_marker", None)
                    if marker is not None and marker.autouse:
                        body[m] = _class_autouse(mods, attr, m, marker.scope)
                body["pytestmark"] = module_marks + list(getattr(obj, "pytestmark", []))
                assert attr not in ns, f"{attr} collected twice"
                ns[attr] = type(attr, (), body)
        elif attr.startswith("test_") and inspect.isfunction(obj) and wanted(attr):
            assert attr not in ns, f"{attr} collected twice"
            ns[attr] = _dispatch(mods, (attr,), obj)
            ns[attr].pytestmark = module_marks + ns[attr].pytestmark


def _counters(side: str) -> dict:
    reg = importlib.import_module(f"{ROOTS[side]}.metrics.registry").default_registry
    out = {}
    for name, metric in list(reg._metrics.items()):
        values = getattr(metric, "_values", None)
        if metric.kind == "counter" and values is not None:
            with metric._lock:
                out[name] = dict(values)
    return out


def other_package_still(exempt: tuple[str, ...] = ()):
    """An autouse fixture: a ``pkg`` case moves no counter of the other
    package. ``exempt`` lists metric-name prefixes a case's fixtures move
    on purpose (a reference server half that the port's case runs)."""

    @pytest.fixture(autouse=True)
    def _other_package_still(request):
        callspec = getattr(request.node, "callspec", None)
        side = callspec.params.get("pkg") if callspec is not None else None
        if side not in SIDES:
            yield
            return
        other = SIDES[1 - SIDES.index(side)]
        before = _counters(other)
        yield
        after = _counters(other)
        moved = sorted(
            n for n in set(before) | set(after)
            if before.get(n, {}) != after.get(n, {}) and not n.startswith(exempt)
        )
        assert not moved, f"{other} counters moved in a {side} case: {moved}"

    return _other_package_still


ported_cases("test_peer_hedge", globals())
_other_package_still = other_package_still()


# ------------------------------------------------------------- cross-package


def _fs(side: str):
    return importlib.import_module(f"{ROOTS[side]}.daemon.fetch_sched")


REF, PORT = _fs("ref"), _fs("port")

_OPS = st.lists(
    st.tuples(st.sampled_from(["add", "remove"]), st.integers(0, 4096), st.integers(0, 600)),
    max_size=40,
)


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(ops=_OPS, q=st.tuples(st.integers(0, 4096), st.integers(0, 900)))
def test_interval_set_algebra_equal(ops, q):
    sets = {side: _fs(side).IntervalSet() for side in SIDES}
    removed = {side: [] for side in SIDES}
    for op, start, length in ops:
        for side, s in sets.items():
            if op == "add":
                s.add(start, start + length)
            else:
                removed[side].append(s.remove(start, start + length))
    ref, port = sets["ref"], sets["port"]
    assert ref.spans() == port.spans() and removed["ref"] == removed["port"]
    assert ref.total_bytes() == port.total_bytes() and len(ref) == len(port)
    lo, hi = q[0], q[0] + q[1]
    assert ref.missing(lo, hi) == port.missing(lo, hi)
    assert ref.covered(lo, hi) == port.covered(lo, hi)


def _spec(rng, names, lo, hi) -> str:
    parts = []
    for _ in range(int(rng.integers(0, 5))):
        name = names[int(rng.integers(0, len(names)))]
        value = ["", "x", str(int(rng.integers(lo, hi)))][int(rng.integers(0, 3))]
        parts.append(f"{name}={value}" if rng.integers(0, 4) else name)
    return ",".join(parts)


def test_grammars_parse_equal():
    """The tier-budget and tenant-weight grammars give equal maps on
    seeded specs, bad entries included."""
    rng = np.random.default_rng(0x5EED)
    for _ in range(200):
        spec = _spec(rng, ("rack", "zone", "origin", ""), -2, 200)
        assert REF.parse_tier_budgets(spec) == PORT.parse_tier_budgets(spec), spec
        spec = _spec(rng, ("team-a", "team-b", "default", ""), -1, 9)
        assert REF.parse_tenant_weights(spec) == PORT.parse_tenant_weights(spec), spec


def test_gate_grant_order_equal():
    """One slot held, then waiters queued on seeded lanes, one tenant
    each (within a tenant the gate promises no order): both gates grant
    them in the same order."""
    rng = np.random.default_rng(7)
    picks = [(int(rng.integers(0, 4)), f"t{i}") for i in range(12)]
    order = {}
    for side in SIDES:
        fs = _fs(side)
        gate = fs.AdmissionGate(
            budget=fs.MemoryBudget(64 << 20), max_concurrent=1, demand_reserve=0,
            weights={"t0": 2.0}, name=f"order-{side}",
        )
        got: list[int] = []
        lock = threading.Lock()
        gate.acquire(4096)
        threads = []

        def run(i, lane, tenant):
            gate.acquire(4096, tenant, lane)
            with lock:
                got.append(i)
            gate.release(4096, tenant, lane)

        for i, (lane, tenant) in enumerate(picks):
            t = threading.Thread(target=run, args=(i, lane, tenant))
            t.start()
            threads.append(t)
            while gate.snapshot()["queued"] < i + 1:
                threading.Event().wait(0.001)
        gate.release(4096)
        for t in threads:
            t.join(10)
        order[side] = got
    assert order["ref"] == order["port"]
    assert sorted(order["ref"]) == list(range(12))
