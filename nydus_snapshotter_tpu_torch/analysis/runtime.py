"""Opt-in runtime concurrency detector (``NTPU_ANALYZE=1``).

Two detectors, both fed by instrumented lock wrappers the concurrent
modules create through :func:`make_lock` / :func:`make_rlock` /
:func:`make_condition`:

- **runtime lock order**: every *blocking* acquisition while other
  instrumented locks are held adds an edge to a global order graph; an
  edge that closes a cycle is recorded as an order violation with both
  directions' provenance. This catches orders the static analyzer cannot
  resolve (locks passed between objects, data-dependent paths);
- **lockset (Eraser-style) races**: hot shared structures are annotated
  with :func:`note_read` / :func:`note_write` (or a :func:`shared`
  handle). Each variable keeps the classic state machine — virgin ->
  exclusive(owner) -> shared / shared-modified — and a candidate lockset
  intersected with the accessing thread's held instrumented locks; an
  empty lockset in shared-modified state is a race candidate, reported
  once per variable with both access points.

Disabled (the default) this module costs one global ``ENABLED`` load
per annotation and ``make_lock`` returns plain ``threading`` primitives
— the hot paths stay exactly as fast as before.

Deliberately excluded: the dict probe tables (lock-free by design,
key-before-value release stores) and the trace-ring stripe locks (the
per-span hot path; see trace/ring.py).
"""

from __future__ import annotations

import itertools
import os
import sys
import threading
from typing import Optional

ENABLED = os.environ.get("NTPU_ANALYZE", "") not in ("", "0", "off", "false")

_meta = threading.Lock()  # guards the graphs/reports; strictly leaf
_tls = threading.local()

# order graph: name -> set of successor names; edge provenance kept for
# the first sighting of each edge.
_edges: dict[str, set] = {}
_edge_where: dict[tuple, str] = {}
_order_violations: list[dict] = []
_seen_cycles: set = set()

# Eraser state per annotated variable name.
_vars: dict[str, dict] = {}
_races: list[dict] = []


# A thread's identity for the lockset state: drawn once per thread from a
# counter, never reused. ``threading.get_ident()`` is reused as soon as a
# thread ends, so a thread started after another one joined would be taken
# for it and a race between the two would go unseen.
_thread_tokens = itertools.count(1)


def _thread_token() -> int:
    try:
        return _tls.token
    except AttributeError:
        t = _tls.token = next(_thread_tokens)
        return t


def _held() -> list:
    try:
        return _tls.held
    except AttributeError:
        h = _tls.held = []
        return h


def _caller(depth: int = 2) -> str:
    try:
        f = sys._getframe(depth)
        return f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"
    except Exception:
        return "?"


def _reaches(src: str, dst: str) -> bool:
    """dst reachable from src in the order graph (callers hold _meta)."""
    seen = {src}
    work = [src]
    while work:
        n = work.pop()
        if n == dst:
            return True
        for s in _edges.get(n, ()):
            if s not in seen:
                seen.add(s)
                work.append(s)
    return False


def _record_order(acquiring: str, where: str) -> None:
    held = _held()
    if not held:
        return
    with _meta:
        for h in held:
            if h.name == acquiring:
                continue
            edge = (h.name, acquiring)
            if edge in _edge_where:
                continue
            # Adding h -> acquiring closes a cycle iff h is already
            # reachable from acquiring.
            if _reaches(acquiring, h.name):
                key = tuple(sorted((h.name, acquiring)))
                if key not in _seen_cycles:
                    _seen_cycles.add(key)
                    back = next(
                        (w for (a, b), w in _edge_where.items()
                         if a == acquiring and b == h.name),
                        "(transitive)",
                    )
                    _order_violations.append(
                        {
                            "locks": [h.name, acquiring],
                            "forward": where,
                            "reverse": back,
                        }
                    )
            _edges.setdefault(h.name, set()).add(acquiring)
            _edge_where[edge] = where


class LocksetLock:
    """threading.Lock / RLock wrapper feeding the detectors. Duck-typed
    for ``threading.Condition``'s fallback protocol (acquire / release /
    context manager), so ``make_condition(name, lock)`` composes."""

    def __init__(self, name: str, reentrant: bool = False):
        self.name = name
        self._inner = threading.RLock() if reentrant else threading.Lock()
        self._reentrant = reentrant
        self._depth = 0  # this-thread reentry depth (tracked per-thread below)

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if blocking:
            _record_order(self.name, _caller())
        got = (
            self._inner.acquire(blocking, timeout)
            if timeout != -1
            else self._inner.acquire(blocking)
        )
        if got:
            held = _held()
            if not (self._reentrant and any(h is self for h in held)):
                held.append(self)
            else:
                self._bump(+1)
        return got

    def release(self) -> None:
        held = _held()
        if self._reentrant and self._depth_of() > 0:
            self._bump(-1)
        else:
            for i in range(len(held) - 1, -1, -1):
                if held[i] is self:
                    del held[i]
                    break
        self._inner.release()

    # per-thread reentry depth for RLocks
    def _depth_of(self) -> int:
        return getattr(_tls, "depth_" + str(id(self)), 0)

    def _bump(self, d: int) -> None:
        setattr(_tls, "depth_" + str(id(self)), self._depth_of() + d)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self) -> bool:
        inner = getattr(self._inner, "locked", None)
        return inner() if inner else False


def make_lock(name: str):
    """A threading.Lock, instrumented when NTPU_ANALYZE is on."""
    return LocksetLock(name) if ENABLED else threading.Lock()


def make_rlock(name: str):
    return LocksetLock(name, reentrant=True) if ENABLED else threading.RLock()


def make_condition(name: str, lock=None):
    """A threading.Condition over an (instrumented) lock. With no lock,
    the condition's internal lock is instrumented under ``name``."""
    if not ENABLED:
        return threading.Condition(lock)
    return threading.Condition(lock if lock is not None else LocksetLock(name))


# ---------------------------------------------------------------------------
# Eraser-style lockset race detection on annotated shared state
# ---------------------------------------------------------------------------


def note(name: str, write: bool = True) -> None:
    """Record one access to the shared variable ``name`` from the current
    thread under its current instrumented lockset. Call sites guard on
    ``ENABLED`` so the disabled path costs one global load."""
    if not ENABLED:
        return
    tid = _thread_token()
    lockset = frozenset(h.name for h in _held())
    where = _caller()
    with _meta:
        v = _vars.get(name)
        if v is None:
            _vars[name] = {
                "state": "exclusive",
                "owner": tid,
                "lockset": None,
                "first": where,
                "raced": False,
            }
            return
        if v["state"] == "exclusive":
            if v["owner"] == tid:
                return
            v["lockset"] = lockset
            v["state"] = "shared-modified" if write else "shared"
        else:
            v["lockset"] = v["lockset"] & lockset
            if write:
                v["state"] = "shared-modified"
        if v["state"] == "shared-modified" and not v["lockset"] and not v["raced"]:
            v["raced"] = True
            _races.append(
                {
                    "var": name,
                    "first": v["first"],
                    "second": where,
                    "kind": "write" if write else "read",
                }
            )


def note_read(name: str) -> None:
    note(name, write=False)


def note_write(name: str) -> None:
    note(name, write=True)


class shared:
    """Annotation handle for a hot shared structure::

        self._flights_shared = runtime.shared(f"fetch.flights[{name}]")
        ...
        self._flights_shared.write()   # at mutation sites
        self._flights_shared.read()    # at lock-free / read sites
    """

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def read(self) -> None:
        if ENABLED:
            note(self.name, write=False)

    def write(self) -> None:
        if ENABLED:
            note(self.name, write=True)


# ---------------------------------------------------------------------------
# Reporting
# ---------------------------------------------------------------------------


def races() -> list[dict]:
    with _meta:
        return list(_races)


def order_violations() -> list[dict]:
    with _meta:
        return list(_order_violations)


def report() -> str:
    lines = []
    for r in races():
        lines.append(
            f"lockset race on {r['var']}: {r['kind']} at {r['second']} with "
            f"empty candidate lockset (first access {r['first']})"
        )
    for v in order_violations():
        lines.append(
            f"runtime lock-order cycle {v['locks'][0]} <-> {v['locks'][1]}: "
            f"{v['forward']} vs {v['reverse']}"
        )
    return "\n".join(lines)


def reset() -> None:
    with _meta:
        _edges.clear()
        _edge_where.clear()
        _order_violations.clear()
        _seen_cycles.clear()
        _vars.clear()
        _races.clear()


def enable(on: bool = True) -> None:
    """Flip the detector for tests. Only affects locks created after the
    flip (creation-time choice keeps the disabled path free)."""
    global ENABLED
    ENABLED = on
