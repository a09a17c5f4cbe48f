"""Lock-order analyzer + blocking-under-lock lint.

Built on the held-set walks in :mod:`.package`:

- **lock order**: every acquisition of lock B while holding lock A adds
  the edge A -> B to the inter-procedural acquisition graph (calls made
  under A contribute edges to every lock the callee can transitively
  acquire). A cycle in that graph is a potential deadlock; a 2-cycle is
  the classic lock-order inversion. Self-edges on non-reentrant locks
  (re-acquiring a plain ``Lock`` you already hold) are reported too —
  that one is not "potential", it deadlocks deterministically.
- **blocking under lock**: calls that can block indefinitely (or for an
  injected failpoint delay) while a lock is held serialize everything
  behind that lock on an external event — the exact shape of stall the
  PrepareBoard joins / flight promotion / dict-service reconcile paths
  can hide. ``Condition.wait()`` on the *held* condition is excused
  (wait releases it); any OTHER lock held across the wait is flagged.

Both detectors are heuristic: they over-approximate reachability and
under-approximate aliasing, so every finding is a candidate to either
fix or suppress **with a written justification** in
``analysis/baseline.toml``.
"""

from __future__ import annotations

import ast
from typing import Optional

from nydus_snapshotter_tpu_torch.analysis.model import Finding
from nydus_snapshotter_tpu_torch.analysis.package import FunctionInfo, LockDef, PackageModel

# Attribute-call names that block on an external event. ``wait`` covers
# Event.wait / Condition.wait / Future/process wait; ``result`` is the
# Future join; ``acquire`` on semaphore/budget-ish receivers is a
# capacity wait (real lock acquires are modeled separately, as locks).
_SOCKETISH = {"recv", "recv_into", "accept", "connect", "sendall"}
_SUBPROCESS = {"run", "check_call", "check_output", "call", "communicate"}
_SEMAPHORISH = ("sem", "budget", "window", "limiter", "slots")


def classify_blocking(walker, call: ast.Call, func, held):
    """(kind, desc, held, lineno, excused_locks) or None. Called from the
    package walker for every Call node; cheap name-shape checks only."""
    if not isinstance(func, ast.Attribute):
        if isinstance(func, ast.Name) and func.id in ("sleep", "_sleep", "urlopen"):
            kind = "sleep" if "sleep" in func.id else func.id
            return (kind, func.id, tuple(held), call.lineno, ())
        return None
    attr = func.attr
    recv = func.value
    recv_name = _recv_name(recv)

    if attr == "sleep":
        return ("sleep", f"{recv_name}.sleep", tuple(held), call.lineno, ())

    if attr == "join":
        # str.join takes one non-numeric positional; thread/process join
        # takes none or a numeric/keyword timeout.
        if call.args and not _is_numeric(call.args[0]):
            return None
        return ("join", f"{recv_name}.join", tuple(held), call.lineno, ())

    if attr == "result":
        return ("future.result", f"{recv_name}.result", tuple(held), call.lineno, ())

    if attr == "wait":
        excused = ()
        ld = walker.lock_of(recv)
        if ld is not None:
            # Condition.wait releases its own lock while waiting.
            excused = (ld,)
        return ("wait", f"{recv_name}.wait", tuple(held), call.lineno, excused)

    if attr == "get":
        # queue.get() blocks with no positional args; dict.get(k) never
        # has zero args, so the arity IS the discriminator.
        if call.args:
            return None
        if any(kw.arg == "block" and _is_false(kw.value) for kw in call.keywords):
            return None
        if not (_queueish(walker, recv, recv_name)):
            return None
        return ("queue.get", f"{recv_name}.get", tuple(held), call.lineno, ())

    if attr == "put":
        if any(kw.arg == "block" and _is_false(kw.value) for kw in call.keywords):
            return None
        if not _queueish(walker, recv, recv_name):
            return None
        return ("queue.put", f"{recv_name}.put", tuple(held), call.lineno, ())

    if attr == "acquire":
        # Real locks are modeled as acquisitions; semaphore/budget-like
        # receivers are capacity waits.
        if walker.lock_of(recv) is not None:
            return None
        if any(s in recv_name.lower() for s in _SEMAPHORISH):
            return (
                "semaphore.acquire",
                f"{recv_name}.acquire",
                tuple(held),
                call.lineno,
                (),
            )
        return None

    if attr in _SOCKETISH:
        return ("socket", f"{recv_name}.{attr}", tuple(held), call.lineno, ())

    if attr in _SUBPROCESS and recv_name == "subprocess":
        return ("subprocess", f"subprocess.{attr}", tuple(held), call.lineno, ())

    if attr == "hit" and recv_name == "failpoint":
        site = ""
        if call.args and isinstance(call.args[0], ast.Constant):
            site = str(call.args[0].value)
        return ("failpoint", f"failpoint.hit({site})", tuple(held), call.lineno, ())

    return None


def _recv_name(recv) -> str:
    if isinstance(recv, ast.Name):
        return recv.id
    if isinstance(recv, ast.Attribute):
        base = _recv_name(recv.value)
        return f"{base}.{recv.attr}" if base else recv.attr
    return ""


def _is_numeric(node) -> bool:
    return isinstance(node, ast.Constant) and isinstance(node.value, (int, float))


def _is_false(node) -> bool:
    return isinstance(node, ast.Constant) and node.value is False


def _queueish(walker, recv, recv_name: str) -> bool:
    tail = recv_name.rsplit(".", 1)[-1].lower()
    if (
        isinstance(recv, ast.Attribute)
        and isinstance(recv.value, ast.Name)
        and recv.value.id == "self"
        and walker.cm is not None
        and recv.attr in walker.cm.queue_attrs
    ):
        return True
    return "queue" in tail or tail in ("q", "_q") or tail.endswith("_q")


# ---------------------------------------------------------------------------
# Lock-order analysis
# ---------------------------------------------------------------------------


class LockGraph:
    """Directed acquisition graph over LockDef identities with edge
    provenance (who acquired what while holding what, and via which call
    chain)."""

    def __init__(self):
        self.edges: dict = {}  # (a_id, b_id) -> list[str] provenance

    def add(self, a: LockDef, b: LockDef, why: str) -> None:
        key = (a.id, b.id)
        prov = self.edges.setdefault(key, [])
        if len(prov) < 4 and why not in prov:
            prov.append(why)

    def successors(self, a_id):
        return {b for (x, b) in self.edges if x == a_id}


def _transitive_acquisitions(model: PackageModel) -> dict:
    """fn key -> set[LockDef] of locks the function may acquire,
    including via (resolvable) callees — a bounded fixpoint."""
    direct: dict[str, set] = {}
    callees: dict[str, set] = {}
    for key, fi in model.functions.items():
        direct[key] = {ld for (ld, _held, _ln) in fi.acquisitions}
        outs = set()
        for ref, _held, _ln in fi.calls:
            tgt = model.resolve_ref(fi, ref)
            if tgt is not None:
                outs.add(tgt.key)
        for ref, _kind, _ln in fi.spawns:
            # Work handed to a thread does not run under the caller's
            # locks — spawned targets are excluded on purpose.
            pass
        callees[key] = outs
    acq = {k: set(v) for k, v in direct.items()}
    for _ in range(len(model.functions)):
        changed = False
        for k, outs in callees.items():
            before = len(acq[k])
            for o in outs:
                acq[k] |= acq.get(o, set())
            if len(acq[k]) != before:
                changed = True
        if not changed:
            break
    return acq


def build_lock_graph(model: PackageModel) -> LockGraph:
    g = LockGraph()
    acq = _transitive_acquisitions(model)
    for key, fi in model.functions.items():
        for ld, held, lineno in fi.acquisitions:
            for h in held:
                if h.id != ld.id:
                    g.add(h, ld, f"{fi.module}.{fi.qualname}:{lineno}")
                elif ld.kind == "lock":
                    g.add(h, ld, f"{fi.module}.{fi.qualname}:{lineno} (re-acquire)")
        for ref, held, lineno in fi.calls:
            if not held:
                continue
            tgt = model.resolve_ref(fi, ref)
            if tgt is None:
                continue
            for inner in acq.get(tgt.key, ()):
                for h in held:
                    if h.id != inner.id:
                        g.add(
                            h,
                            inner,
                            f"{fi.module}.{fi.qualname}:{lineno}"
                            f" -> {tgt.module}.{tgt.qualname}",
                        )
                    elif inner.kind == "lock":
                        g.add(
                            h,
                            inner,
                            f"{fi.module}.{fi.qualname}:{lineno}"
                            f" -> {tgt.module}.{tgt.qualname} (re-acquire)",
                        )
    return g


def _lock_name(model: PackageModel, lid) -> str:
    ld = model.lock_defs.get(lid)
    return ld.name if ld is not None else ".".join(str(x) for x in lid if x)


def find_lock_order_findings(model: PackageModel) -> list[Finding]:
    g = build_lock_graph(model)
    findings: list[Finding] = []

    # Self-deadlock: A -> A on a non-reentrant lock. (Module-level locks
    # carry an empty class slot in their id — kept a string so sorting a
    # module that mixes them with class locks stays well-defined.)
    for (a, b), prov in sorted(g.edges.items()):
        if a == b:
            name = _lock_name(model, a)
            findings.append(
                Finding(
                    detector="lock-order",
                    module=a[0],
                    qualname=name,
                    detail=f"self:{name}",
                    message=(
                        f"non-reentrant lock {name} may be re-acquired while "
                        f"held (guaranteed deadlock): {'; '.join(prov)}"
                    ),
                )
            )

    # Inversions: both A -> B and B -> A (reported pairwise, once).
    seen_pairs = set()
    for (a, b) in sorted(g.edges):
        if a == b or (b, a) not in g.edges:
            continue
        pair = tuple(sorted((a, b)))
        if pair in seen_pairs:
            continue
        seen_pairs.add(pair)
        na, nb = _lock_name(model, pair[0]), _lock_name(model, pair[1])
        prov = g.edges[(pair[0], pair[1])] + g.edges[(pair[1], pair[0])]
        findings.append(
            Finding(
                detector="lock-order",
                module=pair[0][0],
                qualname=f"{na} <-> {nb}",
                detail=f"inversion:{na}<->{nb}",
                message=(
                    f"lock-order inversion between {na} and {nb} "
                    f"(potential deadlock): {'; '.join(prov[:4])}"
                ),
            )
        )

    # Longer cycles: SCCs of size > 2 (pairs already reported above).
    for scc in _sccs(g):
        if len(scc) < 3:
            continue
        names = sorted(_lock_name(model, lid) for lid in scc)
        findings.append(
            Finding(
                detector="lock-order",
                module=sorted(scc)[0][0],
                qualname=" -> ".join(names),
                detail="cycle:" + "|".join(names),
                message=f"lock acquisition cycle across {len(names)} locks "
                f"(potential deadlock): {' -> '.join(names)}",
            )
        )
    return findings


def _sccs(g: LockGraph):
    """Tarjan over the lock graph (iterative; the graph is tiny)."""
    nodes = sorted({a for a, _ in g.edges} | {b for _, b in g.edges})
    succ = {n: sorted(g.successors(n)) for n in nodes}
    index: dict = {}
    low: dict = {}
    onstack: set = set()
    stack: list = []
    out = []
    counter = [0]

    def strongconnect(v):
        work = [(v, 0)]
        while work:
            node, pi = work[-1]
            if pi == 0:
                index[node] = low[node] = counter[0]
                counter[0] += 1
                stack.append(node)
                onstack.add(node)
            recurse = False
            for i in range(pi, len(succ[node])):
                w = succ[node][i]
                if w not in index:
                    work[-1] = (node, i + 1)
                    work.append((w, 0))
                    recurse = True
                    break
                if w in onstack:
                    low[node] = min(low[node], index[w])
            if recurse:
                continue
            if low[node] == index[node]:
                scc = []
                while True:
                    w = stack.pop()
                    onstack.discard(w)
                    scc.append(w)
                    if w == node:
                        break
                out.append(scc)
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])

    for n in nodes:
        if n not in index:
            strongconnect(n)
    return out


# ---------------------------------------------------------------------------
# Blocking-under-lock lint
# ---------------------------------------------------------------------------


def _blocking_summaries(model: PackageModel) -> dict:
    """fn key -> set[(kind, origin, desc)] of blocking calls reachable
    from the function (itself or via resolvable callees), ignoring what
    the *caller* holds — the caller's held set is applied at the call
    site. Condition.wait excused against its own lock does not summarize
    (the callee releases it; a caller's other locks are caught by the
    caller's own call-under-lock edge to the *enclosing* wait kind)."""
    summaries: dict[str, set] = {}
    callees: dict[str, set] = {}
    for key, fi in model.functions.items():
        s = set()
        for kind, desc, _held, _ln, excused in fi.blocking:
            if kind == "wait" and excused:
                # cv.wait on its own condition: releases that lock; as a
                # summary it still blocks the caller, so keep it.
                s.add((kind, f"{fi.module}.{fi.qualname}", desc))
            else:
                s.add((kind, f"{fi.module}.{fi.qualname}", desc))
        summaries[key] = s
        outs = set()
        for ref, _held, _ln in fi.calls:
            tgt = model.resolve_ref(fi, ref)
            if tgt is not None:
                outs.add(tgt.key)
        callees[key] = outs
    for _ in range(len(model.functions)):
        changed = False
        for k, outs in callees.items():
            before = len(summaries[k])
            for o in outs:
                for item in summaries.get(o, ()):
                    if len(summaries[k]) >= 12:
                        break
                    summaries[k].add(item)
            if len(summaries[k]) != before:
                changed = True
        if not changed:
            break
    return summaries


def find_blocking_findings(model: PackageModel) -> list[Finding]:
    findings: list[Finding] = []
    seen: set = set()

    def emit(fi, kind, desc, locks, lineno, via=""):
        names = ", ".join(h.name for h in locks)
        detail = f"{kind}:{desc}" + (f"@{via}" if via else "")
        key = (fi.key, detail)
        if key in seen:
            return
        seen.add(key)
        where = f" (via {via})" if via else ""
        findings.append(
            Finding(
                detector="blocking-under-lock",
                module=fi.module,
                qualname=fi.qualname,
                detail=detail,
                message=f"{desc} ({kind}){where} can block while holding {names}",
                lineno=lineno,
                severity="warn" if kind == "failpoint" else "error",
            )
        )

    summaries = _blocking_summaries(model)
    for key, fi in sorted(model.functions.items()):
        # Direct blocking calls under a held lock.
        for kind, desc, held, lineno, excused in fi.blocking:
            blocked = [h for h in held if h not in excused]
            if blocked:
                emit(fi, kind, desc, blocked, lineno)
        # Calls made under a lock that transitively reach a blocking call.
        for ref, held, lineno in fi.calls:
            if not held:
                continue
            tgt = model.resolve_ref(fi, ref)
            if tgt is None:
                continue
            for kind, origin, desc in sorted(summaries.get(tgt.key, ())):
                if origin == f"{fi.module}.{fi.qualname}":
                    continue  # already reported as direct
                emit(fi, kind, desc, held, lineno, via=origin)
    return findings
