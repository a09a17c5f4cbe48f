"""Whole-package AST model for the concurrency analyzers.

Parses every module under a package root once and resolves the facts the
detectors need:

- **lock objects**: per-class ``self._lock = threading.Lock()`` (and
  ``RLock`` / ``Condition`` / the instrumented
  ``analysis.runtime.make_lock`` wrappers) plus module-level locks.
  ``threading.Condition(self._lock)`` *aliases* the condition attribute
  to the underlying lock, and ``self._lock = lock`` from an ``__init__``
  parameter named like a lock registers the attribute as a lock in its
  own right (the fetch scheduler shares its caller's lock this way);
- **held-set walks**: for every function, which locks are held at every
  lock acquisition, call and blocking-call site.  ``with lock:`` scopes
  exactly; bare ``lock.acquire()`` statements hold until a matching
  ``release()`` at the same nesting level or the end of the function
  (the ``try/finally`` idiom this codebase uses);
- **call graph**: best-effort resolution of ``self.m()``, same-module
  ``f()``, imported ``mod.f()`` and ``self._attr.m()`` where the
  attribute's class is inferred from its constructor assignment — enough
  to see that ``Snapshotter.commit`` reaches ``MetaStore.commit_active``
  while holding the in-flight lock;
- **thread spawns**: every ``threading.Thread(target=...)`` and
  ``executor.submit(...)`` with its resolved target, plus which trace
  primitives (``span`` / ``capture`` / ``with_context``) each function
  references — the trace-carry drift gate's raw material.

Everything here is approximate by design: Python cannot be soundly
analyzed statically, so detectors built on this model report *candidate*
invariant violations, and the reviewed baseline (analysis/baseline.toml)
records the ones that are intentional.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Optional

# (module, class-or-None, attr) — stable identity of one lock object.
LockId = tuple

LOCK_CTORS = {
    "Lock": "lock",
    "RLock": "rlock",
    "make_lock": "lock",
    "make_rlock": "rlock",
}
COND_CTORS = {"Condition", "make_condition"}
QUEUE_CTORS = {"Queue", "SimpleQueue", "LifoQueue", "PriorityQueue", "ByteBoundedQueue"}
# Parameter names that mark a lock handed in by the owner (the
# FetchScheduler pattern: the CachedBlob lock IS the scheduler lock).
LOCKISH_PARAMS = {"lock", "mutex", "mu"}
TRACE_ATTRS = {
    "span",
    "start_span",
    "traced",
    "capture",
    "with_context",
    "remote_context",
}


@dataclass(eq=False)
class LockDef:
    """Identity-hashed: aliases (a Condition over a lock) share one
    instance, so set/dict membership IS lock identity."""

    id: LockId
    kind: str  # lock | rlock | condition
    lineno: int = 0

    @property
    def name(self) -> str:
        mod, cls, attr = self.id
        return f"{mod}.{cls}.{attr}" if cls else f"{mod}.{attr}"


@dataclass
class ClassModel:
    module: str
    name: str
    locks: dict = field(default_factory=dict)  # attr -> LockDef (aliases share)
    attr_types: dict = field(default_factory=dict)  # attr -> (module, ClassName)
    queue_attrs: set = field(default_factory=set)


@dataclass
class FunctionInfo:
    module: str
    qualname: str  # Class.method, func, or outer.<locals>.inner
    node: object
    cls: Optional[str] = None
    acquisitions: list = field(default_factory=list)  # (LockDef, held, lineno)
    calls: list = field(default_factory=list)  # (ref, held, lineno)
    blocking: list = field(default_factory=list)  # (kind, desc, held, lineno, excused)
    spawns: list = field(default_factory=list)  # (ref, kind, lineno)
    trace_refs: set = field(default_factory=set)
    nested: dict = field(default_factory=dict)  # name -> qualkey

    @property
    def key(self) -> str:
        return f"{self.module}:{self.qualname}"


@dataclass
class ModuleModel:
    name: str
    path: str
    tree: object
    imports: dict = field(default_factory=dict)  # local name -> module
    from_imports: dict = field(default_factory=dict)  # local -> (module, name)
    locks: dict = field(default_factory=dict)  # global name -> LockDef
    classes: dict = field(default_factory=dict)  # name -> ClassModel


class PackageModel:
    def __init__(self, root: str, package: str):
        self.root = root
        self.package = package
        self.modules: dict[str, ModuleModel] = {}
        self.functions: dict[str, FunctionInfo] = {}
        self.lock_defs: dict[LockId, LockDef] = {}
        # fn key -> set[LockDef] held at a ``yield`` — ``with self.write_txn():``
        # bodies run under whatever the contextmanager holds at its yield.
        self.yield_held: dict[str, set] = {}
        self._load()
        self._index()

    # -- loading -------------------------------------------------------------

    def _load(self) -> None:
        pkg_dir = os.path.join(self.root, *self.package.split("."))
        for dirpath, dirnames, filenames in os.walk(pkg_dir):
            dirnames[:] = [d for d in dirnames if d not in ("__pycache__", "bin")]
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fn)
                rel = os.path.relpath(path, self.root)
                modname = rel[:-3].replace(os.sep, ".")
                if modname.endswith(".__init__"):
                    modname = modname[: -len(".__init__")]
                with open(path, "r", encoding="utf-8") as f:
                    src = f.read()
                try:
                    tree = ast.parse(src, filename=path)
                except SyntaxError:
                    continue
                mm = ModuleModel(name=modname, path=path, tree=tree)
                self._collect_imports(mm)
                self.modules[modname] = mm

    def _collect_imports(self, mm: ModuleModel) -> None:
        for node in ast.walk(mm.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    mm.imports[a.asname or a.name.split(".")[0]] = a.name
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                for a in node.names:
                    if a.name == "*":
                        continue
                    mm.from_imports[a.asname or a.name] = (node.module, a.name)
                    # `from nydus_snapshotter_tpu_torch import trace` style: the
                    # bound name is itself a module.
                    cand = f"{node.module}.{a.name}"
                    mm.imports.setdefault(a.asname or a.name, cand)

    # -- indexing ------------------------------------------------------------

    def _index(self) -> None:
        for mm in self.modules.values():
            self._index_module_locks(mm)
            for node in mm.tree.body:
                if isinstance(node, ast.ClassDef):
                    mm.classes[node.name] = self._index_class(mm, node)
        # Function infos come after lock/class indexing so held-set walks
        # can resolve everything. Two passes: the first records which
        # locks each contextmanager holds at its yield; the second
        # re-walks with that knowledge so ``with self.write_txn():``
        # bodies count as running under the writer lock.
        for _pass in (1, 2):
            for mm in self.modules.values():
                for node in mm.tree.body:
                    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        self._index_function(mm, node, None, node.name)
                    elif isinstance(node, ast.ClassDef):
                        for sub in node.body:
                            if isinstance(
                                sub, (ast.FunctionDef, ast.AsyncFunctionDef)
                            ):
                                self._index_function(
                                    mm, sub, node.name, f"{node.name}.{sub.name}"
                                )

    def _ctor_name(self, mm: ModuleModel, call: ast.Call) -> Optional[str]:
        """Terminal name of a constructor call: ``threading.Lock`` ->
        ``Lock``, ``runtime.make_lock`` -> ``make_lock``, ``Lock`` -> itself
        when imported from threading."""
        f = call.func
        if isinstance(f, ast.Attribute):
            return f.attr
        if isinstance(f, ast.Name):
            return f.id
        return None

    def _index_module_locks(self, mm: ModuleModel) -> None:
        for node in mm.tree.body:
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
                continue
            tgt = node.targets[0]
            if not isinstance(tgt, ast.Name) or not isinstance(node.value, ast.Call):
                continue
            ctor = self._ctor_name(mm, node.value)
            if ctor in LOCK_CTORS:
                lid = (mm.name, "", tgt.id)
                mm.locks[tgt.id] = self.lock_defs.setdefault(
                    lid, LockDef(lid, LOCK_CTORS[ctor], node.lineno)
                )
            elif ctor in COND_CTORS:
                lid = (mm.name, "", tgt.id)
                mm.locks[tgt.id] = self.lock_defs.setdefault(
                    lid, LockDef(lid, "condition", node.lineno)
                )

    def _index_class(self, mm: ModuleModel, cnode: ast.ClassDef) -> ClassModel:
        cm = ClassModel(module=mm.name, name=cnode.name)
        param_attr: dict[str, str] = {}  # param name -> first attr assigned from it
        for meth in cnode.body:
            if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # class-level lock: ``_MOUNT_LOCK = threading.Lock()``
                if (
                    isinstance(meth, ast.Assign)
                    and len(meth.targets) == 1
                    and isinstance(meth.targets[0], ast.Name)
                    and isinstance(meth.value, ast.Call)
                ):
                    ctor = self._ctor_name(mm, meth.value)
                    if ctor in LOCK_CTORS or ctor in COND_CTORS:
                        attr = meth.targets[0].id
                        lid = (mm.name, cnode.name, attr)
                        kind = LOCK_CTORS.get(ctor, "condition")
                        cm.locks[attr] = self.lock_defs.setdefault(
                            lid, LockDef(lid, kind, meth.lineno)
                        )
                continue
            params = {a.arg for a in meth.args.args}
            for node in ast.walk(meth):
                if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
                    continue
                tgt = node.targets[0]
                if not (
                    isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"
                ):
                    continue
                attr = tgt.attr
                val = node.value
                if isinstance(val, ast.Name) and val.id in params:
                    if val.id in LOCKISH_PARAMS:
                        lid = (mm.name, cnode.name, attr)
                        cm.locks.setdefault(
                            attr,
                            self.lock_defs.setdefault(
                                lid, LockDef(lid, "lock", node.lineno)
                            ),
                        )
                        param_attr.setdefault(val.id, attr)
                    continue
                if not isinstance(val, ast.Call):
                    continue
                ctor = self._ctor_name(mm, val)
                if ctor in LOCK_CTORS:
                    lid = (mm.name, cnode.name, attr)
                    cm.locks[attr] = self.lock_defs.setdefault(
                        lid, LockDef(lid, LOCK_CTORS[ctor], node.lineno)
                    )
                elif ctor in COND_CTORS:
                    # Condition over an explicit lock aliases to it.
                    alias = None
                    args = [
                        a
                        for a in val.args
                        if not isinstance(a, ast.Constant)  # make_condition(name)
                    ]
                    for a in args:
                        if (
                            isinstance(a, ast.Attribute)
                            and isinstance(a.value, ast.Name)
                            and a.value.id == "self"
                            and a.attr in cm.locks
                        ):
                            alias = cm.locks[a.attr]
                        elif isinstance(a, ast.Name) and a.id in param_attr:
                            alias = cm.locks.get(param_attr[a.id])
                        elif isinstance(a, ast.Name) and a.id in params:
                            # Condition(lock) where the param was not (yet)
                            # stored: register the attr as the lock itself.
                            lid = (mm.name, cnode.name, attr)
                            alias = self.lock_defs.setdefault(
                                lid, LockDef(lid, "lock", node.lineno)
                            )
                    if alias is not None:
                        cm.locks[attr] = alias
                    else:
                        lid = (mm.name, cnode.name, attr)
                        cm.locks[attr] = self.lock_defs.setdefault(
                            lid, LockDef(lid, "condition", node.lineno)
                        )
                elif ctor in QUEUE_CTORS:
                    cm.queue_attrs.add(attr)
                elif ctor:
                    t = self._resolve_class(mm, val.func)
                    if t is not None:
                        cm.attr_types[attr] = t
        return cm

    def _resolve_class(self, mm: ModuleModel, func: ast.expr):
        """(module, ClassName) when the constructor resolves to a class
        defined in this package."""
        if isinstance(func, ast.Name):
            name = func.id
            if name in mm.from_imports:
                srcmod, srcname = mm.from_imports[name]
                if srcmod in self.modules:
                    return (srcmod, srcname)
            for node in mm.tree.body:
                if isinstance(node, ast.ClassDef) and node.name == name:
                    return (mm.name, name)
        elif isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name):
            modname = mm.imports.get(func.value.id)
            if modname in self.modules:
                return (modname, func.attr)
        return None

    # -- per-function walk ---------------------------------------------------

    def _index_function(self, mm, node, cls, qualname) -> FunctionInfo:
        fi = FunctionInfo(module=mm.name, qualname=qualname, node=node, cls=cls)
        self.functions[fi.key] = fi
        _FunctionWalker(self, mm, fi).run()
        return fi

    # -- resolution helpers used by detectors --------------------------------

    def resolve_ref(self, fi: FunctionInfo, ref) -> Optional[FunctionInfo]:
        """Symbolic callee ref -> FunctionInfo, or None."""
        if ref is None:
            return None
        kind = ref[0]
        mm = self.modules.get(fi.module)
        if kind == "self" and fi.cls:
            return self.functions.get(f"{fi.module}:{fi.cls}.{ref[1]}")
        if kind == "local":
            name = ref[1]
            if name in fi.nested:
                return self.functions.get(fi.nested[name])
            got = self.functions.get(f"{fi.module}:{name}")
            if got is not None:
                return got
            if mm and name in mm.from_imports:
                srcmod, srcname = mm.from_imports[name]
                return self.functions.get(f"{srcmod}:{srcname}")
            return None
        if kind == "mod":
            modname = mm.imports.get(ref[1]) if mm else None
            if modname is None:
                return None
            return self.functions.get(f"{modname}:{ref[2]}")
        if kind == "attrcall" and fi.cls and mm:
            cm = mm.classes.get(fi.cls)
            t = cm.attr_types.get(ref[1]) if cm else None
            if t is None:
                return None
            return self.functions.get(f"{t[0]}:{t[1]}.{ref[2]}")
        return None


class _FunctionWalker:
    """Held-set walk of one function body (nested defs walk separately)."""

    def __init__(self, model: PackageModel, mm: ModuleModel, fi: FunctionInfo):
        self.model = model
        self.mm = mm
        self.fi = fi
        self.cm = mm.classes.get(fi.cls) if fi.cls else None

    def run(self) -> None:
        self.walk_body(self.fi.node.body, ())

    # -- lock resolution ----------------------------------------------------

    def lock_of(self, expr) -> Optional[LockDef]:
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
            and self.cm is not None
        ):
            return self.cm.locks.get(expr.attr)
        if isinstance(expr, ast.Name):
            ld = self.mm.locks.get(expr.id)
            if ld is not None:
                return ld
            # lock received as a function parameter named like a lock
            if expr.id in LOCKISH_PARAMS:
                lid = (self.fi.module, "", f"<param:{expr.id}>")
                return self.model.lock_defs.setdefault(lid, LockDef(lid, "lock"))
            return None
        if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name):
            modname = self.mm.imports.get(expr.value.id)
            mm2 = self.model.modules.get(modname) if modname else None
            if mm2 is not None:
                return mm2.locks.get(expr.attr)
            # st.lock — a local whose attr is a known lock attr of some
            # class in this module (the trace-ring stripe pattern).
            for cm in self.mm.classes.values():
                if expr.attr in cm.locks and cm.locks[expr.attr].kind != "condition":
                    return cm.locks[expr.attr]
        return None

    # -- body walking -------------------------------------------------------

    def walk_body(self, stmts, held) -> None:
        held = tuple(held)
        for stmt in stmts:
            # bare ``x.acquire()`` / ``x.release()`` statements scope to
            # the rest of this body (the try/finally idiom).
            got = self._bare_acquire_release(stmt)
            if got is not None:
                op, ld = got
                if op == "acquire":
                    self._record_acquisition(ld, held, stmt.lineno)
                    if ld not in held:
                        held = held + (ld,)
                else:
                    held = tuple(x for x in held if x is not ld)
                continue
            self.walk_stmt(stmt, held)

    def _bare_acquire_release(self, stmt):
        if not (isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call)):
            return None
        call = stmt.value
        f = call.func
        if not (isinstance(f, ast.Attribute) and f.attr in ("acquire", "release")):
            return None
        ld = self.lock_of(f.value)
        if ld is None:
            return None
        if f.attr == "acquire" and self._is_trylock(call):
            return None
        return (f.attr, ld)

    @staticmethod
    def _is_trylock(call: ast.Call) -> bool:
        for a in call.args:
            if isinstance(a, ast.Constant) and a.value is False:
                return True
        for kw in call.keywords:
            if (
                kw.arg == "blocking"
                and isinstance(kw.value, ast.Constant)
                and kw.value.value is False
            ):
                return True
        return False

    def walk_stmt(self, stmt, held) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            qual = f"{self.fi.qualname}.<locals>.{stmt.name}"
            sub = self.model._index_function(self.mm, stmt, self.fi.cls, qual)
            self.fi.nested[stmt.name] = sub.key
            return
        if isinstance(stmt, ast.ClassDef):
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            new_held = tuple(held)
            for item in stmt.items:
                ld = self.lock_of(item.context_expr)
                if ld is None and isinstance(item.context_expr, ast.Call):
                    # A contextmanager method that holds locks at its
                    # yield (``with self.write_txn():``) extends the
                    # held set for the body.
                    self.scan_expr(item.context_expr, held)
                    for cl in self._ctx_manager_locks(item.context_expr):
                        self._record_acquisition(cl, new_held, stmt.lineno)
                        if cl not in new_held:
                            new_held = new_held + (cl,)
                    continue
                if ld is not None:
                    self._record_acquisition(ld, new_held, stmt.lineno)
                    if ld not in new_held:
                        new_held = new_held + (ld,)
                else:
                    self.scan_expr(item.context_expr, held)
            self.walk_body(stmt.body, new_held)
            return
        for fname, value in ast.iter_fields(stmt):
            if (
                isinstance(value, list)
                and value
                and isinstance(value[0], ast.stmt)
            ):
                self.walk_body(value, held)
            elif isinstance(value, list) and value and isinstance(
                value[0], ast.excepthandler
            ):
                for h in value:
                    if h.type is not None:
                        self.scan_expr(h.type, held)
                    self.walk_body(h.body, held)
            else:
                self.scan_expr(value, held)

    # -- expression scanning ------------------------------------------------

    def scan_expr(self, node, held) -> None:
        if node is None or isinstance(node, (str, int, float, bytes, bool)):
            return
        if isinstance(node, list):
            for x in node:
                self.scan_expr(x, held)
            return
        if not isinstance(node, ast.AST):
            return
        if isinstance(node, (ast.Lambda, ast.FunctionDef, ast.AsyncFunctionDef)):
            return
        if isinstance(node, (ast.Yield, ast.YieldFrom)):
            self.model.yield_held.setdefault(self.fi.key, set()).update(held)
        if isinstance(node, ast.Call):
            self.classify_call(node, held)
        if isinstance(node, ast.Attribute):
            self._note_trace_ref(node)
        for child in ast.iter_child_nodes(node):
            self.scan_expr(child, held)

    def _ctx_manager_locks(self, call: ast.Call):
        """Locks a ``with <call>():`` body runs under, when the callee is
        a resolvable generator contextmanager that yields while holding
        them (populated in pass 1, consumed in pass 2)."""
        ref = self._callee_ref(call.func)
        tgt = self.model.resolve_ref(self.fi, ref)
        if tgt is None:
            return ()
        return tuple(self.model.yield_held.get(tgt.key, ()))

    def _note_trace_ref(self, node: ast.Attribute) -> None:
        if (
            node.attr in TRACE_ATTRS
            and isinstance(node.value, ast.Name)
            and self.mm.imports.get(node.value.id, "").endswith("trace")
        ):
            self.fi.trace_refs.add(node.attr)

    def _record_acquisition(self, ld: LockDef, held, lineno) -> None:
        self.fi.acquisitions.append((ld, tuple(held), lineno))

    def _callee_ref(self, func):
        if isinstance(func, ast.Name):
            return ("local", func.id)
        if isinstance(func, ast.Attribute):
            v = func.value
            if isinstance(v, ast.Name):
                if v.id == "self":
                    return ("self", func.attr)
                if v.id in self.mm.imports:
                    return ("mod", v.id, func.attr)
                return ("obj", v.id, func.attr)
            if (
                isinstance(v, ast.Attribute)
                and isinstance(v.value, ast.Name)
                and v.value.id == "self"
            ):
                return ("attrcall", v.attr, func.attr)
        return None

    def classify_call(self, call: ast.Call, held) -> None:
        from nydus_snapshotter_tpu_torch.analysis.locks import classify_blocking

        func = call.func
        ref = self._callee_ref(func)
        lineno = call.lineno

        # lock acquire in expression position (e.g. ``if l.acquire(0):``)
        if isinstance(func, ast.Attribute) and func.attr == "acquire":
            ld = self.lock_of(func.value)
            if ld is not None:
                if not self._is_trylock(call):
                    self._record_acquisition(ld, held, lineno)
                return

        # thread spawns — Thread(target=...), executor.submit(fn, ...)
        spawn = self._spawn_target(call, func)
        if spawn is not None:
            self.fi.spawns.append((spawn[0], spawn[1], lineno))

        # blocking-call classification (only interesting under a lock,
        # but recorded unconditionally so callers can reuse it)
        blocked = classify_blocking(self, call, func, held)
        if blocked is not None:
            self.fi.blocking.append(blocked)

        if ref is not None:
            self.fi.calls.append((ref, tuple(held), lineno))

    def _spawn_target(self, call: ast.Call, func):
        name = None
        if isinstance(func, ast.Name):
            name = func.id
        elif isinstance(func, ast.Attribute):
            name = func.attr
        if name == "Thread":
            for kw in call.keywords:
                if kw.arg == "target":
                    return (self._callee_ref_of_value(kw.value), "Thread")
            return (None, "Thread")
        if name == "submit" and isinstance(func, ast.Attribute):
            if call.args:
                return (self._callee_ref_of_value(call.args[0]), "submit")
            return (None, "submit")
        return None

    def _callee_ref_of_value(self, value):
        """A function *reference* (not call) passed as target=fn."""
        if isinstance(value, ast.Name):
            return ("local", value.id)
        if isinstance(value, ast.Attribute) and isinstance(value.value, ast.Name):
            if value.value.id == "self":
                return ("self", value.attr)
            if value.value.id in self.mm.imports:
                return ("mod", value.value.id, value.attr)
            return ("obj", value.value.id, value.attr)
        return None
