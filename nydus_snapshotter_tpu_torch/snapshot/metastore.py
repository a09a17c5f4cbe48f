"""Snapshot metadata store.

The reference leans on containerd's ``storage.MetaStore`` (bbolt,
snapshot/snapshot.go:272) for snapshot parentage, kinds, labels, and usage,
plus the helpers in pkg/snapshot/storage.go:19-108 (get/walk/update info,
``IterateParentSnapshots``). This module reproduces those semantics on
sqlite (stdlib, WAL, transactional):

- snapshots are addressed by *key* (client name) and carry an internal
  monotonic numeric *id* used for on-disk directory names;
- kinds: view / active / committed; Commit turns an active snapshot into a
  committed one under a new name;
- ``Snapshot.parent_ids`` is the full ancestor id chain, immediate parent
  first — what overlay lowerdir synthesis consumes;
- usage (size, inodes) recorded at commit time (and backfilled
  asynchronously via :meth:`MetaStore.set_usages`).

Concurrency model (the concurrent control plane, PR 4): WAL gives one
writer + any number of readers, so the store splits into

- a **read pool** of dedicated connections (``row_factory`` set ONCE per
  connection — the old shared-connection mutation was a latent race) used
  by ``get_snapshot``/``get_info``/``walk``/``id_map``/``usage``; each
  read op runs inside its own read transaction for a stable snapshot and
  never takes the writer lock, and
- a single **serialized writer** connection behind an RLock whose
  :meth:`write_txn` context manager batches nested mutations into one
  ``BEGIN IMMEDIATE`` … ``COMMIT`` (one fsync per batch).

Ancestor chains are memoized in a bounded LRU (``parent key`` →
``parent_ids``), replacing the per-call recursive parent queries. Only
``remove`` (and commit's key rename) can change what a chain resolves to,
and remove refuses while children exist — so a chain cached under key K
can only go stale when K itself is removed or (re)committed, and targeted
invalidation of K is sufficient.
"""

from __future__ import annotations

import json
import os
import sqlite3
import threading
import time
from collections import OrderedDict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Iterator, Optional

from nydus_snapshotter_tpu_torch import failpoint
from nydus_snapshotter_tpu_torch.analysis import runtime as _an
from nydus_snapshotter_tpu_torch import trace
from nydus_snapshotter_tpu_torch.metrics import data as metrics_data
from nydus_snapshotter_tpu_torch.snapshot.async_work import resolve_snapshots_config
from nydus_snapshotter_tpu_torch.utils import errdefs

KIND_VIEW = "view"
KIND_ACTIVE = "active"
KIND_COMMITTED = "committed"


@dataclass
class Usage:
    size: int = 0
    inodes: int = 0

    def add(self, other: "Usage") -> None:
        self.size += other.size
        self.inodes += other.inodes


@dataclass
class Info:
    kind: str
    name: str
    parent: str = ""
    labels: dict[str, str] = field(default_factory=dict)
    created: float = 0.0
    updated: float = 0.0


@dataclass
class Snapshot:
    id: str
    kind: str
    parent_ids: list[str] = field(default_factory=list)


class CommitResult(str):
    """The committed snapshot id, with the transaction timestamp attached
    (``.now``) so callers can meter commit latency against one clock read."""

    now: float

    def __new__(cls, sid: str, now: float) -> "CommitResult":
        self = super().__new__(cls, sid)
        self.now = now
        return self


class RemoveResult(tuple):
    """``(id, kind)`` — unpacks like the historical return — with the
    operation timestamp attached (``.now``) for metrics."""

    now: float

    def __new__(cls, sid: str, kind: str, now: float) -> "RemoveResult":
        self = super().__new__(cls, (sid, kind))
        self.now = now
        return self


class _AncestorCache:
    """Bounded LRU of parent-key -> ancestor id chain (immediate parent
    first). ``maxsize`` 0 disables caching entirely."""

    def __init__(self, maxsize: int):
        self.maxsize = max(0, maxsize)
        self._lock = _an.make_lock("metastore.ancestor_cache")
        self._map: OrderedDict[str, tuple[str, ...]] = OrderedDict()

    def get(self, key: str) -> Optional[tuple[str, ...]]:
        if self.maxsize == 0:
            return None
        with self._lock:
            chain = self._map.get(key)
            if chain is not None:
                self._map.move_to_end(key)
                metrics_data.SnapshotAncestorCacheHits.inc()
            else:
                metrics_data.SnapshotAncestorCacheMisses.inc()
            return chain

    def put(self, key: str, chain: tuple[str, ...]) -> None:
        if self.maxsize == 0:
            return
        with self._lock:
            self._map[key] = chain
            self._map.move_to_end(key)
            while len(self._map) > self.maxsize:
                self._map.popitem(last=False)

    def invalidate(self, key: str) -> None:
        with self._lock:
            self._map.pop(key, None)

    def clear(self) -> None:
        with self._lock:
            self._map.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._map)


def _connect(path: str) -> sqlite3.Connection:
    # isolation_level=None: the stdlib's implicit-BEGIN machinery is off;
    # write_txn()/_read() own transaction boundaries explicitly.
    conn = sqlite3.connect(path, check_same_thread=False, isolation_level=None)
    # One row factory per connection, set once at creation: the seed
    # mutated row_factory on the single shared connection per call, which
    # raced concurrent readers into tuple/Row type confusion.
    conn.row_factory = sqlite3.Row
    conn.execute("PRAGMA busy_timeout=10000")
    conn.execute("PRAGMA journal_mode=WAL")
    conn.execute("PRAGMA synchronous=NORMAL")
    return conn


class _ReadPool:
    """Bounded pool of read-only-by-convention connections. Acquisition
    wait lands in the ``ntpu_snapshot_read_pool_wait_milliseconds``
    histogram — pool-size pressure is observable, not guessable."""

    def __init__(self, path: str, size: int):
        self._path = path
        self.size = max(1, size)
        self._sem = threading.BoundedSemaphore(self.size)
        self._lock = threading.Lock()
        self._free: list[sqlite3.Connection] = []
        self._all: list[sqlite3.Connection] = []
        self._closed = False

    @contextmanager
    def connection(self) -> Iterator[sqlite3.Connection]:
        t0 = time.perf_counter()
        self._sem.acquire()
        metrics_data.SnapshotReadPoolWait.observe((time.perf_counter() - t0) * 1000.0)
        try:
            with self._lock:
                if self._closed:
                    raise sqlite3.ProgrammingError(
                        "Cannot operate on a closed database."
                    )
                conn = self._free.pop() if self._free else None
            if conn is None:
                conn = _connect(self._path)
                with self._lock:
                    self._all.append(conn)
            try:
                yield conn
            finally:
                with self._lock:
                    if self._closed:
                        conn.close()
                    else:
                        self._free.append(conn)
        finally:
            self._sem.release()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            conns = list(self._all)
            self._all = []
            self._free = []
        for c in conns:
            c.close()


class MetaStore:
    """Transactional snapshot metadata store keyed by snapshot name."""

    def __init__(
        self,
        path: str,
        read_pool: Optional[int] = None,
        ancestor_cache: Optional[int] = None,
    ):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        cfg = resolve_snapshots_config()
        self._path = path
        self._wlock = _an.make_rlock("metastore.wlock")
        self._txn_depth = 0
        self._writer = _connect(path)
        with self._writer:
            self._writer.execute(
                "CREATE TABLE IF NOT EXISTS snapshots ("
                " id INTEGER PRIMARY KEY AUTOINCREMENT,"
                " key TEXT UNIQUE NOT NULL,"
                " kind TEXT NOT NULL,"
                " parent TEXT NOT NULL DEFAULT '',"
                " labels TEXT NOT NULL DEFAULT '{}',"
                " size INTEGER NOT NULL DEFAULT 0,"
                " inodes INTEGER NOT NULL DEFAULT 0,"
                " created REAL NOT NULL,"
                " updated REAL NOT NULL)"
            )
        self._pool = _ReadPool(
            path, cfg.read_pool if read_pool is None else read_pool
        )
        self._chain_cache = _AncestorCache(
            cfg.ancestor_cache if ancestor_cache is None else ancestor_cache
        )

    def close(self) -> None:
        self._pool.close()
        with self._wlock:
            self._writer.close()

    # -- transactions --------------------------------------------------------

    @contextmanager
    def write_txn(self) -> Iterator[sqlite3.Connection]:
        """Serialized writer path. Nests: inner ``write_txn`` blocks join
        the outer transaction, so multi-statement ops (and external
        batches like the usage accountant's drain) commit with one fsync."""
        t0 = time.perf_counter()
        self._wlock.acquire()
        try:
            if self._txn_depth == 0:
                metrics_data.SnapshotWriteLockWait.observe(
                    (time.perf_counter() - t0) * 1000.0
                )
                self._writer.execute("BEGIN IMMEDIATE")
            self._txn_depth += 1
            try:
                yield self._writer
            except BaseException:
                self._txn_depth -= 1
                if self._txn_depth == 0 and self._writer.in_transaction:
                    self._writer.execute("ROLLBACK")
                raise
            else:
                self._txn_depth -= 1
                if self._txn_depth == 0 and self._writer.in_transaction:
                    self._writer.execute("COMMIT")
        finally:
            self._wlock.release()

    @contextmanager
    def _read(self) -> Iterator[sqlite3.Connection]:
        """One pooled connection inside its own read transaction: a stable
        WAL snapshot for multi-statement reads, zero writer contention."""
        with self._pool.connection() as conn:
            conn.execute("BEGIN")
            try:
                yield conn
            finally:
                try:
                    conn.execute("COMMIT")
                except sqlite3.Error:
                    pass

    # -- internal ------------------------------------------------------------

    def _row(self, conn: sqlite3.Connection, key: str) -> sqlite3.Row:
        row = conn.execute("SELECT * FROM snapshots WHERE key=?", (key,)).fetchone()
        if row is None:
            raise errdefs.NotFound(f"snapshot {key!r} not found")
        return row

    def _info(self, row: sqlite3.Row) -> Info:
        return Info(
            kind=row["kind"],
            name=row["key"],
            parent=row["parent"],
            labels=json.loads(row["labels"]),
            created=row["created"],
            updated=row["updated"],
        )

    def _parent_ids(self, conn: sqlite3.Connection, parent_key: str) -> list[str]:
        cached = self._chain_cache.get(parent_key)
        if cached is not None:
            return list(cached)
        ids: list[str] = []
        key = parent_key
        while key:
            row = self._row(conn, key)
            ids.append(str(row["id"]))
            key = row["parent"]
        self._chain_cache.put(parent_key, tuple(ids))
        return ids

    # -- storage API (containerd storage package parity) ---------------------

    @trace.traced("metastore.create_snapshot")
    def create_snapshot(
        self, kind: str, key: str, parent: str = "", labels: Optional[dict[str, str]] = None
    ) -> Snapshot:
        failpoint.hit("metastore.create")
        if kind not in (KIND_VIEW, KIND_ACTIVE):
            raise errdefs.InvalidArgument(f"snapshot kind {kind!r} not creatable")
        if not key:
            raise errdefs.InvalidArgument("snapshot key is empty")
        with self.write_txn() as conn:
            if parent:
                prow = self._row(conn, parent)
                if prow["kind"] != KIND_COMMITTED:
                    raise errdefs.InvalidArgument(f"parent {parent!r} is not committed")
            now = time.time()
            try:
                cur = conn.execute(
                    "INSERT INTO snapshots (key, kind, parent, labels, created, updated)"
                    " VALUES (?,?,?,?,?,?)",
                    (key, kind, parent, json.dumps(labels or {}), now, now),
                )
            except sqlite3.IntegrityError:
                raise errdefs.AlreadyExists(f"snapshot {key!r} already exists") from None
            return Snapshot(
                id=str(cur.lastrowid),
                kind=kind,
                parent_ids=self._parent_ids(conn, parent) if parent else [],
            )

    @trace.traced("metastore.get_snapshot")
    def get_snapshot(self, key: str) -> Snapshot:
        with self._read() as conn:
            row = self._row(conn, key)
            return Snapshot(
                id=str(row["id"]),
                kind=row["kind"],
                parent_ids=self._parent_ids(conn, row["parent"]) if row["parent"] else [],
            )

    @trace.traced("metastore.get_info")
    def get_info(self, key: str) -> tuple[str, Info, Usage]:
        with self._read() as conn:
            row = self._row(conn, key)
            return str(row["id"]), self._info(row), Usage(row["size"], row["inodes"])

    @trace.traced("metastore.update_info")
    def update_info(self, info: Info, *fieldpaths: str) -> Info:
        """Update mutable snapshot fields; with fieldpaths only the named
        `labels.*` / `labels` paths change (containerd Update contract)."""
        with self.write_txn() as conn:
            row = self._row(conn, info.name)
            labels = json.loads(row["labels"])
            if fieldpaths:
                for fp in fieldpaths:
                    if fp == "labels":
                        labels = dict(info.labels)
                    elif fp.startswith("labels."):
                        k = fp[len("labels.") :]
                        if k in info.labels:
                            labels[k] = info.labels[k]
                        else:
                            labels.pop(k, None)
                    else:
                        raise errdefs.InvalidArgument(f"cannot update field {fp!r}")
            else:
                labels = dict(info.labels)
            now = time.time()
            conn.execute(
                "UPDATE snapshots SET labels=?, updated=? WHERE key=?",
                (json.dumps(labels), now, info.name),
            )
            row = self._row(conn, info.name)
            return self._info(row)

    @trace.traced("metastore.commit_active")
    def commit_active(
        self,
        key: str,
        name: str,
        usage: Usage,
        now: Optional[float] = None,
        extra_labels: Optional[dict[str, str]] = None,
    ) -> CommitResult:
        """Commit active snapshot `key` as committed snapshot `name`;
        returns the (unchanged) snapshot id with the transaction timestamp
        attached. One `now` stamps the whole operation, and any
        ``extra_labels`` merge in the same statement — one transaction
        where the seed used three."""
        failpoint.hit("metastore.commit")
        if not name:
            raise errdefs.InvalidArgument("committed name is empty")
        with self.write_txn() as conn:
            row = self._row(conn, key)
            if row["kind"] != KIND_ACTIVE:
                raise errdefs.InvalidArgument(f"snapshot {key!r} is not active")
            dup = conn.execute("SELECT 1 FROM snapshots WHERE key=?", (name,)).fetchone()
            if dup is not None:
                raise errdefs.AlreadyExists(f"snapshot {name!r} already exists")
            ts = time.time() if now is None else now
            labels = json.loads(row["labels"])
            if extra_labels:
                labels.update(extra_labels)
            conn.execute(
                "UPDATE snapshots SET key=?, kind=?, labels=?, size=?, inodes=?,"
                " updated=? WHERE key=?",
                (name, KIND_COMMITTED, json.dumps(labels), usage.size, usage.inodes, ts, key),
            )
        self._chain_cache.invalidate(key)
        self._chain_cache.invalidate(name)
        return CommitResult(str(row["id"]), ts)

    @trace.traced("metastore.remove")
    def remove(self, key: str, now: Optional[float] = None) -> RemoveResult:
        """Remove snapshot `key`; returns (id, kind) with the operation
        timestamp attached. Fails while children reference it (containerd
        Remove contract)."""
        failpoint.hit("metastore.remove")
        with self.write_txn() as conn:
            row = self._row(conn, key)
            child = conn.execute(
                "SELECT 1 FROM snapshots WHERE parent=?", (key,)
            ).fetchone()
            if child is not None:
                raise errdefs.FailedPrecondition(f"snapshot {key!r} has children")
            ts = time.time() if now is None else now
            conn.execute("DELETE FROM snapshots WHERE key=?", (key,))
        # Chains cached under OTHER keys cannot contain `key`: a chain
        # entry implies a child row referencing it, and remove refuses
        # while children exist — targeted invalidation is complete.
        self._chain_cache.invalidate(key)
        return RemoveResult(str(row["id"]), row["kind"], ts)

    @trace.traced("metastore.set_usages")
    def set_usages(self, usages: dict[str, Usage], now: Optional[float] = None) -> float:
        """Backfill usage for committed snapshots — one batched write
        transaction for the whole dict (the async accountant's drain).
        Rows that vanished (removed while the scan ran) are skipped
        silently. Returns the stamp used."""
        ts = time.time() if now is None else now
        if not usages:
            return ts
        with self.write_txn() as conn:
            for key, u in usages.items():
                conn.execute(
                    "UPDATE snapshots SET size=?, inodes=?, updated=? WHERE key=?",
                    (u.size, u.inodes, ts, key),
                )
        return ts

    def set_usage(self, key: str, usage: Usage, now: Optional[float] = None) -> float:
        return self.set_usages({key: usage}, now=now)

    def walk(self, fn: Callable[[str, Info], None]) -> None:
        with self._read() as conn:
            rows = conn.execute("SELECT * FROM snapshots ORDER BY id").fetchall()
        for row in rows:
            fn(str(row["id"]), self._info(row))

    def id_map(self) -> dict[str, str]:
        """id -> key for every stored snapshot (storage.IDMap, used by
        orphan-directory cleanup snapshot.go:1006-1038)."""
        with self._read() as conn:
            rows = conn.execute("SELECT id, key FROM snapshots").fetchall()
        return {str(row["id"]): row["key"] for row in rows}

    def usage(self, key: str) -> Usage:
        with self._read() as conn:
            row = self._row(conn, key)
            return Usage(row["size"], row["inodes"])

    def dump(self) -> str:
        """Canonical, id-normalized JSON dump: rows sorted by key, internal
        ids replaced by the ancestor *key* chain, timestamps excluded.
        Two stores that served the same logical op history dump
        identically regardless of id-assignment interleaving — the
        identity gate in tools/snapshot_profile.py and the concurrency
        property tests compare exactly this."""
        with self._read() as conn:
            rows = conn.execute("SELECT * FROM snapshots ORDER BY key").fetchall()
        out = [
            {
                "key": r["key"],
                "kind": r["kind"],
                "parent": r["parent"],
                "labels": json.loads(r["labels"]),
                "size": r["size"],
                "inodes": r["inodes"],
            }
            for r in rows
        ]
        return json.dumps(out, sort_keys=True)

    def cache_stats(self) -> dict[str, float]:
        return {
            "entries": len(self._chain_cache),
            "hits": metrics_data.SnapshotAncestorCacheHits.value(),
            "misses": metrics_data.SnapshotAncestorCacheMisses.value(),
        }

    # -- helpers (reference pkg/snapshot/storage.go) -------------------------

    def iterate_parent_snapshots(
        self, key: str, fn: Callable[[str, Info], bool]
    ) -> tuple[str, Info]:
        """Walk the parent chain starting at `key` until fn returns True
        (reference storage.go:79-108 IterateParentSnapshots); raises
        NotFound when the chain is exhausted."""
        cur = key
        while cur:
            sid, info, _ = self.get_info(cur)
            if fn(sid, info):
                return sid, info
            cur = info.parent
        raise errdefs.NotFound(f"no matching parent snapshot for {key!r}")
