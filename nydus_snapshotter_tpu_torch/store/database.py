"""Crash-consistent state database.

Reference pkg/store/database.go:36-331 keeps two bbolt buckets
(``v1/daemons``, ``v1/instances``) of JSON values plus a monotonic instance
sequence used to replay mounts in creation order after a restart
(rafs.go:112-117), with schema-version migration (database_compat.go).

Re-implemented on sqlite3 (stdlib, transactional): same record semantics,
same JSON value encoding, same monotonic-seq guarantee (survives deletes),
same versioned-schema migration hook.
"""

from __future__ import annotations

import json
import os
import sqlite3
import threading
from typing import Any, Callable, Iterator, Optional

from nydus_snapshotter_tpu_torch.utils import errdefs

SCHEMA_VERSION = 1


class StoreError(errdefs.NydusError):
    pass


class Database:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._lock = threading.RLock()
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA synchronous=NORMAL")
        self._init_schema()

    def _init_schema(self) -> None:
        with self._lock, self._conn:
            c = self._conn
            c.execute("CREATE TABLE IF NOT EXISTS meta (key TEXT PRIMARY KEY, value TEXT)")
            c.execute(
                "CREATE TABLE IF NOT EXISTS daemons (id TEXT PRIMARY KEY, value TEXT NOT NULL)"
            )
            c.execute(
                "CREATE TABLE IF NOT EXISTS instances ("
                "snapshot_id TEXT PRIMARY KEY, value TEXT NOT NULL, seq INTEGER NOT NULL)"
            )
            c.execute("CREATE TABLE IF NOT EXISTS seqs (name TEXT PRIMARY KEY, next INTEGER)")
            row = c.execute("SELECT value FROM meta WHERE key='schema_version'").fetchone()
            if row is None:
                c.execute(
                    "INSERT INTO meta (key, value) VALUES ('schema_version', ?)",
                    (str(SCHEMA_VERSION),),
                )
            else:
                self._migrate(int(row[0]))

    def _migrate(self, from_version: int) -> None:
        """Versioned migration (reference database_compat.go). v1 is current."""
        if from_version == SCHEMA_VERSION:
            return
        if from_version > SCHEMA_VERSION:
            raise StoreError(
                f"database schema {from_version} is newer than supported {SCHEMA_VERSION}"
            )
        # Future upgrades: apply stepwise migrations here, then bump.
        self._conn.execute(
            "UPDATE meta SET value=? WHERE key='schema_version'", (str(SCHEMA_VERSION),)
        )

    def close(self) -> None:
        with self._lock:
            self._conn.close()

    # -- daemons ------------------------------------------------------------

    def save_daemon(self, daemon_id: str, state: dict[str, Any]) -> None:
        with self._lock, self._conn:
            try:
                self._conn.execute(
                    "INSERT INTO daemons (id, value) VALUES (?, ?)",
                    (daemon_id, json.dumps(state, sort_keys=True)),
                )
            except sqlite3.IntegrityError as e:
                raise errdefs.AlreadyExists(f"daemon {daemon_id} already saved") from e

    def update_daemon(self, daemon_id: str, state: dict[str, Any]) -> None:
        with self._lock, self._conn:
            cur = self._conn.execute(
                "UPDATE daemons SET value=? WHERE id=?",
                (json.dumps(state, sort_keys=True), daemon_id),
            )
            if cur.rowcount == 0:
                raise errdefs.NotFound(f"daemon {daemon_id} not in store")

    def get_daemon(self, daemon_id: str) -> dict[str, Any]:
        with self._lock:
            row = self._conn.execute(
                "SELECT value FROM daemons WHERE id=?", (daemon_id,)
            ).fetchone()
        if row is None:
            raise errdefs.NotFound(f"daemon {daemon_id} not in store")
        return json.loads(row[0])

    def delete_daemon(self, daemon_id: str) -> None:
        with self._lock, self._conn:
            self._conn.execute("DELETE FROM daemons WHERE id=?", (daemon_id,))

    def walk_daemons(self) -> Iterator[dict[str, Any]]:
        with self._lock:
            rows = self._conn.execute("SELECT value FROM daemons ORDER BY id").fetchall()
        for (value,) in rows:
            yield json.loads(value)

    def cleanup_daemons(self) -> int:
        with self._lock, self._conn:
            return self._conn.execute("DELETE FROM daemons").rowcount

    # -- instances (RAFS) ---------------------------------------------------

    def next_instance_seq(self) -> int:
        """Monotonic sequence — survives deletes, mirrors bbolt's
        NextSequence (database.go:302)."""
        with self._lock, self._conn:
            self._conn.execute(
                "INSERT INTO seqs (name, next) VALUES ('instance', 1) "
                "ON CONFLICT(name) DO UPDATE SET next = next + 1"
            )
            (seq,) = self._conn.execute(
                "SELECT next FROM seqs WHERE name='instance'"
            ).fetchone()
            return int(seq)

    def save_instance(self, snapshot_id: str, state: dict[str, Any], seq: int) -> None:
        with self._lock, self._conn:
            try:
                self._conn.execute(
                    "INSERT INTO instances (snapshot_id, value, seq) VALUES (?, ?, ?)",
                    (snapshot_id, json.dumps(state, sort_keys=True), seq),
                )
            except sqlite3.IntegrityError as e:
                raise errdefs.AlreadyExists(f"instance {snapshot_id} already saved") from e

    def get_instance(self, snapshot_id: str) -> dict[str, Any]:
        with self._lock:
            row = self._conn.execute(
                "SELECT value FROM instances WHERE snapshot_id=?", (snapshot_id,)
            ).fetchone()
        if row is None:
            raise errdefs.NotFound(f"instance {snapshot_id} not in store")
        return json.loads(row[0])

    def delete_instance(self, snapshot_id: str) -> None:
        with self._lock, self._conn:
            self._conn.execute("DELETE FROM instances WHERE snapshot_id=?", (snapshot_id,))

    def walk_instances(self) -> Iterator[tuple[dict[str, Any], int]]:
        """Yield (state, seq) in seq order — the mount replay order."""
        with self._lock:
            rows = self._conn.execute(
                "SELECT value, seq FROM instances ORDER BY seq"
            ).fetchall()
        for value, seq in rows:
            yield json.loads(value), int(seq)

    def import_legacy_bolt(self, path: str) -> tuple[int, int]:
        """Import a reference-snapshotter bbolt database (nydus.db).

        Handles both on-disk generations the reference migrates between
        (database.go:147-188): the legacy top-level ``daemons`` bucket and
        the ``v1`` hierarchy (v1/daemons + v1/instances). Values are the
        reference's JSON records, stored verbatim so the daemon manager's
        recovery can interpret them. Returns (daemons, instances) counts.
        """
        daemons, instances = load_legacy_bolt(path)
        n_daemons = n_instances = 0
        for rec in daemons:
            did = rec.get("ID") or rec.get("id")
            if not did:
                continue
            try:
                self.save_daemon(did, rec)
            except errdefs.AlreadyExists:
                self.update_daemon(did, rec)
            n_daemons += 1
        # Preserve the reference's recorded mount-replay order: its seq
        # field (rafs.go:112-117), not bbolt's lexical key order, decides
        # recovery order.
        instances = sorted(instances, key=lambda r: r.get("Seq", r.get("seq", 0)))
        for rec in instances:
            sid = rec.get("SnapshotID") or rec.get("snapshot_id")
            if not sid:
                continue
            try:
                self.save_instance(sid, rec, self.next_instance_seq())
                n_instances += 1
            except errdefs.AlreadyExists:
                pass  # idempotent re-import: the existing record wins
        return n_daemons, n_instances


def load_legacy_bolt(path: str) -> tuple[list[dict], list[dict]]:
    """(daemon records, instance records) from a reference bbolt file."""
    from nydus_snapshotter_tpu_torch.store.boltdb import BoltDB

    db = BoltDB(path)
    daemons_bucket = db.bucket(b"v1", b"daemons") or db.bucket(b"daemons")
    instances_bucket = db.bucket(b"v1", b"instances")
    daemons = (
        [json.loads(v) for _k, v in daemons_bucket.items()]
        if daemons_bucket is not None
        else []
    )
    instances = (
        [json.loads(v) for _k, v in instances_bucket.items()]
        if instances_bucket is not None
        else []
    )
    return daemons, instances
