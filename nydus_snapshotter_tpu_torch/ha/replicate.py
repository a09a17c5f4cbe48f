"""Replica-side replication: journal tailing, verbatim apply, promotion.

:class:`ReplicaTailer` runs inside a replica dict-service process. Per
poll round, for every namespace the primary lists:

1. **epoch probe** — tail the primary's ``since`` journal RPC in
   ``count_only`` mode from the last reconciled index epoch: one cheap
   header answers "how many index entries landed since I looked", and
   carries the primary's ``rebuild_epoch`` for reconciliation. An epoch
   that went BACKWARDS (or a chunk total below what this replica
   already applied) means the primary restarted with a younger table —
   the replica cannot reconcile its cursor and RESYNCS from a full
   snapshot, loudly (error log + ``ntpu_dict_ha_resyncs_total``; the
   local namespace is wiped and re-pulled from record zero). A 409
   (journal compacted past the cursor) only re-baselines the epoch
   cursor — the RECORD stream is append-only and never compacted, so
   the record cursor stays valid.
2. **record pull** — fetch the append-only record tail past the
   replica's counts via the ``entries`` RPC with a chunk-row ``limit``
   sized to the byte budget (``limit = budget_bytes // 64``; a chunk
   row is 64 wire bytes). The tailer applies each payload before
   requesting the next, so replication holds AT MOST one budgeted
   payload in flight — the bounded-memory contract that keeps catch-up
   from competing with demand traffic.
3. **verbatim apply** — rows land at exactly the table positions the
   primary holds them
   (:meth:`~nydus_snapshotter_tpu_torch.parallel.dict_service.ServiceDict.
   apply_replica_tail`), which is what lets a promoted replica honor
   the surviving clients' counts-based replay cursors unchanged. The
   applied digests grow the replica's probe index on the service's
   device, under the namespace lock; the index restages its device
   tables after the insert, so the next probe RPC (kernel K3) sees them.

:class:`HaAgent` is the member-side control surface the placement
controller drives: ``/api/v1/ha/status`` (role + per-namespace lag),
``/api/v1/ha/configure`` (role/upstream assignment),
``/api/v1/ha/promote`` (replica -> primary, tailer stopped) and
``/api/v1/ha/demote`` (primary -> draining: planned handoff). A
non-primary member answers probe/entries/since reads but rejects
merges with 503 — a client that reaches a replica fails loudly and
fails over, it never forks the table.

The **draining** role is the planned-demotion window: the member stops
accepting merges (``is_primary()`` false -> writes bounce 503 and
clients park in their failover poll loop), but keeps serving journal
reads so its replicas can catch up to the journal head and the
controller can verify they did before promoting one. Once a successor
is primary the controller re-configures the drained member as its
replica (full resync — its tables are a foreign prefix by then).
"""

from __future__ import annotations

import json
import logging
import threading
from typing import Optional

from nydus_snapshotter_tpu_torch import failpoint, trace
from nydus_snapshotter_tpu_torch import ha as _ha
from nydus_snapshotter_tpu_torch.analysis import runtime as _an

logger = logging.getLogger(__name__)

# Wire bytes per chunk record row (_CHUNK_DT itemsize): the budget ->
# chunk-row-limit conversion used for the in-flight bound.
CHUNK_ROW_BYTES = 64


class _NsCursor:
    """Replication cursor for one namespace against the primary."""

    __slots__ = (
        "chunks", "blobs", "batches", "ciphers", "index_epoch",
        "primary_epoch", "primary_chunks", "resyncs",
    )

    def __init__(self):
        self.chunks = 0
        self.blobs = 0
        self.batches = 0
        self.ciphers = 0
        self.index_epoch = 0  # last reconciled primary index epoch
        self.primary_epoch = 0
        self.primary_chunks = 0
        self.resyncs = 0

    def to_dict(self) -> dict:
        return {
            "chunks": self.chunks,
            "blobs": self.blobs,
            "batches": self.batches,
            "ciphers": self.ciphers,
            "index_epoch": self.index_epoch,
            "primary_epoch": self.primary_epoch,
            "lag_chunks": max(0, self.primary_chunks - self.chunks),
            "resyncs": self.resyncs,
        }


class ReplicaTailer:
    """Tail one primary's journals into the local (replica) service."""

    def __init__(
        self,
        service,
        upstream: str,
        budget_bytes: int = _ha.DEFAULT_BUDGET_KIB << 10,
        poll_s: float = _ha.DEFAULT_POLL_MS / 1000.0,
        rpc_timeout_s: float = 10.0,
    ):
        from nydus_snapshotter_tpu_torch.parallel.dict_service import DictClient

        self.service = service
        self.upstream = upstream
        self.budget_bytes = max(CHUNK_ROW_BYTES, int(budget_bytes))
        self.poll_s = poll_s
        self.client = DictClient(upstream, timeout=rpc_timeout_s)
        self._mu = _an.make_lock("ha.tailer")
        self._cursors: dict[str, _NsCursor] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.max_pull_bytes = 0  # observed in-flight bound (gate evidence)
        self.pulls = 0
        self.errors = 0

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="ntpu-dict-ha-tail", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)
        self.client.close()

    def _loop(self) -> None:
        while True:
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — the tailer must survive anything
                self.errors += 1
                logger.exception("dict-ha: replication round against %s failed",
                                 self.upstream)
            if self._stop.wait(self.poll_s):
                return

    # -- one replication round ----------------------------------------------

    def poll_once(self) -> int:
        """One poll over every primary namespace; returns chunk records
        applied this round."""
        failpoint.hit("ha.replicate")
        applied = 0
        for stats in self.client.namespaces():
            ns = stats.get("namespace", "")
            if not ns:
                continue
            applied += self._poll_namespace(ns, stats)
        return applied

    def _poll_namespace(self, ns: str, stats: dict) -> int:
        from nydus_snapshotter_tpu_torch.parallel.sharded_dict import DictEpochError

        with self._mu:
            cur = self._cursors.get(ns)
            if cur is None:
                cur = self._cursors[ns] = _NsCursor()
        try:
            meta, _d, _v = self.client.entries_since(
                ns, epoch=cur.index_epoch, count_only=True
            )
        except DictEpochError:
            # The journal was compacted past our cursor (a rebuild on
            # the primary). Records are append-only and unaffected —
            # only the epoch cursor re-baselines; the record pull below
            # still measures true lag via total_chunks.
            meta = {"epoch": -1, "entries": 0}
        if (
            0 <= meta["epoch"] < cur.primary_epoch
            or int(stats.get("chunks", 0)) < cur.chunks
        ):
            self._resync(
                ns,
                f"primary {self.upstream} went backwards (epoch "
                f"{meta['epoch']} < {cur.primary_epoch} or "
                f"{stats.get('chunks', 0)} chunks < the {cur.chunks} "
                "already applied)",
            )
            with self._mu:
                cur = self._cursors[ns]
        applied = self._pull_records(ns, cur)
        if meta["epoch"] >= 0:
            cur.index_epoch = meta["epoch"]
            cur.primary_epoch = meta["epoch"]
        else:
            # Re-baseline after compaction from the primary's own epoch (its
            # namespace listing). The reference package takes the replica's
            # index epoch here, which counts the replica's insert batches (one
            # per pull): after a catch-up of many pulls it exceeds the
            # primary's, and the next round resyncs from zero for nothing.
            cur.index_epoch = cur.primary_epoch = max(
                cur.primary_epoch, int(stats.get("epoch", 0))
            )
        _ha.REPLICA_LAG.labels(ns).set(max(0, cur.primary_chunks - cur.chunks))
        return applied

    def _pull_records(self, ns: str, cur: _NsCursor) -> int:
        """Budget-bounded record-tail pulls until the namespace is flush."""
        limit = max(1, self.budget_bytes // CHUNK_ROW_BYTES)
        sd = self.service.dict_for(ns)
        applied = 0
        while True:
            meta, ca, ba, ta, ea = self.client.entries(
                ns,
                chunks=cur.chunks,
                blobs=cur.blobs,
                batches=cur.batches,
                ciphers=cur.ciphers,
                limit=limit,
            )
            cur.primary_chunks = meta["total_chunks"]
            payload = ca.nbytes + ba.nbytes + ta.nbytes + ea.nbytes
            if not (len(ca) or len(ba) or len(ta) or len(ea)):
                break
            self.pulls += 1
            self.max_pull_bytes = max(self.max_pull_bytes, payload)
            _ha.REPLICATION_PULLS.inc()
            _ha.REPLICATION_BYTES.inc(payload)
            try:
                sd.apply_replica_tail(
                    meta, ca, ba, ta, ea,
                    base=(cur.chunks, cur.blobs, cur.batches, cur.ciphers),
                )
            except Exception as e:  # noqa: BLE001 — a gap means resync
                self._resync(ns, f"verbatim apply failed: {e}")
                return applied
            cur.chunks += len(ca)
            cur.blobs += len(ba)
            cur.batches += len(ta)
            cur.ciphers += len(ea)
            applied += len(ca)
            if cur.chunks >= meta["total_chunks"]:
                break
        # Trained-dict replication rides along (epoch-stamped blob; the
        # newer epoch wins on the replica exactly as on the primary).
        self._replicate_zdict(ns, sd)
        return applied

    def _replicate_zdict(self, ns: str, sd) -> None:
        try:
            stats = sd.stats()
            want = self.client.stats(ns)
        except Exception:  # noqa: BLE001 — next round retries
            return
        if want.get("zdict_epoch", -1) > stats.get("zdict_epoch", -1):
            blob = self.client.get_zdict(ns)
            if blob:
                try:
                    sd.put_zdict(blob)
                except Exception:  # noqa: BLE001 — a bad blob must not stop records
                    logger.exception("dict-ha: zdict adopt failed for %s", ns)

    def _resync(self, ns: str, why: str) -> None:
        """LOUD full resync: wipe the local namespace and re-pull the
        full record snapshot from zero (budget-bounded, like any tail)."""
        logger.error(
            "dict-ha: replica of %s cannot reconcile namespace %s — %s; "
            "resyncing from a full snapshot",
            self.upstream, ns, why,
        )
        _ha.RESYNCS.inc()
        with self._mu:
            old = self._cursors.get(ns)
            cur = self._cursors[ns] = _NsCursor()
            cur.resyncs = (old.resyncs if old else 0) + 1
        self.service.reset_namespace(ns)

    # -- surface -------------------------------------------------------------

    def status(self) -> dict:
        with self._mu:
            namespaces = {ns: c.to_dict() for ns, c in self._cursors.items()}
        return {
            "upstream": self.upstream,
            "budget_bytes": self.budget_bytes,
            "poll_ms": round(self.poll_s * 1000.0, 3),
            "pulls": self.pulls,
            "errors": self.errors,
            "max_pull_bytes": self.max_pull_bytes,
            "namespaces": namespaces,
        }


class HaAgent:
    """Member-side HA control surface, mounted on the dict service's
    socket under ``/api/v1/ha`` (see ``DictService.handle``)."""

    def __init__(self, service, cfg: Optional[_ha.HaRuntimeConfig] = None,
                 role: str = "primary"):
        self.service = service
        self.cfg = cfg or _ha.resolve_ha_config()
        self._mu = _an.make_lock("ha.agent")
        self.role = role  # primary | replica | draining
        self.shard = -1
        self.epoch = 0
        self.upstream = ""
        self.tailer: Optional[ReplicaTailer] = None
        service.ha = self

    # -- role transitions ----------------------------------------------------

    def configure(self, role: str, upstream: str = "", shard: int = -1,
                  epoch: int = 0) -> dict:
        if role not in ("primary", "replica"):
            raise ValueError(f"unknown ha role {role!r}")
        if role == "replica" and not upstream:
            raise ValueError("replica role needs an upstream")
        with self._mu:
            stale = self.tailer
            retarget = role == "replica" and (
                stale is None or stale.upstream != upstream
            )
            if role == "primary" or retarget:
                self.tailer = None
            self.role = role
            self.upstream = upstream if role == "replica" else ""
            self.shard = shard
            self.epoch = max(self.epoch, epoch)
            if retarget:
                self.tailer = ReplicaTailer(
                    self.service, upstream,
                    budget_bytes=self.cfg.budget_bytes,
                    poll_s=self.cfg.poll_s,
                )
        if (role == "primary" or retarget) and stale is not None:
            stale.stop()
        if retarget:
            if stale is not None:
                # Retargeted to a DIFFERENT shard's primary: the tables
                # replicated from the old upstream are a foreign prefix —
                # wipe and re-pull rather than wedging on a cursor gap.
                dropped = self.service.reset_all()
                if dropped:
                    logger.warning(
                        "dict-ha: retarget %s -> %s dropped %d replicated "
                        "namespace(s)", stale.upstream, upstream, dropped,
                    )
            self.tailer.start()
        logger.info(
            "dict-ha: %s configured as %s of shard %d (upstream %s, epoch %d)",
            getattr(self.service, "sock_path", "") or "local", role, shard,
            upstream or "-", epoch,
        )
        return self.status()

    def promote(self, epoch: int = 0) -> dict:
        """Replica -> primary (the controller's automatic promotion)."""
        failpoint.hit("ha.promote")
        with trace.span("ha.promote", shard=str(self.shard)):
            with self._mu:
                tailer, self.tailer = self.tailer, None
                was = self.role
                self.role = "primary"
                self.upstream = ""
                self.epoch = max(self.epoch, epoch)
            if tailer is not None:
                # Final best-effort drain: the primary is usually dead by
                # now, but a clean switchover (tests, rolling restart)
                # catches the last records before the cursor freezes.
                try:
                    tailer.poll_once()
                except Exception:  # noqa: BLE001 — the primary is gone
                    pass
                tailer.stop()
            logger.warning(
                "dict-ha: promoted to primary of shard %d (was %s)",
                self.shard, was,
            )
        return self.status()

    def demote(self) -> dict:
        """Primary -> draining (the controller's PLANNED handoff entry).

        Merges start bouncing 503 immediately (``is_primary()`` flips
        false), which parks writing clients in their failover poll loop;
        journal reads keep flowing so replicas drain to the head. The
        journal head is frozen by construction from this point — no
        merge can advance it — so "replica chunks == drained primary
        chunks" is a stable handoff condition, not a race.
        """
        with self._mu:
            was = self.role
            if was == "primary":
                self.role = "draining"
        if was != "primary":
            raise ValueError(f"cannot demote from role {was!r}")
        logger.warning(
            "dict-ha: shard %d primary draining for planned demotion",
            self.shard,
        )
        return self.status()

    def is_primary(self) -> bool:
        with self._mu:
            return self.role == "primary"

    # -- HTTP surface --------------------------------------------------------

    def status(self) -> dict:
        with self._mu:
            tailer = self.tailer
            out = {
                "role": self.role,
                "shard": self.shard,
                "epoch": self.epoch,
                "upstream": self.upstream,
            }
        out["replication"] = tailer.status() if tailer is not None else {}
        if tailer is None and out["role"] in ("primary", "draining"):
            # A promoted primary reports what it had applied — the
            # controller's most-caught-up ranking reads this. A DRAINING
            # primary reports the same view: that is the frozen journal
            # head the drain loop compares replicas against.
            out["replication"] = {
                "namespaces": {
                    s["namespace"]: {"chunks": s["chunks"]}
                    for s in self.service.namespace_stats()
                }
            }
        return out

    def handle(self, method: str, path: str, body: bytes):
        """(status, ctype, payload) for ``/api/v1/ha/...`` routes."""
        if path == "/api/v1/ha/status" and method == "GET":
            return 200, "application/json", json.dumps(self.status()).encode()
        if path == "/api/v1/ha/configure" and method == "POST":
            req = json.loads(body or b"{}")
            try:
                out = self.configure(
                    str(req.get("role", "")),
                    upstream=str(req.get("upstream", "")),
                    shard=int(req.get("shard", -1)),
                    epoch=int(req.get("epoch", 0)),
                )
            except ValueError as e:
                return 400, "application/json", json.dumps(
                    {"message": str(e)}
                ).encode()
            return 200, "application/json", json.dumps(out).encode()
        if path == "/api/v1/ha/promote" and method == "POST":
            req = json.loads(body or b"{}")
            out = self.promote(epoch=int(req.get("epoch", 0)))
            return 200, "application/json", json.dumps(out).encode()
        if path == "/api/v1/ha/demote" and method == "POST":
            try:
                out = self.demote()
            except ValueError as e:
                return 409, "application/json", json.dumps(
                    {"message": str(e)}
                ).encode()
            return 200, "application/json", json.dumps(out).encode()
        return 404, "application/json", b'{"message": "no such ha endpoint"}'
