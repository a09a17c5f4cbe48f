"""Background machinery for the concurrent snapshot control plane.

Three pieces, consumed by :mod:`nydus_snapshotter_tpu_torch.snapshot.snapshotter`
and :mod:`nydus_snapshotter_tpu_torch.snapshot.metastore`:

- :func:`resolve_snapshots_config` — the ``[snapshots]`` knobs (read pool
  size, prepare fanout, usage workers, …) resolved env > config > defaults,
  the same layering the ``[convert]`` / ``[blobcache]`` sections use;
- :class:`PrepareBoard` — deferred per-snapshot prepare work keyed by
  snapshot id, so containerd's serial per-layer Prepare RPCs pipeline:
  each Prepare returns as soon as the routing decision and mount synthesis
  are done, while the slow tail (daemon readiness, stargz bootstrap build)
  runs on a bounded pool. ``join`` is the read barrier at ``mounts()``;
- :class:`UsageAccountant` — async disk-usage accounting: ``commit`` no
  longer walks the upper dir inline; scans run on a worker that backfills
  Usage through ONE batched metastore transaction per drain, and
  ``usage()`` joins any pending scan before reading.

Failure contract (chaos-tested in tests/test_snapshot_concurrency.py): a
failed background prepare STICKS on the board — every ``join`` for that
snapshot re-raises it until ``discard`` at remove/cleanup — so an error
surfaces at ``mounts()`` instead of vanishing into a worker thread. A
failed usage scan surfaces once at the joining ``usage()`` call; the
committed row keeps its last stored value.
"""

from __future__ import annotations

import os
import threading
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Optional

from nydus_snapshotter_tpu_torch import failpoint
from nydus_snapshotter_tpu_torch import trace
from nydus_snapshotter_tpu_torch.analysis import runtime as _an
from nydus_snapshotter_tpu_torch.metrics import data as metrics_data

DEFAULT_READ_POOL = 8
DEFAULT_PREPARE_FANOUT = 4
DEFAULT_USAGE_WORKERS = 1
DEFAULT_CLEANUP_WORKERS = 4
DEFAULT_ANCESTOR_CACHE = 1024

# One usage-scan drain writes at most this many rows per transaction; a
# storm of commits cannot make a single write transaction unbounded.
USAGE_BATCH_MAX = 64


@dataclass
class SnapshotsRuntimeConfig:
    """Resolved ``[snapshots]`` section. Worker counts of 0 mean inline
    (synchronous) execution — the serial control plane of PR 3 and earlier."""

    read_pool: int = DEFAULT_READ_POOL
    prepare_fanout: int = DEFAULT_PREPARE_FANOUT
    usage_workers: int = DEFAULT_USAGE_WORKERS
    cleanup_workers: int = DEFAULT_CLEANUP_WORKERS
    ancestor_cache: int = DEFAULT_ANCESTOR_CACHE


def _env_int(name: str, default: int) -> int:
    try:
        v = int(os.environ.get(name, ""))
        return v if v >= 0 else default
    except ValueError:
        return default


def _global_snapshots_config():
    """The snapshotter's ``[snapshots]`` section when a global config is
    set (config/config.py); None in library / test use."""
    from nydus_snapshotter_tpu_torch.config.config import global_section

    return global_section("snapshots")


def resolve_snapshots_config() -> SnapshotsRuntimeConfig:
    """Resolve control-plane knobs: ``NTPU_SNAPSHOT*`` env > ``[snapshots]``
    config > defaults."""
    sc = _global_snapshots_config()

    def pick(env: str, attr: str, default: int) -> int:
        v = _env_int(env, -1)
        if v >= 0:
            return v
        got = getattr(sc, attr, None)
        return got if got is not None else default

    return SnapshotsRuntimeConfig(
        read_pool=max(1, pick("NTPU_SNAPSHOT_READ_POOL", "read_pool", DEFAULT_READ_POOL)),
        prepare_fanout=pick(
            "NTPU_SNAPSHOT_PREPARE_FANOUT", "prepare_fanout", DEFAULT_PREPARE_FANOUT
        ),
        usage_workers=pick(
            "NTPU_SNAPSHOT_USAGE_WORKERS", "usage_workers", DEFAULT_USAGE_WORKERS
        ),
        cleanup_workers=max(
            1,
            pick("NTPU_SNAPSHOT_CLEANUP_WORKERS", "cleanup_workers", DEFAULT_CLEANUP_WORKERS),
        ),
        ancestor_cache=pick(
            "NTPU_SNAPSHOT_ANCESTOR_CACHE", "ancestor_cache", DEFAULT_ANCESTOR_CACHE
        ),
    )


class PrepareBoard:
    """Background per-snapshot prepare work keyed by snapshot id.

    ``fanout`` of 0 runs every submission inline (serial behavior). The
    ``snapshot.prepare`` failpoint fires at the submitted-work boundary in
    both modes, so chaos coverage is identical serial and concurrent.
    """

    def __init__(self, fanout: int):
        self.fanout = max(0, fanout)
        self._lock = _an.make_lock("snapshot.prepare_board")
        self._exec: Optional[ThreadPoolExecutor] = None
        self._pending: dict[str, Future] = {}
        # Lockset annotation: the pending-futures board is only ever
        # touched under self._lock (NTPU_ANALYZE=1 verifies).
        self._pending_shared = _an.shared("snapshot.prepare_board.pending")
        self._closed = False

    @property
    def enabled(self) -> bool:
        return self.fanout > 0

    def _executor(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._exec is None:
                self._exec = ThreadPoolExecutor(
                    max_workers=self.fanout, thread_name_prefix="ntpu-snap-prep"
                )
            return self._exec

    def _gauge(self) -> None:
        metrics_data.SnapshotPendingPrepares.set(len(self._pending))

    def submit(self, sid: str, fn: Callable[[], None]) -> None:
        if not self.enabled or self._closed:
            with trace.span("snapshot.prepare.bg", sid=sid, inline=True):
                failpoint.hit("snapshot.prepare")
                fn()
            return
        with self._lock:
            self._pending_shared.write()
            prev = self._pending.pop(sid, None)
        # Executor threads have no contextvars: carry the submitting
        # Prepare's trace context so the deferred slow tail (daemon
        # readiness, stargz bootstrap build) lands in its span tree.
        ctx = trace.capture()

        def run() -> None:
            if prev is not None:
                # Per-sid ordering: chained work waits for (and propagates
                # the failure of) whatever was already in flight.
                prev.result()
            with trace.with_context(ctx), trace.span(
                "snapshot.prepare.bg", sid=sid
            ):
                failpoint.hit("snapshot.prepare")
                fn()

        fut = self._executor().submit(run)
        with self._lock:
            self._pending_shared.write()
            self._pending[sid] = fut
            self._gauge()

    def join(self, sid: str) -> None:
        """Block until sid's background work completes; re-raise its
        failure. Success clears the entry; failure sticks (every later
        join raises again) until :meth:`discard`."""
        with self._lock:
            self._pending_shared.read()
            fut = self._pending.get(sid)
        if fut is None:
            return
        try:
            fut.result()
        except BaseException:
            raise
        else:
            with self._lock:
                if self._pending.get(sid) is fut:
                    self._pending.pop(sid, None)
                self._gauge()

    def wait_quiet(self, sid: Optional[str]) -> None:
        """Wait for sid's work without consuming or raising its outcome —
        the usage accountant's pre-scan barrier (the error still surfaces
        at the next ``join``)."""
        if sid is None:
            return
        with self._lock:
            fut = self._pending.get(sid)
        if fut is None:
            return
        try:
            fut.result()
        except BaseException:
            pass

    def discard(self, sid: str) -> None:
        with self._lock:
            self._pending.pop(sid, None)
            self._gauge()

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            ex = self._exec
            self._exec = None
        if ex is not None:
            ex.shutdown(wait=True, cancel_futures=True)


class _Scan:
    __slots__ = ("key", "path", "sid", "done", "exc", "ctx")

    def __init__(self, key: str, path: str, sid: Optional[str]):
        self.key = key
        self.path = path
        self.sid = sid
        self.done = threading.Event()
        self.exc: Optional[BaseException] = None
        # Trace context of the submitting commit, so the async usage scan
        # is attributed to the Commit that queued it.
        self.ctx = trace.capture()


class UsageAccountant:
    """Async disk-usage accounting queue backfilling committed Usage.

    ``scan(path) -> Usage`` and ``write({key: Usage}) -> ts`` are injected
    (the snapshotter passes ``_disk_usage`` and ``MetaStore.set_usages``),
    so one drain lands every completed scan in a single batched write
    transaction. ``pre_wait(sid)`` (the prepare board's quiet barrier)
    keeps a scan from measuring a layer whose background prep is still
    writing into it.
    """

    def __init__(
        self,
        scan: Callable[[str], object],
        write: Callable[[dict], object],
        workers: int = DEFAULT_USAGE_WORKERS,
        pre_wait: Optional[Callable[[Optional[str]], None]] = None,
    ):
        self._scan = scan
        self._write = write
        self._pre_wait = pre_wait
        self.workers = max(0, workers)
        self._cond = _an.make_condition("snapshot.usage_accountant")
        self._queue: deque[_Scan] = deque()
        self._pending: dict[str, _Scan] = {}
        self._threads: list[threading.Thread] = []
        self._closed = False

    def _gauge_locked(self) -> None:
        metrics_data.SnapshotPendingUsageScans.set(len(self._pending))

    def _run_inline(self, entry: _Scan) -> None:
        with trace.span("snapshot.usage.scan", key=entry.key, inline=True):
            if self._pre_wait is not None:
                self._pre_wait(entry.sid)
            failpoint.hit("snapshot.usage")
            self._write({entry.key: self._scan(entry.path)})

    def submit(self, key: str, path: str, sid: Optional[str] = None) -> None:
        """Queue a scan of ``path`` whose result backfills snapshot ``key``.
        With 0 workers the scan runs inline and errors propagate to the
        caller — the serial commit path."""
        entry = _Scan(key, path, sid)
        if self.workers == 0 or self._closed:
            self._run_inline(entry)
            return
        with self._cond:
            self._pending[key] = entry
            self._queue.append(entry)
            self._gauge_locked()
            while len(self._threads) < min(self.workers, len(self._queue)):
                t = threading.Thread(
                    target=self._worker,
                    name=f"ntpu-snap-usage-{len(self._threads)}",
                    daemon=True,
                )
                self._threads.append(t)
                t.start()
            self._cond.notify()

    def _worker(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if self._closed and not self._queue:
                    return
                batch = [
                    self._queue.popleft()
                    for _ in range(min(USAGE_BATCH_MAX, len(self._queue)))
                ]
            results: dict[str, object] = {}
            scanned: list[_Scan] = []
            for e in batch:
                try:
                    with trace.with_context(e.ctx), trace.span(
                        "snapshot.usage.scan", key=e.key
                    ):
                        if self._pre_wait is not None:
                            self._pre_wait(e.sid)
                        failpoint.hit("snapshot.usage")
                        results[e.key] = self._scan(e.path)
                    scanned.append(e)
                except BaseException as exc:  # noqa: BLE001 - stored, surfaced at join
                    e.exc = exc
            if results:
                try:
                    self._write(results)
                except BaseException as exc:  # noqa: BLE001
                    for e in scanned:
                        e.exc = exc
            with self._cond:
                for e in batch:
                    if e.exc is None and self._pending.get(e.key) is e:
                        self._pending.pop(e.key, None)
                self._gauge_locked()
            for e in batch:
                e.done.set()

    def join(self, key: str) -> None:
        """Wait for any pending scan of ``key``; a failed scan raises here
        ONCE (the entry is consumed) and the stored Usage is left at its
        last value."""
        with self._cond:
            entry = self._pending.get(key)
        if entry is None:
            return
        entry.done.wait()
        with self._cond:
            if self._pending.get(key) is entry:
                self._pending.pop(key, None)
            self._gauge_locked()
        if entry.exc is not None:
            raise entry.exc

    def discard(self, key: str) -> None:
        with self._cond:
            self._pending.pop(key, None)
            self._gauge_locked()

    def pending_count(self) -> int:
        with self._cond:
            return len(self._pending)

    def flush(self) -> None:
        """Block until everything queued so far has been scanned and
        written (errors stay parked for their joins)."""
        with self._cond:
            entries = list(self._pending.values())
        for e in entries:
            e.done.wait()

    def close(self, timeout: float = 10.0) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=timeout)
