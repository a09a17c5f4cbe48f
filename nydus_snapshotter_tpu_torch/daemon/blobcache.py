"""Registry-backed lazy blob reads with a chunk-granular local cache.

This is the half of nydusd's data plane the daemon was missing: with a
``registry`` backend in the instance config, chunk reads become ranged
HTTP GETs against the blob (mirrors first, origin last — the failover the
reference configures through mirror lists, daemonconfig mirrors.go), and
every fetched extent is written through to a local cache file so the
second access is a local pread. Cache artifacts use the reference's
blobcache names — ``<blob_id>.blob.data`` + ``<blob_id>.chunk_map`` — the
exact files pkg/cache's accounting/GC already manages (cache/manager.py).

The miss path is parallel (daemon/fetch_sched.py): concurrent misses on
overlapping extents share one flight, adjacent miss gaps coalesce into
larger ranged GETs, sequential readers get readahead, and all fetches run
on a multi-connection worker pool under a byte-bounded in-flight budget.

The chunk map is an append-only sequence of ``(u64 offset, u32 size)``
little-endian records; a torn final record (crash mid-append) is dropped
on load, and the corresponding extent simply re-fetches. Appends are
batched: each fetch batch (one ``read_at`` miss, one prefetch-replay
file) flushes once instead of once per record.
"""

from __future__ import annotations

import logging
import os
import struct
import threading
import time
from time import perf_counter
from typing import Callable, Optional

from nydus_snapshotter_tpu_torch import trace
from nydus_snapshotter_tpu_torch.analysis import runtime as _an
from nydus_snapshotter_tpu_torch.daemon import fetch_sched
from nydus_snapshotter_tpu_torch.daemon.fetch_sched import (
    BACKGROUND,
    DEMAND,
    PREFETCH,
    FetchConfig,
    FetchScheduler,
    IntervalSet,
)
from nydus_snapshotter_tpu_torch.provenance import ledger as provenance
from nydus_snapshotter_tpu_torch.remote import mirror as mirror_mod
from nydus_snapshotter_tpu_torch.remote.mirror import HostHealth

logger = logging.getLogger(__name__)

_RECORD = struct.Struct("<QI")

# A throttling registry's Retry-After is honored in place (the host is
# being polite, not failing), bounded like remote/transport.py.
RETRY_AFTER_CAP = 5.0


class RegistryBlobFetcher:
    """Ranged blob GETs with health-scored mirror failover.

    ``backend`` is a daemonconfig.BackendConfig-shaped object (host, repo,
    scheme, auth, skip_verify, mirrors). Mirrors are tried in listed order,
    the origin host last. Each host carries a
    :class:`~nydus_snapshotter_tpu_torch.remote.mirror.HostHealth` consecutive-
    failure scorer: a host that trips its failure limit goes on cooldown
    and is skipped by the ordering until the cooldown expires, then gets a
    fresh budget — no host stays demoted forever. Cooled-down hosts are
    still tried last-resort when every healthy candidate failed. HTTP 429
    honors Retry-After with one bounded in-place retry, the same contract
    as remote/transport.py.

    ``read_range`` is thread-safe and is called concurrently by the fetch
    scheduler's worker pool (one pooled RegistryClient per host; the
    client itself opens one connection per request).
    """

    def __init__(
        self,
        backend,
        blob_id: str,
        clock=time.monotonic,
        sleep=time.sleep,
        health_registry=None,
    ):
        self.backend = backend
        self.blob_id = blob_id
        self._sleep = sleep
        mirrors = [m for m in getattr(backend, "mirrors", []) if m.host]
        hosts = [m.host for m in mirrors]
        hosts.append(backend.host)
        self._hosts = hosts
        self._clients: dict[str, object] = {}
        # Host health lives in the PROCESS-WIDE registry shared with the
        # converter transport (remote/transport.Pool) and the peer router
        # (daemon/peer.py): a host one component demotes is avoided by
        # all. A custom clock (tests) gets a private table instead.
        if health_registry is None:
            if clock is time.monotonic:
                health_registry = mirror_mod.global_health_registry()
            else:
                health_registry = mirror_mod.HostHealthRegistry(clock=clock)
        self._registry = health_registry
        self._health: dict[str, HostHealth] = {}
        for m in mirrors:
            self._health[m.host] = health_registry.health_for(
                m.host,
                failure_limit=getattr(m, "failure_limit", 5),
                cooldown=float(getattr(m, "health_check_interval", 5)),
            )
        self._health[backend.host] = health_registry.health_for(backend.host)
        self._lock = _an.make_lock(f"blobcache.fetcher[{blob_id[:8]}]")

    def _client(self, host: str):
        from nydus_snapshotter_tpu_torch.auth import keychain as authmod
        from nydus_snapshotter_tpu_torch.remote.registry import RegistryClient

        with self._lock:
            client = self._clients.get(host)
            if client is None:
                kc = None
                if getattr(self.backend, "auth", ""):
                    kc = authmod.from_base64(self.backend.auth)
                # Scheme is per host: an explicit URL prefix wins, the
                # origin scheme is only the default for bare hosts (an
                # https:// mirror must never be contacted in cleartext).
                if host.startswith("https://"):
                    plain = False
                elif host.startswith("http://"):
                    plain = True
                else:
                    plain = self.backend.scheme == "http"
                client = RegistryClient(
                    host.replace("http://", "").replace("https://", ""),
                    keychain=kc,
                    plain_http=plain,
                    insecure_tls=getattr(self.backend, "skip_verify", False),
                )
                self._clients[host] = client
        return client

    def _candidates(self) -> list[str]:
        """Healthy hosts in configured order, cooled-down hosts after —
        a last resort, not a permanent exclusion."""
        with self._lock:
            healthy = [h for h in self._hosts if self._health[h].available()]
            cooling = [h for h in self._hosts if not self._health[h].available()]
        return healthy + cooling

    def _record(self, host: str, ok: bool) -> None:
        with self._lock:
            h = self._health[host]
            if ok:
                h.record_success()
            else:
                h.record_failure()

    def _fetch_once(self, host: str, digest: str, offset: int, size: int) -> bytes:
        r = self._client(host).fetch_blob(
            self.backend.repo, digest, byte_range=(offset, offset + size - 1)
        )
        try:
            status = r.status
            data = r.read()
        finally:
            r.close()
        if status == 200 and len(data) > size:
            # Registry ignored the Range header and served the whole
            # blob (fetch_blob whitelists 200 for exactly this case).
            data = data[offset : offset + size]
        if len(data) != size:
            raise OSError(f"ranged GET returned {len(data)} bytes, wanted {size}")
        return data

    def read_range(self, offset: int, size: int) -> bytes:
        from nydus_snapshotter_tpu_torch.remote.registry import HTTPError

        if size <= 0:
            return b""
        digest = self.blob_id if ":" in self.blob_id else f"sha256:{self.blob_id}"
        last_error: Optional[Exception] = None
        for host in self._candidates():
            try:
                try:
                    data = self._fetch_once(host, digest, offset, size)
                except HTTPError as e:
                    if e.code != 429:
                        raise
                    # Throttled, not broken: pause as asked (bounded) and
                    # retry this host once before moving on.
                    self._sleep(min(max(e.retry_after, 0.0), RETRY_AFTER_CAP))
                    data = self._fetch_once(host, digest, offset, size)
                self._record(host, ok=True)
                return data
            except Exception as e:  # noqa: BLE001 — any failure scores, next host tries
                last_error = e
                self._record(host, ok=False)
                logger.warning("blob fetch from %s failed: %s", host, e)
        raise OSError(f"all registry hosts failed for {self.blob_id}: {last_error}")


class CachedBlob:
    """Write-through extent cache over a remote fetcher.

    ``read_at(offset, size)`` serves from ``<blob_id>.blob.data`` when the
    requested extent is covered by previously fetched intervals, else
    schedules the miss gaps on the fetch scheduler (singleflight +
    coalescing + readahead), waits, and preads the now-resident range.

    ``blob_size`` (when known) clamps readahead so sequential warming
    never runs past the blob's end. An eviction that unlinks the cache
    files under a live instance is survived transparently: the next read
    notices the dropped link, re-creates the files and re-fetches.
    """

    def __init__(
        self,
        cache_dir: str,
        blob_id: str,
        fetch_range: Callable[[int, int], bytes],
        blob_size: int = 0,
        config: Optional[FetchConfig] = None,
        budget=None,
        gate=None,
        tenant: str = "default",
    ):
        os.makedirs(cache_dir, exist_ok=True)
        self.blob_id = blob_id
        self.data_path = os.path.join(cache_dir, f"{blob_id}.blob.data")
        self.map_path = os.path.join(cache_dir, f"{blob_id}.chunk_map")
        self.fetch_range = fetch_range
        self.blob_size = max(0, int(blob_size))
        self._lock = _an.make_lock(f"blobcache.blob[{blob_id[:8]}]")
        self._intervals = IntervalSet()
        # Lockset annotation: interval/chunk-map state is only ever
        # touched under self._lock (shared with the fetch scheduler).
        self._intervals_shared = _an.shared(f"blobcache.intervals[{blob_id[:8]}]")
        self._ra_spans = IntervalSet()  # readahead-fetched, not yet read
        self._data_fd = os.open(self.data_path, os.O_RDWR | os.O_CREAT, 0o644)
        self._map_f = open(self.map_path, "ab")
        self._map_dirty = False
        self._closed = False
        self._last_end = -1  # sequential-access detector
        self._load_map()
        self.remote_bytes = 0  # fetched over the network (metrics)
        self.tenant = tenant
        self.sched = FetchScheduler(
            self._lock,
            self._intervals,
            self._fetch,
            self._deliver,
            config=config,
            budget=budget,
            name=blob_id[:8],
            gate=gate,
            tenant=tenant,
            on_fetched=self._prov_fetched,
        )
        provenance.set_blob_meta(blob_id, tenant=tenant)

    # -- persistence ---------------------------------------------------------

    def _load_map(self) -> None:
        try:
            with open(self.map_path, "rb") as f:
                raw = f.read()
        except OSError:
            return
        usable = len(raw) - len(raw) % _RECORD.size  # drop a torn tail record
        for i in range(0, usable, _RECORD.size):
            off, size = _RECORD.unpack_from(raw, i)
            self._intervals.add(off, off + size)

    def _fetch(self, offset: int, size: int) -> bytes:
        data = self.fetch_range(offset, size)
        if len(data) != size:
            raise OSError(
                f"fetcher returned {len(data)} bytes for [{offset}, {offset + size})"
            )
        return data

    def _deliver(self, offset: int, data: bytes) -> None:
        """Persist one completed flight (runs under self._lock): sparse
        pwrite + chunk-map append (flushed per batch, not per record)."""
        self._intervals_shared.write()
        os.pwrite(self._data_fd, data, offset)
        self._map_f.write(_RECORD.pack(offset, len(data)))
        self._map_dirty = True
        self._intervals.add(offset, offset + len(data))
        self.remote_bytes += len(data)

    def _flush_map_locked(self) -> None:
        if self._map_dirty:
            self._map_f.flush()
            self._map_dirty = False

    def _prov_fetched(self, flight, n: int) -> None:
        """Attribute one delivered flight in the provenance ledger
        (called by the scheduler under self._lock, on the worker thread
        that ran the fetch). Cause resolution: a plan-time tag override
        (e.g. the seekable-index build) wins, then a fired hedge race,
        then the flight's QoS lane. Attribution can degrade (the
        ``prov.record`` chaos contract) but can never fail the read."""
        try:
            notes = fetch_sched.take_fetch_notes()
            if flight.tag:
                cause = flight.tag
            elif notes.get("hedged"):
                cause = provenance.CAUSE_HEDGE_WINNER
            else:
                cause = fetch_sched.LANE_NAMES[flight.priority]
            provenance.record_fetch(
                self.blob_id,
                flight.start,
                n,
                cause,
                tier=str(notes.get("tier", "")),
            )
        except Exception:  # noqa: BLE001 — attribution never fails a read
            logger.debug("provenance record failed", exc_info=True)

    # -- eviction survival ---------------------------------------------------

    def _revalidate_locked(self) -> None:
        """A capacity-watermark eviction (cache/manager.py) may unlink the
        cache files under a live instance. The open fd keeps old bytes
        readable but new write-through would land in an unlinked inode —
        so detect the dropped link and start the cache over. The link
        count alone misses it where an open, unlinked file keeps
        ``st_nlink`` 1 (9p): the path must also still name the fd's
        inode."""
        try:
            st = os.fstat(self._data_fd)
        except OSError:
            return
        if st.st_nlink > 0:
            try:
                on_disk = os.stat(self.data_path)
            except FileNotFoundError:
                on_disk = None
            except OSError:
                return
            if on_disk is not None and (on_disk.st_dev, on_disk.st_ino) == (st.st_dev, st.st_ino):
                return
        try:
            os.close(self._data_fd)
        except OSError:
            pass
        try:
            self._map_f.close()
        except OSError:
            pass
        self._data_fd = os.open(self.data_path, os.O_RDWR | os.O_CREAT, 0o644)
        self._map_f = open(self.map_path, "ab")
        self._map_dirty = False
        self._intervals.clear()
        self._ra_spans.clear()
        self._load_map()  # a concurrent writer may have re-seeded it

    # -- reads ---------------------------------------------------------------

    def _plan_readahead_locked(self, end: int) -> None:
        """Sequential reader: extend the window ahead of the read as
        BACKGROUND flights (never merged into the demand fetch, so a
        readahead failure can't fail the read)."""
        ra = self.sched.cfg.readahead
        if ra <= 0:
            return
        ra_end = end + ra
        if self.blob_size:
            ra_end = min(ra_end, self.blob_size)
        if ra_end <= end:
            return
        from nydus_snapshotter_tpu_torch import failpoint

        with trace.span(
            "blobcache.readahead", blob=self.blob_id[:8], window=(end, ra_end)
        ) as sp:
            failpoint.hit("blobcache.readahead")
            planned = 0
            pre = {id(f) for f in self.sched.overlapping_flights(end, ra_end)}
            for f in self.sched.plan_locked(end, ra_end, priority=BACKGROUND):
                if id(f) not in pre and f.priority == BACKGROUND:
                    # New flights cover exactly uncovered, not-in-flight gaps.
                    fetch_sched.READAHEAD_BYTES.inc(f.end - f.start)
                    self._ra_spans.add(f.start, f.end)
                    planned += f.end - f.start
            sp.annotate(planned_bytes=planned)

    def _account_ra_hit_locked(self, start: int, end: int) -> None:
        hit = self._ra_spans.remove(start, end)
        if hit:
            fetch_sched.READAHEAD_HIT_BYTES.inc(hit)

    def read_at(self, offset: int, size: int, lane: int = DEMAND) -> bytes:
        """Serve ``[offset, offset+size)``. ``lane`` is the QoS lane the
        miss fetches run at: DEMAND for real reads, PEER_SERVE when a
        peer chunk server pulls through on behalf of another node
        (daemon/peer.py) — local demand must always outrank it."""
        if size <= 0:
            return b""
        # One span + one histogram sample per read, both metering the
        # same window — the trace shows WHERE this read's time went (its
        # fetch flights carry this context), the histogram shows the
        # population.
        t0 = perf_counter()
        with trace.span(
            "blobcache.read_at", blob=self.blob_id[:8], offset=offset, bytes=size
        ):
            try:
                return self._read_at(offset, size, lane)
            finally:
                fetch_sched.OP_HIST.labels("read_at").observe(
                    (perf_counter() - t0) * 1000.0
                )

    def _read_at(self, offset: int, size: int, lane: int = DEMAND) -> bytes:
        end = offset + size
        first_pass = True
        while True:
            with self._lock:
                if self._closed:
                    raise OSError(f"blob cache {self.data_path} is closed")
                self._revalidate_locked()
                self._intervals_shared.write()
                # Peer-serve pull-throughs must not pollute the LOCAL
                # sequential-reader detector (readahead is a demand-lane
                # heuristic).
                sequential = lane == DEMAND and offset == self._last_end
                if lane == DEMAND:
                    self._last_end = end
                if self._intervals.covered(offset, end):
                    if first_pass:
                        fetch_sched.HIT_BYTES.inc(size)
                    self._account_ra_hit_locked(offset, end)
                    if sequential and lane == DEMAND:
                        self._plan_readahead_locked(end)
                    if lane == DEMAND:
                        # The read set the provenance waste accounting
                        # overlays on the attributed extents (peer-serve
                        # pull-throughs are a remote node's reads, not
                        # local heat).
                        provenance.record_read(self.blob_id, offset, size)
                    return os.pread(self._data_fd, size, offset)
                flights = self.sched.plan_locked(offset, end, priority=lane)
                if sequential and first_pass and lane == DEMAND:
                    self._plan_readahead_locked(end)
            first_pass = False
            for f in flights:
                f.wait()
            errors = [f.error for f in flights if f.error is not None]
            if errors:
                hard = [
                    e for e in errors
                    if not isinstance(e, fetch_sched.LaneShedError)
                ]
                if hard:
                    raise hard[0]
                if lane != DEMAND:
                    # This read's own lane is shed: degrade like any other
                    # background failure (prefetch warms nothing, a peer
                    # requester falls back to the registry).
                    raise errors[0]
                # A demand read piggybacked on a background flight that SLO
                # actuation shed: replan — the while loop re-plans the
                # still-uncovered extent at DEMAND priority, which is never
                # shed, so actuation cannot fail or starve a real read.
                continue
            with self._lock:
                if self._closed:
                    raise OSError(f"blob cache {self.data_path} is closed")
                self._flush_map_locked()
                self._intervals_shared.read()
                # A concurrent eviction can drop coverage between flight
                # delivery and this pread — replan instead of returning
                # holes (the while-loop re-checks under the lock).
                if self._intervals.covered(offset, end):
                    self._account_ra_hit_locked(offset, end)
                    if lane == DEMAND:
                        provenance.record_read(self.blob_id, offset, size)
                    return os.pread(self._data_fd, size, offset)

    def covered(self, offset: int, size: int) -> bool:
        """Whether ``[offset, offset+size)`` is resident locally — the
        peer chunk server (daemon/peer.py) answers cover-only requests
        from this, never fetching on a stranger's behalf."""
        with self._lock:
            if self._closed:
                return False
            self._intervals_shared.read()
            return self._intervals.covered(offset, offset + size)

    def coverage_bytes(self) -> int:
        """Total resident bytes (peer announce/stat endpoint)."""
        with self._lock:
            if self._closed:
                return 0
            self._intervals_shared.read()
            return self._intervals.total_bytes()

    def warm(self, offset: int, size: int) -> list:
        """Schedule ``[offset, offset+size)`` residency at PREFETCH
        priority (prefetch-list replay — below the readahead lane, above
        peer-serve); returns the flights to optionally wait on. Never
        raises on a closed cache — warming is advisory."""
        if size <= 0:
            return []
        with self._lock:
            if self._closed:
                return []
            self._intervals_shared.read()
            if self._intervals.covered(offset, offset + size):
                return []
            try:
                return self.sched.plan_locked(offset, offset + size, priority=PREFETCH)
            except OSError:
                return []

    def flush_map(self) -> None:
        """One batched chunk-map flush (prefetch replay calls this per
        replayed file; read_at flushes per miss batch)."""
        with self._lock:
            if not self._closed:
                self._flush_map_locked()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        # Scheduler teardown happens outside the lock: in-flight workers
        # need it to finish delivering before they observe the close.
        self.sched.close()
        with self._lock:
            try:
                try:
                    self._map_f.flush()
                finally:
                    os.close(self._data_fd)
            finally:
                self._map_f.close()
