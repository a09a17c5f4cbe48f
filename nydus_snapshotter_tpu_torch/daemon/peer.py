"""Peer chunk tier: nodes serve each other's lazy-read chunk fetches.

PR 3 made one node's cold reads fast; at cluster scale a new image deploy
makes thousands of nodes hammer the registry for the SAME chunks at the
same moment, so aggregate registry egress scales as N x unique bytes and
the storm collapses the origin. This module adds the second cache tier of
the registry -> peer -> local-cache waterfall:

- **PeerChunkServer** — every node serves ranged reads for extents its
  :class:`~nydus_snapshotter_tpu_torch.daemon.blobcache.CachedBlob`\\ s already
  cover, over the same HTTP-over-UDS/TCP machinery the chunk-dict service
  uses (parallel/dict_service.py). With ``pull_through`` on, the REGION
  OWNER of a cold extent fetches it from the registry on behalf of the
  cluster — through its own CachedBlob, whose per-blob singleflight table
  collapses every concurrent peer request into one origin GET, so a chunk
  is fetched from origin at most ~once per cluster.
- **PeerRouter** — the peer-announce/lookup map: a static peer list from
  the ``[peer]`` config (no gossip protocol), rendezvous-hashed per
  ``(blob, region)`` so every node independently agrees which peer owns a
  region. Peers are scored through the process-wide
  :class:`~nydus_snapshotter_tpu_torch.remote.mirror.HostHealthRegistry` —
  the same table the registry-mirror failover and the converter transport
  score through — so a dead peer goes on cooldown and the ranking walks
  to the next owner (or the origin) instead of timing out every read.
- **PeerAwareFetcher** — the planner's waterfall: each planned flight
  tries the healthy region owner first and falls back to the registry on
  miss / timeout / error / corrupt payload (CRC32-trailer verified), so a
  dead peer can never fail a read, only slow it by one bounded timeout.

Serving peers is the LOWEST QoS lane: the chunk server admits its bytes
through the node's :class:`~nydus_snapshotter_tpu_torch.daemon.fetch_sched.
AdmissionGate` at PEER_SERVE priority, below local demand, readahead and
prefetch replay — a node under local pressure sheds peer traffic first
(requesters transparently fall back to the registry).

At planet scale the flat ring is not enough: racks × zones × regions
have wildly asymmetric link costs, and one slow peer can hold a demand
read's tail hostage. The **hierarchical read tier** makes the topology
explicit: every member carries a ``rack:zone:region`` locality label
(``[peer] locality`` / ``NTPU_PEER_LOCALITY``, advertised through the
membership records), and lookups walk a two-level rendezvous —

- **rack owner**: rendezvous over this node's rack members; the cheap
  hop, tried first;
- **zone shield**: rendezvous over the zone's members; the shield is
  the zone's single serve point against origin — with pull-through it
  fetches a forwarded cold extent ONCE per zone (the only node whose
  pull-through rule ignores the relay-depth bound), so a region's
  unique bytes cross the zone boundary exactly once;
- **origin**: the registry, reached only by the shield (or by a node
  whose tiers are all cooling down — health cooldowns walk past dead
  tiers immediately, never time out twice).

Zone shields double as caching proxies for the hot small artifacts
(soci indexes via ``/api/v1/peer/soci/*``, trained zdicts / dict
journal tails via ``/api/v1/peer/artifact/<kind>/<key>``): on a miss
the shield adopts the artifact from the flat owner once and re-serves
it zone-locally. Tail latency rides the fetch scheduler's
:class:`~nydus_snapshotter_tpu_torch.daemon.fetch_sched.Hedger`: a flight
past its tier's rolling p99 races a hedged second request at the next
tier, loser cancelled by accounting (never a double charge, never a
double-fetch into the cache — the winner's bytes are the only bytes
delivered).

Failpoint sites ``peer.{serve,fetch,admit,member,hedge,tier}`` make
every boundary chaos-testable (docs/robustness.md); metrics land as
``ntpu_peer_*`` (per-tier egress under ``ntpu_peer_tier_egress_bytes``);
trace context rides the same ``x-ntpu-trace-*`` headers the dict service
uses, so a peer-served read's span tree spans both nodes.
"""

from __future__ import annotations

import hashlib
import http.client
import json
import logging
import os
import socket
import socketserver
import threading
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from time import perf_counter
from typing import Callable, Optional
from urllib.parse import parse_qs, urlparse

from nydus_snapshotter_tpu_torch import failpoint, trace
from nydus_snapshotter_tpu_torch.analysis import runtime as _an
from nydus_snapshotter_tpu_torch.daemon import fetch_sched
from nydus_snapshotter_tpu_torch.daemon.fetch_sched import PEER_SERVE
from nydus_snapshotter_tpu_torch.metrics import registry as _metrics
from nydus_snapshotter_tpu_torch.remote import mirror as mirror_mod

logger = logging.getLogger(__name__)

DEFAULT_REGION_KIB = 512
DEFAULT_TIMEOUT_MS = 1500
PEER_FAILURE_LIMIT = 3
PEER_COOLDOWN_SECS = 2.0
MAX_SERVE_BYTES = 64 << 20  # one ranged peer read, not a blob mirror

# Topology tiers, in link-cost order. "flat" is the pre-topology single
# rendezvous ring (no locality configured); "origin" is the registry
# fallthrough. TIER_COSTS is the score multiplier of the cost-aware
# ranking: the tier distance DOMINATES the rendezvous score, so a rack
# hop always outranks a zone hop and the numbers only matter relative
# to each other.
TIER_RACK = "rack"
TIER_ZONE = "zone"
TIER_FLAT = "flat"
TIER_ORIGIN = "origin"
TIER_COSTS = {TIER_RACK: 1.0, TIER_FLAT: 1.0, TIER_ZONE: 4.0}


def parse_locality(label: str) -> Optional[tuple[str, str, str]]:
    """``"rack:zone:region"`` → ``(rack, zone, region)``, or None for an
    empty/malformed label (a label-less member routes flat — topology is
    strictly opt-in, mixed fleets keep working)."""
    if not label:
        return None
    parts = [p.strip() for p in str(label).split(":")]
    if len(parts) != 3 or not all(parts):
        return None
    return parts[0], parts[1], parts[2]

_reg = _metrics.default_registry
SERVE_REQUESTS = _reg.register(
    _metrics.Counter(
        "ntpu_peer_serve_requests",
        "Ranged peer-read requests served by this node's chunk server,"
        " by outcome (hit / pull / miss / error)",
        ("outcome",),
    )
)
SERVED_BYTES = _reg.register(
    _metrics.Counter(
        "ntpu_peer_served_bytes",
        "Bytes this node served to cluster peers",
    )
)
FETCH_REQUESTS = _reg.register(
    _metrics.Counter(
        "ntpu_peer_fetch_requests",
        "Ranged reads this node attempted against a peer",
    )
)
FETCH_BYTES = _reg.register(
    _metrics.Counter(
        "ntpu_peer_fetch_bytes",
        "Bytes this node fetched from cluster peers instead of the registry",
    )
)
FETCH_FALLBACKS = _reg.register(
    _metrics.Counter(
        "ntpu_peer_fetch_fallbacks",
        "Peer reads that fell back to the registry, by reason"
        " (miss / timeout / error / corrupt)",
        ("reason",),
    )
)
SERVE_MS = _reg.register(
    _metrics.Histogram(
        "ntpu_peer_serve_duration_milliseconds",
        "Peer chunk-server request latency",
        ("outcome",),
    )
)
MEMBERSHIP_EPOCH = _reg.register(
    _metrics.Gauge(
        "ntpu_peer_membership_epoch",
        "Region-ownership epoch: bumps whenever the live peer set changes",
    )
)
MEMBERSHIP_PEERS = _reg.register(
    _metrics.Gauge(
        "ntpu_peer_membership_peers",
        "Peers in the current live membership view (incl. this node)",
    )
)
MEMBERSHIP_EVENTS = _reg.register(
    _metrics.Counter(
        "ntpu_peer_membership_events_total",
        "Peer membership transitions observed, by kind"
        " (join / leave / down / refresh_error)",
        ("kind",),
    )
)
TIER_EGRESS = _reg.register(
    _metrics.Counter(
        "ntpu_peer_tier_egress_bytes",
        "Peer-read bytes by the topology tier that served them"
        " (rack / zone / flat peer / origin fallthrough)",
        ("tier",),
    )
)


def snapshot_counters() -> dict:
    """Cumulative ``ntpu_peer_*`` values (tools delta these around runs)."""
    return {
        "serve_hit": SERVE_REQUESTS.value("hit"),
        "serve_pull": SERVE_REQUESTS.value("pull"),
        "serve_miss": SERVE_REQUESTS.value("miss"),
        "serve_error": SERVE_REQUESTS.value("error"),
        "served_bytes": SERVED_BYTES.value(),
        "fetch_requests": FETCH_REQUESTS.value(),
        "fetch_bytes": FETCH_BYTES.value(),
        "fallback_miss": FETCH_FALLBACKS.value("miss"),
        "fallback_timeout": FETCH_FALLBACKS.value("timeout"),
        "fallback_error": FETCH_FALLBACKS.value("error"),
        "fallback_corrupt": FETCH_FALLBACKS.value("corrupt"),
        "fallback_budget": FETCH_FALLBACKS.value("budget"),
        "tier_rack_bytes": TIER_EGRESS.value(TIER_RACK),
        "tier_zone_bytes": TIER_EGRESS.value(TIER_ZONE),
        "tier_flat_bytes": TIER_EGRESS.value(TIER_FLAT),
        "tier_origin_bytes": TIER_EGRESS.value(TIER_ORIGIN),
        **{
            f"hedge_{k}": v
            for k, v in fetch_sched.hedge_counters().items()
        },
    }


class PeerError(OSError):
    """A peer request failed (connection, protocol, or server error)."""


class PeerMiss(PeerError):
    """The peer does not cover the requested extent (HTTP 404)."""


# ---------------------------------------------------------------------------
# Config resolution (env > [peer] config > defaults)
# ---------------------------------------------------------------------------


class PeerRuntimeConfig:
    """Resolved ``[peer]`` knobs for this process."""

    __slots__ = (
        "enable", "listen", "peers", "region_bytes", "timeout_s",
        "pull_through", "membership", "membership_refresh_s",
        "locality", "hedge", "hedge_window", "tier_budgets",
    )

    def __init__(self, enable, listen, peers, region_bytes, timeout_s,
                 pull_through, membership="auto", membership_refresh_s=2.0,
                 locality="", hedge=True, hedge_window=0, tier_budgets=None):
        self.enable = enable
        self.listen = listen
        self.peers = peers
        self.region_bytes = region_bytes
        self.timeout_s = timeout_s
        self.pull_through = pull_through
        # "static" = the [peer] list only; "fleet" = the member registry
        # (seeded by the list); "auto" = fleet when a controller address
        # is known, static otherwise.
        self.membership = membership
        self.membership_refresh_s = membership_refresh_s
        # "rack:zone:region" label of THIS node ("" = flat routing).
        self.locality = locality
        self.hedge = hedge
        self.hedge_window = hedge_window
        # tier name -> in-flight byte cap (bytes, resolved from MiB).
        self.tier_budgets = dict(tier_budgets or {})


def _env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name, "")
    if not v:
        return default
    return v not in ("0", "off", "false")


def _global_peer_config():
    try:
        from nydus_snapshotter_tpu_torch.config import config as _cfg

        return _cfg.get_global_config().peer
    except Exception:
        return None


def resolve_peer_config() -> PeerRuntimeConfig:
    """env (``NTPU_PEER*``) > ``[peer]`` global config > defaults. Env
    overrides are also how the section reaches the spawned daemon
    processes, which have no global snapshotter config."""
    pc = _global_peer_config()
    peers_env = os.environ.get("NTPU_PEER_PEERS", "")
    if peers_env:
        peers = [p.strip() for p in peers_env.split(",") if p.strip()]
    else:
        peers = list(getattr(pc, "peers", None) or [])
    region_kib = fetch_sched._env_int(
        "NTPU_PEER_REGION_KIB",
        getattr(pc, "region_kib", 0) or DEFAULT_REGION_KIB,
    )
    timeout_ms = fetch_sched._env_int(
        "NTPU_PEER_TIMEOUT_MS",
        getattr(pc, "timeout_ms", 0) or DEFAULT_TIMEOUT_MS,
    )
    refresh_ms = fetch_sched._env_int(
        "NTPU_PEER_MEMBERSHIP_REFRESH_MS",
        int(float(getattr(pc, "membership_refresh_secs", 0) or 2.0) * 1000),
    )
    hedge_on, hedge_window = fetch_sched.resolve_hedge()
    return PeerRuntimeConfig(
        enable=_env_bool("NTPU_PEER_ENABLE", bool(getattr(pc, "enable", False))),
        listen=os.environ.get("NTPU_PEER_LISTEN", getattr(pc, "listen", "")),
        peers=peers,
        region_bytes=max(1, region_kib) << 10,
        timeout_s=max(1, timeout_ms) / 1000.0,
        pull_through=_env_bool(
            "NTPU_PEER_PULL_THROUGH", bool(getattr(pc, "pull_through", True))
        ),
        membership=os.environ.get(
            "NTPU_PEER_MEMBERSHIP", getattr(pc, "membership", "auto") or "auto"
        ),
        membership_refresh_s=max(0.05, refresh_ms / 1000.0),
        locality=os.environ.get(
            "NTPU_PEER_LOCALITY", getattr(pc, "locality", "") or ""
        ),
        hedge=hedge_on,
        hedge_window=hedge_window,
        tier_budgets=fetch_sched.resolve_tier_budgets(),
    )


def _normalize_addr(addr: str) -> str:
    """``uds:///run/x.sock`` / ``/run/x.sock`` / ``host:port`` — strip the
    scheme so an address compares equal however it was written."""
    if addr.startswith("uds://"):
        return addr[len("uds://"):]
    return addr


def _is_uds(addr: str) -> bool:
    return "/" in addr


# ---------------------------------------------------------------------------
# Local export map: which blobs this node can serve
# ---------------------------------------------------------------------------


class PeerExport:
    """blob_id -> live CachedBlob announce map for the local chunk server.

    The daemon registers every registry-backed CachedBlob it opens and
    unregisters on instance close; the server resolves requests against
    this map only (a blob nobody lazily reads here is a 404, never a
    registry fetch on a stranger's behalf)."""

    def __init__(self):
        self._mu = _an.make_lock("peer.export")
        # Lockset annotation: the blob map is only ever touched under
        # self._mu (NTPU_ANALYZE=1 verifies).
        self._blobs_shared = _an.shared("peer.export.blobs")
        self._blobs: dict[str, object] = {}
        # blob_id -> persisted soci index path this node can replicate
        # (checksummed on the wire by the requester's index load).
        self._soci: dict[str, str] = {}
        # Small hot artifacts beyond soci indexes (trained zdicts, dict
        # journal tails): (kind, key) -> file path. Zone shields adopt
        # remote ones into _adopted and re-serve them zone-locally.
        self._artifacts: dict[tuple[str, str], str] = {}
        self._adopted: dict[tuple[str, str], bytes] = {}

    def register(self, blob_id: str, cached_blob) -> None:
        with self._mu:
            self._blobs_shared.write()
            self._blobs[blob_id] = cached_blob

    def unregister(self, blob_id: str, cached_blob=None) -> None:
        """Drop the announce; with ``cached_blob`` given, only when the
        map still points at that instance (two instances of one blob:
        closing the first must not unannounce the survivor)."""
        with self._mu:
            self._blobs_shared.write()
            if cached_blob is None or self._blobs.get(blob_id) is cached_blob:
                self._blobs.pop(blob_id, None)

    def get(self, blob_id: str):
        with self._mu:
            self._blobs_shared.read()
            return self._blobs.get(blob_id)

    def register_soci(self, blob_id: str, index_path: str) -> None:
        """Announce a persisted soci index: peers missing one replicate
        it instead of re-pulling the whole layer to rebuild."""
        with self._mu:
            self._blobs_shared.write()
            self._soci[blob_id] = index_path

    def unregister_soci(self, blob_id: str) -> None:
        with self._mu:
            self._blobs_shared.write()
            self._soci.pop(blob_id, None)

    def soci_path(self, blob_id: str):
        with self._mu:
            self._blobs_shared.read()
            return self._soci.get(blob_id)

    # -- generic artifact plane (zdicts, journal tails, ...) -----------------

    def register_artifact(self, kind: str, key: str, path: str) -> None:
        """Announce a small persisted artifact (a trained zdict, a dict
        journal tail snapshot) under ``/api/v1/peer/artifact/kind/key``
        — the hierarchy's replication unit beyond chunk extents."""
        with self._mu:
            self._blobs_shared.write()
            self._artifacts[(kind, key)] = path

    def unregister_artifact(self, kind: str, key: str) -> None:
        with self._mu:
            self._blobs_shared.write()
            self._artifacts.pop((kind, key), None)

    def artifact_path(self, kind: str, key: str):
        with self._mu:
            self._blobs_shared.read()
            return self._artifacts.get((kind, key))

    def adopt_artifact(self, kind: str, key: str, payload: bytes) -> None:
        """Shield-adopted remote artifact, re-served from memory.
        Bounded count with oldest-first eviction — these are small hot
        artifacts, not a blob mirror."""
        with self._mu:
            self._blobs_shared.write()
            self._adopted[(kind, key)] = bytes(payload)
            while len(self._adopted) > 64:
                self._adopted.pop(next(iter(self._adopted)))

    def adopted_artifact(self, kind: str, key: str):
        with self._mu:
            self._blobs_shared.read()
            return self._adopted.get((kind, key))

    def stats(self) -> dict:
        with self._mu:
            self._blobs_shared.read()
            blobs = dict(self._blobs)
            soci = dict(self._soci)
            artifacts = sorted(self._artifacts)
            adopted = sorted(self._adopted)
        return {
            "blobs": {
                bid: {"covered_bytes": cb.coverage_bytes()}
                for bid, cb in blobs.items()
            },
            "soci_indexes": sorted(soci),
            "artifacts": [f"{k}/{key}" for k, key in artifacts],
            "adopted": [f"{k}/{key}" for k, key in adopted],
        }


# ---------------------------------------------------------------------------
# Chunk server (HTTP over UDS or TCP)
# ---------------------------------------------------------------------------


_BLOB_ROUTE = "/api/v1/peer/blob/"
_SOCI_ROUTE = "/api/v1/peer/soci/"
_ART_ROUTE = "/api/v1/peer/artifact/"
_STAT_ROUTE = "/api/v1/peer/stat"


def _crc32(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


class _UnixHTTPServer(socketserver.ThreadingUnixStreamServer):
    daemon_threads = True
    # The default backlog of 5 overflows when a whole deploy storm's
    # worth of peers dials the region owner at once: excess connects
    # fail instead of queueing (same fix as the daemon API server).
    request_queue_size = 128

    def finish_request(self, request, client_address):
        self.RequestHandlerClass(request, ("uds", 0), self)


class _TCPHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    request_queue_size = 128


class PeerChunkServer:
    """Serves ranged chunk reads for locally cached extents to peers.

    ``handle()`` is transport-agnostic (the same split as DictService);
    ``run(address)`` serves on a UDS path (contains ``/``) or a TCP
    ``host:port``. Responses carry an ``x-ntpu-peer-crc32`` trailer header
    so a requester detects transit corruption and falls back to the
    registry instead of caching poisoned bytes.
    """

    def __init__(
        self,
        export: PeerExport,
        gate=None,
        pull_through: Optional[bool] = None,
        tenant: str = "peer",
        router: Optional["PeerRouter"] = None,
    ):
        cfg = resolve_peer_config()
        self.export = export
        self.gate = gate if gate is not None else fetch_sched.shared_gate()
        self.pull_through = (
            cfg.pull_through if pull_through is None else pull_through
        )
        self.tenant = tenant
        # Introspection only: the stat route surfaces this node's dynamic
        # membership view + admission actuation state (ntpuctl peers).
        self.router = router
        self._httpd = None
        self._closed = False
        self.address = ""

    # -- request handling ----------------------------------------------------

    def handle(self, method: str, path: str, headers) -> tuple[int, dict, bytes]:
        """(method, path?query, headers) -> (status, extra headers, body)."""
        parsed = urlparse(path)
        if parsed.path == _STAT_ROUTE:
            stat = self.export.stats()
            stat["admission"] = self.gate.lane_state()
            stat["tiers"] = self.gate.tier_state()
            stat["hedge"] = fetch_sched.hedge_counters()
            if self.router is not None:
                stat["topology"] = self.router.topology()
                if self.router.membership is not None:
                    stat["membership"] = self.router.membership.snapshot()
            body = json.dumps(stat).encode()
            return 200, {"Content-Type": "application/json"}, body
        if parsed.path == "/api/v1/traces":
            # A standalone peer server is a fleet member: its process's
            # span ring joins the cluster-merged trace (trace/aggregate.py).
            body = trace.chrome_trace_bytes()
            return 200, {"Content-Type": "application/json"}, body
        if parsed.path in ("/metrics", "/v1/metrics"):
            body = _reg.render().encode()
            return 200, {"Content-Type": "text/plain; version=0.0.4"}, body
        if parsed.path.startswith(_SOCI_ROUTE) and method == "GET":
            # Seekable-OCI index replication: serve the persisted,
            # checksummed artifact so one pod's first-pull build
            # amortizes across the fleet. The requester revalidates the
            # embedded SHA-256 before adopting (a corrupt relay costs a
            # local rebuild, never a poisoned read).
            blob_id = parsed.path[len(_SOCI_ROUTE):]
            return self._serve_artifact("soci", blob_id, headers)
        if parsed.path.startswith(_ART_ROUTE) and method == "GET":
            # Generic small-artifact replication (trained zdicts, dict
            # journal tail snapshots): same serve/adopt discipline as
            # soci indexes, keyed "<kind>/<key>".
            kind, _, key = parsed.path[len(_ART_ROUTE):].partition("/")
            if not kind or not key:
                return 400, {}, b'{"message": "bad artifact key"}'
            return self._serve_artifact(kind, key, headers)
        if not parsed.path.startswith(_BLOB_ROUTE) or method != "GET":
            return 404, {}, b'{"message": "no such endpoint"}'
        blob_id = parsed.path[len(_BLOB_ROUTE):]
        q = parse_qs(parsed.query)
        try:
            offset = int(q.get("offset", ["-1"])[0])
            size = int(q.get("size", ["0"])[0])
            depth = int(headers.get("x-ntpu-peer-depth", "0"))
        except ValueError:
            return 400, {}, b'{"message": "bad range"}'
        if offset < 0 or size <= 0 or size > MAX_SERVE_BYTES:
            return 400, {}, b'{"message": "bad range"}'
        try:
            tid = int(headers.get("x-ntpu-trace-id", "0"), 16)
            pid = int(headers.get("x-ntpu-parent-id", "0"), 16)
        except ValueError:
            tid = pid = 0
        t0 = perf_counter()
        outcome = "error"
        try:
            with trace.with_context(trace.remote_context(tid, pid)):
                with trace.span(
                    "peer.serve", blob=blob_id[:8], offset=offset, bytes=size
                ) as sp:
                    failpoint.hit("peer.serve")
                    cb = self.export.get(blob_id)
                    if cb is None:
                        outcome = "miss"
                        return 404, {}, b'{"message": "unknown blob"}'
                    covered = cb.covered(offset, size)
                    if not covered and not self.pull_through:
                        outcome = "miss"
                        return 404, {}, b'{"message": "extent not cached"}'
                    if not covered and depth > 0 and not (
                        self.router is not None
                        and self.router.is_shield(blob_id, offset)
                    ):
                        # Cover-only serving for forwarded requests —
                        # bounds the relay depth — EXCEPT at the zone
                        # shield, whose whole job is pulling a forwarded
                        # cold extent through origin once per zone.
                        outcome = "miss"
                        return 404, {}, b'{"message": "extent not cached"}'
                    if covered:
                        outcome = "hit"
                        # Serving cached bytes still consumes this node's
                        # uplink: admit it at the lowest lane.
                        self.gate.acquire(
                            size,
                            tenant=self.tenant,
                            lane=PEER_SERVE,
                            aborted=lambda: self._closed,
                        )
                        try:
                            data = cb.read_at(offset, size, lane=PEER_SERVE)
                        finally:
                            self.gate.release(
                                size, tenant=self.tenant, lane=PEER_SERVE
                            )
                    else:
                        # Pull-through: this node is the region owner —
                        # fetch once through the local CachedBlob (its
                        # singleflight table collapses the cluster's
                        # concurrent requests); the flight itself admits
                        # at PEER_SERVE lane.
                        outcome = "pull"
                        data = cb.read_at(offset, size, lane=PEER_SERVE)
                    sp.annotate(outcome=outcome)
                    SERVED_BYTES.inc(len(data))
                    return 200, {
                        "Content-Type": "application/octet-stream",
                        "x-ntpu-peer-crc32": f"{_crc32(data):08x}",
                        "x-ntpu-peer-outcome": outcome,
                    }, data
        except Exception as e:  # noqa: BLE001 - mapped to a wire status
            outcome = "error"
            logger.warning("peer serve %s[%d,+%d) failed: %s",
                           blob_id[:12], offset, size, e)
            return 500, {}, json.dumps({"message": str(e)}).encode()
        finally:
            SERVE_REQUESTS.labels(outcome).inc()
            SERVE_MS.labels(outcome).observe((perf_counter() - t0) * 1000.0)

    # -- artifact serving (soci indexes, zdicts, journal tails) --------------

    def _serve_artifact(
        self, kind: str, key: str, headers
    ) -> tuple[int, dict, bytes]:
        path = (
            self.export.soci_path(key)
            if kind == "soci"
            else self.export.artifact_path(kind, key)
        )
        body = None
        outcome = "hit"
        if path is not None:
            try:
                with open(path, "rb") as f:
                    body = f.read()
            except OSError as e:
                SERVE_REQUESTS.labels("error").inc()
                return 500, {}, json.dumps({"message": str(e)}).encode()
        if body is None:
            body = self.export.adopted_artifact(kind, key)
        if body is None:
            body = self._shield_adopt(
                kind, key, headers.get("x-ntpu-peer-depth", "0")
            )
            outcome = "pull"
        if body is None:
            SERVE_REQUESTS.labels("miss").inc()
            return 404, {}, b'{"message": "no such artifact"}'
        SERVE_REQUESTS.labels(outcome).inc()
        SERVED_BYTES.inc(len(body))
        return 200, {
            "Content-Type": "application/octet-stream",
            "x-ntpu-peer-crc32": f"{_crc32(body):08x}",
        }, body

    def _shield_adopt(self, kind: str, key: str, depth) -> Optional[bytes]:
        """Zone-shield caching proxy: on an artifact miss the shield
        pulls it ONCE from the flat owner (the topology-blind rendezvous
        owner — where the artifact was first built and persisted),
        adopts it, and re-serves it zone-locally — replicate down the
        hierarchy instead of re-deriving per zone. Best-effort: any
        failure is a plain miss (the requester rebuilds locally), and a
        forwarded (depth > 0) request never adopts, which bounds the
        relay exactly like chunk serving."""
        try:
            if int(depth) > 0:
                return None
        except (TypeError, ValueError):
            return None
        if (
            not self.pull_through
            or self.router is None
            or not self.router.is_shield(key, 0)
        ):
            return None
        owner = self.router.flat_owner(key)
        if owner is None:
            return None
        try:
            client = PeerClient(owner, resolve_peer_config().timeout_s)
            if kind == "soci":
                body = client.fetch_soci_index(key, depth=1)
            else:
                body = client.fetch_artifact(kind, key, depth=1)
        except PeerError:
            return None
        self.export.adopt_artifact(kind, key, body)
        return body

    # -- server lifecycle ----------------------------------------------------

    def run(self, address: str) -> None:
        """Serve on ``address``: a UDS path or ``host:port``."""
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_GET(self):
                status, extra, payload = server.handle(
                    self.command, self.path, self.headers
                )
                self.send_response(status)
                if "Content-Type" not in extra:
                    self.send_header("Content-Type", "application/json")
                for k, v in extra.items():
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

        addr = _normalize_addr(address)
        if _is_uds(addr):
            os.makedirs(os.path.dirname(addr) or ".", exist_ok=True)
            try:
                os.remove(addr)
            except FileNotFoundError:
                pass
            self._httpd = _UnixHTTPServer(addr, Handler)
        else:
            host, _, port = addr.rpartition(":")
            self._httpd = _TCPHTTPServer((host or "0.0.0.0", int(port)), Handler)
        self.address = addr
        threading.Thread(
            target=self._httpd.serve_forever, name="ntpu-peer-serve", daemon=True
        ).start()
        logger.info("peer chunk server on %s", addr)

    def stop(self) -> None:
        self._closed = True
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self.address and _is_uds(self.address):
            try:
                os.remove(self.address)
            except OSError:
                pass
        self.address = ""


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------


class _UDSHTTPConnection(http.client.HTTPConnection):
    def __init__(self, sock_path: str, timeout: float):
        super().__init__("localhost", timeout=timeout)
        self._sock_path = sock_path

    def connect(self) -> None:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(self.timeout)
        try:
            s.connect(self._sock_path)
        except BaseException:
            # A dead peer must not leak the half-made socket (close()
            # only knows about self.sock once the connect succeeded).
            s.close()
            raise
        self.sock = s


class PeerClient:
    """One ranged read against one peer. Connections are per-call (peer
    reads fan out across fetch workers; a UDS/TCP dial is cheap next to
    the range it carries) and every phase is bounded by ``timeout_s``."""

    def __init__(self, address: str, timeout_s: float = DEFAULT_TIMEOUT_MS / 1000.0):
        self.address = _normalize_addr(address)
        self.timeout_s = timeout_s

    def _connect(self) -> http.client.HTTPConnection:
        if _is_uds(self.address):
            return _UDSHTTPConnection(self.address, self.timeout_s)
        host, _, port = self.address.rpartition(":")
        return http.client.HTTPConnection(
            host or "localhost", int(port), timeout=self.timeout_s
        )

    def read_range(
        self, blob_id: str, offset: int, size: int, depth: int = 0
    ) -> bytes:
        """Bytes of ``blob_id[offset, offset+size)`` from this peer.
        Raises :class:`PeerMiss` when the peer doesn't cover the extent,
        :class:`PeerError` on any transport/server/integrity failure."""
        headers = {"x-ntpu-peer-depth": str(depth)}
        ctx = trace.capture()
        if ctx is not None and ctx.sampled:
            headers["x-ntpu-trace-id"] = f"{ctx.trace_id:x}"
            headers["x-ntpu-parent-id"] = f"{ctx.span_id:x}"
        conn = self._connect()
        try:
            conn.request(
                "GET",
                f"{_BLOB_ROUTE}{blob_id}?offset={offset}&size={size}",
                headers=headers,
            )
            resp = conn.getresponse()
            payload = resp.read()
            if resp.status == 404:
                raise PeerMiss(f"peer {self.address} misses {blob_id}[{offset})")
            if resp.status != 200:
                raise PeerError(
                    f"peer {self.address} -> {resp.status}: {payload[:120]!r}"
                )
            want_crc = resp.headers.get("x-ntpu-peer-crc32", "")
        except (http.client.HTTPException, OSError) as e:
            if isinstance(e, PeerError):
                raise
            raise PeerError(f"peer {self.address} request failed: {e}") from e
        finally:
            conn.close()
        if len(payload) != size:
            raise PeerError(
                f"peer {self.address} returned {len(payload)} bytes, wanted {size}"
            )
        # Deliberately NOT the server's _crc32 helper: the two sides must
        # compute independently for the check to mean anything (tests
        # inject corruption by patching the server-side helper).
        if want_crc and f"{zlib.crc32(payload) & 0xFFFFFFFF:08x}" != want_crc:
            raise PeerError(f"peer {self.address} payload failed CRC32 check")
        return payload

    def fetch_soci_index(self, blob_id: str, depth: int = 0) -> bytes:
        """The peer's persisted soci index artifact for ``blob_id``
        (serialized; the caller revalidates its embedded checksum).
        Raises :class:`PeerMiss`/:class:`PeerError` like ``read_range``."""
        return self._fetch_checked(f"{_SOCI_ROUTE}{blob_id}", depth)

    def fetch_artifact(self, kind: str, key: str, depth: int = 0) -> bytes:
        """A small named artifact (``zdict``, ``journal``, ...) from the
        peer's export — the zone-shield replication unit beyond chunk
        extents. Raises :class:`PeerMiss`/:class:`PeerError`."""
        return self._fetch_checked(f"{_ART_ROUTE}{kind}/{key}", depth)

    def _fetch_checked(self, route: str, depth: int) -> bytes:
        conn = self._connect()
        try:
            conn.request(
                "GET", route, headers={"x-ntpu-peer-depth": str(depth)}
            )
            resp = conn.getresponse()
            payload = resp.read()
            if resp.status == 404:
                raise PeerMiss(f"peer {self.address} misses {route}")
            if resp.status != 200:
                raise PeerError(
                    f"peer {self.address} -> {resp.status}: {payload[:120]!r}"
                )
            want_crc = resp.headers.get("x-ntpu-peer-crc32", "")
        except (http.client.HTTPException, OSError) as e:
            if isinstance(e, PeerError):
                raise
            raise PeerError(f"peer {self.address} request failed: {e}") from e
        finally:
            conn.close()
        if want_crc and f"{zlib.crc32(payload) & 0xFFFFFFFF:08x}" != want_crc:
            raise PeerError(f"peer {self.address} artifact failed CRC32 check")
        return payload

    def stat(self) -> dict:
        conn = self._connect()
        try:
            conn.request("GET", _STAT_ROUTE)
            resp = conn.getresponse()
            payload = resp.read()
        except (http.client.HTTPException, OSError) as e:
            raise PeerError(f"peer {self.address} stat failed: {e}") from e
        finally:
            conn.close()
        if resp.status != 200:
            raise PeerError(f"peer {self.address} stat -> {resp.status}")
        return json.loads(payload)


# ---------------------------------------------------------------------------
# Dynamic membership: the fleet registry as the peer discovery source
# ---------------------------------------------------------------------------


class PeerMembership:
    """Live peer-address view driven by the fleet member registry.

    The static ``[peer] peers`` list is kept as the SEED: it is the
    membership whenever the registry is unreachable or empty (fresh
    cluster, controller restarting), so a config-only deployment keeps
    working unchanged. With a reachable controller, the registry IS the
    membership — peers joining (self-registering) and leaving
    (deregistering) re-shape rendezvous region ownership without a config
    edit, and members the fleet plane flags down/stale are pushed onto
    the shared :class:`~nydus_snapshotter_tpu_torch.remote.mirror.
    HostHealthRegistry` cooldown so routing walks past them immediately.

    ``fetch`` returns ``[{"address", "up", "stale"}, ...]`` rows; the
    default implementation pulls the controller's
    ``/api/v1/fleet/peers`` route. Refreshes are rate-limited to
    ``refresh_secs`` and serialized (concurrent callers reuse the cached
    view); a failing refresh keeps the last-good membership — discovery
    outages degrade to a stale view, never to an empty cluster.
    """

    def __init__(
        self,
        seed: Optional[list] = None,
        controller: str = "",
        fetch=None,
        refresh_secs: float = 2.0,
        clock=None,
        health_registry=None,
        stale_cooldown: float = PEER_COOLDOWN_SECS,
    ):
        from time import monotonic

        self.seed = sorted(
            {a for a in (_normalize_addr(p) for p in (seed or [])) if a}
        )
        self.controller = controller
        self._fetch = fetch if fetch is not None else self._fetch_controller
        self.refresh_secs = max(0.0, float(refresh_secs))
        self._clock = clock or monotonic
        self._health = (
            health_registry
            if health_registry is not None
            else mirror_mod.global_health_registry()
        )
        self.stale_cooldown = float(stale_cooldown)
        self._mu = _an.make_lock("peer.membership")
        # Lockset annotation: the live view + event log only mutate under
        # self._mu (the refresh fetch itself runs outside it).
        self._view_shared = _an.shared("peer.membership.view")
        self._live: list[str] = list(self.seed)
        self._epoch = 0
        self._events: list[dict] = []
        self._last_refresh = float("-inf")
        self._last_error = ""
        self._refreshing = False
        # address -> member name from the last registry listing, and the
        # rate limiter for upward health reports (report_down).
        self._names: dict[str, str] = {}
        self._reported: dict[str, float] = {}
        # address -> "rack:zone:region" locality labels advertised on
        # the member records — the topology source for tiered routing.
        self._localities: dict[str, str] = {}

    def _fetch_controller(self) -> list[dict]:
        if not self.controller:
            return []
        from nydus_snapshotter_tpu_torch.utils import udshttp

        rows = udshttp.get_json(
            self.controller, "/api/v1/fleet/peers", timeout=2.0
        )
        return rows if isinstance(rows, list) else []

    def _maybe_refresh(self) -> None:
        now = self._clock()
        with self._mu:
            self._view_shared.read()
            if now - self._last_refresh < self.refresh_secs or self._refreshing:
                return
            self._refreshing = True
        rows: Optional[list] = None
        err = ""
        try:
            failpoint.hit("peer.member")
            rows = self._fetch()
        except Exception as e:  # noqa: BLE001 — keep the last-good view
            err = str(e)
            MEMBERSHIP_EVENTS.labels("refresh_error").inc()
        down: list[str] = []
        live: Optional[list[str]] = None
        if rows is not None:
            addrs = set()
            names: dict[str, str] = {}
            locs: dict[str, str] = {}
            for r in rows:
                addr = _normalize_addr(str(r.get("address", "")))
                if not addr:
                    continue
                if r.get("name"):
                    names[addr] = str(r["name"])
                if r.get("locality"):
                    locs[addr] = str(r["locality"])
                if r.get("up", True) and not r.get("stale", False):
                    addrs.add(addr)
                else:
                    # Crashed-but-registered: keep it OUT of the live set
                    # (its regions re-own immediately) and cool it down in
                    # the shared health table so an in-flight route walks
                    # past it instead of timing out.
                    down.append(addr)
            # Registry empty (or only down members) => the seed list is
            # the fallback floor, exactly the pre-dynamic behavior.
            live = sorted(addrs) if addrs else list(self.seed)
        for addr in down:
            self._health.health_for(
                addr,
                failure_limit=PEER_FAILURE_LIMIT,
                cooldown=PEER_COOLDOWN_SECS,
            ).mark_down(self.stale_cooldown)
            MEMBERSHIP_EVENTS.labels("down").inc()
        with self._mu:
            self._view_shared.write()
            self._refreshing = False
            self._last_refresh = now
            self._last_error = err
            if rows is not None:
                self._names.update(names)
                self._localities.update(locs)
            if live is not None and live != self._live:
                prev = set(self._live)
                cur = set(live)
                for addr in sorted(cur - prev):
                    self._events.append(
                        {"at": now, "kind": "join", "address": addr}
                    )
                    MEMBERSHIP_EVENTS.labels("join").inc()
                for addr in sorted(prev - cur):
                    self._events.append(
                        {"at": now, "kind": "leave", "address": addr}
                    )
                    MEMBERSHIP_EVENTS.labels("leave").inc()
                del self._events[:-64]
                self._live = live
                self._epoch += 1
                MEMBERSHIP_EPOCH.set(self._epoch)
            MEMBERSHIP_PEERS.set(len(self._live))

    def addresses(self) -> list[str]:
        """The current live peer set (refreshing if the view is stale)."""
        self._maybe_refresh()
        with self._mu:
            self._view_shared.read()
            return list(self._live)

    def localities(self) -> dict[str, str]:
        """address -> advertised ``rack:zone:region`` label, from the
        last registry listing (no refresh of its own: callers pair this
        with :meth:`addresses`, which refreshes)."""
        with self._mu:
            self._view_shared.read()
            return dict(self._localities)

    def report_down(self, address: str, source: str = "peer-router") -> bool:
        """Upward health signal: a peer at ``address`` stopped answering
        (its health cooldown tripped). Resolves the member name from the
        last registry listing and posts it to the controller's
        ``/api/v1/fleet/placement/report`` — the dict-HA placement plane
        promotes around a reported-down member without waiting out
        scrape staleness. Rate-limited per address; best-effort (the
        report rides a background thread, a down controller drops it)."""
        addr = _normalize_addr(address)
        now = self._clock()
        with self._mu:
            self._view_shared.write()
            name = self._names.get(addr, "")
            if not self.controller or not name:
                return False
            last = self._reported.get(addr, float("-inf"))
            if now - last < self.stale_cooldown:
                return False
            self._reported[addr] = now
        controller = self.controller

        def push():
            from nydus_snapshotter_tpu_torch.utils import udshttp

            try:
                udshttp.post_json(
                    controller,
                    "/api/v1/fleet/placement/report",
                    {"name": name, "source": source},
                    timeout=2.0,
                )
                MEMBERSHIP_EVENTS.labels("report_down").inc()
            except Exception:  # noqa: BLE001 — best-effort signal
                pass

        threading.Thread(
            target=push, name="ntpu-peer-report-down", daemon=True
        ).start()
        return True

    @property
    def epoch(self) -> int:
        with self._mu:
            self._view_shared.read()
            return self._epoch

    def snapshot(self) -> dict:
        with self._mu:
            self._view_shared.read()
            return {
                "epoch": self._epoch,
                "peers": list(self._live),
                "seed": list(self.seed),
                "events": [dict(e) for e in self._events[-16:]],
                "localities": dict(self._localities),
                "last_error": self._last_error,
                "controller": self.controller,
            }


# ---------------------------------------------------------------------------
# Router: which peer owns which region
# ---------------------------------------------------------------------------


class PeerRouter:
    """Rendezvous region ownership over a (possibly dynamic) peer set.

    Every node, given the same peer set, independently computes the same
    owner for a ``(blob, region)`` — the lookup map that needs no gossip.
    The set comes from the static ``[peer]`` list, or — with a
    :class:`PeerMembership` attached — from the live fleet registry, so
    autoscaling re-shapes ownership with minimal churn: rendezvous
    hashing moves only the ~K/n regions the joining/leaving peer wins or
    owned (property-tested in tests/test_peer_membership.py). Ownership
    walks the rendezvous ranking past unhealthy peers (cooldown via the
    process-wide HostHealthRegistry), and returns None when this node
    itself ranks first (fetch from origin: we ARE the serve point for
    this region).

    With a ``locality`` label (``rack:zone:region``) the flat ring
    becomes a two-level hierarchy (:meth:`routes`): the rack-local
    rendezvous owner is the cheap first hop, the zone's shield owner the
    second, origin the last — and role-based cycle avoidance bounds
    relays (the shield itself goes straight to origin; a rack owner
    routes only upward to the shield). Members without a locality, or
    in a foreign region, never own our tiers; a node with no locality
    of its own keeps the flat single-ring behavior unchanged.
    """

    def __init__(
        self,
        peers: list[str],
        self_address: str = "",
        region_bytes: int = DEFAULT_REGION_KIB << 10,
        health_registry=None,
        membership: Optional[PeerMembership] = None,
        locality: str = "",
        localities: Optional[dict[str, str]] = None,
    ):
        self.self_address = _normalize_addr(self_address)
        self.peers = [
            a for a in (_normalize_addr(p) for p in peers) if a
        ]
        self.region_bytes = max(1, int(region_bytes))
        self.membership = membership
        self.health = (
            health_registry
            if health_registry is not None
            else mirror_mod.global_health_registry()
        )
        self.locality = str(locality or "")
        self._loc = parse_locality(self.locality)
        # Static address -> locality map (tests, storm tooling); the
        # membership's advertised labels overlay it when attached.
        self.localities = {
            _normalize_addr(a): str(l)
            for a, l in (localities or {}).items()
        }

    @staticmethod
    def _score(addr: str, blob_id: str, region: int) -> int:
        h = hashlib.blake2b(
            f"{addr}|{blob_id}|{region}".encode(), digest_size=8
        )
        return int.from_bytes(h.digest(), "little")

    def current_peers(self) -> list[str]:
        """The peer set ownership hashes over right now: the live
        membership view when one is attached, else the static list."""
        if self.membership is not None:
            return self.membership.addresses()
        return list(self.peers)

    def ranked(self, blob_id: str, offset: int) -> list[str]:
        region = offset // self.region_bytes
        members = set(self.current_peers())
        if self.self_address:
            members.add(self.self_address)
        return sorted(
            members,
            key=lambda a: self._score(a, blob_id, region),
            reverse=True,
        )

    def _available(self, addr: str) -> bool:
        return self.health.health_for(
            addr,
            failure_limit=PEER_FAILURE_LIMIT,
            cooldown=PEER_COOLDOWN_SECS,
        ).available()

    def locality_map(self) -> dict[str, str]:
        """address -> locality label: static map overlaid by the
        membership's advertised labels, plus this node's own."""
        out = dict(self.localities)
        if self.membership is not None:
            out.update(self.membership.localities())
        if self.self_address and self.locality:
            out[self.self_address] = self.locality
        return out

    def _tier_sets(self, members: set, locs: dict) -> tuple[list, list]:
        """(rack members, zone members) sharing this node's locality
        coordinates; foreign/unknown localities own no tier of ours."""
        mine = self._loc
        rack: list[str] = []
        zone: list[str] = []
        for a in members:
            loc = parse_locality(locs.get(a, ""))
            if loc is None or loc[2] != mine[2] or loc[1] != mine[1]:
                continue
            zone.append(a)
            if loc[0] == mine[0]:
                rack.append(a)
        return rack, zone

    def routes(self, blob_id: str, offset: int) -> list[tuple[str, str]]:
        """The tier waterfall for this extent: healthy ``(addr, tier)``
        candidates in cost order — the rack-local owner, then the zone's
        shield owner; ``[]`` = fetch from origin. Without a locality
        this is the flat single-owner route.

        The ranking is cost-aware: tier distance dominates the
        rendezvous score (TIER_COSTS — a rack hop always outranks a zone
        hop), and cooled-down candidates are dropped HERE, so a dead
        rack owner walks to the shield immediately instead of timing out
        first. Role-based cycle avoidance bounds relays: the shield
        itself returns ``[]`` (it IS the zone's serve point against
        origin), and the rack owner routes only upward to the shield."""
        if self._loc is None:
            addr = self._flat_route(blob_id, offset)
            return [(addr, TIER_FLAT)] if addr is not None else []
        region = offset // self.region_bytes
        members = set(self.current_peers())
        if self.self_address:
            members.add(self.self_address)
        rack, zone = self._tier_sets(members, self.locality_map())

        def score(a: str) -> int:
            return self._score(a, blob_id, region)

        shield = max(zone, key=score) if zone else None
        if self.self_address and shield == self.self_address:
            return []  # we ARE the zone shield: pull from origin
        rack_owner = max(rack, key=score) if rack else None
        out: list[tuple[str, str]] = []
        if rack_owner is not None and rack_owner != self.self_address:
            out.append((rack_owner, TIER_RACK))
        if shield is not None and shield != rack_owner:
            out.append((shield, TIER_ZONE))
        out.sort(key=lambda at: (TIER_COSTS.get(at[1], 9.0), -score(at[0])))
        return [(a, t) for a, t in out if self._available(a)]

    def is_shield(self, blob_id: str, offset: int) -> bool:
        """Is THIS node the zone's shield owner for the extent's region?
        Shield-ness widens the server's pull-through rule: a shield may
        fetch a forwarded (depth > 0) cold extent from origin on the
        zone's behalf — the point where a region's unique bytes cross
        the zone boundary exactly once."""
        if self._loc is None or not self.self_address:
            return False
        region = offset // self.region_bytes
        members = set(self.current_peers())
        members.add(self.self_address)
        _, zone = self._tier_sets(members, self.locality_map())
        if not zone:
            return False
        return (
            max(zone, key=lambda a: self._score(a, blob_id, region))
            == self.self_address
        )

    def flat_owner(self, blob_id: str, offset: int = 0) -> Optional[str]:
        """The flat (topology-blind) healthy owner, excluding self —
        where a cluster-wide artifact (soci index, trained zdict) lives
        before zone shields adopt it."""
        for addr in self.ranked(blob_id, offset):
            if addr == self.self_address:
                continue
            if self._available(addr):
                return addr
        return None

    def topology(self, sample_regions: int = 64) -> dict:
        """Introspection for ``ntpuctl peers``: this node's locality,
        per-tier member counts, and its shield-ownership share over a
        deterministic synthetic region sample."""
        locs = self.locality_map()
        members = set(self.current_peers())
        if self.self_address:
            members.add(self.self_address)
        mine = self._loc
        counts = {"rack": 0, "zone": 0, "region": 0, "remote": 0, "flat": 0}
        racks: set = set()
        zones: set = set()
        for a in members:
            loc = parse_locality(locs.get(a, ""))
            if loc is None:
                counts["flat"] += 1
                continue
            racks.add((loc[2], loc[1], loc[0]))
            zones.add((loc[2], loc[1]))
            if mine is None or loc[2] != mine[2]:
                counts["remote"] += 1
            elif loc[1] != mine[1]:
                counts["region"] += 1
            elif loc[0] != mine[0]:
                counts["zone"] += 1
            else:
                counts["rack"] += 1
        shielded = sum(
            1
            for r in range(max(0, int(sample_regions)))
            if self.is_shield("_topology", r * self.region_bytes)
        )
        return {
            "locality": self.locality,
            "members": len(members),
            "tiers": counts,
            "racks": len(racks),
            "zones": len(zones),
            "shield_share": (
                round(shielded / sample_regions, 3) if sample_regions else 0.0
            ),
        }

    def route(self, blob_id: str, offset: int) -> Optional[str]:
        """The healthy peer to ask FIRST for this extent, or None for
        the registry — the head of the tier waterfall when a locality is
        configured, the flat rendezvous owner otherwise."""
        if self._loc is not None:
            tiers = self.routes(blob_id, offset)
            return tiers[0][0] if tiers else None
        return self._flat_route(blob_id, offset)

    def _flat_route(self, blob_id: str, offset: int) -> Optional[str]:
        for addr in self.ranked(blob_id, offset):
            if addr == self.self_address:
                return None
            if self._available(addr):
                return addr
        return None

    def record(self, addr: str, ok: bool) -> None:
        h = self.health.health_for(
            addr, failure_limit=PEER_FAILURE_LIMIT, cooldown=PEER_COOLDOWN_SECS
        )
        if ok:
            h.record_success()
        else:
            h.record_failure()
            if self.membership is not None and not h.available():
                # Cooldown tripped: this node just WATCHED the member
                # fail repeatedly — tell the controller so the dict-HA
                # plane can promote around it before scrape staleness.
                self.membership.report_down(addr)


# ---------------------------------------------------------------------------
# The waterfall: registry -> peer -> local cache
# ---------------------------------------------------------------------------


class PeerAwareFetcher:
    """Wraps a blob's origin ``fetch_range`` with the peer tier.

    Drop-in for the callable CachedBlob takes: the fetch scheduler's
    flights call ``read_range`` concurrently, each flight walking the
    extent's tier waterfall (rack owner → zone shield → origin; flat
    single owner without topology) and falling back a tier on miss /
    timeout / error / corrupt payload / full tier budget — so a dead,
    slow or melting tier never fails a read (chaos-pinned via the
    ``peer.fetch`` and ``peer.tier`` sites).

    With a :class:`~nydus_snapshotter_tpu_torch.daemon.fetch_sched.Hedger`
    attached, a flight past its tier's rolling p99 races a hedged
    second request at the NEXT tier; the hedge admits and releases its
    own gate charge (loser cancellation, never a double charge) and
    only the winner's bytes are returned — a hedge can never
    double-fetch into the cache. With an
    :class:`~nydus_snapshotter_tpu_torch.daemon.fetch_sched.AdmissionGate`
    attached, per-tier in-flight byte budgets bound how much demand a
    melting tier can absorb before the waterfall walks on.
    """

    def __init__(
        self,
        blob_id: str,
        origin_fetch: Callable[[int, int], bytes],
        router: PeerRouter,
        timeout_s: float = 0.0,
        hedger=None,
        gate=None,
        tenant: str = fetch_sched.DEFAULT_TENANT,
    ):
        self.blob_id = blob_id
        self.origin_fetch = origin_fetch
        self.router = router
        self.timeout_s = timeout_s or resolve_peer_config().timeout_s
        self.hedger = hedger
        self.gate = gate
        self.tenant = tenant

    def _peer_read(self, addr: str, tier: str, offset: int, size: int):
        depth = 1 if tier == TIER_ZONE else 0

        def fetch() -> bytes:
            return PeerClient(addr, self.timeout_s).read_range(
                self.blob_id, offset, size, depth=depth
            )

        return fetch

    def _hedge_target(self, rest, offset: int, size: int):
        """(tier, fn) for the hedged second request: the next tier of
        the waterfall, else origin."""
        for addr, tier in rest:
            return tier, self._peer_read(addr, tier, offset, size)
        return TIER_ORIGIN, lambda: self.origin_fetch(offset, size)

    def _record_hedge_loss(self, offset: int):
        """on_loser callback for the hedger: a cancelled-by-accounting
        loser's bytes enter the provenance ledger as pure waste (they
        crossed the network but were never delivered to any cache)."""
        from nydus_snapshotter_tpu_torch.provenance import ledger as provenance

        def on_loser(loser_tier: str, nbytes: int) -> None:
            provenance.record_hedge_loss(
                self.blob_id, offset, nbytes, tier=loser_tier
            )

        return on_loser

    def read_range(self, offset: int, size: int) -> bytes:
        tiers = self.router.routes(self.blob_id, offset)
        for i, (addr, tier) in enumerate(tiers):
            data = self._attempt(addr, tier, tiers[i + 1:], offset, size)
            if data is not None:
                return data
        TIER_EGRESS.labels(TIER_ORIGIN).inc(size)
        return self.origin_fetch(offset, size)

    def _attempt(
        self, addr: str, tier: str, rest, offset: int, size: int
    ) -> Optional[bytes]:
        """One tier of the waterfall; None = walk to the next tier."""
        if self.gate is not None and not self.gate.tier_acquire(tier, size):
            # Tier budget full (melting zone): walk on immediately —
            # rack-local service never queues behind a saturated tier.
            FETCH_FALLBACKS.labels("budget").inc()
            return None
        try:
            FETCH_REQUESTS.inc()
            with trace.span(
                "peer.fetch",
                blob=self.blob_id[:8],
                peer=addr,
                tier=tier,
                offset=offset,
                bytes=size,
            ) as sp:
                try:
                    failpoint.hit("peer.tier")
                    failpoint.hit("peer.fetch")
                    primary = self._peer_read(addr, tier, offset, size)
                    if self.hedger is not None:
                        hedge_tier, hedge_fn = self._hedge_target(
                            rest, offset, size
                        )
                        data, winner = self.hedger.fetch(
                            size,
                            tier,
                            primary,
                            hedge_tier,
                            hedge_fn,
                            tenant=self.tenant,
                            on_loser=self._record_hedge_loss(offset),
                        )
                    else:
                        data, winner = primary(), tier
                    self.router.record(addr, ok=True)
                    if winner != TIER_ORIGIN:
                        FETCH_BYTES.inc(size)
                    TIER_EGRESS.labels(winner).inc(size)
                    # Provenance: the delivery hook on this same worker
                    # thread attributes these bytes to the serving tier.
                    fetch_sched.fetch_note("tier", winner)
                    sp.annotate(outcome="hit", tier=winner)
                    return data
                except Exception as e:  # noqa: BLE001 — any peer failure
                    # degrades to the next tier / registry, never to the
                    # reader
                    reason = self._reason(e)
                    # A miss is an honest answer, not ill health.
                    self.router.record(addr, ok=isinstance(e, PeerMiss))
                    FETCH_FALLBACKS.labels(reason).inc()
                    sp.annotate(outcome=f"fallback:{reason}")
                    return None
        finally:
            if self.gate is not None:
                self.gate.tier_release(tier, size)

    @staticmethod
    def _reason(e: Exception) -> str:
        if isinstance(e, PeerMiss):
            return "miss"
        msg = str(e).lower()
        if "timed out" in msg or "timeout" in msg:
            return "timeout"
        if "crc32" in msg:
            return "corrupt"
        return "error"


# ---------------------------------------------------------------------------
# Process wiring (cmd/snapshotter.py + daemon/server.py)
# ---------------------------------------------------------------------------

_default_lock = threading.Lock()
_default_export: Optional[PeerExport] = None
_default_router: Optional[PeerRouter] = None
_default_server: Optional[PeerChunkServer] = None
_default_resolved = False


def default_export() -> PeerExport:
    """The process-wide announce map local CachedBlobs register with."""
    global _default_export
    with _default_lock:
        if _default_export is None:
            _default_export = PeerExport()
        return _default_export


def _fleet_controller() -> str:
    """The controller UDS this process would register itself with —
    the same resolution fleet.register_self uses."""
    try:
        from nydus_snapshotter_tpu_torch import fleet

        return fleet.resolve_fleet_config().controller
    except Exception:
        return os.environ.get("NTPU_FLEET_CONTROLLER", "")


def build_membership(cfg: PeerRuntimeConfig) -> Optional[PeerMembership]:
    """The dynamic membership view for this config, or None when
    ``[peer] membership`` resolves static (no controller under "auto",
    or "static" pinned)."""
    if cfg.membership == "static":
        return None
    controller = _fleet_controller()
    if not controller and cfg.membership != "fleet":
        return None
    return PeerMembership(
        seed=cfg.peers,
        controller=controller,
        refresh_secs=cfg.membership_refresh_s,
    )


def default_router() -> Optional[PeerRouter]:
    """The configured peer router, or None when the peer tier is off.
    Resolved once per process from env/``[peer]`` config. With dynamic
    membership configured, the router needs no static peer list — the
    fleet registry is the discovery source."""
    global _default_router, _default_resolved
    with _default_lock:
        if not _default_resolved:
            _default_resolved = True
            cfg = resolve_peer_config()
            if cfg.enable:
                membership = build_membership(cfg)
                if cfg.peers or membership is not None:
                    _default_router = PeerRouter(
                        cfg.peers,
                        self_address=cfg.listen,
                        region_bytes=cfg.region_bytes,
                        membership=membership,
                        locality=cfg.locality,
                    )
        return _default_router


def start_from_config() -> Optional[PeerChunkServer]:
    """Start the chunk server when ``[peer]`` enables one (idempotent);
    returns the running server (caller stops it on shutdown)."""
    global _default_server
    cfg = resolve_peer_config()
    if not (cfg.enable and cfg.listen):
        return None
    with _default_lock:
        if _default_server is not None:
            return _default_server
    server = PeerChunkServer(
        default_export(), pull_through=cfg.pull_through, router=default_router()
    )
    server.run(cfg.listen)
    with _default_lock:
        _default_server = server
    # Fleet plane: a standalone peer-server process self-registers with
    # the controller so its metrics/traces federate. No-op when this
    # process already registered under another role (daemon/snapshotter):
    # one process is ONE member — one ring, one registry. Either way the
    # serve address is annotated on the member record, which is what the
    # controller's /api/v1/fleet/peers route (dynamic peer discovery)
    # lists for the cluster.
    from nydus_snapshotter_tpu_torch import fleet

    extra = {"peer_listen": server.address}
    if cfg.locality:
        # The locality label rides the member record: the fleet peers
        # listing re-advertises it, which is how every router learns the
        # cluster's topology without a topology service.
        extra["locality"] = cfg.locality
    fleet.register_self("peer", server.address, extra=extra)
    fleet.annotate_self("peer_listen", server.address)
    if cfg.locality:
        fleet.annotate_self("locality", cfg.locality)
    return server


def stop_default() -> None:
    global _default_server, _default_router, _default_resolved
    with _default_lock:
        server = _default_server
        _default_server = None
        _default_router = None
        _default_resolved = False
    if server is not None:
        server.stop()
