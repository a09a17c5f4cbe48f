"""Byte-provenance ledger: why is this byte here, and did anyone read it?

The data plane has five ways to move a byte — a demand read, the
sequential readahead window, prefetch-list replay, a peer pull-through
on a stranger's behalf, a hedged second request — plus the seekable-
index build that pulls a whole compressed layer through the cache. Each
of those is individually metered, but none of the existing counters can
answer the attribution question: *which cause fetched this extent, and
was it ever read?*

This module is that attribution layer. Every extent delivered into a
:class:`~nydus_snapshotter_tpu_torch.daemon.blobcache.CachedBlob` is recorded
here with a **cause** (one of :data:`CAUSES`), the topology **tier**
that served it, and the blob's tenant/format; the *actually read*
extent set is recorded separately (first-touch order — that order IS
the heat signal provenance/heat.py compiles). The ledger is striped:
blob ids hash onto :data:`_N_STRIPES` independent locks so concurrent
pods never serialize on one global mutex, and every stripe lock nests
strictly inside the caller's blob lock (the ledger never calls back
into the data plane).

Conservation is the load-bearing invariant: for every blob,

    sum(attributed bytes per cause) + untagged == bytes delivered

where ``untagged`` counts bytes whose provenance *record* failed (the
``prov.record`` chaos site) — attribution degrades, reads never do.
Hedge-loser bytes are accounted on top as pure waste: they were fetched
over the network but never delivered into any cache.

``snapshot()`` overlays each cause's extents with the read set to yield
wasted-bytes and accuracy per cause / tenant / tier, exported as
``ntpu_prov_*`` metrics and the daemon's ``/api/v1/provenance``
endpoint; ``waterfall()`` is the per-deploy cold-start view — the
time-ordered cause breakdown of one image pull, joined to the trace ids
the flights already carry.
"""

from __future__ import annotations

import os
import threading
import time
import zlib
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional

from nydus_snapshotter_tpu_torch import failpoint, trace
from nydus_snapshotter_tpu_torch.analysis import runtime as _an
from nydus_snapshotter_tpu_torch.daemon.fetch_sched import IntervalSet, _env_int
from nydus_snapshotter_tpu_torch.metrics.registry import Counter, Gauge

# ---------------------------------------------------------------------------
# Causes
# ---------------------------------------------------------------------------

CAUSE_DEMAND = "demand"
CAUSE_READAHEAD = "readahead"
CAUSE_PREFETCH = "prefetch"
CAUSE_PEER_SERVE = "peer_serve"
CAUSE_HEDGE_WINNER = "hedge_winner"
CAUSE_HEDGE_LOSER = "hedge_loser"
CAUSE_INDEX_BUILD = "soci_index_build"

#: Every way a byte enters (or is burned by) the data plane. The first
#: four align with fetch_sched.LANE_NAMES — a flight's QoS lane is its
#: default cause; the last three are overrides resolved at delivery.
CAUSES = (
    CAUSE_DEMAND,
    CAUSE_READAHEAD,
    CAUSE_PREFETCH,
    CAUSE_PEER_SERVE,
    CAUSE_HEDGE_WINNER,
    CAUSE_HEDGE_LOSER,
    CAUSE_INDEX_BUILD,
)

UNTAGGED = "untagged"

# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

PROV_BYTES = Counter(
    "ntpu_prov_bytes_total",
    "Fetched bytes attributed by the provenance ledger, by cause",
    ("cause",),
)
PROV_EVENTS = Counter(
    "ntpu_prov_events_total",
    "Provenance ledger records, by cause",
    ("cause",),
)
PROV_READ_BYTES = Counter(
    "ntpu_prov_read_bytes_total",
    "First-touch bytes actually read from provenance-tracked blobs",
)
PROV_UNTAGGED_BYTES = Counter(
    "ntpu_prov_untagged_bytes_total",
    "Delivered bytes whose provenance record failed (attribution "
    "degraded to untagged; the read itself was unaffected)",
)
PROV_WASTED_BYTES = Gauge(
    "ntpu_prov_wasted_bytes",
    "Attributed-but-never-read bytes by cause (refreshed on snapshot)",
    ("cause",),
)

# ---------------------------------------------------------------------------
# Config: [provenance] + NTPU_PROV* env
# ---------------------------------------------------------------------------


@dataclass
class ProvenanceRuntimeConfig:
    enable: bool = True
    heat: bool = True
    heat_budget_mib: int = 64
    events: int = 4096
    replicate: bool = True


def _bool(v: str, default: bool) -> bool:
    if v == "":
        return default
    return v.lower() not in ("0", "false", "no", "off")


def resolve_provenance_config() -> ProvenanceRuntimeConfig:
    """Effective provenance settings: ``NTPU_PROV*`` env wins, then the
    global ``[provenance]`` config section, then defaults."""
    cfg = ProvenanceRuntimeConfig()
    try:
        from nydus_snapshotter_tpu_torch.config.config import get_global_config

        section = getattr(get_global_config(), "provenance", None)
        if section is not None:
            cfg.enable = bool(getattr(section, "enable", cfg.enable))
            cfg.heat = bool(getattr(section, "heat", cfg.heat))
            cfg.heat_budget_mib = int(
                getattr(section, "heat_budget_mib", cfg.heat_budget_mib)
            )
            cfg.events = int(getattr(section, "events", cfg.events))
            cfg.replicate = bool(getattr(section, "replicate", cfg.replicate))
    except Exception:  # noqa: BLE001 — config plane must never break reads
        pass
    cfg.enable = _bool(os.environ.get("NTPU_PROV", ""), cfg.enable)
    cfg.heat = _bool(os.environ.get("NTPU_PROV_HEAT", ""), cfg.heat)
    cfg.heat_budget_mib = _env_int(
        "NTPU_PROV_HEAT_BUDGET_MIB", cfg.heat_budget_mib
    )
    cfg.events = _env_int("NTPU_PROV_EVENTS", cfg.events)
    cfg.replicate = _bool(
        os.environ.get("NTPU_PROV_REPLICATE", ""), cfg.replicate
    )
    return cfg


_cfg_lock = threading.Lock()
_cfg: Optional[ProvenanceRuntimeConfig] = None


def config() -> ProvenanceRuntimeConfig:
    """Resolved-once runtime config (``invalidate_config`` after env or
    global-config changes — tests and the profile arms do)."""
    global _cfg
    with _cfg_lock:
        if _cfg is None:
            _cfg = resolve_provenance_config()
        return _cfg


def invalidate_config() -> None:
    global _cfg
    with _cfg_lock:
        _cfg = None


def enabled() -> bool:
    return config().enable


# ---------------------------------------------------------------------------
# The striped ledger
# ---------------------------------------------------------------------------

_N_STRIPES = 16


class _BlobLedger:
    """Per-blob attribution state. All mutation happens under the owning
    stripe's lock."""

    __slots__ = (
        "blob_id",
        "tenant",
        "fmt",
        "extents",
        "bytes_by_cause",
        "untagged_bytes",
        "lost_bytes",
        "tier_bytes",
        "read",
        "read_bytes",
        "heat",
        "events",
        "t0",
    )

    def __init__(self, blob_id: str, events_cap: int):
        self.blob_id = blob_id
        self.tenant = "default"
        self.fmt = "raw"
        # Delivered extents per cause (hedge losers never deliver, so
        # they have bytes but no extents — pure waste by construction).
        self.extents: dict[str, IntervalSet] = {}
        self.bytes_by_cause: dict[str, int] = {}
        self.untagged_bytes = 0
        self.lost_bytes = 0  # hedge-loser bytes (fetched, never cached)
        self.tier_bytes: dict[str, int] = {}
        self.read = IntervalSet()
        self.read_bytes = 0
        # First-touch read order: that sequence IS the heat signal the
        # HeatCompiler distills into the .heat prefetch artifact.
        self.heat: list[tuple[int, int]] = []
        # Waterfall ring: time-ordered cause events joined to trace ids.
        from collections import deque

        self.events: deque = deque(maxlen=max(16, events_cap))
        self.t0 = time.time()


class Ledger:
    """Lock-striped blob_id -> :class:`_BlobLedger` table."""

    def __init__(self, stripes: int = _N_STRIPES):
        self._locks = [
            _an.make_lock(f"prov.ledger[{i}]") for i in range(stripes)
        ]
        # Lockset annotation: each stripe's blob table only mutates under
        # its own stripe lock (NTPU_ANALYZE=1 verifies).
        self._shared = [
            _an.shared(f"prov.ledger.stripe[{i}]") for i in range(stripes)
        ]
        self._blobs: list[dict[str, _BlobLedger]] = [
            {} for _ in range(stripes)
        ]

    def _idx(self, blob_id: str) -> int:
        return zlib.crc32(blob_id.encode()) % len(self._locks)

    def _get_locked(self, i: int, blob_id: str) -> _BlobLedger:
        bl = self._blobs[i].get(blob_id)
        if bl is None:
            bl = self._blobs[i][blob_id] = _BlobLedger(
                blob_id, config().events
            )
        return bl

    # -- recording (hot path) -------------------------------------------

    def record_fetch(
        self,
        blob_id: str,
        offset: int,
        size: int,
        cause: str,
        tier: str = "",
        delivered: bool = True,
    ) -> None:
        """Attribute one fetched extent. NEVER raises: an armed
        ``prov.record`` chaos failure (or any internal error) degrades
        the extent to untagged — attribution is lossy under fault, the
        read path is not."""
        if size <= 0 or not enabled():
            return
        i = self._idx(blob_id)
        try:
            failpoint.hit("prov.record")
            ctx = trace.capture()
            with self._locks[i]:
                self._shared[i].write()
                bl = self._get_locked(i, blob_id)
                bl.bytes_by_cause[cause] = (
                    bl.bytes_by_cause.get(cause, 0) + size
                )
                if delivered:
                    ivs = bl.extents.get(cause)
                    if ivs is None:
                        ivs = bl.extents[cause] = IntervalSet()
                    ivs.add(offset, offset + size)
                else:
                    bl.lost_bytes += size
                if tier:
                    bl.tier_bytes[tier] = bl.tier_bytes.get(tier, 0) + size
                bl.events.append(
                    (
                        time.time() - bl.t0,
                        cause,
                        offset,
                        size,
                        tier,
                        getattr(ctx, "trace_id", 0) or 0,
                        getattr(ctx, "span_id", 0) or 0,
                    )
                )
            PROV_BYTES.labels(cause).inc(size)
            PROV_EVENTS.labels(cause).inc()
        except Exception:  # noqa: BLE001 — degrade to untagged, never fail
            try:
                if delivered:
                    with self._locks[i]:
                        self._shared[i].write()
                        self._get_locked(i, blob_id).untagged_bytes += size
                PROV_UNTAGGED_BYTES.inc(size)
            except Exception:  # noqa: BLE001 — last-ditch: drop the record
                pass

    def record_read(self, blob_id: str, offset: int, size: int) -> None:
        """Record an actually-served read; only the first touch of each
        byte counts (re-reads are cache hits, not new heat)."""
        if size <= 0 or not enabled():
            return
        i = self._idx(blob_id)
        try:
            with self._locks[i]:
                self._shared[i].write()
                bl = self._get_locked(i, blob_id)
                fresh = bl.read.missing(offset, offset + size)
                if not fresh:
                    return
                new = 0
                for s, e in fresh:
                    bl.heat.append((s, e - s))
                    new += e - s
                bl.read.add(offset, offset + size)
                bl.read_bytes += new
            PROV_READ_BYTES.inc(new)
        except Exception:  # noqa: BLE001 — accounting never fails a read
            pass

    # -- views ----------------------------------------------------------

    def _blob_view_locked(self, bl: _BlobLedger) -> dict:
        causes = {}
        for cause, total in sorted(bl.bytes_by_cause.items()):
            ivs = bl.extents.get(cause)
            read_overlap = 0
            if ivs is not None:
                for s, e in ivs.spans():
                    gap = sum(ge - gs for gs, ge in bl.read.missing(s, e))
                    read_overlap += (e - s) - gap
            wasted = total - read_overlap
            causes[cause] = {
                "bytes": total,
                "read_bytes": read_overlap,
                "wasted_bytes": wasted,
                "accuracy": round(read_overlap / total, 4) if total else 1.0,
            }
        attributed = sum(bl.bytes_by_cause.values())
        delivered = attributed - bl.lost_bytes + bl.untagged_bytes
        return {
            "blob_id": bl.blob_id,
            "tenant": bl.tenant,
            "format": bl.fmt,
            "causes": causes,
            "tiers": dict(sorted(bl.tier_bytes.items())),
            "untagged_bytes": bl.untagged_bytes,
            "hedge_lost_bytes": bl.lost_bytes,
            "delivered_bytes": delivered,
            "fetched_bytes": delivered + bl.lost_bytes,
            "read_bytes": bl.read_bytes,
        }

    def blob_snapshot(self, blob_id: str) -> Optional[dict]:
        i = self._idx(blob_id)
        with self._locks[i]:
            self._shared[i].read()
            bl = self._blobs[i].get(blob_id)
            return self._blob_view_locked(bl) if bl is not None else None

    def snapshot(self) -> dict:
        """The full accounting view: per-blob breakdowns plus cause /
        tenant / tier rollups. Refreshes ``ntpu_prov_wasted_bytes``."""
        blobs = []
        for i, lock in enumerate(self._locks):
            with lock:
                self._shared[i].read()
                for bl in self._blobs[i].values():
                    blobs.append(self._blob_view_locked(bl))
        totals: dict[str, dict] = {}
        tenants: dict[str, dict] = {}
        tiers: dict[str, int] = {}
        for b in blobs:
            t = tenants.setdefault(
                b["tenant"], {"fetched_bytes": 0, "read_bytes": 0,
                              "wasted_bytes": 0}
            )
            t["fetched_bytes"] += b["fetched_bytes"]
            t["read_bytes"] += b["read_bytes"]
            for tier, n in b["tiers"].items():
                tiers[tier] = tiers.get(tier, 0) + n
            for cause, c in b["causes"].items():
                agg = totals.setdefault(
                    cause, {"bytes": 0, "read_bytes": 0, "wasted_bytes": 0}
                )
                agg["bytes"] += c["bytes"]
                agg["read_bytes"] += c["read_bytes"]
                agg["wasted_bytes"] += c["wasted_bytes"]
                t["wasted_bytes"] += c["wasted_bytes"]
        for cause, agg in totals.items():
            agg["accuracy"] = (
                round(agg["read_bytes"] / agg["bytes"], 4)
                if agg["bytes"]
                else 1.0
            )
            PROV_WASTED_BYTES.labels(cause).set(agg["wasted_bytes"])
        return {
            "enabled": enabled(),
            "causes": dict(sorted(totals.items())),
            "tenants": dict(sorted(tenants.items())),
            "tiers": dict(sorted(tiers.items())),
            "untagged_bytes": sum(b["untagged_bytes"] for b in blobs),
            "delivered_bytes": sum(b["delivered_bytes"] for b in blobs),
            "fetched_bytes": sum(b["fetched_bytes"] for b in blobs),
            "read_bytes": sum(b["read_bytes"] for b in blobs),
            "blobs": sorted(blobs, key=lambda b: b["blob_id"]),
        }

    def waterfall(self, blob_id: str = "", limit: int = 0) -> list[dict]:
        """Time-ordered cause events — the cold-start waterfall of one
        deploy, each row joined to the trace that planned the fetch."""
        rows: list[tuple] = []
        for i, lock in enumerate(self._locks):
            with lock:
                self._shared[i].read()
                for bl in self._blobs[i].values():
                    if blob_id and bl.blob_id != blob_id:
                        continue
                    base = bl.t0
                    rows.extend(
                        (base + rel, bl.blob_id, rel, cause, off, size,
                         tier, tid, sid)
                        for rel, cause, off, size, tier, tid, sid
                        in bl.events
                    )
        rows.sort()
        if limit > 0:
            rows = rows[-limit:]
        t_first = rows[0][0] if rows else 0.0
        return [
            {
                "t_ms": round((abs_t - t_first) * 1000.0, 3),
                "blob_id": bid,
                "cause": cause,
                "offset": off,
                "bytes": size,
                "tier": tier,
                "trace_id": format(tid, "x") if tid else "",
                "span_id": format(sid, "x") if sid else "",
            }
            for abs_t, bid, _rel, cause, off, size, tier, tid, sid in rows
        ]

    def heat_extents(self, blob_id: str) -> list[tuple[int, int]]:
        """First-touch read extents in access order, adjacent runs
        coalesced — the replay list the HeatCompiler persists."""
        i = self._idx(blob_id)
        with self._locks[i]:
            self._shared[i].read()
            bl = self._blobs[i].get(blob_id)
            if bl is None:
                return []
            out: list[tuple[int, int]] = []
            for off, size in bl.heat:
                if out and out[-1][0] + out[-1][1] == off:
                    out[-1] = (out[-1][0], out[-1][1] + size)
                else:
                    out.append((off, size))
            return out

    def conservation(self, blob_id: str) -> Optional[dict]:
        """The pinned invariant, byte-exact: attributed(delivered causes)
        + untagged == delivered_bytes; hedge losses accounted on top."""
        view = self.blob_snapshot(blob_id)
        if view is None:
            return None
        attributed = sum(c["bytes"] for c in view["causes"].values())
        return {
            "attributed_bytes": attributed,
            "untagged_bytes": view["untagged_bytes"],
            "hedge_lost_bytes": view["hedge_lost_bytes"],
            "delivered_bytes": view["delivered_bytes"],
            "fetched_bytes": view["fetched_bytes"],
            "exact": attributed + view["untagged_bytes"]
            == view["fetched_bytes"],
        }

    def set_blob_meta(
        self,
        blob_id: str,
        tenant: Optional[str] = None,
        fmt: Optional[str] = None,
    ) -> None:
        if not enabled():
            return
        i = self._idx(blob_id)
        with self._locks[i]:
            self._shared[i].write()
            bl = self._get_locked(i, blob_id)
            if tenant is not None:
                bl.tenant = tenant
            if fmt is not None:
                bl.fmt = fmt

    def forget(self, blob_id: str) -> None:
        i = self._idx(blob_id)
        with self._locks[i]:
            self._shared[i].write()
            self._blobs[i].pop(blob_id, None)

    def reset(self) -> None:
        for i, lock in enumerate(self._locks):
            with lock:
                self._shared[i].write()
                self._blobs[i].clear()


#: The process-wide ledger every CachedBlob records into.
LEDGER = Ledger()


# -- module-level conveniences (the wiring surface) -------------------------


def record_fetch(
    blob_id: str,
    offset: int,
    size: int,
    cause: str,
    tier: str = "",
) -> None:
    LEDGER.record_fetch(blob_id, offset, size, cause, tier=tier)


def record_hedge_loss(
    blob_id: str, offset: int, size: int, tier: str = ""
) -> None:
    """Hedge-loser bytes: fetched over the network, cancelled by
    accounting, never delivered — pure waste, attributed as such."""
    LEDGER.record_fetch(
        blob_id, offset, size, CAUSE_HEDGE_LOSER, tier=tier, delivered=False
    )


def record_read(blob_id: str, offset: int, size: int) -> None:
    LEDGER.record_read(blob_id, offset, size)


def set_blob_meta(blob_id: str, tenant=None, fmt=None) -> None:
    LEDGER.set_blob_meta(blob_id, tenant=tenant, fmt=fmt)


def snapshot() -> dict:
    return LEDGER.snapshot()


def blob_snapshot(blob_id: str) -> Optional[dict]:
    return LEDGER.blob_snapshot(blob_id)


def waterfall(blob_id: str = "", limit: int = 0) -> list[dict]:
    return LEDGER.waterfall(blob_id, limit)


def heat_extents(blob_id: str) -> list[tuple[int, int]]:
    return LEDGER.heat_extents(blob_id)


def conservation(blob_id: str) -> Optional[dict]:
    return LEDGER.conservation(blob_id)


def reset() -> None:
    LEDGER.reset()


@contextmanager
def disabled():
    """Force the plane off for a scope (profile baseline arms)."""
    prev = os.environ.get("NTPU_PROV")
    os.environ["NTPU_PROV"] = "0"
    invalidate_config()
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("NTPU_PROV", None)
        else:
            os.environ["NTPU_PROV"] = prev
        invalidate_config()
