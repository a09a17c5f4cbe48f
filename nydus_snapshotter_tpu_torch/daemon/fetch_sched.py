"""Parallel fetch scheduler for the lazy-read data plane.

The serial lazy-read path (daemon/blobcache.py before this module) issued
one blocking ranged GET per miss, duplicate-fetched the same extent under
concurrent readers, and never looked ahead. This module is the data-plane
counterpart of the convert pipeline (parallel/pipeline.py): it turns every
cache miss into *flights* — in-flight ranged fetches tracked in a per-blob
singleflight table — and executes them on a multi-connection worker pool
under a byte-bounded in-flight budget (the same
:class:`~nydus_snapshotter_tpu_torch.parallel.pipeline.MemoryBudget` discipline
the convert path uses):

- **singleflight**: concurrent misses on overlapping extents wait on the
  existing flight instead of re-fetching; only uncovered gaps spawn new
  flights, so no byte is ever fetched twice by racing readers;
- **coalescing**: adjacent miss gaps closer than ``merge_gap`` merge into
  one larger ranged GET (re-fetching the few covered bytes in between is
  cheaper than another HTTP round trip);
- **readahead**: a sequential reader extends its miss window ahead of the
  read as *background* flights, clamped to the blob size and isolated
  from the demand read — a failed readahead never fails a read;
- **prefetch replay**: :class:`PrefetchReplayer` walks prefetch file
  lists / fanotify traces through the bootstrap chunk index and warms the
  cache through the same scheduler at background priority, cancellable on
  umount.

Flights dispatch in strict lane order (demand > readahead > prefetch
replay > peer serve); a demand read that lands on a queued lower-lane
flight promotes it. On top of the per-blob scheduling sits the process
QoS layer (:class:`AdmissionGate`): every fetch passes a global
concurrency + byte admission gate with strict priority across lanes and
weighted-tenant fairness inside a lane, so a thousand-pod deploy storm
queues gracefully instead of oversubscribing the node (docs/lazy_read.md;
the peer chunk tier in daemon/peer.py serves through the same gate).
Observability lands in ``metrics/registry.default_registry`` as
``ntpu_blobcache_*`` and ``ntpu_admission_*``; ``failpoint.hit`` fires at
the fetch / coalesce / readahead / admission boundaries
(``blobcache.{fetch,coalesce,readahead}``, ``peer.admit``) so the overlap
is chaos-testable (docs/robustness.md).

Tail-latency weapons for the topology-aware peer tier (daemon/peer.py)
also live here, because they are admission-gate disciplines: per-tier
in-flight byte budgets on :class:`AdmissionGate` (``tier_acquire`` is
strictly non-blocking — a melting zone sheds, it never starves
rack-local service) and :class:`Hedger`, the rolling-p99 hedged second
request with loser cancellation that can never double-charge the
``MemoryBudget`` (the ``peer.hedge`` failpoint arms its launch point).
"""

from __future__ import annotations

import os
import threading
from bisect import bisect_left, bisect_right
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass
from time import perf_counter
from typing import Callable, Optional

from nydus_snapshotter_tpu_torch import failpoint
from nydus_snapshotter_tpu_torch import trace
from nydus_snapshotter_tpu_torch.analysis import runtime as _an
from nydus_snapshotter_tpu_torch.metrics import registry as _metrics
from nydus_snapshotter_tpu_torch.parallel.pipeline import MemoryBudget

DEFAULT_FETCH_WORKERS = 4
DEFAULT_MERGE_GAP = 128 << 10
DEFAULT_READAHEAD = 1 << 20
DEFAULT_BUDGET_BYTES = 64 << 20
MAX_FETCH_WORKERS = 32
DEFAULT_ADMIT_CONCURRENT = 64
DEFAULT_DEMAND_RESERVE = 1
DEFAULT_TENANT = "default"
# Tail-latency hedging (daemon/peer.py tier waterfall): a demand peer
# read past its tier's rolling p99 fires ONE hedged second request at
# the next tier. The p99 trigger bounds added egress to ~1% of flights
# by construction; the window is the rolling-percentile sample count.
DEFAULT_HEDGE_WINDOW = 64
HEDGE_MIN_SAMPLES = 20
HEDGE_PERCENTILE = 0.99

# Flight priority lanes, strictly ordered: a demand read outranks the
# sequential readahead window, which outranks prefetch-list replay, which
# outranks serving chunk ranges to cluster peers (daemon/peer.py). Lane
# order is both the scheduler's queue-pop order and the admission gate's
# strict-priority order. BACKGROUND is the pre-QoS name of the readahead
# lane, kept as an alias.
DEMAND = 0
READAHEAD = 1
PREFETCH = 2
PEER_SERVE = 3
BACKGROUND = READAHEAD
N_LANES = 4
LANE_NAMES = ("demand", "readahead", "prefetch", "peer_serve")

_reg = _metrics.default_registry
HIT_BYTES = _reg.register(
    _metrics.Counter(
        "ntpu_blobcache_hit_bytes",
        "Lazy-read bytes served from the local chunk cache",
    )
)
MISS_BYTES = _reg.register(
    _metrics.Counter(
        "ntpu_blobcache_miss_bytes",
        "Lazy-read bytes that required a remote fetch",
    )
)
FETCH_REQUESTS = _reg.register(
    _metrics.Counter(
        "ntpu_blobcache_fetch_requests",
        "Ranged GETs issued by the fetch scheduler",
    )
)
COALESCED_REQUESTS = _reg.register(
    _metrics.Counter(
        "ntpu_blobcache_coalesced_requests",
        "Ranged GETs that merged more than one miss gap",
    )
)
INFLIGHT_BYTES = _reg.register(
    _metrics.Gauge(
        "ntpu_blobcache_inflight_bytes",
        "Bytes currently being fetched by blobcache workers",
    )
)
READAHEAD_BYTES = _reg.register(
    _metrics.Counter(
        "ntpu_blobcache_readahead_bytes",
        "Bytes fetched speculatively ahead of sequential readers",
    )
)
READAHEAD_HIT_BYTES = _reg.register(
    _metrics.Counter(
        "ntpu_blobcache_readahead_hit_bytes",
        "Readahead bytes later served to a real read (accuracy numerator)",
    )
)
PREFETCH_BYTES = _reg.register(
    _metrics.Counter(
        "ntpu_blobcache_prefetch_bytes",
        "Bytes warmed by the background prefetch replayer",
    )
)
SINGLEFLIGHT_WAITS = _reg.register(
    _metrics.Counter(
        "ntpu_blobcache_singleflight_waits",
        "Reads that piggybacked on another reader's in-flight fetch",
    )
)
EVICTED_BYTES = _reg.register(
    _metrics.Counter(
        "ntpu_blobcache_evicted_bytes",
        "Bytes removed by capacity-watermark blob cache eviction",
    )
)
EVICTED_ENTRIES = _reg.register(
    _metrics.Counter(
        "ntpu_blobcache_evicted_entries",
        "Whole blob cache entries removed by capacity-watermark eviction",
    )
)
OP_HIST = _reg.register(
    _metrics.Histogram(
        "ntpu_blobcache_op_duration_milliseconds",
        "Latency of lazy-read data-plane operations (read_at / fetch),"
        " metered by the same window the trace spans record",
        ("op",),
    )
)
ADMITTED = _reg.register(
    _metrics.Counter(
        "ntpu_admission_admitted_total",
        "Fetch/serve operations admitted through the QoS gate, per lane",
        ("lane",),
    )
)
ADMIT_WAIT_MS = _reg.register(
    _metrics.Histogram(
        "ntpu_admission_wait_milliseconds",
        "Time operations queued in the QoS admission gate before a slot,"
        " per lane",
        ("lane",),
    )
)
ADMIT_QUEUED = _reg.register(
    _metrics.Gauge(
        "ntpu_admission_queued",
        "Operations currently waiting in the QoS admission gate, per lane",
        ("lane",),
    )
)
ADMIT_TENANT_BYTES = _reg.register(
    _metrics.Gauge(
        "ntpu_admission_tenant_inflight_bytes",
        "In-flight bytes currently admitted per tenant",
        ("tenant",),
    )
)
ADMIT_SHED = _reg.register(
    _metrics.Counter(
        "ntpu_admission_shed_total",
        "Operations rejected because their lane was shed by SLO actuation",
        ("lane",),
    )
)
ADMIT_LANE_CAP = _reg.register(
    _metrics.Gauge(
        "ntpu_admission_lane_cap",
        "Current per-lane concurrency cap (-1 = unlimited, 0 = lane shed)",
        ("lane",),
    )
)
ADMIT_TIER_INFLIGHT = _reg.register(
    _metrics.Gauge(
        "ntpu_admission_tier_inflight_bytes",
        "In-flight peer-read bytes currently admitted per topology tier",
        ("tier",),
    )
)
ADMIT_TIER_REJECTED = _reg.register(
    _metrics.Counter(
        "ntpu_admission_tier_rejected_total",
        "Peer-read attempts a tier's in-flight byte budget walked past"
        " (the caller fell through to the next tier immediately)",
        ("tier",),
    )
)
HEDGE_TOTAL = _reg.register(
    _metrics.Counter(
        "ntpu_peer_hedge_total",
        "Hedged second requests on slow peer-tier demand reads, by"
        " outcome (fired / won / cancelled / skipped / error)",
        ("outcome",),
    )
)
HEDGE_WASTED_BYTES = _reg.register(
    _metrics.Counter(
        "ntpu_peer_hedge_wasted_bytes_total",
        "Bytes fetched by the losing side of a hedge race and discarded"
        " (cancelled by accounting — real network cost, zero delivery)",
    )
)


# -- provenance plumbing (provenance/ledger.py) -----------------------------
#
# Two thread-local channels carry attribution context across the planner /
# worker boundary without the scheduler knowing about the ledger:
#
# * ``fetch_tag``: a cause override captured at PLAN time (the planning
#   thread) and pinned onto every flight it creates — e.g. the seekable-
#   index build wraps its whole-layer pull in
#   ``with fetch_tag("soci_index_build")``.
# * ``fetch_note``: per-fetch annotations set by the WORKER thread while
#   the fetch runs (the peer fetcher notes the winning tier and whether a
#   hedge fired) and consumed by the delivery hook on the same thread.

_prov_tls = threading.local()


@contextmanager
def fetch_tag(tag: str):
    """Scope a provenance cause override onto flights planned within."""
    prev = getattr(_prov_tls, "tag", None)
    _prov_tls.tag = tag
    try:
        yield
    finally:
        _prov_tls.tag = prev


def current_fetch_tag():
    return getattr(_prov_tls, "tag", None)


def fetch_note(key: str, value) -> None:
    """Annotate the in-progress fetch on THIS worker thread."""
    notes = getattr(_prov_tls, "notes", None)
    if notes is None:
        notes = _prov_tls.notes = {}
    notes[key] = value


def take_fetch_notes() -> dict:
    """Drain this thread's fetch notes (cleared so a note can never leak
    onto the worker's next flight)."""
    notes = getattr(_prov_tls, "notes", None)
    if not notes:
        return {}
    _prov_tls.notes = {}
    return notes


class LaneShedError(OSError):
    """The operation's QoS lane is currently shed by SLO actuation.

    Non-demand callers degrade exactly as they do on any other transient
    failure: a shed readahead/prefetch flight is replanned at demand
    priority only when a real read needs the bytes, a shed peer-serve
    request makes the requester fall back to the registry."""


def snapshot_counters() -> dict:
    """Current cumulative ``ntpu_blobcache_*`` values (bench/tools delta
    these around a run)."""
    ra = READAHEAD_BYTES.value()
    return {
        "hit_bytes": HIT_BYTES.value(),
        "miss_bytes": MISS_BYTES.value(),
        "fetch_requests": FETCH_REQUESTS.value(),
        "coalesced_requests": COALESCED_REQUESTS.value(),
        "readahead_bytes": ra,
        "readahead_hit_bytes": READAHEAD_HIT_BYTES.value(),
        "readahead_accuracy": (
            READAHEAD_HIT_BYTES.value() / ra if ra else None
        ),
        "prefetch_bytes": PREFETCH_BYTES.value(),
        "singleflight_waits": SINGLEFLIGHT_WAITS.value(),
        "evicted_bytes": EVICTED_BYTES.value(),
        "evicted_entries": EVICTED_ENTRIES.value(),
    }


# ---------------------------------------------------------------------------
# Sorted-interval coverage
# ---------------------------------------------------------------------------


class IntervalSet:
    """Disjoint, sorted, half-open ``[start, end)`` intervals with
    bisect-based point/range queries — O(log n + k) where the previous
    blobcache scan was O(n) per read. Touching intervals merge."""

    __slots__ = ("_starts", "_ends")

    def __init__(self):
        self._starts: list[int] = []
        self._ends: list[int] = []

    def __len__(self) -> int:
        return len(self._starts)

    def add(self, start: int, end: int) -> None:
        if end <= start:
            return
        # Intervals whose end >= start and whose start <= end overlap or
        # touch [start, end): one contiguous run in the sorted lists.
        i = bisect_left(self._ends, start)
        j = bisect_right(self._starts, end)
        if i < j:
            start = min(start, self._starts[i])
            end = max(end, self._ends[j - 1])
        self._starts[i:j] = [start]
        self._ends[i:j] = [end]

    def covered(self, start: int, end: int) -> bool:
        if end <= start:
            return True
        i = bisect_right(self._starts, start) - 1
        return i >= 0 and self._ends[i] >= end

    def missing(self, start: int, end: int) -> list[tuple[int, int]]:
        """Sub-ranges of ``[start, end)`` not covered, in order."""
        if end <= start:
            return []
        gaps: list[tuple[int, int]] = []
        i = bisect_right(self._starts, start) - 1
        if i < 0 or self._ends[i] <= start:
            i += 1
        pos = start
        while pos < end and i < len(self._starts):
            s, e = self._starts[i], self._ends[i]
            if s >= end:
                break
            if pos < s:
                gaps.append((pos, s))
            pos = max(pos, e)
            i += 1
        if pos < end:
            gaps.append((pos, end))
        return gaps

    def spans(self) -> list[tuple[int, int]]:
        return list(zip(self._starts, self._ends))

    def total_bytes(self) -> int:
        return sum(e - s for s, e in zip(self._starts, self._ends))

    def clear(self) -> None:
        self._starts.clear()
        self._ends.clear()

    def remove(self, start: int, end: int) -> int:
        """Uncover ``[start, end)``; returns bytes actually removed."""
        if end <= start:
            return 0
        removed = 0
        keep_s: list[int] = []
        keep_e: list[int] = []
        for s, e in zip(self._starts, self._ends):
            if e <= start or s >= end:
                keep_s.append(s)
                keep_e.append(e)
                continue
            removed += min(e, end) - max(s, start)
            if s < start:
                keep_s.append(s)
                keep_e.append(start)
            if e > end:
                keep_s.append(end)
                keep_e.append(e)
        self._starts, self._ends = keep_s, keep_e
        return removed


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------


@dataclass
class FetchConfig:
    fetch_workers: int = DEFAULT_FETCH_WORKERS
    merge_gap: int = DEFAULT_MERGE_GAP
    readahead: int = DEFAULT_READAHEAD
    budget_bytes: int = DEFAULT_BUDGET_BYTES
    prefetch_replay: bool = True


def _env_int(name: str, default: int) -> int:
    try:
        v = int(os.environ.get(name, ""))
        return v if v >= 0 else default
    except ValueError:
        return default


def _global_blobcache_config():
    """The snapshotter's ``[blobcache]`` section when a global config is
    set (config/config.py); None in the daemon process / library use."""
    try:
        from nydus_snapshotter_tpu_torch.config import config as _cfg

        return _cfg.get_global_config().blobcache
    except Exception:
        return None


def resolve_config() -> FetchConfig:
    """Resolve the lazy-read knobs: env > ``[blobcache]`` config > defaults.

    Environment overrides (``NTPU_BLOBCACHE*``) matter doubly here: the
    daemon is a separate process with no global snapshotter config, so the
    spawned environment is how the section reaches the data plane.
    """
    bc = _global_blobcache_config()
    workers = _env_int(
        "NTPU_BLOBCACHE_WORKERS",
        getattr(bc, "fetch_workers", 0) or DEFAULT_FETCH_WORKERS,
    )
    merge_gap = _env_int(
        "NTPU_BLOBCACHE_MERGE_GAP_KIB",
        -1,
    )
    if merge_gap < 0:
        gap_kib = getattr(bc, "merge_gap_kib", None)
        merge_gap = gap_kib if gap_kib is not None else (DEFAULT_MERGE_GAP >> 10)
    readahead = _env_int("NTPU_BLOBCACHE_READAHEAD_KIB", -1)
    if readahead < 0:
        ra_kib = getattr(bc, "readahead_kib", None)
        readahead = ra_kib if ra_kib is not None else (DEFAULT_READAHEAD >> 10)
    budget = _env_int(
        "NTPU_BLOBCACHE_BUDGET_MIB",
        getattr(bc, "inflight_budget_mib", 0) or (DEFAULT_BUDGET_BYTES >> 20),
    )
    prefetch_env = os.environ.get("NTPU_BLOBCACHE_PREFETCH", "")
    if prefetch_env:
        prefetch = prefetch_env not in ("0", "off", "false")
    else:
        prefetch = bool(getattr(bc, "prefetch_replay", True))
    return FetchConfig(
        fetch_workers=min(MAX_FETCH_WORKERS, max(1, workers)),
        merge_gap=merge_gap << 10,
        readahead=readahead << 10,
        budget_bytes=max(1, budget) << 20,
        prefetch_replay=prefetch,
    )


def resolve_watermark_bytes(config_mib: int) -> int:
    """``[blobcache].eviction_watermark_mib`` with its documented
    ``NTPU_BLOBCACHE_WATERMARK_MIB`` env override (env > config, like
    every other blobcache knob; 0 disables capacity eviction)."""
    mib = _env_int("NTPU_BLOBCACHE_WATERMARK_MIB", -1)
    if mib < 0:
        mib = max(0, int(config_mib))
    return mib << 20


_shared_budget: Optional[MemoryBudget] = None
_shared_budget_lock = threading.Lock()


def shared_budget() -> MemoryBudget:
    """Process-wide in-flight byte budget every scheduler without an
    explicit budget shares, so aggregate fetch memory is independent of
    how many blobs are being lazily read at once."""
    global _shared_budget
    with _shared_budget_lock:
        if _shared_budget is None:
            _shared_budget = MemoryBudget(resolve_config().budget_bytes)
        return _shared_budget


# ---------------------------------------------------------------------------
# QoS admission control
# ---------------------------------------------------------------------------


def parse_tenant_weights(spec: str) -> dict[str, float]:
    """``"team-a=2,team-b=1"`` → weight map (bad entries ignored; an
    unlisted tenant weighs 1.0)."""
    out: dict[str, float] = {}
    for part in spec.split(","):
        name, _, w = part.strip().partition("=")
        if not name or not w:
            continue
        try:
            val = float(w)
        except ValueError:
            continue
        if val > 0:
            out[name] = val
    return out


def _global_peer_config():
    try:
        from nydus_snapshotter_tpu_torch.config import config as _cfg

        return _cfg.get_global_config().peer
    except Exception:
        return None


def resolve_admission() -> tuple[int, int, dict[str, float]]:
    """(max_concurrent, demand_reserve, tenant_weights) for the process
    admission gate: env (``NTPU_PEER_MAX_CONCURRENT``,
    ``NTPU_PEER_DEMAND_RESERVE``, ``NTPU_PEER_TENANT_WEIGHTS``) >
    ``[peer]`` config > defaults. Env is also how the section reaches
    spawned daemon processes, like every other blobcache knob."""
    pc = _global_peer_config()
    max_c = _env_int(
        "NTPU_PEER_MAX_CONCURRENT",
        getattr(pc, "max_concurrent", 0) or DEFAULT_ADMIT_CONCURRENT,
    )
    reserve = _env_int(
        "NTPU_PEER_DEMAND_RESERVE",
        getattr(pc, "demand_reserve", DEFAULT_DEMAND_RESERVE),
    )
    weights = dict(getattr(pc, "tenant_weights", None) or {})
    env_w = os.environ.get("NTPU_PEER_TENANT_WEIGHTS", "")
    if env_w:
        weights = parse_tenant_weights(env_w)
    return max(1, max_c), max(0, reserve), weights


def parse_tier_budgets(spec: str) -> dict[str, int]:
    """``"zone=32,origin=64"`` (MiB per tier) → per-tier in-flight byte
    caps (bad entries ignored; an unlisted tier is unbudgeted)."""
    out: dict[str, int] = {}
    for part in spec.split(","):
        name, _, v = part.strip().partition("=")
        if not name or not v:
            continue
        try:
            mib = int(v)
        except ValueError:
            continue
        if mib > 0:
            out[name] = mib << 20
    return out


def resolve_tier_budgets() -> dict[str, int]:
    """Per-tier in-flight byte budgets for the admission gate: env
    (``NTPU_PEER_TIER_BUDGETS``, MiB spec) > ``[peer] tier_budgets`` >
    unbudgeted. A budgeted tier sheds (walks past) rather than queues —
    a melting zone cannot starve rack-local service."""
    env = os.environ.get("NTPU_PEER_TIER_BUDGETS", "")
    if env:
        return parse_tier_budgets(env)
    pc = _global_peer_config()
    out: dict[str, int] = {}
    for k, v in dict(getattr(pc, "tier_budgets", None) or {}).items():
        try:
            mib = int(v)
        except (TypeError, ValueError):
            continue
        if mib > 0:
            out[str(k)] = mib << 20
    return out


def resolve_hedge() -> tuple[bool, int]:
    """(enabled, window) for peer-read tail hedging: env
    (``NTPU_PEER_HEDGE``, ``NTPU_PEER_HEDGE_WINDOW``) > ``[peer]``
    config > defaults."""
    pc = _global_peer_config()
    env = os.environ.get("NTPU_PEER_HEDGE", "")
    if env:
        enabled = env not in ("0", "off", "false")
    else:
        enabled = bool(getattr(pc, "hedge", True))
    window = _env_int(
        "NTPU_PEER_HEDGE_WINDOW",
        getattr(pc, "hedge_window", 0) or DEFAULT_HEDGE_WINDOW,
    )
    return enabled, max(8, window)


class _Ticket:
    __slots__ = ("tenant", "lane", "n", "seq")

    def __init__(self, tenant: str, lane: int, n: int, seq: int):
        self.tenant = tenant
        self.lane = lane
        self.n = n
        self.seq = seq


class AdmissionGate:
    """Cross-pod QoS admission: strict priority lanes + weighted-tenant
    fairness + a global concurrency gate, layered on the shared
    :class:`MemoryBudget`.

    A thousand-pod deploy storm must queue gracefully, not oversubscribe:
    every fetch/serve operation passes ``acquire(n, tenant, lane)`` before
    touching the network, and is admitted only when

    - **strict priority** holds: no waiter in a higher lane (demand >
      readahead > prefetch-replay > peer-serve) is queued;
    - a **concurrency slot** is free — at most ``max_concurrent`` admitted
      operations, of which ``demand_reserve`` slots only the demand lane
      may use (so a demand read never waits behind more than the
      non-reserved in-service operations);
    - the **byte cap** holds: admitted bytes fit the budget's total, with
      the bounded-queue degrade-to-serial discipline (one op larger than
      the whole cap is admitted alone rather than deadlocking);
    - **weighted fairness** holds: among waiting tenants in the same
      lane, the tenant with the smallest in-flight-bytes/weight score is
      admitted first (weighted fair queuing on in-flight byte service),
      unless that tenant cannot currently fit (no slot / bytes) — an
      oversized under-served waiter never wedges the lane.

    The gate does its own accounting under one condition variable and
    settles the byte grant against the shared ``MemoryBudget`` AFTER the
    admission decision, outside the gate lock, so budget co-users (other
    schedulers without a gate) still see one consistent byte pool.
    """

    def __init__(
        self,
        budget: Optional[MemoryBudget] = None,
        max_concurrent: int = 0,
        demand_reserve: int = DEFAULT_DEMAND_RESERVE,
        weights: Optional[dict[str, float]] = None,
        name: str = "gate",
        tier_budgets: Optional[dict[str, int]] = None,
    ):
        self.budget = budget or shared_budget()
        self.cap = self.budget.total
        self.max_concurrent = max(1, max_concurrent or DEFAULT_ADMIT_CONCURRENT)
        self.demand_reserve = min(max(0, demand_reserve), self.max_concurrent - 1)
        self.weights = dict(weights or {})
        self.name = name
        self._cv = _an.make_condition(f"fetch.admission[{name}]")
        # Lockset annotation: every gate field below is only ever touched
        # under the condition's lock (NTPU_ANALYZE=1 verifies).
        self._state_shared = _an.shared(f"fetch.admission.state[{name}]")
        self._waiters: list[_Ticket] = []
        self._seq = 0
        self._in_service = 0
        self._held = 0
        self._tenant_bytes: dict[str, int] = {}
        self._tenant_service: dict[str, int] = {}
        self._admitted = [0] * N_LANES
        # SLO actuation state: per-lane concurrency caps (None = unlimited,
        # 0 = lane shed — new acquires raise LaneShedError immediately).
        # The demand lane is never cappable: actuation protects demand by
        # construction, it must not be able to starve it.
        self._lane_caps: list[Optional[int]] = [None] * N_LANES
        self._lane_in_service = [0] * N_LANES
        self._shed_total = [0] * N_LANES
        # Per-tier in-flight byte budgets (peer-read topology tiers:
        # rack / zone / origin). Orthogonal to lanes: a tier cap never
        # queues — tier_acquire is strictly non-blocking, the caller
        # walks to the next tier on a full budget.
        self._tier_caps: dict[str, int] = {
            str(t): max(0, int(c)) for t, c in (tier_budgets or {}).items()
        }
        self._tier_bytes: dict[str, int] = {}
        self._tier_rejected: dict[str, int] = {}
        # Demand-pressure signal (scale-up actuation, metrics/slo.py
        # SloScaleUp): an EWMA of demand-lane queue waits plus the live
        # queue depth — cheap enough to keep on every acquire, read
        # rarely.
        self._demand_wait_ewma_ms = 0.0
        self._demand_wait_samples = 0
        self._demand_queued_peak = 0

    def weight(self, tenant: str) -> float:
        return max(1e-9, float(self.weights.get(tenant, 1.0)))

    # -- SLO actuation --------------------------------------------------------

    def set_lane_cap(self, lane: int, cap: Optional[int]) -> None:
        """Actuate one lane: ``None`` restores it, ``0`` sheds it (new
        acquires fail fast with :class:`LaneShedError`), ``k > 0`` bounds
        its in-service operations. The DEMAND lane cannot be actuated."""
        lane = int(lane)
        if lane == DEMAND or not 0 < lane < N_LANES:
            raise ValueError(f"lane {lane} is not actuatable")
        with self._cv:
            self._state_shared.write()
            self._lane_caps[lane] = None if cap is None else max(0, int(cap))
            self._cv.notify_all()
        ADMIT_LANE_CAP.labels(LANE_NAMES[lane]).set(
            -1 if cap is None else max(0, int(cap))
        )

    def lane_state(self) -> dict:
        """{lane: {cap, in_service, shed_total}} actuation view."""
        with self._cv:
            self._state_shared.read()
            return {
                LANE_NAMES[i]: {
                    "cap": self._lane_caps[i],
                    "in_service": self._lane_in_service[i],
                    "shed_total": self._shed_total[i],
                }
                for i in range(N_LANES)
            }

    # -- per-tier byte budgets (peer-read topology) ---------------------------

    def set_tier_budget(self, tier: str, cap: Optional[int]) -> None:
        """Bound one tier's in-flight peer-read bytes (``None`` removes
        the cap). Like the MemoryBudget, one read larger than the whole
        cap admits alone rather than wedging the tier."""
        with self._cv:
            self._state_shared.write()
            if cap is None:
                self._tier_caps.pop(tier, None)
            else:
                self._tier_caps[tier] = max(0, int(cap))

    def tier_acquire(self, tier: str, n: int) -> bool:
        """Non-blocking per-tier byte admission. False = the tier's
        budget is full RIGHT NOW: the caller falls through to the next
        tier (or origin) immediately — a melting zone must not starve
        rack-local service by queueing demand reads behind it. A True
        must be paired with :meth:`tier_release`."""
        n = max(0, int(n))
        with self._cv:
            self._state_shared.write()
            cap = self._tier_caps.get(tier)
            used = self._tier_bytes.get(tier, 0)
            if cap is not None and used > 0 and used + n > cap:
                self._tier_rejected[tier] = self._tier_rejected.get(tier, 0) + 1
                ADMIT_TIER_REJECTED.labels(tier).inc()
                return False
            self._tier_bytes[tier] = used + n
            ADMIT_TIER_INFLIGHT.labels(tier).set(used + n)
        return True

    def tier_release(self, tier: str, n: int) -> None:
        n = max(0, int(n))
        with self._cv:
            self._state_shared.write()
            left = max(0, self._tier_bytes.get(tier, 0) - n)
            self._tier_bytes[tier] = left
            ADMIT_TIER_INFLIGHT.labels(tier).set(left)

    def tier_state(self) -> dict:
        """{tier: {cap, inflight_bytes, rejected_total}} budget view."""
        with self._cv:
            self._state_shared.read()
            tiers = (
                set(self._tier_caps)
                | set(self._tier_bytes)
                | set(self._tier_rejected)
            )
            return {
                t: {
                    "cap": self._tier_caps.get(t),
                    "inflight_bytes": self._tier_bytes.get(t, 0),
                    "rejected_total": self._tier_rejected.get(t, 0),
                }
                for t in sorted(tiers)
            }

    # -- admission predicate (caller holds self._cv) -------------------------

    def _fits(self, t: _Ticket) -> bool:
        """Slot + byte feasibility, ignoring priority/fairness."""
        if self._in_service >= self.max_concurrent:
            return False
        if t.lane != DEMAND and self._in_service >= (
            self.max_concurrent - self.demand_reserve
        ):
            return False
        cap = self._lane_caps[t.lane]
        if cap is not None and self._lane_in_service[t.lane] >= cap:
            return False
        return self._held == 0 or self._held + t.n <= self.cap

    def _admissible(self, t: _Ticket) -> bool:
        for w in self._waiters:
            if w.lane < t.lane:
                return False  # strict priority: higher lanes drain first
        if not self._fits(t):
            return False
        score = self._tenant_bytes.get(t.tenant, 0) / self.weight(t.tenant)
        for w in self._waiters:
            if w is t or w.lane != t.lane or w.tenant == t.tenant:
                continue
            ws = self._tenant_bytes.get(w.tenant, 0) / self.weight(w.tenant)
            if (ws < score or (ws == score and w.seq < t.seq)) and self._fits(w):
                return False  # the under-served tenant goes first
        return True

    # -- acquire / release ---------------------------------------------------

    def acquire(
        self,
        n: int,
        tenant: str = DEFAULT_TENANT,
        lane: int = DEMAND,
        aborted: Optional[Callable[[], bool]] = None,
    ) -> float:
        """Block until admitted; returns seconds spent queued. Raises
        OSError when ``aborted()`` flips while waiting."""
        failpoint.hit("peer.admit")
        n = max(0, int(n))
        lane = min(max(0, int(lane)), N_LANES - 1)
        t0 = perf_counter()
        with self._cv:
            self._state_shared.write()
            if self._lane_caps[lane] == 0:
                # Lane shed by SLO actuation: fail fast instead of queueing
                # — background callers degrade, peer requesters fall back.
                self._shed_total[lane] += 1
                ADMIT_SHED.labels(LANE_NAMES[lane]).inc()
                raise LaneShedError(
                    f"admission gate {self.name!r}: lane "
                    f"{LANE_NAMES[lane]} is shed"
                )
            self._seq += 1
            t = _Ticket(tenant, lane, n, self._seq)
            self._waiters.append(t)
            depth = sum(1 for w in self._waiters if w.lane == lane)
            ADMIT_QUEUED.labels(LANE_NAMES[lane]).set(depth)
            if lane == DEMAND and depth > self._demand_queued_peak:
                self._demand_queued_peak = depth
            try:
                while not self._admissible(t):
                    if self._lane_caps[lane] == 0:
                        # Shed while queued: same fail-fast contract.
                        self._shed_total[lane] += 1
                        ADMIT_SHED.labels(LANE_NAMES[lane]).inc()
                        raise LaneShedError(
                            f"admission gate {self.name!r}: lane "
                            f"{LANE_NAMES[lane]} is shed"
                        )
                    if aborted is not None and aborted():
                        raise OSError(
                            f"admission gate {self.name!r} wait aborted"
                        )
                    # Short poll: an aborted() flip has no notifier.
                    self._cv.wait(0.05)
                self._in_service += 1
                self._lane_in_service[lane] += 1
                self._held += n
                self._tenant_bytes[tenant] = self._tenant_bytes.get(tenant, 0) + n
                self._tenant_service[tenant] = (
                    self._tenant_service.get(tenant, 0) + n
                )
                self._admitted[lane] += 1
            finally:
                self._waiters.remove(t)
                ADMIT_QUEUED.labels(LANE_NAMES[lane]).set(
                    sum(1 for w in self._waiters if w.lane == lane)
                )
                # The waiter set changed either way: strict-priority and
                # fairness predicates of other waiters may now pass.
                self._cv.notify_all()
            ADMIT_TENANT_BYTES.labels(tenant).set(self._tenant_bytes[tenant])
            if lane == DEMAND:
                self._demand_wait_samples += 1
                self._demand_wait_ewma_ms += 0.2 * (
                    (perf_counter() - t0) * 1000.0 - self._demand_wait_ewma_ms
                )
        waited = perf_counter() - t0
        ADMITTED.labels(LANE_NAMES[lane]).inc()
        ADMIT_WAIT_MS.labels(LANE_NAMES[lane]).observe(waited * 1000.0)
        # Settle against the shared byte pool OUTSIDE the gate lock; the
        # gate's own cap makes this non-blocking unless budget co-users
        # (ungated schedulers) hold bytes.
        try:
            self.budget.acquire(n, aborted=aborted)
        except BaseException:
            with self._cv:
                self._state_shared.write()
                self._in_service -= 1
                self._lane_in_service[lane] = max(
                    0, self._lane_in_service[lane] - 1
                )
                self._held -= n
                self._tenant_bytes[tenant] = max(
                    0, self._tenant_bytes.get(tenant, 0) - n
                )
                self._cv.notify_all()
            raise
        return waited

    def try_acquire(
        self, n: int, tenant: str = DEFAULT_TENANT, lane: int = DEMAND
    ) -> bool:
        """Non-blocking acquire for hedged second requests: admitted
        only when a slot AND the bytes are free right now with nobody
        queued at this or a higher lane — a hedge is pure opportunism,
        it must never displace or delay first-request traffic. Returns
        False instead of queueing; a True must be paired with the usual
        ``release(n, tenant, lane)``."""
        n = max(0, int(n))
        lane = min(max(0, int(lane)), N_LANES - 1)
        with self._cv:
            self._state_shared.write()
            if self._lane_caps[lane] == 0:
                self._shed_total[lane] += 1
                ADMIT_SHED.labels(LANE_NAMES[lane]).inc()
                return False
            t = _Ticket(tenant, lane, n, self._seq + 1)
            if any(w.lane <= lane for w in self._waiters) or not self._fits(t):
                return False
            self._seq += 1
            self._in_service += 1
            self._lane_in_service[lane] += 1
            self._held += n
            self._tenant_bytes[tenant] = self._tenant_bytes.get(tenant, 0) + n
            self._tenant_service[tenant] = (
                self._tenant_service.get(tenant, 0) + n
            )
            self._admitted[lane] += 1
            ADMIT_TENANT_BYTES.labels(tenant).set(self._tenant_bytes[tenant])
        ADMITTED.labels(LANE_NAMES[lane]).inc()
        # Settle against the shared byte pool outside the gate lock, non-
        # blocking: budget co-users holding bytes fail the hedge instead
        # of queueing it.
        if not self.budget.try_acquire(n, timeout=0.0):
            with self._cv:
                self._state_shared.write()
                self._in_service = max(0, self._in_service - 1)
                self._lane_in_service[lane] = max(
                    0, self._lane_in_service[lane] - 1
                )
                self._held = max(0, self._held - n)
                self._tenant_bytes[tenant] = max(
                    0, self._tenant_bytes.get(tenant, 0) - n
                )
                ADMIT_TENANT_BYTES.labels(tenant).set(
                    self._tenant_bytes[tenant]
                )
                self._cv.notify_all()
            return False
        return True

    def release(
        self, n: int, tenant: str = DEFAULT_TENANT, lane: int = DEMAND
    ) -> None:
        n = max(0, int(n))
        lane = min(max(0, int(lane)), N_LANES - 1)
        self.budget.release(n)
        with self._cv:
            self._state_shared.write()
            self._in_service = max(0, self._in_service - 1)
            self._lane_in_service[lane] = max(0, self._lane_in_service[lane] - 1)
            self._held = max(0, self._held - n)
            self._tenant_bytes[tenant] = max(
                0, self._tenant_bytes.get(tenant, 0) - n
            )
            ADMIT_TENANT_BYTES.labels(tenant).set(self._tenant_bytes[tenant])
            self._cv.notify_all()

    # -- introspection -------------------------------------------------------

    def snapshot(self) -> dict:
        with self._cv:
            self._state_shared.read()
            return {
                "max_concurrent": self.max_concurrent,
                "demand_reserve": self.demand_reserve,
                "in_service": self._in_service,
                "held_bytes": self._held,
                "queued": len(self._waiters),
                "admitted_per_lane": dict(
                    zip(LANE_NAMES, self._admitted)
                ),
                "lane_caps": dict(zip(LANE_NAMES, self._lane_caps)),
                "lane_in_service": dict(
                    zip(LANE_NAMES, self._lane_in_service)
                ),
                "shed_per_lane": dict(zip(LANE_NAMES, self._shed_total)),
                "tenant_inflight_bytes": dict(self._tenant_bytes),
                "tenant_service_bytes": dict(self._tenant_service),
                "tiers": {
                    t: {
                        "cap": self._tier_caps.get(t),
                        "inflight_bytes": self._tier_bytes.get(t, 0),
                        "rejected_total": self._tier_rejected.get(t, 0),
                    }
                    for t in sorted(
                        set(self._tier_caps)
                        | set(self._tier_bytes)
                        | set(self._tier_rejected)
                    )
                },
            }

    def demand_pressure(self) -> dict:
        """The scale-up demand signal: live demand-lane queue depth, the
        deepest queue seen over this gate's lifetime, and the wait EWMA.
        Burn-clean-but-growing pressure here means the node is
        UNDERSIZED, not misbehaving — the SLO scale-up policy
        (metrics/slo.py) spawns capacity instead of shedding load."""
        with self._cv:
            self._state_shared.read()
            return {
                "queued": sum(1 for w in self._waiters if w.lane == DEMAND),
                "queued_peak": self._demand_queued_peak,
                "wait_ms": round(self._demand_wait_ewma_ms, 3),
                "samples": self._demand_wait_samples,
            }

    def service_bytes(self, tenant: str) -> int:
        """Cumulative admitted bytes for ``tenant`` (fairness gauges
        delta this around a saturation window)."""
        with self._cv:
            self._state_shared.read()
            return self._tenant_service.get(tenant, 0)


_shared_gate: Optional[AdmissionGate] = None
_shared_gate_lock = threading.Lock()


def shared_gate() -> AdmissionGate:
    """Process-wide admission gate every scheduler without an explicit
    gate/budget shares — the storm-wide concurrency, priority and
    fairness decisions are per NODE, not per blob."""
    global _shared_gate
    with _shared_gate_lock:
        if _shared_gate is not None:
            return _shared_gate
    # Build outside the lock (shared_budget takes its own module lock —
    # never nest the two); publish first-wins.
    max_c, reserve, weights = resolve_admission()
    gate = AdmissionGate(
        budget=shared_budget(),
        max_concurrent=max_c,
        demand_reserve=reserve,
        weights=weights,
        name="shared",
        tier_budgets=resolve_tier_budgets(),
    )
    with _shared_gate_lock:
        if _shared_gate is None:
            _shared_gate = gate
        return _shared_gate


# ---------------------------------------------------------------------------
# Tail-latency hedging (the peer tier's demand lane)
# ---------------------------------------------------------------------------


class RollingPercentile:
    """Rolling latency percentile over the last ``window`` samples — the
    trace exemplar reservoir's discipline (trace/export.py ExemplarStore):
    a bounded deque, sorted lazily by the reader. Below ``min_samples``
    there is no estimate at all — with no history every flight "exceeds
    p99" and a hedge trigger would be pure noise."""

    __slots__ = ("_samples", "min_samples")

    def __init__(
        self,
        window: int = DEFAULT_HEDGE_WINDOW,
        min_samples: int = HEDGE_MIN_SAMPLES,
    ):
        self._samples: deque = deque(maxlen=max(8, int(window)))
        self.min_samples = max(1, int(min_samples))

    def __len__(self) -> int:
        return len(self._samples)

    def record(self, ms: float) -> None:
        self._samples.append(float(ms))

    def percentile(self, q: float = HEDGE_PERCENTILE) -> Optional[float]:
        snap = sorted(self._samples)
        if len(snap) < self.min_samples:
            return None
        return snap[min(len(snap) - 1, int(q * len(snap)))]


class Hedger:
    """Hedged second requests for slow demand-lane peer reads.

    A flight that exceeds its tier's rolling p99 fires ONE hedge at the
    next tier (or origin); the first good response wins. The loser is
    cancelled by ACCOUNTING, not interruption: the hedge admits its own
    bytes through a non-blocking :meth:`AdmissionGate.try_acquire` (a
    saturated node skips the hedge rather than queueing it behind
    first-request traffic) and the hedge thread releases that charge in
    its own ``finally`` — win or lose — so a hedged flight can never
    double-charge the MemoryBudget (property-tested across 1k flights in
    tests/test_peer_hedge.py). Because the trigger is the rolling p99,
    at most ~1% of flights hedge: added egress is bounded by
    construction, which is the analytic bound the storm profile gates.

    The ``peer.hedge`` failpoint fires at the hedge-launch boundary; an
    armed failure aborts the hedge and the primary proceeds exactly as
    an unhedged flight (docs/robustness.md).
    """

    def __init__(
        self,
        gate: Optional[AdmissionGate] = None,
        enabled: bool = True,
        window: int = DEFAULT_HEDGE_WINDOW,
        percentile: float = HEDGE_PERCENTILE,
        name: str = "hedge",
    ):
        self.gate = gate if gate is not None else shared_gate()
        self.enabled = enabled
        self.percentile = percentile
        self.window = max(8, int(window))
        self._mu = _an.make_lock(f"fetch.hedge[{name}]")
        # Lockset annotation: per-tier latency windows and the outcome
        # counters only mutate under self._mu (NTPU_ANALYZE=1 verifies).
        self._state_shared = _an.shared(f"fetch.hedge.state[{name}]")
        self._lat: dict[str, RollingPercentile] = {}
        self._counts: dict[str, int] = {}

    def record(self, tier: str, ms: float) -> None:
        with self._mu:
            self._state_shared.write()
            rp = self._lat.get(tier)
            if rp is None:
                rp = self._lat[tier] = RollingPercentile(self.window)
            rp.record(ms)

    def threshold_ms(self, tier: str) -> Optional[float]:
        """The tier's rolling p99, or None while the window is cold."""
        with self._mu:
            self._state_shared.read()
            rp = self._lat.get(tier)
            return rp.percentile(self.percentile) if rp is not None else None

    def _count(self, outcome: str) -> None:
        with self._mu:
            self._state_shared.write()
            self._counts[outcome] = self._counts.get(outcome, 0) + 1
        HEDGE_TOTAL.labels(outcome).inc()

    def counters(self) -> dict:
        with self._mu:
            self._state_shared.read()
            return {
                k: self._counts.get(k, 0)
                for k in ("fired", "won", "cancelled", "skipped", "error")
            }

    def fetch(
        self,
        size: int,
        tier: str,
        primary: Callable[[], bytes],
        hedge_tier: Optional[str] = None,
        hedge: Optional[Callable[[], bytes]] = None,
        tenant: str = DEFAULT_TENANT,
        lane: int = DEMAND,
        on_loser: Optional[Callable[[str, int], None]] = None,
    ) -> tuple[bytes, str]:
        """Run ``primary()``; past the tier's rolling p99, race
        ``hedge()`` against it. Returns ``(data, winner_tier)``. When
        both sides fail the PRIMARY error propagates, so the caller's
        tier waterfall degrades exactly as it does unhedged.

        A loser that *successfully* fetched is accounted exactly once —
        ``ntpu_peer_hedge_wasted_bytes_total`` plus the optional
        ``on_loser(loser_tier, nbytes)`` callback (the provenance
        ledger's hedge-loser waste record) — whether its result arrived
        before or after the winner was chosen."""
        threshold = self.threshold_ms(tier) if self.enabled else None
        t0 = perf_counter()
        if threshold is None or hedge is None:
            data = primary()
            self.record(tier, (perf_counter() - t0) * 1000.0)
            return data, tier

        cv = threading.Condition()
        results: dict[str, tuple] = {}
        decided: list[str] = []

        def lost(which: str, nbytes: int) -> None:
            HEDGE_WASTED_BYTES.inc(nbytes)
            if on_loser is not None:
                try:
                    on_loser(
                        (hedge_tier or "origin") if which == "hedge"
                        else tier,
                        nbytes,
                    )
                except Exception:  # noqa: BLE001 — accounting is advisory
                    pass

        def run(which: str, fn, charged: bool) -> None:
            t1 = perf_counter()
            try:
                out = (fn(), (perf_counter() - t1) * 1000.0, None)
            except BaseException as e:  # noqa: BLE001 — surfaced to the waiter
                out = (None, None, e)
            finally:
                if charged:
                    # Loser-cancellation invariant: the hedge's extra
                    # charge is released HERE, by the thread that owns
                    # it, win or lose — never by the winner's path.
                    self.gate.release(size, tenant=tenant, lane=lane)
            with cv:
                results[which] = out
                # Posted after the decision: this side lost the race and
                # its bytes are about to be discarded. (Posted before the
                # decision, the winner's path does this accounting — the
                # cv serializes the two, so exactly one side counts it.)
                late_loss = (
                    bool(decided)
                    and decided[0] != which
                    and out[2] is None
                    and out[0] is not None
                )
                cv.notify_all()
            if late_loss:
                lost(which, len(out[0]))

        threading.Thread(
            target=run,
            args=("primary", primary, False),
            name="ntpu-hedge-primary",
            daemon=True,
        ).start()
        with cv:
            cv.wait_for(
                lambda: "primary" in results, timeout=threshold / 1000.0
            )
            done = dict(results)
        hedged = False
        if "primary" not in done:
            # Past the tier's p99: fire the second request — IF the gate
            # admits its bytes right now (a hedge never queues) and the
            # chaos site lets it.
            try:
                failpoint.hit("peer.hedge")
                hedged = self.gate.try_acquire(size, tenant=tenant, lane=lane)
            except Exception:  # noqa: BLE001 — armed chaos aborts the
                hedged = False  # hedge, never the primary
            if hedged:
                self._count("fired")
                # Provenance: the bytes this flight delivers came out of
                # a hedge race (cause hedge_winner, whichever side wins).
                fetch_note("hedged", True)
                threading.Thread(
                    target=run,
                    args=("hedge", hedge, True),
                    name="ntpu-hedge-second",
                    daemon=True,
                ).start()
            else:
                self._count("skipped")
        want = {"primary", "hedge"} if hedged else {"primary"}
        while True:
            with cv:
                cv.wait_for(
                    lambda: len(results) > len(done)
                    or (want & set(results)) == want
                )
                done = dict(results)
            for which in ("hedge", "primary"):
                if which in done and done[which][2] is None:
                    if which == "hedge":
                        self._count("won")
                    elif hedged:
                        self._count("cancelled")
                    win_tier = tier if which == "primary" else (
                        hedge_tier or "origin"
                    )
                    other = "primary" if which == "hedge" else "hedge"
                    with cv:
                        decided.append(which)
                        o = results.get(other) if hedged else None
                    if o is not None and o[2] is None and o[0] is not None:
                        # The loser had already posted a good result when
                        # the race was decided: its bytes are waste.
                        lost(other, len(o[0]))
                    # Only the DELIVERED latency enters the rolling
                    # window: a cancelled loser's eventual completion
                    # was never observed by the caller, and recording
                    # it would let one persistently slow peer ratchet
                    # the p99 trigger up to its own latency, disarming
                    # the hedge that is routing around it.
                    self.record(win_tier, done[which][1])
                    return done[which][0], win_tier
            if (want & set(done)) == want:
                if hedged and done.get("hedge", (None, None, None))[2] is not None:
                    self._count("error")
                err = done["primary"][2]
                if isinstance(err, Exception):
                    raise err
                raise OSError(str(err))


_shared_hedger: Optional[Hedger] = None
_shared_hedger_lock = threading.Lock()


def shared_hedger() -> Hedger:
    """Process-wide hedger every peer-aware fetcher without an explicit
    one shares: the rolling per-tier latency windows are per NODE —
    every flight's sample sharpens every other flight's trigger."""
    global _shared_hedger
    with _shared_hedger_lock:
        if _shared_hedger is not None:
            return _shared_hedger
    # Build outside the lock (shared_gate takes its own module lock —
    # never nest the two); publish first-wins.
    enabled, window = resolve_hedge()
    hedger = Hedger(
        gate=shared_gate(), enabled=enabled, window=window, name="shared"
    )
    with _shared_hedger_lock:
        if _shared_hedger is None:
            _shared_hedger = hedger
        return _shared_hedger


def hedge_counters() -> dict:
    """Cumulative ``ntpu_peer_hedge_total`` values by outcome (ntpuctl
    and the storm profile delta these around a run)."""
    return {
        k: HEDGE_TOTAL.value(k)
        for k in ("fired", "won", "cancelled", "skipped", "error")
    }


# ---------------------------------------------------------------------------
# Flights + scheduler
# ---------------------------------------------------------------------------


class Flight:
    """One in-flight ranged fetch covering ``[start, end)``."""

    __slots__ = (
        "start", "end", "priority", "coalesced", "done", "error", "ctx",
        "tag",
    )

    def __init__(self, start: int, end: int, priority: int, coalesced: int = 1):
        self.start = start
        self.end = end
        self.priority = priority
        self.coalesced = coalesced  # miss gaps merged into this fetch
        self.done = threading.Event()
        self.error: Optional[BaseException] = None
        # Trace context of the read that PLANNED this flight — a
        # background readahead fetch thereby records which trace spawned
        # it, even though it executes on a worker thread later.
        self.ctx = None
        # Provenance cause override captured at plan time (fetch_tag),
        # carried the same way the trace context is.
        self.tag: Optional[str] = None

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self.done.wait(timeout)


class FetchScheduler:
    """Per-blob singleflight table + coalescing planner + worker pool.

    The scheduler shares its caller's lock (the CachedBlob lock): every
    ``plan_locked`` call and every delivery runs under that one lock, so
    interval state, the flight table and the cache file never disagree.
    ``fetch_range(offset, size)`` runs concurrently on worker threads and
    must be thread-safe; ``deliver(offset, data)`` is called back under
    the lock to persist a completed fetch.
    """

    def __init__(
        self,
        lock: threading.Lock,
        intervals: IntervalSet,
        fetch_range: Callable[[int, int], bytes],
        deliver: Callable[[int, bytes], None],
        config: Optional[FetchConfig] = None,
        budget: Optional[MemoryBudget] = None,
        name: str = "",
        gate: Optional[AdmissionGate] = None,
        tenant: str = DEFAULT_TENANT,
        on_fetched: Optional[Callable[["Flight", int], None]] = None,
    ):
        self.cfg = config or resolve_config()
        # QoS admission: an explicit gate wins; an explicit budget gets a
        # private pass-through gate (pre-QoS byte semantics preserved for
        # callers that isolate their budget); otherwise the process gate.
        if gate is not None:
            self.gate = gate
        elif budget is not None:
            self.gate = AdmissionGate(budget=budget, name=name or "private")
        else:
            self.gate = shared_gate()
        self.budget = self.gate.budget
        self.tenant = tenant
        self.name = name
        self._lock = lock
        self._cv = threading.Condition(lock)
        self._intervals = intervals
        self._fetch_range = fetch_range
        self._deliver = deliver
        # Called under the shared lock right after a delivery, with the
        # flight and its byte count — the provenance attribution hook.
        self._on_fetched = on_fetched
        self._flights: list[Flight] = []  # active (queued or fetching)
        # One FIFO per priority lane, popped in lane order.
        self._queues: tuple[deque[Flight], ...] = tuple(
            deque() for _ in range(N_LANES)
        )
        # Lockset annotation: flight table + queues must only ever be
        # touched under the shared lock (NTPU_ANALYZE=1 verifies).
        self._flights_shared = _an.shared(f"fetch.flights[{name}]")
        self._threads: list[threading.Thread] = []
        self._idle = 0
        self._closed = False

    # -- planning (caller holds the shared lock) ----------------------------

    def overlapping_flights(self, start: int, end: int) -> list[Flight]:
        return [f for f in self._flights if f.start < end and f.end > start]

    def plan_locked(
        self, start: int, end: int, priority: int = DEMAND
    ) -> list[Flight]:
        """Ensure ``[start, end)`` becomes resident: returns every flight
        the caller must wait on (pre-existing overlaps + newly created
        gap fetches). Caller holds the shared lock."""
        if self._closed:
            raise OSError(f"fetch scheduler {self.name!r} is closed")
        self._flights_shared.write()
        waiters = self.overlapping_flights(start, end)
        if waiters and priority == DEMAND:
            SINGLEFLIGHT_WAITS.inc()
            self._promote(waiters)
        # Gaps = uncovered minus already in flight.
        gaps: list[tuple[int, int]] = []
        for s, e in self._intervals.missing(start, end):
            pos = s
            for f in sorted(self.overlapping_flights(s, e), key=lambda f: f.start):
                if f.start > pos:
                    gaps.append((pos, f.start))
                pos = max(pos, f.end)
            if pos < e:
                gaps.append((pos, e))
        new = self._coalesce(gaps, priority)
        ctx = trace.capture() if new else None
        tag = current_fetch_tag() if new else None
        for f in new:
            f.ctx = ctx
            f.tag = tag
            self._flights.append(f)
            self._queues[f.priority].append(f)
        if new:
            self._spawn_workers(len(new))
            self._cv.notify_all()
        return waiters + new

    def _coalesce(self, gaps: list[tuple[int, int]], priority: int) -> list[Flight]:
        flights: list[Flight] = []
        for s, e in gaps:
            if (
                flights
                and s - flights[-1].end <= self.cfg.merge_gap
                and flights[-1].priority == priority
            ):
                failpoint.hit("blobcache.coalesce")
                flights[-1].end = e
                flights[-1].coalesced += 1
            else:
                flights.append(Flight(s, e, priority))
        return flights

    def _promote(self, flights: list[Flight]) -> None:
        """A demand read waits on these: lower-lane flights still queued
        jump to the demand queue so the reader isn't stuck behind other
        warming or peer-serve work."""
        for f in flights:
            if f.priority != DEMAND and f in self._queues[f.priority]:
                self._queues[f.priority].remove(f)
                f.priority = DEMAND
                self._queues[DEMAND].append(f)

    # -- worker pool ---------------------------------------------------------

    def _spawn_workers(self, backlog: int) -> None:
        if self._idle >= backlog:
            return
        want = min(self.cfg.fetch_workers, len(self._threads) + backlog - self._idle)
        while len(self._threads) < want:
            t = threading.Thread(
                target=self._worker,
                name=f"ntpu-fetch-{self.name}-{len(self._threads)}",
                daemon=True,
            )
            self._threads.append(t)
            t.start()

    def _worker(self) -> None:
        while True:
            with self._cv:
                while not self._closed and not any(self._queues):
                    self._idle += 1
                    try:
                        self._cv.wait()
                    finally:
                        self._idle -= 1
                if self._closed and not any(self._queues):
                    return
                self._flights_shared.write()
                flight = next(q for q in self._queues if q).popleft()
            self._run_flight(flight)

    def _run_flight(self, flight: Flight) -> None:
        n = flight.end - flight.start
        acquired = False
        t0 = perf_counter()
        with trace.with_context(flight.ctx), trace.span(
            "blobcache.fetch",
            blob=self.name,
            offset=flight.start,
            bytes=n,
            coalesced=flight.coalesced,
            lane=LANE_NAMES[flight.priority],
            background=flight.priority != DEMAND,
        ) as sp:
            try:
                waited = self.gate.acquire(
                    n,
                    tenant=self.tenant,
                    lane=flight.priority,
                    aborted=lambda: self._closed,
                )
                acquired = True
                if waited > 0.001:
                    sp.annotate(admission_wait_ms=round(waited * 1000.0, 3))
                INFLIGHT_BYTES.set(self.budget.held)
                failpoint.hit("blobcache.fetch")
                take_fetch_notes()  # a prior flight's notes never leak in
                data = self._fetch_range(flight.start, n)
                FETCH_REQUESTS.inc()
                if flight.coalesced > 1:
                    COALESCED_REQUESTS.inc()
                MISS_BYTES.inc(n)
                with self._lock:
                    if not self._closed:
                        self._deliver(flight.start, data)
                        if self._on_fetched is not None:
                            # Attribution hook: same thread as the fetch
                            # (fetch notes are still this thread's), same
                            # lock as the delivery.
                            self._on_fetched(flight, len(data))
            except BaseException as e:  # noqa: BLE001 — surfaced to waiters
                flight.error = e if isinstance(e, Exception) else OSError(str(e))
                sp.annotate(error=repr(flight.error))
            finally:
                if acquired:
                    self.gate.release(
                        n, tenant=self.tenant, lane=flight.priority
                    )
                    INFLIGHT_BYTES.set(self.budget.held)
                with self._cv:
                    self._flights_shared.write()
                    try:
                        self._flights.remove(flight)
                    except ValueError:
                        pass
                    self._cv.notify_all()
                flight.done.set()
        OP_HIST.labels("fetch").observe((perf_counter() - t0) * 1000.0)

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        """Abort queued flights, wake workers, join the pool. Caller must
        NOT hold the shared lock (workers need it to finish delivering)."""
        with self._cv:
            self._closed = True
            self._flights_shared.write()
            aborted = [f for q in self._queues for f in q]
            for q in self._queues:
                q.clear()
            for f in aborted:
                try:
                    self._flights.remove(f)
                except ValueError:
                    pass
                f.error = OSError(f"fetch scheduler {self.name!r} closed")
                f.done.set()
            self._cv.notify_all()
        for t in self._threads:
            t.join()
        self._threads.clear()


# ---------------------------------------------------------------------------
# Background prefetch replay
# ---------------------------------------------------------------------------


class PrefetchReplayer:
    """Replays a prefetch file list through the bootstrap chunk index to
    warm blob caches off the critical path.

    ``warm_chunk(rec)`` is provided by the owner (daemon/server.py): for
    registry-backed blobs it routes the chunk's compressed extent through
    the fetch scheduler at BACKGROUND priority; any other backend falls
    back to a plain read. The replayer owns cancellation: ``cancel()``
    (umount/close) stops the walk between chunks and is also observed by
    in-flight waits, so teardown never blocks on a cold registry.
    """

    def __init__(
        self,
        bootstrap,
        by_path: dict,
        warm_chunk: Callable[[object], int],
        name: str = "",
        on_file: Optional[Callable[[], None]] = None,
    ):
        self.bootstrap = bootstrap
        self.by_path = by_path
        self.warm_chunk = warm_chunk
        self.name = name
        self.on_file = on_file  # e.g. one batched chunk-map flush per file
        self.warmed_bytes = 0
        self.files_replayed = 0
        self._cancel = threading.Event()

    @property
    def cancelled(self) -> bool:
        return self._cancel.is_set()

    def cancel(self) -> None:
        self._cancel.set()

    @staticmethod
    def paths_from_trace(trace_path: str, strip_prefix: str = "") -> list[str]:
        """Fanotify/optimizer access trace → ordered path list (first
        access first — that IS the replay priority)."""
        from nydus_snapshotter_tpu_torch.prefetch.prefetch import patterns_from_trace

        text = patterns_from_trace(trace_path, strip_prefix=strip_prefix)
        return [p for p in text.split("\n") if p]

    def replay(self, paths: list[str]) -> int:
        """Warm every chunk of every path, in order; returns bytes warmed.
        Per-file errors are contained (prefetch lists are hints)."""
        import logging

        log = logging.getLogger(__name__)
        for path in paths:
            if self._cancel.is_set():
                break
            failpoint.hit("blobcache.replay")
            inode = self.by_path.get(path)
            if inode is None:
                continue
            if inode.hardlink_target:
                inode = self.by_path.get(inode.hardlink_target) or inode
            try:
                for rec in self.bootstrap.chunks[
                    inode.chunk_index : inode.chunk_index + inode.chunk_count
                ]:
                    if self._cancel.is_set():
                        break
                    n = self.warm_chunk(rec)
                    self.warmed_bytes += n
                    PREFETCH_BYTES.inc(n)
            except Exception:  # noqa: BLE001 — one bad hint must not
                # abandon the rest of the list
                log.warning("prefetch replay of %s failed", path, exc_info=True)
                continue
            if self._cancel.is_set():
                break  # cancelled mid-file: it was not fully replayed
            self.files_replayed += 1
            if self.on_file is not None:
                self.on_file()
        return self.warmed_bytes
