"""Fleet metrics federation: scrape every member, one namespaced view.

Each process in the deployment (snapshotter, spawned daemons, standalone
dict services, peer servers) keeps its own in-process metrics registry.
This module gives the system controller one cluster-wide view:

- :class:`FleetFederator` scrapes every registered member's ``/metrics``
  endpoint on a timer (``[fleet] scrape_interval_secs``), keeps the last
  good exposition per member, and re-serves the union on
  ``/api/v1/fleet/metrics`` with ``node``/``component`` labels injected
  into every series — Prometheus federation semantics without the
  Prometheus server;
- a **health scoreboard** (:meth:`FleetFederator.scoreboard`) derives the
  operational ratios an operator actually pages on — blobcache hit rate,
  readahead accuracy, peer egress ratio, dict RPC health, QoS admission
  queue depths, host-health cooldowns — per member, from the scraped
  samples;
- **degradation over wedging**: a member that dies mid-scrape is marked
  unreachable/stale (``ntpu_fleet_member_up``, ``stale`` flags in the
  scoreboard) and its last-good series age out of the view; the scrape
  loop and the serving endpoints never propagate the failure
  (``ntpu_fleet_scrape_errors_total{member}`` counts it instead). The
  ``fleet.scrape`` failpoint injects exactly this failure mode in chaos
  tests.

The local (controller) process is itself a member: its "scrape" goes
through the metrics server's cached ``collect_once`` snapshot
(:meth:`MetricsServer.snapshot`), so serving the scoreboard never runs
the collectors inline per request.
"""

from __future__ import annotations

import logging
import re
import time
from typing import Callable, Iterable, Optional

from nydus_snapshotter_tpu_torch import failpoint
from nydus_snapshotter_tpu_torch.analysis import runtime as _an
from nydus_snapshotter_tpu_torch.metrics import registry as _metrics
from nydus_snapshotter_tpu_torch.remote import mirror as mirror_mod
from nydus_snapshotter_tpu_torch.utils import udshttp

logger = logging.getLogger(__name__)

_reg = _metrics.default_registry

FLEET_MEMBERS = _reg.register(
    _metrics.Gauge(
        "ntpu_fleet_members",
        "Members currently registered with the fleet plane, per component",
        ("component",),
    )
)
FLEET_SCRAPES = _reg.register(
    _metrics.Counter(
        "ntpu_fleet_scrapes_total", "Completed fleet federation scrape rounds"
    )
)
FLEET_SCRAPE_ERRORS = _reg.register(
    _metrics.Counter(
        "ntpu_fleet_scrape_errors_total",
        "Per-member scrape/trace-pull failures; a dead member degrades the "
        "scoreboard instead of wedging the round",
        ("member",),
    )
)
FLEET_MEMBER_UP = _reg.register(
    _metrics.Gauge(
        "ntpu_fleet_member_up",
        "1 when the member's last scrape succeeded, 0 when it is unreachable",
        ("member",),
    )
)
FLEET_SCRAPE_MS = _reg.register(
    _metrics.Histogram(
        "ntpu_fleet_scrape_duration_milliseconds",
        "Wall time of one full federation scrape round across all members",
    )
)

METRICS_PATH = "/metrics"

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})?\s+([^ ]+)\s*$"
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_exposition(text: str) -> dict[str, list[tuple[dict, float]]]:
    """Prometheus text exposition → {metric: [(labels, value), ...]}.

    Tolerant by design: unparseable lines are skipped (a member running
    a newer build must not break the whole federation round).
    """
    out: dict[str, list[tuple[dict, float]]] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        name, _, labelstr, raw = m.groups()
        labels = {
            k: v.replace('\\"', '"').replace("\\\\", "\\")
            for k, v in _LABEL_RE.findall(labelstr or "")
        }
        try:
            value = float(raw)
        except ValueError:
            continue
        out.setdefault(name, []).append((labels, value))
    return out


def _inject_labels(text: str, extra: dict[str, str]) -> str:
    """Re-emit an exposition with ``extra`` labels on every sample line.
    Comment (# HELP/# TYPE) lines pass through unchanged."""
    prefix = ",".join(f'{k}="{v}"' for k, v in extra.items())
    out = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            out.append(line)
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            out.append(line)
            continue
        name, _, labelstr, raw = m.groups()
        inner = f"{prefix},{labelstr}" if labelstr else prefix
        out.append(f"{name}{{{inner}}} {raw}")
    return "\n".join(out)


def _sum(samples: dict, metric: str, labels: Optional[dict] = None) -> Optional[float]:
    rows = samples.get(metric)
    if rows is None:
        return None
    total = 0.0
    for lab, v in rows:
        if labels is not None and any(lab.get(k) != v2 for k, v2 in labels.items()):
            continue
        total += v
    return total


def _by_label(samples: dict, metric: str, label: str) -> dict[str, float]:
    rows = samples.get(metric) or ()
    out: dict[str, float] = {}
    for lab, v in rows:
        key = lab.get(label, "")
        out[key] = out.get(key, 0.0) + v
    return out


def _ratio(num: Optional[float], den: Optional[float]) -> Optional[float]:
    if num is None or not den:
        return None
    return round(num / den, 4)


class _MemberState:
    __slots__ = ("text", "samples", "last_ok", "last_err", "ok")

    def __init__(self):
        self.text = ""
        self.samples: dict = {}
        self.last_ok = 0.0
        self.last_err = ""
        self.ok = False


class FleetFederator:
    """Scrapes members, serves the federated exposition + scoreboard.

    ``members`` is a callable returning the current registry listing
    (duck-typed: ``name``/``component``/``address``/``pid``/``local``/
    ``registered_at``), so this module needs no import of the registry.
    ``local_metrics`` renders the controller process's own exposition —
    wired to :meth:`MetricsServer.snapshot` when a metrics server runs,
    ``default_registry.render`` otherwise.
    """

    def __init__(
        self,
        members: Callable[[], Iterable],
        local_metrics: Callable[[], str],
        stale_after_secs: float = 45.0,
        timeout_s: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self._members = members
        self._local_metrics = local_metrics
        self.stale_after = float(stale_after_secs)
        self.timeout_s = timeout_s
        self._clock = clock
        self._lock = _an.make_lock("fleet.federation")
        self._state_shared = _an.shared("fleet.federation.state")
        self._state: dict[str, _MemberState] = {}
        self._seen_components: set[str] = set()

    # -- scraping ------------------------------------------------------------

    def _fetch_member(self, member) -> str:
        failpoint.hit("fleet.scrape")
        if member.local:
            return self._local_metrics()
        status, body = udshttp.request(
            member.address, METRICS_PATH, timeout=self.timeout_s
        )
        if status != 200:
            raise OSError(f"{member.address} {METRICS_PATH} -> {status}")
        return body.decode("utf-8", "replace")

    def scrape_once(self) -> dict:
        """One federation round over the current member list. Per-member
        isolation: a failing member is flagged and counted, never raised."""
        t0 = time.perf_counter()
        members = list(self._members())
        counts: dict[str, int] = {}
        errors = 0
        live = set()
        for member in members:
            counts[member.component] = counts.get(member.component, 0) + 1
            live.add(member.name)
            try:
                text = self._fetch_member(member)
                samples = parse_exposition(text)
            except Exception as e:  # noqa: BLE001 — degradation is the contract
                errors += 1
                FLEET_SCRAPE_ERRORS.labels(member.name).inc()
                FLEET_MEMBER_UP.labels(member.name).set(0)
                with self._lock:
                    self._state_shared.write()
                    st = self._state.setdefault(member.name, _MemberState())
                    st.ok = False
                    st.last_err = str(e)
                logger.warning("fleet scrape of %s failed: %s", member.name, e)
                continue
            FLEET_MEMBER_UP.labels(member.name).set(1)
            with self._lock:
                self._state_shared.write()
                st = self._state.setdefault(member.name, _MemberState())
                st.text = text
                st.samples = samples
                st.last_ok = self._clock()
                st.last_err = ""
                st.ok = True
        with self._lock:
            self._state_shared.write()
            for name in [n for n in self._state if n not in live]:
                del self._state[name]
                FLEET_MEMBER_UP.remove(name)
        for comp in self._seen_components - set(counts):
            FLEET_MEMBERS.labels(comp).set(0)
        self._seen_components |= set(counts)
        for comp, n in counts.items():
            FLEET_MEMBERS.labels(comp).set(n)
        FLEET_SCRAPES.inc()
        FLEET_SCRAPE_MS.observe((time.perf_counter() - t0) * 1000.0)
        return {"members": len(members), "errors": errors}

    def _snapshot(self) -> dict[str, _MemberState]:
        with self._lock:
            self._state_shared.read()
            return dict(self._state)

    # -- exports -------------------------------------------------------------

    def render(self) -> str:
        """The federated exposition: every member's last good scrape with
        ``node``/``component`` labels injected. Stale members' series stay
        visible (flagged by ntpu_fleet_member_up / the scoreboard) so a
        flapping member doesn't blink its history away."""
        state = self._snapshot()
        members = {m.name: m for m in self._members()}
        parts = []
        for name in sorted(state):
            member = members.get(name)
            st = state[name]
            if member is None or not st.text:
                continue
            parts.append(
                _inject_labels(
                    st.text, {"node": name, "component": member.component}
                )
            )
        return "\n".join(parts) + "\n"

    def member_samples(self) -> dict[str, dict]:
        """{member: parsed samples} of the last good scrape per member —
        the SLO engine's federated histogram source."""
        return {name: st.samples for name, st in self._snapshot().items() if st.ok or st.samples}

    def liveness(self) -> dict[str, dict]:
        """{member: {"up", "stale", "age_s"}} from the last scrape round —
        the cheap health view dynamic peer membership routes on (a member
        never scraped yet is up-but-stale-unknown: treated live so a peer
        racing the first scrape round isn't shunned at birth)."""
        now = self._clock()
        out: dict[str, dict] = {}
        for name, st in self._snapshot().items():
            age = (now - st.last_ok) if st.last_ok else None
            out[name] = {
                "up": st.ok,
                "stale": (not st.ok) or (age is not None and age > self.stale_after),
                "age_s": None if age is None else round(age, 3),
            }
        return out

    def scoreboard(self) -> dict:
        """Derived per-member health view. Every field is best-effort:
        a ratio whose inputs a member doesn't export is None, a member
        that stopped answering is carried with ``up: false`` and its
        last-good numbers — degraded, never absent."""
        now = self._clock()
        state = self._snapshot()
        members = sorted(self._members(), key=lambda m: m.name)
        rows = {}
        seen_pids: set[int] = set()
        up = stale = 0
        for member in members:
            st = state.get(member.name) or _MemberState()
            s = st.samples
            age = (now - st.last_ok) if st.last_ok else (now - member.registered_at)
            is_stale = (not st.ok) or age > self.stale_after
            up += 1 if st.ok else 0
            stale += 1 if is_stale else 0
            hit = _sum(s, "ntpu_blobcache_hit_bytes")
            miss = _sum(s, "ntpu_blobcache_miss_bytes")
            ra = _sum(s, "ntpu_blobcache_readahead_bytes")
            ra_hit = _sum(s, "ntpu_blobcache_readahead_hit_bytes")
            served = _sum(s, "ntpu_peer_served_bytes")
            fetched = _sum(s, "ntpu_peer_fetch_bytes")
            duplicate = member.pid in seen_pids
            seen_pids.add(member.pid)
            rows[member.name] = {
                "component": member.component,
                "address": member.address,
                "pid": member.pid,
                "up": st.ok,
                "stale": is_stale,
                "age_s": round(age, 3),
                "last_err": st.last_err,
                # Two registrations from one OS process (e.g. a daemon
                # that also runs a peer server) share counters; fleet
                # aggregates must count the pid once.
                "duplicate_pid": duplicate,
                "scrape_errors": FLEET_SCRAPE_ERRORS.value(member.name),
                "cache": {
                    "hit_bytes": hit,
                    "miss_bytes": miss,
                    "hit_rate": _ratio(hit, (hit or 0) + (miss or 0)),
                    "readahead_accuracy": _ratio(ra_hit, ra),
                    "evicted_bytes": _sum(s, "ntpu_blobcache_evicted_bytes"),
                },
                "peer": {
                    "served_bytes": served,
                    "fetched_bytes": fetched,
                    # Peer-tier leverage: bytes this node served peers per
                    # byte it pulled from peers itself.
                    "egress_ratio": _ratio(served, fetched),
                    "fallbacks": _sum(s, "ntpu_peer_fetch_fallbacks"),
                },
                "dict": {
                    "rpcs": _sum(s, "ntpu_dict_rpc_total"),
                    "rpc_errors": _sum(s, "ntpu_dict_rpc_errors_total"),
                    "insert_entries": _sum(s, "ntpu_dict_insert_entries"),
                    "rebuilds": _sum(s, "ntpu_dict_rebuilds"),
                },
                "admission": {
                    "queued": _by_label(s, "ntpu_admission_queued", "lane"),
                    "tenant_inflight_bytes": _by_label(
                        s, "ntpu_admission_tenant_inflight_bytes", "tenant"
                    ),
                },
                "traces": {
                    "spans_total": _sum(s, "ntpu_trace_spans_total"),
                    "dropped": _sum(s, "ntpu_trace_dropped_spans_total"),
                    "slow_ops": _sum(s, "ntpu_trace_slow_ops_total"),
                },
            }
        # Host-health cooldowns are in-process state (no exported series):
        # report the controller process's shared table — every component in
        # this process (mirrors, lazy-read fetcher, peer router) scores
        # through it.
        cooldowns = {
            host: h
            for host, h in mirror_mod.global_health_registry().snapshot().items()
            if not h["available"]
        }
        return {
            "members": rows,
            "fleet": {
                "registered": len(members),
                "up": up,
                "stale": stale,
                "host_cooldowns": cooldowns,
            },
        }
