"""Declarative SLOs over the op-duration histograms, with error budgets
and multi-window burn-rate alerting.

The profile tools already gate ad-hoc latency bounds ("demand p95 under
storm <= 2x unloaded"); this module makes such objectives a *deployed*
contract: the ``[slo]`` config section declares objectives over the
histograms the planes already export (``ntpu_snapshot_op_duration_*``,
``ntpu_blobcache_op_duration_*``, ...), and the engine evaluates them
continuously:

- **sliding windows**: every tick snapshots the objective's cumulative
  (observations <= threshold, total) pair; window compliance is the diff
  between now and the sample just outside the window — no per-request
  bookkeeping, the histograms the hot paths already feed are the only
  data source;
- **error budget**: an objective with ``target`` 0.99 has a 1% budget;
  the **burn rate** is (bad fraction in window) / budget — burn 1.0
  consumes the budget exactly at the window's length, Google-SRE style;
- **multi-window alerting**: a breach fires only when the burn rate
  exceeds ``burn_threshold`` on BOTH the short window and the
  ``long_window_factor``x long window — a latency spike shorter than the
  long window's smoothing can't page, a sustained regression can't hide;
- **flight-recorder attachment**: each breach event carries the slow-op
  recorder's current dumps and the over-p95 trace exemplars, so the page
  arrives WITH the span trees of the requests that burned the budget.

Histogram sources are pluggable: the default reads this process's
registry; the fleet plane (metrics/federation.py) supplies a federated
source summing ``<metric>_bucket``/``<metric>_count`` samples across
scraped members (deduplicated by pid), so one objective can span every
daemon in the deployment.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from typing import Callable, Optional

from nydus_snapshotter_tpu_torch import trace
from nydus_snapshotter_tpu_torch.analysis import runtime as _an
from nydus_snapshotter_tpu_torch.metrics import registry as _metrics

logger = logging.getLogger(__name__)

_reg = _metrics.default_registry

SLO_COMPLIANCE = _reg.register(
    _metrics.Gauge(
        "ntpu_slo_compliance_ratio",
        "Fraction of operations within the objective's threshold over the "
        "short window",
        ("objective",),
    )
)
SLO_BUDGET_REMAINING = _reg.register(
    _metrics.Gauge(
        "ntpu_slo_error_budget_remaining",
        "Unburned fraction of the objective's error budget over the long "
        "window (1 = untouched, 0 = exhausted)",
        ("objective",),
    )
)
SLO_BURN_RATE = _reg.register(
    _metrics.Gauge(
        "ntpu_slo_burn_rate",
        "Error-budget burn rate per evaluation window (1.0 consumes the "
        "budget in exactly one window length)",
        ("objective", "window"),
    )
)
SLO_BREACHES = _reg.register(
    _metrics.Counter(
        "ntpu_slo_breaches_total",
        "Multi-window burn-rate alerts raised, per objective",
        ("objective",),
    )
)
SLO_ACTUATIONS = _reg.register(
    _metrics.Counter(
        "ntpu_slo_actuations_total",
        "Admission-gate lane actuations driven by SLO burn state",
        ("action", "lane"),
    )
)
SLO_LANE_SHED = _reg.register(
    _metrics.Gauge(
        "ntpu_slo_lane_shed",
        "1 while SLO actuation holds the lane shed, 0 when restored",
        ("lane",),
    )
)
SLO_SCALEUP = _reg.register(
    _metrics.Counter(
        "ntpu_slo_scaleup_total",
        "Capacity scale-up transitions driven by clean-burn demand "
        "pressure (spawn/retire/spawn_failed/retire_failed)",
        ("action",),
    )
)
SLO_SCALEUP_MEMBERS = _reg.register(
    _metrics.Gauge(
        "ntpu_slo_scaleup_members",
        "Extra capacity members currently held by scale-up actuation",
    )
)


class SloSpecError(ValueError):
    """A malformed ``[[slo.objectives]]`` table."""


class SloObjective:
    """One declarative objective, parsed from a ``[[slo.objectives]]``
    table (or the ``NTPU_SLO_OBJECTIVES`` JSON)."""

    def __init__(
        self,
        name: str,
        metric: str,
        threshold_ms: float,
        target: float = 0.99,
        labels: Optional[dict] = None,
        window_secs: float = 300.0,
        long_window_factor: float = 12.0,
        burn_threshold: float = 2.0,
    ):
        if not name or not metric:
            raise SloSpecError("slo objective needs name and metric")
        if threshold_ms <= 0:
            raise SloSpecError(f"{name}: threshold_ms must be positive")
        if not 0.0 < target < 1.0:
            raise SloSpecError(f"{name}: target must be within (0, 1)")
        if window_secs <= 0 or long_window_factor < 1.0 or burn_threshold <= 0:
            raise SloSpecError(f"{name}: bad window/burn parameters")
        self.name = name
        self.metric = metric
        self.threshold_ms = float(threshold_ms)
        self.target = float(target)
        self.labels = dict(labels or {})
        self.window_secs = float(window_secs)
        self.long_window_secs = float(window_secs) * float(long_window_factor)
        self.burn_threshold = float(burn_threshold)

    @classmethod
    def from_dict(cls, d: dict) -> "SloObjective":
        known = {
            "name", "metric", "threshold_ms", "target", "labels",
            "window_secs", "long_window_factor", "burn_threshold",
        }
        unknown = set(d) - known
        if unknown:
            raise SloSpecError(
                f"slo objective {d.get('name', '?')!r}: unknown keys {sorted(unknown)}"
            )
        try:
            return cls(**d)
        except TypeError as e:
            raise SloSpecError(f"slo objective {d.get('name', '?')!r}: {e}") from e


# ---------------------------------------------------------------------------
# Histogram sources
# ---------------------------------------------------------------------------


def local_source(registry: Optional[_metrics.Registry] = None):
    """(objective) -> (good, total) cumulative pair from this process's
    registry. Label filter matches a subset of the histogram's labels."""
    reg = registry or _reg

    def read(obj: SloObjective) -> tuple[float, float]:
        metric = reg._metrics.get(obj.metric)  # noqa: SLF001 — same package
        if not isinstance(metric, _metrics.Histogram):
            return 0.0, 0.0
        names = metric.label_names
        want = [(names.index(k), v) for k, v in obj.labels.items() if k in names]
        if len(want) != len(obj.labels):
            return 0.0, 0.0
        good = total = 0.0
        for key, (g, t) in metric.cumulative_le(obj.threshold_ms).items():
            if all(key[i] == v for i, v in want):
                good += g
                total += t
        return good, total

    return read


def federated_source(federator, members: Callable[[], list]):
    """(objective) -> (good, total) summed across every scraped member's
    last-good samples, counting each OS process (pid) once."""

    def read(obj: SloObjective) -> tuple[float, float]:
        by_member = federator.member_samples()
        listing = {m.name: m for m in members()}
        good = total = 0.0
        seen_pids: set[int] = set()
        fmt = _metrics._fmt_value  # noqa: SLF001 — bucket le formatting
        le = fmt(obj.threshold_ms)
        for name in sorted(by_member):
            member = listing.get(name)
            if member is None or member.pid in seen_pids:
                continue
            seen_pids.add(member.pid)
            samples = by_member[name]
            for labels, v in samples.get(f"{obj.metric}_bucket", ()):
                if labels.get("le") != le:
                    continue
                if any(labels.get(k) != s for k, s in obj.labels.items()):
                    continue
                good += v
            for labels, v in samples.get(f"{obj.metric}_count", ()):
                if any(labels.get(k) != s for k, s in obj.labels.items()):
                    continue
                total += v
        return good, total

    return read


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


class _ObjectiveState:
    __slots__ = ("samples", "breached", "last_status")

    def __init__(self):
        # (t, good, total) cumulative snapshots, oldest first.
        self.samples: deque = deque()
        self.breached = False
        self.last_status: dict = {}


class SloEngine:
    """Evaluates objectives on :meth:`tick`; serves ``/api/v1/fleet/slo``."""

    def __init__(
        self,
        objectives: list[SloObjective],
        source: Optional[Callable[[SloObjective], tuple[float, float]]] = None,
        clock: Callable[[], float] = time.monotonic,
        keep_events: int = 32,
    ):
        self.objectives = list(objectives)
        self._source = source or local_source()
        self._clock = clock
        self._lock = _an.make_lock("slo.engine")
        self._state_shared = _an.shared("slo.engine.state")
        self._state = {o.name: _ObjectiveState() for o in self.objectives}
        self._events: deque = deque(maxlen=keep_events)
        # Operational events other control planes surface here (the HA
        # placement controller's promotions land on /api/v1/fleet/slo
        # next to the breaches they often explain).
        self._ops_events: deque = deque(maxlen=keep_events)

    def record_event(self, kind: str, **detail) -> dict:
        """Attach one operational event (e.g. ``dict_ha_promotion``) to
        the SLO surface; returns the recorded event."""
        event = {"kind": kind, "at": self._clock(), **detail}
        with self._lock:
            self._state_shared.write()
            self._ops_events.append(event)
        return event

    def _window(self, st: _ObjectiveState, now: float, secs: float):
        """(good delta, total delta) between now's snapshot and the
        newest snapshot at least ``secs`` old (None until one exists —
        a window with no history must not alert)."""
        newest = st.samples[-1]
        base = None
        for t, good, total in st.samples:
            if now - t >= secs:
                base = (good, total)
            else:
                break
        if base is None:
            return None
        return newest[1] - base[0], newest[2] - base[1]

    def tick(self) -> list[dict]:
        """One evaluation round; returns breach events raised this tick."""
        now = self._clock()
        raised = []
        for obj in self.objectives:
            good, total = self._source(obj)
            st = self._state[obj.name]
            with self._lock:
                self._state_shared.write()
                st.samples.append((now, good, total))
                horizon = now - obj.long_window_secs * 1.5
                while len(st.samples) > 2 and st.samples[1][0] <= horizon:
                    st.samples.popleft()
            budget = 1.0 - obj.target
            status = {
                "objective": obj.name,
                "metric": obj.metric,
                "threshold_ms": obj.threshold_ms,
                "target": obj.target,
                "window_secs": obj.window_secs,
                "long_window_secs": obj.long_window_secs,
                "burn_threshold": obj.burn_threshold,
                "total_ops": total,
            }
            burns = {}
            for label, secs in (
                ("short", obj.window_secs),
                ("long", obj.long_window_secs),
            ):
                delta = self._window(st, now, secs)
                if delta is None or delta[1] <= 0:
                    # No traffic / no history: compliant by definition.
                    compliance, burn = 1.0, 0.0
                else:
                    compliance = max(0.0, min(1.0, delta[0] / delta[1]))
                    burn = (1.0 - compliance) / budget
                burns[label] = burn
                status[f"compliance_{label}"] = round(compliance, 6)
                status[f"burn_{label}"] = round(burn, 4)
                SLO_BURN_RATE.labels(obj.name, label).set(burn)
            remaining = max(0.0, 1.0 - burns["long"])
            status["budget_remaining"] = round(remaining, 4)
            SLO_COMPLIANCE.labels(obj.name).set(status["compliance_short"])
            SLO_BUDGET_REMAINING.labels(obj.name).set(remaining)
            breach = (
                burns["short"] > obj.burn_threshold
                and burns["long"] > obj.burn_threshold
            )
            status["breached"] = breach
            with self._lock:
                self._state_shared.write()
                transition = breach and not st.breached
                st.breached = breach
                st.last_status = status
            if transition:
                SLO_BREACHES.labels(obj.name).inc()
                event = {
                    "objective": obj.name,
                    "at": now,
                    "status": dict(status),
                    # The page arrives WITH the evidence: the slow-op
                    # recorder's reconstructed trees and the over-p95
                    # trace ids current at breach time.
                    "slow_ops": trace.slow_ops(),
                    "trace_exemplars": trace.exemplars(),
                }
                with self._lock:
                    self._state_shared.write()
                    self._events.append(event)
                raised.append(event)
                logger.warning(
                    "SLO breach: %s burn short=%.2f long=%.2f (threshold %.2f)",
                    obj.name, burns["short"], burns["long"], obj.burn_threshold,
                )
        return raised

    def status(self) -> dict:
        with self._lock:
            self._state_shared.read()
            return {
                "objectives": [
                    dict(self._state[o.name].last_status)
                    for o in self.objectives
                    if self._state[o.name].last_status
                ],
                "breaches": [dict(e) for e in self._events],
                "events": [dict(e) for e in self._ops_events],
            }

    def breached(self) -> list[str]:
        """Objectives currently in multi-window breach (the actuator's
        escalate/hold signal)."""
        with self._lock:
            self._state_shared.read()
            return [o.name for o in self.objectives if self._state[o.name].breached]

    def max_burn_short(self) -> float:
        """The worst short-window burn across objectives right now (the
        actuator's restore signal: recovery must show on the fast
        window, not wait out the long one)."""
        with self._lock:
            self._state_shared.read()
            burns = [
                self._state[o.name].last_status.get("burn_short", 0.0)
                for o in self.objectives
                if self._state[o.name].last_status
            ]
            return max(burns, default=0.0)


# ---------------------------------------------------------------------------
# Actuation: burn-rate alerts close the loop onto the admission gate
# ---------------------------------------------------------------------------


class SloActuator:
    """Sheds AdmissionGate lanes on sustained burn, restores on recovery.

    The engine observes; this closes the loop: while ANY
    objective is in multi-window breach, one more lane from
    ``shed_lanes`` (least-important first — peer_serve, then prefetch,
    then readahead; the demand lane is not actuatable by construction)
    is shed per tick, so pressure is removed incrementally before demand
    latency suffers. Once every objective's SHORT-window burn drops
    under ``restore_burn`` the most recently shed lane is restored per
    tick — recovery reads the fast window so the budget refills without
    waiting out the long window's smoothing.

    Every transition fires the ``slo.actuate`` failpoint, records a
    ``slo.actuate`` trace span, bumps ``ntpu_slo_actuations_total`` and
    lands in the event log the fleet surface serves
    (``/api/v1/fleet/slo`` → ``actuation``).
    """

    def __init__(
        self,
        engine: SloEngine,
        gate=None,
        shed_lanes: Optional[list[str]] = None,
        restore_burn: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
        keep_events: int = 64,
    ):
        from nydus_snapshotter_tpu_torch.daemon import fetch_sched

        self.engine = engine
        self._gate = gate  # resolved lazily: shared_gate() builds config
        self._fetch_sched = fetch_sched
        lanes = shed_lanes or ["peer_serve", "prefetch", "readahead"]
        self.shed_lanes = []
        for name in lanes:
            if name not in fetch_sched.LANE_NAMES:
                raise SloSpecError(f"unknown slo shed lane {name!r}")
            lane = fetch_sched.LANE_NAMES.index(name)
            if lane == fetch_sched.DEMAND:
                raise SloSpecError("the demand lane is not sheddable")
            self.shed_lanes.append(lane)
        self.restore_burn = float(restore_burn)
        self._clock = clock
        self._lock = _an.make_lock("slo.actuator")
        self._state_shared = _an.shared("slo.actuator.state")
        self._shed_depth = 0  # how many of shed_lanes are currently shed
        self._events: deque = deque(maxlen=keep_events)

    @property
    def gate(self):
        if self._gate is None:
            self._gate = self._fetch_sched.shared_gate()
        return self._gate

    def _transition(self, action: str, lane: int, reason: str) -> None:
        from nydus_snapshotter_tpu_torch import failpoint, trace

        lane_name = self._fetch_sched.LANE_NAMES[lane]
        with trace.span("slo.actuate", action=action, lane=lane_name):
            failpoint.hit("slo.actuate")
            self.gate.set_lane_cap(lane, 0 if action == "shed" else None)
        SLO_ACTUATIONS.labels(action, lane_name).inc()
        SLO_LANE_SHED.labels(lane_name).set(1 if action == "shed" else 0)
        event = {
            "at": self._clock(),
            "action": action,
            "lane": lane_name,
            "reason": reason,
        }
        with self._lock:
            self._state_shared.write()
            self._events.append(event)
        logger.warning("SLO actuation: %s lane %s (%s)", action, lane_name, reason)

    def tick(self) -> Optional[dict]:
        """One actuation decision; returns the transition event if any.
        Call after :meth:`SloEngine.tick` on the same cadence."""
        breached = self.engine.breached()
        with self._lock:
            self._state_shared.read()
            depth = self._shed_depth
        if breached and depth < len(self.shed_lanes):
            lane = self.shed_lanes[depth]
            self._transition("shed", lane, f"breach: {', '.join(breached)}")
            with self._lock:
                self._state_shared.write()
                self._shed_depth = depth + 1
                return dict(self._events[-1])
        if not breached and depth > 0:
            burn = self.engine.max_burn_short()
            if burn < self.restore_burn:
                lane = self.shed_lanes[depth - 1]
                self._transition(
                    "restore", lane, f"burn_short {burn:.2f} < {self.restore_burn}"
                )
                with self._lock:
                    self._state_shared.write()
                    self._shed_depth = depth - 1
                    return dict(self._events[-1])
        return None

    def state(self) -> dict:
        """The actuation view the fleet surface publishes (and member
        followers apply to their local gates)."""
        with self._lock:
            self._state_shared.read()
            depth = self._shed_depth
            events = [dict(e) for e in self._events]
        names = self._fetch_sched.LANE_NAMES
        return {
            "shed_lanes": [names[lane] for lane in self.shed_lanes[:depth]],
            "shed_depth": depth,
            "restore_burn": self.restore_burn,
            "events": events[-16:],
        }


class SloScaleUp:
    """Closed-loop capacity scale-UP: the other half of actuation.

    :class:`SloActuator` handles a burn breach by shedding background
    lanes — correct when the node is *misbehaving*, wrong when it is
    simply *undersized*: a fleet whose demand queues grow while burn
    stays clean needs more capacity, not less work. This policy closes
    that loop: when no objective is breached but the demand-pressure
    signal (:meth:`AdmissionGate.demand_pressure` — queue depth and wait
    EWMA) crosses its thresholds, ``spawn_fn`` asks the placement/fleet
    plane for another member (peer server, dict replica); after
    ``quiet_ticks`` calm ticks the newest member is retired again.

    Failure contract (the chaos suite pins this): a spawn attempt fires
    the ``soak.scaleup`` failpoint and any exception out of it — or out
    of ``spawn_fn`` itself — degrades to a ``spawn_failed`` event plus a
    ``cooldown_ticks`` back-off. The policy NEVER raises out of
    :meth:`tick` and never blocks: a broken spawn path leaves the fleet
    on the shed-only behaviour it had before this class existed.

    During a burn breach the policy stands down entirely (no spawn, no
    retire): shedding owns the gate until the burn clears, and spawning
    while misbehaving would mask the breach with hardware.
    """

    def __init__(
        self,
        engine: SloEngine,
        demand_fn: Callable[[], dict],
        spawn_fn: Callable[[int], object],
        retire_fn: Optional[Callable[[int], object]] = None,
        queue_high: int = 4,
        wait_high_ms: float = 25.0,
        quiet_ticks: int = 2,
        max_members: int = 2,
        cooldown_ticks: int = 2,
        clock: Callable[[], float] = time.monotonic,
        keep_events: int = 64,
    ):
        self.engine = engine
        self.demand_fn = demand_fn
        self.spawn_fn = spawn_fn
        self.retire_fn = retire_fn
        self.queue_high = max(1, int(queue_high))
        self.wait_high_ms = float(wait_high_ms)
        self.quiet_ticks = max(1, int(quiet_ticks))
        self.max_members = max(0, int(max_members))
        self.cooldown_ticks = max(0, int(cooldown_ticks))
        self._clock = clock
        self._lock = _an.make_lock("slo.scaleup")
        self._state_shared = _an.shared("slo.scaleup.state")
        self.members = 0
        self._quiet = 0
        self._cooldown = 0
        self._events: deque = deque(maxlen=keep_events)
        SLO_SCALEUP_MEMBERS.set(0)

    def _record(self, action: str, reason: str, **detail) -> dict:
        event = {
            "at": self._clock(),
            "action": action,
            "members": self.members,
            "reason": reason,
            **detail,
        }
        with self._lock:
            self._state_shared.write()
            self._events.append(event)
        SLO_SCALEUP.labels(action).inc()
        if self.engine is not None:
            self.engine.record_event(f"slo_scaleup_{action}", **event)
        logger.warning(
            "SLO scale-up: %s -> %d members (%s)", action, self.members, reason
        )
        return event

    def _spawn(self, reason: str) -> dict:
        from nydus_snapshotter_tpu_torch import failpoint, trace

        target = self.members + 1
        try:
            with trace.span("slo.scaleup", action="spawn", target=target):
                failpoint.hit("soak.scaleup")
                self.spawn_fn(target)
        except BaseException as e:  # noqa: BLE001 — degrade, never wedge
            self._cooldown = self.cooldown_ticks
            return self._record(
                "spawn_failed", reason, error=repr(e)[:200]
            )
        self.members = target
        SLO_SCALEUP_MEMBERS.set(self.members)
        return self._record("spawn", reason)

    def _retire(self, reason: str) -> dict:
        from nydus_snapshotter_tpu_torch import trace

        target = self.members - 1
        try:
            with trace.span("slo.scaleup", action="retire", target=target):
                if self.retire_fn is not None:
                    self.retire_fn(target)
        except BaseException as e:  # noqa: BLE001 — degrade, never wedge
            self._cooldown = self.cooldown_ticks
            return self._record(
                "retire_failed", reason, error=repr(e)[:200]
            )
        self.members = target
        SLO_SCALEUP_MEMBERS.set(self.members)
        self._quiet = 0
        return self._record("retire", reason)

    def tick(self) -> Optional[dict]:
        """One capacity decision; returns the transition event if any.
        Call after :meth:`SloEngine.tick` on the same cadence."""
        if self.engine is not None and self.engine.breached():
            self._quiet = 0  # the shed path owns a breach window
            return None
        try:
            press = self.demand_fn() or {}
        except Exception:  # a dead signal source reads as zero pressure
            press = {}
        queued = int(press.get("queued", 0))
        wait_ms = float(press.get("wait_ms", 0.0))
        hot = queued >= self.queue_high or wait_ms >= self.wait_high_ms
        if self._cooldown > 0:
            self._cooldown -= 1
            return None
        if hot:
            self._quiet = 0
            if self.members < self.max_members:
                return self._spawn(
                    f"demand queued={queued} wait_ms={wait_ms:.3f}"
                )
            return None
        if self.members > 0:
            self._quiet += 1
            if self._quiet >= self.quiet_ticks:
                return self._retire(f"quiet for {self._quiet} ticks")
        return None

    def state(self) -> dict:
        """The capacity view the fleet surface publishes."""
        with self._lock:
            self._state_shared.read()
            events = [dict(e) for e in self._events]
        return {
            "members": self.members,
            "max_members": self.max_members,
            "quiet": self._quiet,
            "cooldown": self._cooldown,
            "queue_high": self.queue_high,
            "wait_high_ms": self.wait_high_ms,
            "events": events[-16:],
        }


class SloActuationFollower:
    """Member-side actuation: polls the controller's published actuation
    state and applies it to this process's shared admission gate, so a
    breach the CONTROLLER detects (federated histograms span every
    daemon) sheds lanes fleet-wide, not just in the controller process.
    A poll failure keeps the last applied state (an unreachable
    controller must not flap lanes); stop() restores everything."""

    def __init__(
        self,
        controller: str,
        gate=None,
        poll_secs: float = 2.0,
        fetch=None,
    ):
        from nydus_snapshotter_tpu_torch.daemon import fetch_sched

        self._fetch_sched = fetch_sched
        self.controller = controller
        self._gate = gate
        self.poll_secs = max(0.05, float(poll_secs))
        self._fetch = fetch if fetch is not None else self._fetch_controller
        self._applied: set[str] = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def gate(self):
        if self._gate is None:
            self._gate = self._fetch_sched.shared_gate()
        return self._gate

    def _fetch_controller(self) -> dict:
        from nydus_snapshotter_tpu_torch.utils import udshttp

        status = udshttp.get_json(self.controller, "/api/v1/fleet/slo", timeout=2.0)
        return status.get("actuation", {}) if isinstance(status, dict) else {}

    def poll_once(self) -> bool:
        """One poll+apply round; returns whether the state changed."""
        try:
            want = set(self._fetch().get("shed_lanes", ()))
        except Exception:  # noqa: BLE001 — keep last applied state
            return False
        names = self._fetch_sched.LANE_NAMES
        changed = False
        for name in sorted(want - self._applied):
            if name in names and names.index(name) != self._fetch_sched.DEMAND:
                self.gate.set_lane_cap(names.index(name), 0)
                SLO_ACTUATIONS.labels("follow_shed", name).inc()
                changed = True
        for name in sorted(self._applied - want):
            if name in names and names.index(name) != self._fetch_sched.DEMAND:
                self.gate.set_lane_cap(names.index(name), None)
                SLO_ACTUATIONS.labels("follow_restore", name).inc()
                changed = True
        self._applied = {n for n in want if n in names}
        return changed

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_secs):
            self.poll_once()

    def start(self) -> None:
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="ntpu-slo-follow", daemon=True
            )
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)
        # Never leave lanes shed behind a dead follower.
        names = self._fetch_sched.LANE_NAMES
        for name in self._applied:
            self.gate.set_lane_cap(names.index(name), None)
        self._applied.clear()


def resolve_slo_actuation() -> tuple[bool, list[str], float]:
    """(actuate, shed_lanes, restore_burn) from ``NTPU_SLO_ACTUATE`` /
    ``NTPU_SLO_SHED_LANES`` / ``NTPU_SLO_RESTORE_BURN`` env over the
    ``[slo]`` section."""
    actuate = False
    lanes = ["peer_serve", "prefetch", "readahead"]
    restore = 1.0
    try:
        from nydus_snapshotter_tpu_torch.config import config as _cfg

        sc = _cfg.get_global_config().slo
        actuate = bool(sc.actuate)
        if sc.shed_lanes:
            lanes = list(sc.shed_lanes)
        restore = float(sc.restore_burn)
    except Exception:
        pass
    env = os.environ.get("NTPU_SLO_ACTUATE", "")
    if env:
        actuate = env not in ("0", "off", "false")
    env_lanes = os.environ.get("NTPU_SLO_SHED_LANES", "")
    if env_lanes:
        lanes = [p.strip() for p in env_lanes.split(",") if p.strip()]
    try:
        restore = float(os.environ["NTPU_SLO_RESTORE_BURN"])
    except (KeyError, ValueError):
        pass
    return actuate, lanes, max(0.0, restore)


def build_actuator(engine: SloEngine, gate=None, clock=time.monotonic):
    """The config-resolved actuator for the fleet plane, or None when
    ``[slo] actuate`` is off (the engine then only observes, the
    pre-actuation behavior)."""
    actuate, lanes, restore = resolve_slo_actuation()
    if not actuate:
        return None
    try:
        return SloActuator(
            engine, gate=gate, shed_lanes=lanes, restore_burn=restore, clock=clock
        )
    except SloSpecError as e:
        logger.warning("slo actuation disabled: %s", e)
        return None


# ---------------------------------------------------------------------------
# Config resolution (env > [slo] config > defaults)
# ---------------------------------------------------------------------------


def resolve_slo_objectives() -> tuple[bool, float, list[SloObjective]]:
    """(enabled, eval interval, objectives) from ``NTPU_SLO*`` env over
    the ``[slo]`` section. Malformed objective tables are skipped loudly:
    a typo in one objective must not take the others (or the process)
    down."""
    enabled = False
    interval = 10.0
    raw: list[dict] = []
    try:
        from nydus_snapshotter_tpu_torch.config import config as _cfg

        sc = _cfg.get_global_config().slo
        enabled = bool(sc.enable)
        interval = float(sc.eval_interval_secs)
        raw = list(sc.objectives)
    except Exception:
        pass
    env = os.environ.get("NTPU_SLO", "")
    if env:
        enabled = env not in ("0", "off", "false")
    try:
        interval = float(os.environ["NTPU_SLO_EVAL_INTERVAL_SECS"])
    except (KeyError, ValueError):
        pass
    env_obj = os.environ.get("NTPU_SLO_OBJECTIVES", "")
    if env_obj:
        try:
            raw = json.loads(env_obj)
        except ValueError:
            logger.warning("ignoring unparseable NTPU_SLO_OBJECTIVES")
    objectives = []
    for d in raw:
        try:
            objectives.append(SloObjective.from_dict(dict(d)))
        except SloSpecError as e:
            logger.warning("skipping slo objective: %s", e)
    return enabled, max(0.1, interval), objectives
