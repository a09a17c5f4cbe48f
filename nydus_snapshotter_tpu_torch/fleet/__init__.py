"""Fleet observability plane: member registry + the `/api/v1/fleet/*`
surface on the system controller.

The deployment is multi-process by design — one snapshotter drives many
daemon processes over UDS APIs, plus standalone dict services and peer
chunk servers. Each process self-registers with the system controller
(``POST /api/v1/fleet/members`` over the controller UDS, address from
``[fleet] controller`` / ``NTPU_FLEET_CONTROLLER`` — the env is how the
address reaches spawned daemons), and the controller's
:class:`FleetPlane` bundles the three consumers of that registry:

- :class:`~nydus_snapshotter_tpu_torch.metrics.federation.FleetFederator`
  (``/api/v1/fleet/metrics`` + the health scoreboard),
- :class:`~nydus_snapshotter_tpu_torch.trace.aggregate.FleetTraceCollector`
  (``/api/v1/fleet/traces`` — the cluster-merged Chrome trace),
- :class:`~nydus_snapshotter_tpu_torch.metrics.slo.SloEngine`
  (``/api/v1/fleet/slo`` — objectives, budgets, breach events).

``tools/ntpuctl.py`` is the operator CLI over this surface.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional
from urllib.parse import parse_qs, urlparse

from nydus_snapshotter_tpu_torch import failpoint
from nydus_snapshotter_tpu_torch.analysis import runtime as _an
from nydus_snapshotter_tpu_torch.config.config import global_section
from nydus_snapshotter_tpu_torch.metrics import federation as _fed
from nydus_snapshotter_tpu_torch.metrics import registry as _metrics
from nydus_snapshotter_tpu_torch.metrics import slo as _slo
from nydus_snapshotter_tpu_torch.trace import aggregate as _agg
from nydus_snapshotter_tpu_torch.utils import udshttp

logger = logging.getLogger(__name__)

MEMBERS_PATH = "/api/v1/fleet/members"
PROVENANCE_PATH = "/api/v1/provenance"

__all__ = [
    "FleetPlane",
    "FleetRegistry",
    "FleetRuntimeConfig",
    "Member",
    "annotate_self",
    "build_plane",
    "deregister_self",
    "register_self",
    "resolve_fleet_config",
]


# ---------------------------------------------------------------------------
# Config resolution (env > [fleet] config > defaults)
# ---------------------------------------------------------------------------


@dataclass
class FleetRuntimeConfig:
    enable: bool = False
    scrape_interval_secs: float = 15.0
    stale_after_secs: float = 45.0
    scoreboard_max_age_secs: float = 5.0
    controller: str = ""
    member_name: str = ""


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ[name])
    except (KeyError, ValueError):
        return default


def resolve_fleet_config() -> FleetRuntimeConfig:
    cfg = FleetRuntimeConfig()
    fc = global_section("fleet")
    if fc is not None:
        cfg.enable = bool(fc.enable)
        cfg.scrape_interval_secs = float(fc.scrape_interval_secs)
        cfg.stale_after_secs = float(fc.stale_after_secs)
        cfg.scoreboard_max_age_secs = float(fc.scoreboard_max_age_secs)
        cfg.controller = fc.controller
    env = os.environ.get("NTPU_FLEET", "")
    if env:
        cfg.enable = env not in ("0", "off", "false")
    cfg.controller = os.environ.get("NTPU_FLEET_CONTROLLER", cfg.controller)
    cfg.member_name = os.environ.get("NTPU_FLEET_MEMBER", "")
    cfg.scrape_interval_secs = max(
        0.05, _env_float("NTPU_FLEET_SCRAPE_INTERVAL_SECS", cfg.scrape_interval_secs)
    )
    cfg.stale_after_secs = max(
        0.05, _env_float("NTPU_FLEET_STALE_AFTER_SECS", cfg.stale_after_secs)
    )
    cfg.scoreboard_max_age_secs = max(
        0.0,
        _env_float("NTPU_FLEET_SCOREBOARD_MAX_AGE_SECS", cfg.scoreboard_max_age_secs),
    )
    return cfg


# ---------------------------------------------------------------------------
# Member registry
# ---------------------------------------------------------------------------


@dataclass
class Member:
    name: str
    component: str  # snapshotter | daemon | peer | dict
    address: str  # UDS path or host:port ("" for the local process)
    pid: int
    registered_at: float = 0.0
    local: bool = False
    extra: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "component": self.component,
            "address": self.address,
            "pid": self.pid,
            "registered_at": self.registered_at,
            "local": self.local,
            **({"extra": self.extra} if self.extra else {}),
        }


class FleetRegistry:
    """Thread-safe name → :class:`Member` table on the controller.
    Re-registration under the same name replaces (latest wins — a
    restarted daemon re-registers with a fresh pid)."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._lock = _an.make_lock("fleet.registry")
        self._members_shared = _an.shared("fleet.registry.members")
        self._members: dict[str, Member] = {}

    def register(self, member: Member) -> Member:
        member.registered_at = self._clock()
        with self._lock:
            self._members_shared.write()
            self._members[member.name] = member
        logger.info(
            "fleet member registered: %s (%s, pid %d, %s)",
            member.name, member.component, member.pid, member.address or "local",
        )
        return member

    def deregister(self, name: str) -> bool:
        with self._lock:
            self._members_shared.write()
            return self._members.pop(name, None) is not None

    def members(self) -> list[Member]:
        with self._lock:
            self._members_shared.read()
            return sorted(self._members.values(), key=lambda m: m.name)

    def get(self, name: str) -> Optional[Member]:
        with self._lock:
            self._members_shared.read()
            return self._members.get(name)

    def annotate(self, name: str, key: str, value) -> bool:
        """Merge one ``extra`` key into a member's record in place."""
        with self._lock:
            self._members_shared.write()
            member = self._members.get(name)
            if member is None:
                return False
            member.extra = {**member.extra, key: value}
            return True


# ---------------------------------------------------------------------------
# The plane: registry + federator + collector + SLO engine + HTTP surface
# ---------------------------------------------------------------------------


class FleetPlane:
    """Everything the controller mounts under ``/api/v1/fleet``.

    ``handle()`` is transport-agnostic (the DictService split), so the
    system controller routes to it without this module owning a server.
    """

    def __init__(
        self,
        registry: Optional[FleetRegistry] = None,
        metrics_server=None,
        cfg: Optional[FleetRuntimeConfig] = None,
        slo_objectives: Optional[list] = None,
        slo_source=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.cfg = cfg or resolve_fleet_config()
        self.registry = registry or FleetRegistry(clock=clock)
        self._metrics_server = metrics_server
        self.federator = _fed.FleetFederator(
            self.registry.members,
            self._local_metrics,
            stale_after_secs=self.cfg.stale_after_secs,
            clock=clock,
        )
        self.collector = _agg.FleetTraceCollector(self.registry.members)
        if slo_objectives is None:
            _, _, slo_objectives = _slo.resolve_slo_objectives()
        self.slo = _slo.SloEngine(
            slo_objectives,
            source=slo_source
            or _slo.federated_source(self.federator, self.registry.members),
            clock=clock,
        )
        # Close the loop: burn-rate breaches actuate the controller
        # process's admission gate (shed non-demand lanes before demand
        # suffers; restore on budget recovery). Member processes follow
        # the published actuation state (metrics/slo.SloActuationFollower).
        self.actuator = _slo.build_actuator(self.slo, clock=clock)
        # Optional ha.placement.PlacementController: dict-shard placement
        # + automatic replica promotion, ticked by the scrape loop and
        # published on /api/v1/fleet/placement.
        self.placement = None
        # Optional metrics/slo.SloScaleUp: the spawn/retire half of
        # actuation, ticked after the shed actuator so a burn breach
        # observed this round stands the scale-up policy down.
        self.scaleup = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def attach_placement(self, controller) -> None:
        """Mount a dict-HA placement controller on this plane (ticked by
        the scrape loop, served on ``/api/v1/fleet/placement``)."""
        self.placement = controller

    def attach_scaleup(self, policy) -> None:
        """Mount a capacity scale-up policy (metrics/slo.SloScaleUp):
        ticked by the scrape loop, published under ``scaleup`` on
        ``/api/v1/fleet/slo``."""
        self.scaleup = policy

    def _local_metrics(self) -> str:
        """The controller process's own exposition, through the cached
        collect_once snapshot when a metrics server runs (one collection
        round per max-age window, never inline per request)."""
        if self._metrics_server is not None:
            text, _age = self._metrics_server.snapshot(
                self.cfg.scoreboard_max_age_secs
            )
            return text
        return _metrics.default_registry.render()

    def register_local(self, name: str, component: str = "snapshotter") -> Member:
        # Claim this process's one member slot so a dict service or peer
        # server started later in the SAME process doesn't register the
        # process a second time over HTTP.
        _claim_self(name, registry=self.registry)
        return self.registry.register(
            Member(name=name, component=component, address="", pid=os.getpid(),
                   local=True)
        )

    # -- background loop ------------------------------------------------------

    def _loop(self) -> None:
        # First round immediately: ntpuctl against a freshly-started
        # controller should see members, not an empty first interval.
        while True:
            try:
                self.federator.scrape_once()
                self.slo.tick()
                if self.actuator is not None:
                    self.actuator.tick()
                if self.scaleup is not None:
                    self.scaleup.tick()
                if self.placement is not None:
                    self.placement.tick()
            except Exception:  # noqa: BLE001 — the loop must survive anything
                logger.exception("fleet scrape round failed")
            if self._stop.wait(self.cfg.scrape_interval_secs):
                return

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="ntpu-fleet-scrape", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)

    # -- HTTP surface ---------------------------------------------------------

    def handle(
        self, method: str, path: str, headers, body: bytes
    ) -> tuple[int, str, bytes]:
        """(status, content type, payload) for ``/api/v1/fleet/...``."""
        parsed = urlparse(path)
        q = parse_qs(parsed.query)
        route = parsed.path
        try:
            if route == MEMBERS_PATH:
                if method == "GET":
                    return self._json(
                        [m.to_dict() for m in self.registry.members()]
                    )
                if method == "POST":
                    d = json.loads(body or b"{}")
                    name = str(d.get("name", ""))
                    if not name:
                        return self._json({"message": "member name required"}, 400)
                    self.registry.register(
                        Member(
                            name=name,
                            component=str(d.get("component", "daemon")),
                            address=str(d.get("address", "")),
                            pid=int(d.get("pid", 0)),
                            extra=dict(d.get("extra", {})),
                        )
                    )
                    return self._json({"registered": name})
                if method == "DELETE":
                    name = q.get("name", [""])[0]
                    return self._json(
                        {"deregistered": self.registry.deregister(name)}
                    )
            if route == "/api/v1/fleet/placement/report" and method == "POST":
                # External health signal (a peer/client that watched a
                # dict member's socket die) — feeds promotion faster than
                # scrape staleness.
                if self.placement is None:
                    return self._json({"message": "no placement plane"}, 404)
                d = json.loads(body or b"{}")
                name = str(d.get("name", ""))
                if not name:
                    return self._json({"message": "member name required"}, 400)
                self.placement.report_down(name, source=str(d.get("source", "")))
                return self._json({"reported": name})
            if route == "/api/v1/fleet/placement/demote" and method == "POST":
                # Planned primary handoff (ntpuctl dict demote <shard>):
                # drain, wait for replica catch-up, promote, THEN demote.
                if self.placement is None:
                    return self._json({"message": "no placement plane"}, 404)
                d = json.loads(body or b"{}")
                try:
                    shard = int(d.get("shard", -1))
                except (TypeError, ValueError):
                    return self._json({"message": "shard must be an int"}, 400)
                try:
                    event = self.placement.demote(
                        shard, timeout_s=float(d.get("timeout_s", 10.0))
                    )
                except ValueError as e:
                    return self._json({"message": str(e)}, 400)
                except RuntimeError as e:
                    return self._json({"message": str(e)}, 409)
                return self._json(event)
            if method != "GET":
                return self._json({"message": "no such endpoint"}, 404)
            if route == "/api/v1/fleet/placement":
                if self.placement is None:
                    return self._json({"message": "no placement plane"}, 404)
                return self._json(self.placement.map())
            if route == "/api/v1/fleet/metrics":
                return 200, "text/plain; version=0.0.4", self.federator.render().encode()
            if route == "/api/v1/fleet/scoreboard":
                board = self.federator.scoreboard()
                board["slo"] = self.slo.status()
                return self._json(board)
            if route == "/api/v1/fleet/traces":
                doc = self.collector.collect(q.get("trace_id", [""])[0])
                return self._json(doc)
            if route == "/api/v1/fleet/slo":
                status = self.slo.status()
                if self.actuator is not None:
                    status["actuation"] = self.actuator.state()
                if self.scaleup is not None:
                    status["scaleup"] = self.scaleup.state()
                return self._json(status)
            if route == "/api/v1/fleet/provenance":
                return self._json(self.collect_provenance())
            if route == "/api/v1/fleet/peers":
                return self._json(self.peer_listing())
            return self._json({"message": "no such endpoint"}, 404)
        except Exception as e:  # noqa: BLE001 — the serve loop stays up
            logger.exception("fleet route %s failed", route)
            return self._json({"message": str(e)}, 500)

    def collect_provenance(self) -> dict:
        """Every member's ``/api/v1/provenance`` snapshot joined into one
        fleet view: per-node snapshots plus a cluster-wide cause rollup.
        Same degradation contract as the trace collector — a member that
        dies mid-pull is counted and skipped, the view still serves."""
        t0 = time.perf_counter()
        nodes: dict[str, dict] = {}
        errors = 0
        for member in self.registry.members():
            try:
                failpoint.hit("fleet.collect")
                if member.local:
                    from nydus_snapshotter_tpu_torch.provenance import (
                        heat_counters,
                        snapshot as _prov_snapshot,
                    )

                    snap = dict(_prov_snapshot(), heat=heat_counters())
                else:
                    snap = udshttp.get_json(
                        member.address, PROVENANCE_PATH, timeout=5.0
                    )
                nodes[member.name] = snap
            except Exception as e:  # noqa: BLE001 — degradation is the contract
                errors += 1
                _fed.FLEET_SCRAPE_ERRORS.labels(member.name).inc()
                logger.warning(
                    "fleet provenance pull of %s failed: %s", member.name, e
                )
        causes: dict[str, dict] = {}
        totals = {"fetched_bytes": 0, "read_bytes": 0, "untagged_bytes": 0}
        for snap in nodes.values():
            for key in totals:
                totals[key] += int(snap.get(key, 0) or 0)
            for cause, c in (snap.get("causes") or {}).items():
                agg = causes.setdefault(
                    cause, {"bytes": 0, "read_bytes": 0, "wasted_bytes": 0}
                )
                for key in agg:
                    agg[key] += int(c.get(key, 0) or 0)
        for agg in causes.values():
            agg["accuracy"] = (
                round(agg["read_bytes"] / agg["bytes"], 4) if agg["bytes"] else 1.0
            )
        return {
            "nodes": nodes,
            "causes": dict(sorted(causes.items())),
            **totals,
            "fleet": {
                "members": len(nodes),
                "errors": errors,
                "collect_ms": round((time.perf_counter() - t0) * 1000.0, 3),
            },
        }

    def peer_listing(self) -> list[dict]:
        """Dynamic peer discovery: every member with a peer serve address
        (component ``peer``, or any member annotated ``peer_listen``),
        flagged with the federator's liveness so routers drop crashed
        peers without waiting for a deregistration that never came."""
        liveness = self.federator.liveness()
        rows = []
        for m in self.registry.members():
            addr = m.extra.get("peer_listen", "") or (
                m.address if m.component == "peer" else ""
            )
            if not addr:
                continue
            live = liveness.get(m.name)
            rows.append(
                {
                    "name": m.name,
                    "component": m.component,
                    "address": addr,
                    "pid": m.pid,
                    # Never scraped yet (racing the first round) counts as
                    # up: a joining peer must not be shunned at birth.
                    "up": True if live is None else bool(live["up"]),
                    "stale": False if live is None else bool(live["stale"]),
                    # rack:zone:region label for tiered routing ("" = the
                    # member routes flat): daemon/peer.py PeerMembership
                    # feeds this straight into PeerRouter.locality_map.
                    "locality": str(m.extra.get("locality", "")),
                }
            )
        return rows

    @staticmethod
    def _json(payload, status: int = 200) -> tuple[int, str, bytes]:
        return status, "application/json", json.dumps(payload).encode()


def build_plane(metrics_server=None) -> Optional[FleetPlane]:
    """The config-resolved plane for cmd/snapshotter.py, or None when
    ``[fleet]`` is off."""
    cfg = resolve_fleet_config()
    if not cfg.enable:
        return None
    return FleetPlane(metrics_server=metrics_server, cfg=cfg)


# ---------------------------------------------------------------------------
# Member-side self-registration (daemon / peer / dict processes)
# ---------------------------------------------------------------------------

_self_lock = _an.make_lock("fleet.self")
_self_member: Optional[dict] = None


def _claim_self(name: str, registry: Optional[FleetRegistry] = None) -> bool:
    """Take this process's member slot without an HTTP registration (the
    controller process registers itself locally; ``registry`` lets
    annotate_self update the local record in place)."""
    global _self_member
    with _self_lock:
        if _self_member is not None:
            return False
        _self_member = {"name": name, "controller": "", "registry": registry}
        return True


def annotate_self(key: str, value) -> bool:
    """Merge one ``extra`` key into this process's member record and
    re-push the registration (registry replace-by-name). This is how a
    process that registered under one role advertises another it later
    grew — e.g. a daemon member annotating ``peer_listen`` when its peer
    chunk server starts, which the ``/api/v1/fleet/peers`` discovery
    route lists for the cluster. No-op (False) when this process never
    registered at all. The controller process itself (a LOCAL member)
    annotates its registry record in place."""
    with _self_lock:
        member = _self_member
        if member is None:
            return False
        if not member.get("controller"):
            registry = member.get("registry")
            if registry is not None:
                return registry.annotate(member["name"], key, value)
            return False
        payload = member.get("payload")
        if payload is None:
            return False
        payload.setdefault("extra", {})[key] = value
        payload = dict(payload)

    def push():
        for _ in range(5):
            try:
                udshttp.post_json(member["controller"], MEMBERS_PATH, payload)
                return
            except Exception:  # noqa: BLE001 — retry briefly
                time.sleep(0.25)

    threading.Thread(target=push, name="ntpu-fleet-annotate", daemon=True).start()
    return True


def register_self(
    component: str,
    address: str,
    name: str = "",
    controller: str = "",
    retries: int = 20,
    retry_delay_s: float = 0.25,
    extra: Optional[dict] = None,
) -> bool:
    """Register this process with the controller resolved from
    ``controller`` / env / config; returns whether a registration was
    initiated. Idempotent per process: the first role wins (a daemon
    that also runs a peer server is ONE member — one ring, one registry
    — and must not be scraped twice). Registration retries briefly in
    the background so a member racing the controller's startup still
    lands."""
    global _self_member
    cfg = resolve_fleet_config()
    controller = controller or cfg.controller
    if not controller or controller == address:
        return False
    name = name or cfg.member_name or f"{component}-{os.getpid()}"
    payload = {
        "name": name,
        "component": component,
        "address": address,
        "pid": os.getpid(),
    }
    if extra:
        payload["extra"] = dict(extra)
    with _self_lock:
        if _self_member is not None:
            return False
        _self_member = {"name": name, "controller": controller, "payload": payload}

    def push():
        for _ in range(max(1, retries)):
            try:
                udshttp.post_json(controller, MEMBERS_PATH, payload)
                return
            except Exception:  # noqa: BLE001 — retry until the budget ends
                time.sleep(retry_delay_s)
        logger.warning(
            "fleet registration of %s with %s never succeeded", name, controller
        )

    threading.Thread(target=push, name="ntpu-fleet-register", daemon=True).start()
    return True


def deregister_self() -> None:
    """Best-effort deregistration on shutdown (a crash skips it — the
    controller's staleness flagging covers that path)."""
    global _self_member
    with _self_lock:
        member, _self_member = _self_member, None
    if member is None or not member["controller"]:
        return
    try:
        udshttp.request(
            member["controller"],
            f"{MEMBERS_PATH}?name={member['name']}",
            method="DELETE",
            timeout=2.0,
        )
    except Exception:  # noqa: BLE001 — shutdown path
        pass
