"""The member half of the fleet plane: this process's registration with
the fleet controller, as the reference package's ``fleet/`` has it.

A standalone dict-service process (``DictService.run``,
``ha/runner.py``) self-registers with the controller
(``POST /api/v1/fleet/members`` over the controller's unix socket,
address from ``[fleet] controller`` / ``NTPU_FLEET_CONTROLLER``), which
is how the placement controller (ha/placement.py) finds its ``dict``
members. Carried here: :class:`FleetRuntimeConfig` and
:func:`resolve_fleet_config`, :class:`Member`, :func:`register_self`,
:func:`annotate_self` and :func:`deregister_self`. The controller side
(``FleetPlane``, ``FleetRegistry``, metrics federation, SLOs, trace
aggregation) is not ported yet.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from nydus_snapshotter_tpu_torch.analysis import runtime as _an
from nydus_snapshotter_tpu_torch.config.config import global_section
from nydus_snapshotter_tpu_torch.utils import udshttp

logger = logging.getLogger(__name__)

MEMBERS_PATH = "/api/v1/fleet/members"

__all__ = [
    "FleetRuntimeConfig",
    "Member",
    "annotate_self",
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
# Member record
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


# ---------------------------------------------------------------------------
# Member-side self-registration
# ---------------------------------------------------------------------------

_self_lock = _an.make_lock("fleet.self")
_self_member: Optional[dict] = None


def annotate_self(key: str, value) -> bool:
    """Merge one ``extra`` key into this process's member record and
    re-push the registration (registry replace-by-name). This is how a
    process that registered under one role advertises another it later
    grew — e.g. a daemon member annotating ``peer_listen`` when its peer
    chunk server starts, which the ``/api/v1/fleet/peers`` discovery
    route lists for the cluster. No-op (False) when this process never
    registered at all."""
    with _self_lock:
        member = _self_member
        if member is None:
            return False
        payload = member["payload"]
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
