"""Placement controller: shard -> primary + R replicas over live fleet
members, with sticky primaries and automatic promotion.

The fleet plane (``fleet.FleetPlane``) ticks it from its scrape loop on
the system controller. Its inputs are injected: ``members_fn`` returns the
fleet registry's members (objects with ``name``, ``component``,
``address``, ``pid`` and ``extra``), ``liveness_fn`` the scrape liveness
by name (``{"up": bool, "stale": bool}``), and :meth:`report_down` takes
peer-reported down signals. ``engine`` is anything with
``record_event(kind, **fields)`` (``metrics.slo.SloEngine``).

Assignment rules (the minimal-churn contract):

- candidates for shard ``s`` are ranked by rendezvous hash
  ``blake2b(f"{s}|{member}")``: a member join/leave only disturbs the
  assignments where its rank lands in the top ``1 + R``;
- the primary is sticky: a live primary is never displaced by ranking;
- a dead/stale/reported-down primary is replaced by the most-caught-up
  live replica (``/api/v1/ha/status`` applied-chunk totals), promoted over
  its ``/api/v1/ha/promote`` route; the placement epoch bumps, the event
  goes to ``engine`` and ``ntpu_dict_ha_promotions_total``;
- replica slots refill from the live rendezvous ranking (primary
  excluded).

Role assignments are pushed to members' ``/api/v1/ha/configure`` after
every map change and re-pushed until acknowledged (and again when a
member re-registers with a fresh pid). All member RPCs happen outside the
controller's lock.

:meth:`PlacementController.demote` runs a planned primary handoff (drain
-> replica catch-up to the frozen journal head -> promote -> the demoted
member re-joins as replica), and :meth:`PlacementController.scale_replicas`
adjusts the per-shard replica target.
"""

from __future__ import annotations

import hashlib
import logging
import time
from collections import deque
from typing import Callable, Optional

from nydus_snapshotter_tpu_torch import failpoint, trace
from nydus_snapshotter_tpu_torch import ha as _ha
from nydus_snapshotter_tpu_torch.analysis import runtime as _an
from nydus_snapshotter_tpu_torch.utils import udshttp

logger = logging.getLogger(__name__)

# A peer-reported down signal outlives scrape liveness for this long; a
# successful scrape after the window clears it.
REPORT_COOLDOWN_SECS = 10.0


def _rank(shard: int, names: list[str]) -> list[str]:
    """Rendezvous ranking of ``names`` for one shard (desc by score)."""
    def score(name: str) -> int:
        h = hashlib.blake2b(f"{shard}|{name}".encode(), digest_size=8)
        return int.from_bytes(h.digest(), "little")

    return sorted(names, key=lambda n: (-score(n), n))


class ShardAssignment:
    """One shard's current placement."""

    __slots__ = ("shard", "primary", "replicas")

    def __init__(self, shard: int):
        self.shard = shard
        self.primary: str = ""
        self.replicas: list[str] = []

    def to_dict(self, addr_of: Callable[[str], str]) -> dict:
        return {
            "shard": self.shard,
            "primary": {"name": self.primary, "address": addr_of(self.primary)},
            "replicas": [
                {"name": r, "address": addr_of(r)} for r in self.replicas
            ],
        }


class PlacementController:
    def __init__(
        self,
        members_fn: Callable[[], list],
        liveness_fn: Callable[[], dict],
        shards: int = 1,
        replicas: int = 1,
        engine=None,
        clock: Callable[[], float] = time.monotonic,
        rpc_timeout_s: float = 2.0,
        keep_events: int = 32,
    ):
        self._members_fn = members_fn
        self._liveness_fn = liveness_fn
        self.shards = max(1, int(shards))
        self.replicas = max(0, int(replicas))
        self._engine = engine  # SloEngine (promotion events surface)
        self._clock = clock
        self._rpc_timeout_s = rpc_timeout_s
        self._lock = _an.make_lock("ha.placement")
        self._state_shared = _an.shared("ha.placement.state")
        self.epoch = 0
        self._assign = [ShardAssignment(s) for s in range(self.shards)]
        self._addr: dict[str, str] = {}
        self._pids: dict[str, int] = {}
        self._reports: dict[str, float] = {}
        # member -> last acked (role, upstream, shard, epoch, pid). The
        # pid is part of the key: a member that RESTARTED under the same
        # name re-registered with a fresh pid and lost its role — it
        # must be re-pushed or it would sit unassigned, rejecting writes.
        self._pushed: dict[str, tuple] = {}
        self._events: deque = deque(maxlen=keep_events)
        self.promotions = 0

    # -- health inputs -------------------------------------------------------

    def report_down(self, name: str, source: str = "") -> None:
        """External down signal (a peer/client that watched the member's
        socket die) — faster than waiting out scrape staleness."""
        now = self._clock()
        with self._lock:
            self._state_shared.write()
            self._reports[name] = now
        logger.warning(
            "dict-ha: member %s reported down%s", name,
            f" by {source}" if source else "",
        )

    def _live_members(self) -> tuple[list[str], dict[str, str]]:
        """(live dict-member names, name -> address) right now."""
        liveness = self._liveness_fn()
        now = self._clock()
        with self._lock:
            self._state_shared.read()
            reports = dict(self._reports)
        names, addr = [], {}
        pids: dict[str, int] = {}
        for m in self._members_fn():
            # Candidates: dedicated dict members, plus any member
            # advertising a dict socket via the ``dict_listen`` extra
            # (a snapshotter whose one member slot is already taken —
            # the peer_listen pattern).
            address = m.extra.get("dict_listen", "") or (
                m.address if m.component == "dict" else ""
            )
            if not address:
                continue
            addr[m.name] = address
            pids[m.name] = m.pid
            live = liveness.get(m.name)
            # Never scraped yet counts as up (a joining member must not
            # be shunned at birth — the peer_listing rule).
            up = True if live is None else bool(live["up"]) and not live["stale"]
            reported = reports.get(m.name)
            if reported is not None:
                if now - reported < REPORT_COOLDOWN_SECS:
                    up = False
                elif live is not None and live["up"]:
                    with self._lock:
                        self._state_shared.write()
                        self._reports.pop(m.name, None)
            if up:
                names.append(m.name)
        with self._lock:
            self._state_shared.write()
            self._pids = pids
        return names, addr

    # -- member RPCs (always outside the lock) -------------------------------

    def _ha_status(self, address: str) -> Optional[dict]:
        try:
            return udshttp.get_json(
                address, "/api/v1/ha/status", timeout=self._rpc_timeout_s
            )
        except Exception:  # noqa: BLE001 — a dead member is an absent vote
            return None

    def _applied_chunks(self, status: Optional[dict]) -> int:
        if not status:
            return -1
        repl = status.get("replication", {}) or {}
        return sum(
            int(ns.get("chunks", 0))
            for ns in (repl.get("namespaces", {}) or {}).values()
        )

    def _push_role(self, name: str, address: str, payload: dict) -> bool:
        try:
            udshttp.post_json(
                address, "/api/v1/ha/configure", payload,
                timeout=self._rpc_timeout_s,
            )
            return True
        except Exception:  # noqa: BLE001 — retried next tick
            logger.warning("dict-ha: role push to %s (%s) failed", name, address)
            return False

    # -- the tick ------------------------------------------------------------

    def tick(self) -> bool:
        """One placement round; returns whether the map changed.

        Decides on a snapshot (member RPCs outside the lock), applies
        under the lock, then pushes roles/promotions — so ``map()``
        readers never observe a half-updated assignment."""
        failpoint.hit("ha.place")
        live, addr = self._live_members()
        with self._lock:
            self._state_shared.read()
            snapshot = [(a.shard, a.primary, list(a.replicas)) for a in self._assign]
        changed = False
        promoted: list[dict] = []
        # A member holds AT MOST ONE slot: a replica tails exactly one
        # upstream, and a shard primary must never be pushed a replica
        # role for another shard (the role is per-member). Primaries are
        # decided first so replica refills can't steal a primary seat;
        # only when shards outnumber live members does a member serve as
        # primary of more than one shard (degraded but role-consistent).
        used: set[str] = set()
        primaries: list[str] = []
        for shard, primary, replicas in snapshot:
            order = _rank(shard, live)
            if primary and primary in live:
                pass  # sticky primary
            elif primary and replicas:
                # Primary is dead/stale: promote the most-caught-up live
                # replica (status RPCs happen outside the lock).
                candidates = [r for r in replicas if r in live and r not in used]
                if candidates:
                    scored = [
                        (self._applied_chunks(self._ha_status(addr[r])), r)
                        for r in candidates
                    ]
                    scored.sort(key=lambda t: (-t[0], t[1]))
                    promoted.append(
                        {
                            "shard": shard,
                            "from": primary,
                            "to": scored[0][1],
                            "applied_chunks": scored[0][0],
                        }
                    )
                    primary = scored[0][1]
                    changed = True
                # No live replica: hold the assignment — clients keep
                # failing loudly, and the next live replica wins.
            elif not primary and order:
                avail = [n for n in order if n not in used]
                primary = avail[0] if avail else order[0]
                changed = True
            if primary:
                used.add(primary)
            primaries.append(primary)
        decided: list[tuple[int, str, list[str]]] = []
        for (shard, _old_primary, replicas), primary in zip(snapshot, primaries):
            order = _rank(shard, live)
            want = [n for n in order if n != primary and n not in used][
                : self.replicas
            ]
            if want != replicas and (primary or want):
                replicas = want
                changed = True
            used.update(want)
            decided.append((shard, primary, replicas))
        with self._lock:
            self._state_shared.write()
            self._addr = dict(addr)
            for a, (_s, primary, replicas) in zip(self._assign, decided):
                a.primary = primary
                a.replicas = replicas
        for event in promoted:
            failpoint.hit("ha.promote")
            with trace.span(
                "ha.promote", shard=str(event["shard"]), member=event["to"]
            ):
                ok = self._promote_member(event["to"], addr.get(event["to"], ""))
            event["acked"] = ok
            _ha.PROMOTIONS.labels(str(event["shard"])).inc()
            logger.warning(
                "dict-ha: promoted %s to primary of shard %d (was %s, "
                "applied_chunks=%d, acked=%s)",
                event["to"], event["shard"], event["from"],
                event["applied_chunks"], ok,
            )
            if self._engine is not None:
                self._engine.record_event(
                    "dict_ha_promotion",
                    shard=event["shard"],
                    promoted=event["to"],
                    previous=event["from"],
                    applied_chunks=event["applied_chunks"],
                )
        if changed:
            with self._lock:
                self._state_shared.write()
                self.epoch += 1
                self.promotions += len(promoted)
                for event in promoted:
                    self._events.append(
                        {"kind": "promotion", "at": self._clock(), **event}
                    )
                epoch = self.epoch
            _ha.PLACEMENT_EPOCH.set(epoch)
        self._push_assignments(addr)
        return changed

    def scale_replicas(self, delta: int, max_replicas: int = 8) -> int:
        """Adjust the per-shard replica target (the dict-replica half of
        SLO scale-up actuation: spawn -> +1, retire -> -1). Returns the
        new target; the next tick refills/shrinks slots from the live
        rendezvous ranking."""
        with self._lock:
            self._state_shared.write()
            self.replicas = min(max_replicas, max(0, self.replicas + int(delta)))
            target = self.replicas
        logger.info("dict-ha: replica target scaled to %d", target)
        return target

    def demote(self, shard: int, timeout_s: float = 10.0,
               poll_s: float = 0.05) -> dict:
        """Planned primary demotion for one shard: drain, catch up, hand
        off, THEN demote — zero client-visible errors by construction.

        1. The primary is told to DRAIN (``/api/v1/ha/demote``): merges
           bounce 503 from here on, freezing the journal head, while
           writing clients park in their failover poll loop.
        2. Replicas are polled until one reaches the frozen head (equal
           applied-chunk totals — an exact condition, not a heuristic,
           because nothing can advance the head anymore).
        3. That replica is promoted (same RPC as crash promotion) and
           the map is re-pointed; the drained member is pushed a replica
           role of the successor (full resync — its tables are a foreign
           prefix once the successor accepts writes).

        If no replica catches up inside ``timeout_s`` the drain is
        ABORTED by re-promoting the drained primary — the shard never
        stays headless longer than the timeout.
        """
        if not 0 <= shard < self.shards:
            raise ValueError(f"shard {shard} out of range (0..{self.shards - 1})")
        with self._lock:
            self._state_shared.read()
            a = self._assign[shard]
            primary, replicas = a.primary, list(a.replicas)
            addr = dict(self._addr)
        if not primary or not addr.get(primary):
            raise ValueError(f"shard {shard} has no addressable primary")
        if not replicas:
            raise ValueError(f"shard {shard} has no replica to hand off to")
        primary_addr = addr[primary]
        udshttp.post_json(
            primary_addr, "/api/v1/ha/demote", {}, timeout=self._rpc_timeout_s
        )
        want = self._applied_chunks(self._ha_status(primary_addr))
        deadline = self._clock() + timeout_s
        best: Optional[tuple[int, str]] = None
        while want >= 0:
            scored = [
                (self._applied_chunks(self._ha_status(addr[r])), r)
                for r in replicas if addr.get(r)
            ]
            scored.sort(key=lambda t: (-t[0], t[1]))
            if scored and scored[0][0] >= want:
                best = scored[0]
                break
            if self._clock() >= deadline:
                break
            time.sleep(poll_s)
        if best is None:
            # Abort: hand the role straight back — clients were parked,
            # not failed, and resume against the same primary.
            self._promote_member(primary, primary_addr)
            raise RuntimeError(
                f"planned demotion of shard {shard} aborted: no replica "
                f"reached the journal head ({want} chunks) in {timeout_s}s"
            )
        applied, successor = best
        failpoint.hit("ha.promote")
        with trace.span(
            "ha.promote", shard=str(shard), member=successor, planned="true"
        ):
            acked = self._promote_member(successor, addr.get(successor, ""))
        event = {
            "kind": "planned_demotion",
            "at": self._clock(),
            "shard": shard,
            "from": primary,
            "to": successor,
            "applied_chunks": applied,
            "acked": acked,
        }
        with self._lock:
            self._state_shared.write()
            a = self._assign[shard]
            a.primary = successor
            a.replicas = [r for r in replicas if r != successor] + [primary]
            self.epoch += 1
            self.promotions += 1
            self._events.append(event)
            epoch = self.epoch
        _ha.PROMOTIONS.labels(str(shard)).inc()
        _ha.PLACEMENT_EPOCH.set(epoch)
        logger.warning(
            "dict-ha: planned demotion handed shard %d from %s to %s "
            "(applied_chunks=%d, acked=%s)",
            shard, primary, successor, applied, acked,
        )
        if self._engine is not None:
            self._engine.record_event(
                "dict_ha_planned_demotion",
                shard=shard, promoted=successor, previous=primary,
                applied_chunks=applied,
            )
        # The drained member's re-push as replica happens here (its
        # pushed-state key still holds the old primary tuple, so the
        # push is not suppressed).
        self._push_assignments(addr)
        return event

    def _promote_member(self, name: str, address: str) -> bool:
        if not address:
            return False
        try:
            udshttp.post_json(
                address, "/api/v1/ha/promote",
                {"epoch": self.epoch + 1},
                timeout=self._rpc_timeout_s,
            )
            return True
        except Exception:  # noqa: BLE001 — the role push below retries
            logger.warning("dict-ha: promote RPC to %s (%s) failed", name, address)
            return False

    def _push_assignments(self, addr: dict[str, str]) -> None:
        """Push each member's (role, upstream, shard) until acked."""
        with self._lock:
            self._state_shared.read()
            epoch = self.epoch
            roles: dict[str, tuple] = {}
            for a in self._assign:
                if a.primary:
                    roles[a.primary] = ("primary", "", a.shard)
                for r in a.replicas:
                    roles[r] = ("replica", addr.get(a.primary, ""), a.shard)
            pushed = dict(self._pushed)
            pids = dict(self._pids)
        for name, (role, upstream, shard) in roles.items():
            address = addr.get(name, "")
            want = (role, upstream, shard, epoch, pids.get(name, 0))
            if not address or pushed.get(name) == want:
                continue
            ok = self._push_role(
                name, address,
                {"role": role, "upstream": upstream, "shard": shard,
                 "epoch": epoch},
            )
            if ok:
                with self._lock:
                    self._state_shared.write()
                    self._pushed[name] = want

    # -- published surface ---------------------------------------------------

    def map(self) -> dict:
        """The ``/api/v1/fleet/placement`` payload."""
        with self._lock:
            self._state_shared.read()
            addr = dict(self._addr)
            return {
                "epoch": self.epoch,
                "shards": self.shards,
                "replicas": self.replicas,
                "promotions": self.promotions,
                "assignments": [
                    a.to_dict(lambda n: addr.get(n, "")) for a in self._assign
                ],
                "events": [dict(e) for e in self._events],
            }
