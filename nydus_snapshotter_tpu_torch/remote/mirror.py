"""Registry mirror failover routing with per-host health scoring.

Consumes the containerd-style per-registry mirror directories parsed by
:mod:`nydus_snapshotter_tpu_torch.config.mirrors` (``<dir>/<host>/hosts.toml``)
and keeps an in-process health score per mirror host: after
``failure_limit`` consecutive failures a mirror is put on cooldown for
``health_check_interval`` seconds and skipped by the candidate ordering
until the cooldown expires (reference mirrors_health.go semantics,
collapsed into the request path — no background prober needed for a
snapshotter-side transport).
"""

from __future__ import annotations

import threading
import time
import urllib.parse
from typing import Callable, Optional

from nydus_snapshotter_tpu_torch.config.daemonconfig import MirrorConfig
from nydus_snapshotter_tpu_torch.config.mirrors import load_mirrors_config


class HostHealth:
    """Consecutive-failure scorer with cooldown."""

    def __init__(
        self,
        failure_limit: int = 5,
        cooldown: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.failure_limit = max(1, int(failure_limit))
        self.cooldown = float(cooldown)
        self._clock = clock
        self.consecutive_failures = 0
        self.down_until = 0.0

    def available(self) -> bool:
        return self._clock() >= self.down_until

    def record_success(self) -> None:
        self.consecutive_failures = 0
        self.down_until = 0.0

    def record_failure(self) -> None:
        self.consecutive_failures += 1
        if self.consecutive_failures >= self.failure_limit:
            # Trip: cool down, then start a fresh count — a recovered
            # mirror gets a full failure budget after the cooldown.
            self.down_until = self._clock() + self.cooldown
            self.consecutive_failures = 0

    def mark_down(self, duration: Optional[float] = None) -> None:
        """Externally-sourced cooldown (e.g. the fleet registry flagging a
        member stale): trip immediately without burning the failure
        budget, so the host recovers the instant the source clears."""
        self.down_until = max(
            self.down_until,
            self._clock() + (self.cooldown if duration is None else duration),
        )
        self.consecutive_failures = 0


def split_mirror_host(mirror_host: str) -> tuple[str, bool]:
    """``https://mirror:5000`` → (netloc, plain_http)."""
    parsed = urllib.parse.urlsplit(mirror_host)
    if parsed.netloc:
        return parsed.netloc, parsed.scheme == "http"
    return mirror_host, False


class HostHealthRegistry:
    """Process-wide host → :class:`HostHealth` table.

    The converter transport (``remote/transport.Pool``), the lazy-read
    data plane (``daemon/blobcache.RegistryBlobFetcher``) and the peer
    chunk tier (``daemon/peer.PeerRouter``) all score hosts through ONE
    shared table, so a registry/mirror/peer demoted by any component is
    avoided by every other one. The first caller's limits stick for a
    host (limits are per-host deployment facts, not per-caller)."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._health: dict[str, HostHealth] = {}

    def health_for(
        self, host: str, failure_limit: int = 5, cooldown: float = 5.0
    ) -> HostHealth:
        with self._lock:
            h = self._health.get(host)
            if h is None:
                h = HostHealth(
                    failure_limit=failure_limit,
                    cooldown=cooldown,
                    clock=self._clock,
                )
                self._health[host] = h
            return h

    def health(self, host: str) -> Optional[HostHealth]:
        with self._lock:
            return self._health.get(host)

    def record(self, host: str, ok: bool) -> None:
        h = self.health_for(host)
        if ok:
            h.record_success()
        else:
            h.record_failure()

    def available(self, host: str) -> bool:
        return self.health_for(host).available()

    def snapshot(self) -> dict[str, dict]:
        with self._lock:
            return {
                host: {
                    "available": h.available(),
                    "consecutive_failures": h.consecutive_failures,
                    "down_until": h.down_until,
                }
                for host, h in self._health.items()
            }


_global_health = HostHealthRegistry()


def global_health_registry() -> HostHealthRegistry:
    """The one process-wide health table (see :class:`HostHealthRegistry`).
    Components with an injected test clock build private registries
    instead, so fake-clock tests never pollute the process table."""
    return _global_health


class MirrorRouter:
    """Orders mirror candidates per upstream registry host, health-aware."""

    def __init__(
        self,
        mirrors_config_dir: str = "",
        clock: Callable[[], float] = time.monotonic,
        health_registry: Optional["HostHealthRegistry"] = None,
    ):
        self.mirrors_config_dir = mirrors_config_dir
        self._clock = clock
        self._lock = threading.Lock()
        self._mirrors: dict[str, list[MirrorConfig]] = {}
        # Score through the process-wide table so the data plane sees the
        # same demotions; a custom clock (tests) gets a private table.
        if health_registry is not None:
            self._registry = health_registry
        elif clock is time.monotonic:
            self._registry = global_health_registry()
        else:
            self._registry = HostHealthRegistry(clock=clock)

    def mirrors_for(self, registry_host: str) -> list[MirrorConfig]:
        """Configured mirrors for ``registry_host`` (cached per host)."""
        if not self.mirrors_config_dir:
            return []
        with self._lock:
            if registry_host in self._mirrors:
                return self._mirrors[registry_host]
        mirrors = load_mirrors_config(self.mirrors_config_dir, registry_host)
        with self._lock:
            self._mirrors.setdefault(registry_host, mirrors)
            return self._mirrors[registry_host]

    def candidates(self, registry_host: str) -> list[MirrorConfig]:
        """Healthy mirrors in configured order (cooled-down hosts skipped)."""
        return [
            m
            for m in self.mirrors_for(registry_host)
            if self._health_for(m).available()
        ]

    def _health_for(self, mirror: MirrorConfig) -> HostHealth:
        return self._registry.health_for(
            mirror.host,
            failure_limit=mirror.failure_limit,
            cooldown=float(mirror.health_check_interval),
        )

    def health(self, mirror_host: str) -> Optional[HostHealth]:
        return self._registry.health(mirror_host)

    def record(self, mirror: MirrorConfig, ok: bool) -> None:
        h = self._health_for(mirror)
        if ok:
            h.record_success()
        else:
            h.record_failure()

    def invalidate(self, registry_host: Optional[str] = None) -> None:
        """Drop the cached hosts.toml parse (config reload)."""
        with self._lock:
            if registry_host is None:
                self._mirrors.clear()
            else:
                self._mirrors.pop(registry_host, None)
