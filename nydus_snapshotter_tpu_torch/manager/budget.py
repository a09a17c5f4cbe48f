"""Restart budget / circuit breaker for daemon recovery.

A crashing daemon with the ``restart`` (or ``failover``) policy must not
turn into a hot respawn loop: each daemon gets ``max_restarts`` respawns
per sliding ``window`` seconds, with exponential backoff between them
(first respawn immediate, then ``base_delay * 2^(n-1)`` capped at
``max_delay``). When the budget is exhausted the circuit opens: the
manager degrades the daemon to passthrough instead of respawning.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional


class RestartBudget:
    def __init__(
        self,
        max_restarts: int = 3,
        window: float = 60.0,
        base_delay: float = 0.5,
        max_delay: float = 8.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if max_restarts < 1:
            raise ValueError("max_restarts must be >= 1")
        self.max_restarts = max_restarts
        self.window = float(window)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self._clock = clock
        self._lock = threading.Lock()
        self._events: dict[str, deque[float]] = {}

    def _prune_locked(self, daemon_id: str, now: float) -> "deque[float]":
        events = self._events.setdefault(daemon_id, deque())
        while events and now - events[0] > self.window:
            events.popleft()
        return events

    def next_delay(self, daemon_id: str) -> Optional[float]:
        """Consume one respawn slot. Returns the backoff to wait before
        respawning (0.0 for the first respawn in the window), or None when
        the budget is exhausted — the caller must degrade, not respawn."""
        now = self._clock()
        with self._lock:
            events = self._prune_locked(daemon_id, now)
            n = len(events)
            if n >= self.max_restarts:
                return None
            events.append(now)
        if n == 0:
            return 0.0
        return min(self.base_delay * (2 ** (n - 1)), self.max_delay)

    def exhausted(self, daemon_id: str) -> bool:
        now = self._clock()
        with self._lock:
            return len(self._prune_locked(daemon_id, now)) >= self.max_restarts

    def restarts_in_window(self, daemon_id: str) -> int:
        now = self._clock()
        with self._lock:
            return len(self._prune_locked(daemon_id, now))

    def reset(self, daemon_id: str) -> None:
        with self._lock:
            self._events.pop(daemon_id, None)
