"""Signal-driven shutdown helper (reference pkg/utils/signals)."""

from __future__ import annotations

import signal
import threading
from typing import Callable, Iterable

_DEFAULT = (signal.SIGTERM, signal.SIGINT)


def setup_signal_handler(
    stop: threading.Event, extra: Iterable[int] = (), on_signal: Callable[[int], None] = None
) -> None:
    """Set ``stop`` when a termination signal arrives
    (signals.go SetupSignalHandler)."""

    def handler(signum, _frame):
        if on_signal is not None:
            on_signal(signum)
        stop.set()

    for sig in (*_DEFAULT, *extra):
        signal.signal(sig, handler)
