"""Duplicate-call suppression (golang.org/x/sync/singleflight semantics).

Concurrent callers with the same key share one in-flight execution and all
receive its result (or its exception). Used by the referrer and tarfs
managers exactly like the reference (pkg/referrer/manager.go:26,
pkg/tarfs/tarfs.go singleflight use).
"""

from __future__ import annotations

import threading
from typing import Any, Callable


class _Call:
    def __init__(self):
        self.done = threading.Event()
        self.result: Any = None
        self.err: BaseException | None = None


class Group:
    def __init__(self):
        self._mu = threading.Lock()
        self._calls: dict[str, _Call] = {}

    def do(self, key: str, fn: Callable[[], Any]) -> tuple[Any, bool]:
        """Run ``fn`` once per concurrent ``key``; returns (result, shared)
        where ``shared`` says this caller piggybacked on another's flight."""
        with self._mu:
            call = self._calls.get(key)
            if call is not None:
                leader = False
            else:
                call = _Call()
                self._calls[key] = call
                leader = True
        if not leader:
            call.done.wait()
            if call.err is not None:
                raise call.err
            return call.result, True
        try:
            call.result = fn()
            return call.result, False
        except BaseException as e:
            call.err = e
            raise
        finally:
            with self._mu:
                self._calls.pop(key, None)
            call.done.set()
