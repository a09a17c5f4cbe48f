"""Bounded lock-striped span ring buffer.

Finished spans land here (drop-oldest past capacity) and are read back by
the exporters: the ``/api/v1/traces`` Chrome-trace endpoint and the
slow-op flight recorder's tree reconstruction. The striping keeps
concurrent writers (pipeline workers, layer threads, dict-service
handlers) off one hot lock: each writer thread hashes to a stripe with
its own lock and deque, and only readers touch every stripe.

Accounting invariant (pinned by tests/test_torch_planes.py): for any interleaving
of pushes, ``len(ring) + ring.dropped() == total pushes`` — drop-oldest
never loses the count, and the drop total is exported as
``ntpu_trace_dropped_spans_total``.
"""

from __future__ import annotations

import threading
from collections import deque

from nydus_snapshotter_tpu_torch.metrics import registry as _metrics
from nydus_snapshotter_tpu_torch.metrics.registry import LazyCounter

SPANS_DROPPED = _metrics.default_registry.register(
    LazyCounter(
        "ntpu_trace_dropped_spans_total",
        "Spans evicted oldest-first from the bounded trace ring buffer",
    )
)

DEFAULT_STRIPES = 8


class _Stripe:
    # Deliberately NOT instrumented by analysis.runtime (NTPU_ANALYZE):
    # the stripe lock is taken once per recorded span — the hottest lock
    # in the process. The ring's concurrency invariant (len + dropped ==
    # pushes under any interleaving) is pinned directly by the tests.
    __slots__ = ("lock", "items", "cap", "drops", "pushes")

    def __init__(self, cap: int):
        self.lock = threading.Lock()
        self.items: deque = deque()
        self.cap = cap
        self.drops = 0
        self.pushes = 0


class SpanRing:
    """Drop-oldest span store bounded at ``capacity`` spans total."""

    def __init__(self, capacity: int, stripes: int = DEFAULT_STRIPES):
        capacity = max(1, int(capacity))
        stripes = max(1, min(stripes, capacity))
        base, extra = divmod(capacity, stripes)
        # Stripe capacities sum exactly to `capacity`.
        self._stripes = [
            _Stripe(base + (1 if i < extra else 0)) for i in range(stripes)
        ]
        self.capacity = capacity

    def push(self, span) -> None:
        st = self._stripes[threading.get_ident() % len(self._stripes)]
        with st.lock:
            st.pushes += 1
            if len(st.items) >= st.cap:
                st.items.popleft()
                st.drops += 1
            st.items.append(span)

    def snapshot(self) -> list:
        """All buffered spans, oldest start first."""
        out = []
        for st in self._stripes:
            with st.lock:
                out.extend(st.items)
        out.sort(key=lambda s: s.start)
        return out

    def of_trace(self, trace_id) -> list:
        """The buffered spans of one trace, in no order."""
        out = []
        for st in self._stripes:
            with st.lock:
                out.extend([s for s in st.items if s.trace_id == trace_id])
        return out

    def dropped(self) -> int:
        return sum(st.drops for st in self._stripes)

    def pushes(self) -> int:
        return sum(st.pushes for st in self._stripes)

    def clear(self) -> None:
        for st in self._stripes:
            with st.lock:
                st.items.clear()

    def __len__(self) -> int:
        return sum(len(st.items) for st in self._stripes)
