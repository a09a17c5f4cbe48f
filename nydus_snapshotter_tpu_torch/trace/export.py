"""Span exporters: Chrome ``trace_event`` JSON, span-tree text rendering,
the slow-op flight recorder, and over-p95 trace exemplars.

``to_chrome_trace`` emits the Trace Event Format (complete ``"X"`` events
plus ``thread_name`` metadata) that chrome://tracing and Perfetto load
directly — the dict service's ``/api/v1/traces`` serves exactly this
document.

The :class:`SlowOpRecorder` is the flight recorder: when a ROOT span ends
over the configured threshold, the full span tree of that trace is
reconstructed from the ring buffer and logged in one message, so the
latency breakdown of a slow conversion or RPC is in the log exactly
when it happened, without anyone having scraped the endpoint in time.

The :class:`ExemplarStore` links metrics to traces: it keeps the last N
root trace ids whose duration exceeded the rolling p95 of recent roots —
the ``trace_exemplars`` field on the metrics summaries.
"""

from __future__ import annotations

import logging
import os
import threading
from collections import deque

logger = logging.getLogger(__name__)

# Core args every exported event carries besides the user attrs.
_ID_KEYS = ("trace_id", "span_id", "parent_id")


def _fmt_id(v) -> str:
    """Ids are 64-bit ints internally; export them as hex strings so JSON
    consumers (Perfetto's JS heritage caps exact ints at 2^53) keep them
    exact. The empty string stands for "no parent"."""
    if isinstance(v, int):
        return format(v, "x") if v else ""
    return str(v)


def to_chrome_trace(spans) -> dict:
    """Chrome/Perfetto ``trace_event`` document for a span list."""
    pid = os.getpid()
    tids: dict[str, int] = {}
    events = []
    for sp in spans:
        tid = tids.setdefault(sp.thread, len(tids) + 1)
        args = {
            "trace_id": _fmt_id(sp.trace_id),
            "span_id": _fmt_id(sp.span_id),
            "parent_id": _fmt_id(sp.parent_id),
        }
        args.update(sp.attrs)
        events.append(
            {
                "name": sp.name,
                "cat": sp.name.split(".", 1)[0],
                "ph": "X",
                "ts": round(sp.start * 1e6, 3),  # microseconds
                "dur": round(sp.duration_ms * 1000.0, 3),
                "pid": pid,
                "tid": tid,
                "args": args,
            }
        )
    events.sort(key=lambda e: e["ts"])
    meta = [
        {
            "name": "thread_name",
            "ph": "M",
            "pid": pid,
            "tid": tid,
            "args": {"name": name},
        }
        for name, tid in tids.items()
    ]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def format_tree(spans, trace_id: str) -> str:
    """Indented text rendering of one trace's span tree. Spans whose
    parent has not landed in the ring (still running, or already evicted)
    are listed under a ``(detached)`` marker rather than silently lost."""
    mine = [s for s in spans if s.trace_id == trace_id]
    by_id = {s.span_id: s for s in mine}
    children: dict[str, list] = {}
    roots, detached = [], []
    for s in mine:
        if not s.parent_id:
            roots.append(s)
        elif s.parent_id in by_id:
            children.setdefault(s.parent_id, []).append(s)
        else:
            detached.append(s)
    lines: list[str] = []

    def fmt(s) -> str:
        extra = ""
        if "failpoints" in s.attrs:
            extra += f" failpoints={','.join(s.attrs['failpoints'])}"
        if "error" in s.attrs:
            extra += f" error={s.attrs['error']!r}"
        if s.attrs.get("background"):
            extra += " background"
        return f"{s.name} {s.duration_ms:.2f}ms [{_fmt_id(s.span_id)}]{extra}"

    def walk(s, depth: int) -> None:
        lines.append("  " * depth + fmt(s))
        for c in sorted(children.get(s.span_id, ()), key=lambda x: x.start):
            walk(c, depth + 1)

    for r in sorted(roots, key=lambda x: x.start):
        walk(r, 0)
    if detached:
        lines.append("(detached)")
        for s in sorted(detached, key=lambda x: x.start):
            walk(s, 1)
    return "\n".join(lines)


class SlowOpRecorder:
    """Logs the reconstructed span tree of any root op over threshold."""

    def __init__(self, threshold_ms: float, keep: int = 32):
        self.threshold_ms = float(threshold_ms)
        self._lock = threading.Lock()
        self._records: deque = deque(maxlen=keep)

    def record(self, root, ring) -> None:
        # the root's own trace only: a snapshot sorts the whole ring
        tree = format_tree(ring.of_trace(root.trace_id), root.trace_id)
        logger.warning(
            "slow op %s took %.1fms (threshold %.0fms), trace %s:\n%s",
            root.name,
            root.duration_ms,
            self.threshold_ms,
            root.trace_id,
            tree,
        )
        with self._lock:
            self._records.append(
                {
                    "trace_id": _fmt_id(root.trace_id),
                    "op": root.name,
                    "duration_ms": round(root.duration_ms, 3),
                    "tree": tree,
                }
            )

    def records(self) -> list[dict]:
        with self._lock:
            return list(self._records)


class ExemplarStore:
    """Rolling p95 of root durations + the last N roots that exceeded it.

    ``record`` is on the hot path (every root span ends here), so it is a
    single bounded-deque append — GIL-atomic, no lock, no sort. The p95
    and the over-p95 filter are computed lazily in :meth:`exemplars`,
    which only runs when a metrics summary is actually scraped.

    ``min_window`` roots must have been seen before anything qualifies —
    with no history every op "exceeds p95" and the exemplars are noise.
    """

    def __init__(self, window: int = 256, keep: int = 16, min_window: int = 20):
        self._keep = keep
        self._min_window = min_window
        # (duration_ms, trace_id, name) of recent roots, oldest first.
        self._roots: deque = deque(maxlen=window)

    def record(self, root) -> None:
        self._roots.append((root.duration_ms, root.trace_id, root.name))

    def exemplars(self, limit: int = 16) -> list[dict]:
        """Most recent over-p95 roots, newest first."""
        recent = list(self._roots)
        n = len(recent)
        if n < self._min_window:
            return []
        durations = sorted(d for d, _, _ in recent)
        p95 = durations[min(n - 1, int(n * 0.95))]
        out = [
            {"trace_id": _fmt_id(tid), "op": name, "duration_ms": round(d, 3)}
            for d, tid, name in reversed(recent)
            if d > p95
        ]
        return out[: min(limit, self._keep)]
