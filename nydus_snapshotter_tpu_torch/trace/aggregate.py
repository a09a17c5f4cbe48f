"""Cross-process trace aggregation: one cluster-wide Chrome trace.

Every process already exports its own span ring as a Chrome
``trace_event`` document on ``/api/v1/traces``, and trace ids already
cross process boundaries (the ``x-ntpu-trace-*`` headers on dict-service
and peer-tier RPCs). What was missing is the JOIN: a storm-rooted
``grpc.Prepare`` or ``nydusd.read`` whose children ran in another
process (a peer owner's pull-through, a dict-service merge) could only
be inspected one ring at a time.

:class:`FleetTraceCollector` pulls each registered member's ring,
rewrites the event lanes so every member gets its own process row
(members on one host share real pids with nothing to disambiguate them;
the synthetic lane pid keeps Perfetto's process grouping meaningful and
``process_name`` metadata carries the member name, component and real
pid), and merges the documents into ONE trace — spans from different
OS processes that share a trace id line up on the same timeline because
every ring stamps wall-clock epoch microseconds.

Per-member isolation mirrors the metrics federation: a member that dies
mid-pull is skipped and counted (``ntpu_fleet_scrape_errors_total``),
the merged document still serves. The ``fleet.collect`` failpoint
injects exactly that failure in chaos tests.
"""

from __future__ import annotations

import json
import logging
import time
from typing import Callable, Iterable, Optional

from nydus_snapshotter_tpu_torch import failpoint
from nydus_snapshotter_tpu_torch import trace as trace_mod
from nydus_snapshotter_tpu_torch.metrics import federation as _fed
from nydus_snapshotter_tpu_torch.utils import udshttp

logger = logging.getLogger(__name__)

TRACES_PATH = "/api/v1/traces"


def merge_member_traces(docs: list[tuple[object, dict]]) -> dict:
    """[(member, chrome doc)] -> one merged chrome doc.

    Lane assignment is deterministic in member-name order so repeated
    pulls render identically. Each member's (pid, tid) pairs are remapped
    into its lane; ``thread_name`` metadata rides along, ``process_name``
    metadata is synthesized per member.
    """
    events = []
    meta = []
    for lane, (member, doc) in enumerate(
        sorted(docs, key=lambda md: md[0].name), start=1
    ):
        real_pids = set()
        for ev in doc.get("traceEvents", ()):
            ev = dict(ev)
            real_pids.add(ev.get("pid"))
            ev["pid"] = lane
            if ev.get("ph") == "M":
                meta.append(ev)
            else:
                ev.setdefault("args", {})
                ev["args"] = dict(ev["args"], node=member.name)
                events.append(ev)
        real = next(iter(real_pids), "?")
        meta.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": lane,
                "args": {
                    "name": f"{member.name} ({member.component}, pid {real})"
                },
            }
        )
    events.sort(key=lambda e: e.get("ts", 0))
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def filter_trace(doc: dict, trace_id: str) -> dict:
    """The merged doc narrowed to one trace id (metadata rows kept for
    the lanes that still have events)."""
    events = [
        e
        for e in doc.get("traceEvents", ())
        if e.get("ph") != "M" and e.get("args", {}).get("trace_id") == trace_id
    ]
    pids = {e["pid"] for e in events}
    meta = [
        e
        for e in doc.get("traceEvents", ())
        if e.get("ph") == "M" and e.get("pid") in pids
    ]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def trace_trees(doc: dict) -> dict[str, dict]:
    """{trace_id: {roots, spans, processes, single_tree}} over a merged
    doc — the cross-process join check the storm profile gates on."""
    by_trace: dict[str, list[dict]] = {}
    for e in doc.get("traceEvents", ()):
        if e.get("ph") != "X":
            continue
        tid = e.get("args", {}).get("trace_id")
        if tid:
            by_trace.setdefault(tid, []).append(e)
    out = {}
    for tid, events in by_trace.items():
        ids = {e["args"].get("span_id") for e in events}
        roots = [e for e in events if not e["args"].get("parent_id")]
        # Single tree: every non-root's parent landed in the merged doc.
        joined = all(
            not e["args"].get("parent_id") or e["args"]["parent_id"] in ids
            for e in events
        )
        out[tid] = {
            "roots": [e["name"] for e in roots],
            "spans": len(events),
            "processes": len({e["pid"] for e in events}),
            "single_tree": bool(roots) and joined,
        }
    return out


class FleetTraceCollector:
    """Pulls every member's ring and serves the merged document.

    ``members`` is the same duck-typed listing callable the metrics
    federator takes; the local member's ring is read in-process (no
    self-HTTP hop through our own serve loop).
    """

    def __init__(
        self,
        members: Callable[[], Iterable],
        timeout_s: float = 5.0,
        local_traces: Optional[Callable[[], dict]] = None,
    ):
        self._members = members
        self.timeout_s = timeout_s
        self._local_traces = local_traces or trace_mod.chrome_trace

    def _pull(self, member) -> dict:
        failpoint.hit("fleet.collect")
        if member.local:
            return self._local_traces()
        status, body = udshttp.request(
            member.address, TRACES_PATH, timeout=self.timeout_s
        )
        if status != 200:
            raise OSError(f"{member.address} {TRACES_PATH} -> {status}")
        return json.loads(body)

    def collect(self, trace_id: str = "") -> dict:
        """The merged fleet trace (optionally narrowed to one trace id).
        Pull failures degrade: the member is counted and skipped."""
        t0 = time.perf_counter()
        docs = []
        errors = 0
        for member in self._members():
            try:
                docs.append((member, self._pull(member)))
            except Exception as e:  # noqa: BLE001 — degradation is the contract
                errors += 1
                _fed.FLEET_SCRAPE_ERRORS.labels(member.name).inc()
                logger.warning("fleet trace pull of %s failed: %s", member.name, e)
        doc = merge_member_traces(docs)
        if trace_id:
            doc = filter_trace(doc, trace_id)
        doc["fleet"] = {
            "members": len(docs),
            "errors": errors,
            "collect_ms": round((time.perf_counter() - t0) * 1000.0, 3),
        }
        return doc
