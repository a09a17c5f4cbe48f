"""The port's fleet plane (member registry, metrics federation, trace
aggregation, the controller's ``/api/v1/fleet/*`` surface) against the JAX
package's.

Every case of tests/test_fleet_obs.py runs in both packages (``pkg``,
through ``ported_cases``: the reference's own bodies), including its
``fleet.scrape`` and ``fleet.collect`` failpoint cases, the ``ntpuctl``
cases against each package's controller and the ``DaemonServer`` case.

Cross-package case, on numpy-seeded members: a ``FleetPlane`` of each
package federates the same two canned members (a Prometheus exposition
and a Chrome trace each, served over unix sockets) into equal merged
metrics text, equal scoreboards (ages and times taken out) and an equal
merged trace document (the collect time taken out).
"""

from __future__ import annotations

import importlib
import json

import numpy as np
import pytest

from tests.test_torch_fetch_sched import ROOTS, SIDES, ported_cases

ported_cases("test_fleet_obs", globals())


def _mod(side: str, name: str):
    return importlib.import_module(f"{ROOTS[side]}.{name}")


def _exposition(rng) -> bytes:
    lines = ["# HELP ntpu_blobcache_hit_bytes x", "# TYPE ntpu_blobcache_hit_bytes counter"]
    for name in ("ntpu_blobcache_hit_bytes", "ntpu_blobcache_miss_bytes", "ntpu_blobcache_readahead_bytes",
                 "ntpu_blobcache_readahead_hit_bytes", "ntpu_peer_served_bytes", "ntpu_peer_fetch_bytes"):
        lines.append(f"{name} {int(rng.integers(1, 1 << 20))}")
    for lane in ("demand", "prefetch"):
        lines.append(f'ntpu_admission_queued{{lane="{lane}"}} {int(rng.integers(0, 9))}')
    lines.append(f'ntpu_trace_spans_total{{name="peer.serve"}} {int(rng.integers(0, 500))}')
    return ("\n".join(lines) + "\n").encode()


def _trace_doc(rng, pid: int, trace_id: str) -> bytes:
    events = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": 1, "args": {"name": "worker"}}]
    parent = ""
    for i in range(int(rng.integers(2, 6))):
        span = f"{int(rng.integers(1, 1 << 40)):x}"
        events.append({"name": ("peer.serve", "blobcache.fetch", "nydusd.read")[i % 3], "cat": "x", "ph": "X",
                       "ts": float(rng.integers(0, 10_000)), "dur": float(rng.integers(1, 500)), "pid": pid,
                       "tid": int(rng.integers(1, 4)),
                       "args": {"trace_id": trace_id, "span_id": span, "parent_id": parent}})
        parent = span
    return json.dumps({"traceEvents": events, "displayTimeUnit": "ms"}).encode()


def _strip_times(obj):
    if isinstance(obj, dict):
        return {k: _strip_times(v) for k, v in obj.items()
                if not any(t in k for t in ("age", "_at", "ms", "time", "last_ok"))}
    if isinstance(obj, list):
        return [_strip_times(v) for v in obj]
    return obj


@pytest.mark.parametrize("seed", [0, 1])
def test_federation_of_two_members_is_equal(tmp_path, seed):
    from tests.test_fleet_obs import CannedServer

    rng = np.random.default_rng(seed)
    trace_id = f"{int(rng.integers(1, 1 << 60)):x}"
    routes = {name: {"/metrics": _exposition(rng), "/api/v1/traces": _trace_doc(rng, 4000 + k, trace_id)}
              for k, name in enumerate(("m-a", "m-b"))}
    servers = {name: CannedServer(str(tmp_path / f"{name}.sock"), r) for name, r in routes.items()}
    got = {}
    try:
        for side in SIDES:
            fleet = _mod(side, "fleet")
            plane = fleet.FleetPlane(cfg=fleet.FleetRuntimeConfig(enable=True, scrape_interval_secs=60.0,
                                                                  stale_after_secs=30.0))
            for k, name in enumerate(routes):
                plane.registry.register(fleet.Member(name=name, component=("daemon", "peer")[k],
                                                     address=str(tmp_path / f"{name}.sock"), pid=4000 + k))
            scraped = plane.federator.scrape_once()
            text = plane.federator.render()
            board = _strip_times(plane.federator.scoreboard())
            doc = plane.collector.collect()
            doc["fleet"].pop("collect_ms")
            trees = _mod(side, "trace.aggregate").trace_trees(doc)
            got[side] = (scraped, text, board, doc, trees)
    finally:
        for s in servers.values():
            s.stop()
    assert got["port"] == got["ref"]
    scraped, text, _board, doc, trees = got["port"]
    assert scraped == {"members": 2, "errors": 0}
    assert 'node="m-a"' in text and 'node="m-b"' in text
    assert doc["fleet"]["members"] == 2 and trees[trace_id]["processes"] == 2
