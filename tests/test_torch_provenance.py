"""The port's byte provenance and heat against the JAX package's: the
ledger (attribution by cause, conservation, first-touch reads, the
waterfall, the bounded event ring, rollups by tenant), its wiring into
``CachedBlob`` and the hedger, the ``.heat`` artifact (round trip, compile
from the ledger, corrupt and stale files, adoption from a peer, chaos), and
the 16-pod conservation storm and the heat closed loop.

Every portable case of tests/test_provenance.py and
tests/test_provenance_storm.py runs in both packages (``pkg``, through
``ported_cases``: the reference's own bodies, sizes and tolerances), and
the other package's counters must not move in any of them. Left out until
their modules exist (ROADMAP.md A15):

- ``TestCollectorTiming::test_collect_once_observes_per_collector_seconds``
  and ``::test_failing_collector_still_timed`` start
  ``metrics.serve.MetricsServer`` and read ``metrics.data``;
- ``TestFleetFederation::test_fleet_provenance_route_joins_members`` and
  ``::test_member_pull_failure_degrades`` run the fleet controller
  (``fleet.FleetPlane``, the server half), which federates the ledger of
  its own process.

Cross-package cases, on numpy-seeded reads: both ledgers fed the same
fetch and read events agree on conservation, snapshots and heat extents;
a ``.heat`` artifact compiled by one package is byte-equal to the other's
and is adopted by it (from a file and as a peer payload).
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest

from tests.test_torch_fetch_sched import ROOTS, SIDES, other_package_still, ported_cases

ported_cases(
    "test_provenance",
    globals(),
    keep=("from nydus_snapshotter_tpu.metrics import data",),
    leave_out=(
        "TestCollectorTiming::test_collect_once_observes_per_collector_seconds",
        "TestCollectorTiming::test_failing_collector_still_timed",
        "TestFleetFederation::test_fleet_provenance_route_joins_members",
        "TestFleetFederation::test_member_pull_failure_degrades",
    ),
)
ported_cases("test_provenance_storm", globals())
_other_package_still = other_package_still()


def _prov(side: str):
    return importlib.import_module(f"{ROOTS[side]}.provenance")


@pytest.fixture()
def clean_ledgers():
    for side in SIDES:
        _prov(side).reset()
        _prov(side).invalidate_config()
    yield
    for side in SIDES:
        _prov(side).reset()
        _prov(side).invalidate_config()


def _events(seed: int, blob_id: str):
    rng = np.random.default_rng(seed)
    causes = ("demand", "readahead", "prefetch", "peer_serve")
    out = []
    for _ in range(300):
        off = int(rng.integers(0, 1 << 22))
        size = int(rng.integers(1, 1 << 16))
        if rng.integers(0, 3):
            out.append(("fetch", blob_id, off, size, causes[int(rng.integers(0, len(causes)))]))
        else:
            out.append(("read", blob_id, off, size, None))
    return out


def test_ledgers_agree_on_seeded_events(clean_ledgers):
    blob_id = "a7" * 32
    events = _events(41, blob_id)
    for side in SIDES:
        prov = _prov(side)
        for kind, bid, off, size, cause in events:
            if kind == "fetch":
                prov.record_fetch(bid, off, size, cause)
            else:
                prov.record_read(bid, off, size)
    ref, port = _prov("ref"), _prov("port")
    assert ref.conservation(blob_id) == port.conservation(blob_id)
    assert ref.heat_extents(blob_id) == port.heat_extents(blob_id)
    assert ref.blob_snapshot(blob_id) == port.blob_snapshot(blob_id)
    rows = lambda p: [(r["cause"], r["offset"], r["bytes"]) for r in p.waterfall(blob_id)]  # noqa: E731
    assert rows(ref) == rows(port)


@pytest.mark.parametrize("writer,adopter", [("ref", "port"), ("port", "ref")])
def test_heat_artifact_compiled_by_one_adopted_by_other(tmp_path, clean_ledgers, writer, adopter):
    blob_id = "b8" * 32
    rng = np.random.default_rng(8)
    reads = [(int(rng.integers(0, 1 << 24)), int(rng.integers(1, 1 << 17))) for _ in range(64)]
    arts = {}
    for side in SIDES:
        for off, size in reads:
            _prov(side).record_read(blob_id, off, size)
        d = tmp_path / side
        d.mkdir()
        arts[side] = _prov(side).compile_heat(blob_id, str(d), source_size=1 << 24)
        assert arts[side] is not None
    paths = {side: tmp_path / side / (blob_id + ".heat") for side in SIDES}
    assert paths["ref"].read_bytes() == paths["port"].read_bytes()
    assert arts["ref"].to_bytes() == arts["port"].to_bytes()
    raw = paths[writer].read_bytes()
    heat = _prov(adopter)
    local = tmp_path / "adopter"
    local.mkdir()
    (local / (blob_id + ".heat")).write_bytes(raw)
    got = heat.find_heat([str(local)], blob_id, source_size=1 << 24)
    assert got is not None and got.extents == arts[writer].extents
    fresh = tmp_path / "fresh"
    fresh.mkdir()
    got = heat.load_or_adopt_heat([str(fresh)], blob_id, source_size=1 << 24, fetch_remote=lambda: raw)
    assert got is not None and got.extents == arts[writer].extents
    assert (fresh / (blob_id + ".heat")).read_bytes() == raw
