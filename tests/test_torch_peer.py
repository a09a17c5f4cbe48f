"""The port's peer chunk tier against the JAX package's: the admission
gate, the chunk server (UDS and TCP, pull-through, cover-only), the client,
the waterfall fetcher with its CRC check and fallbacks, host-health
unification, dynamic membership, rendezvous churn, the rack/zone topology
and the zone-shield artifact proxy.

Every case of tests/test_peer_tier.py, tests/test_peer_membership.py and
tests/test_peer_topology.py runs in both packages (``pkg``, through
``ported_cases``: the reference's own bodies, sizes and tolerances), and
the other package's counters must not move in any of them. Two kinds of
case are special:

- ``test_peer_tier.py::TestMiniStorm`` drives
  ``tools/cluster_storm_profile._run_storm``, which imports the reference.
  Its two cases run here in both packages over this file's own copy of
  that storm harness (``_run_storm``), with the same sizes and bounds.
- ``test_peer_membership.py::TestFleetPeersRoute`` tests the fleet
  controller (``fleet.FleetPlane``, the server half, which the port does
  not have): both arms run the reference's controller.
  ``test_port_membership_through_reference_controller`` points the port's
  ``PeerMembership`` at that controller over UDS.

Cross-package cases: each package's ``PeerClient`` against the other's
``PeerChunkServer`` over UDS and TCP (equal bytes, the CRC header, the
miss and bad-range codes, artifacts), a corrupted payload refused by
either client, and a numpy-seeded rendezvous: both routers rank the same
peers for every region.
"""

from __future__ import annotations

import hashlib
import importlib
import os
import random
import shutil
import socket
import tempfile
import threading
import time
import zlib

import numpy as np
import pytest

from tests.test_torch_fetch_sched import ROOTS, SIDES, other_package_still, ported_cases

ported_cases(
    "test_peer_tier",
    globals(),
    leave_out=(
        "TestMiniStorm::test_four_pod_storm_identity_and_bounded_egress",
        "TestMiniStorm::test_four_pod_storm_peer_kill_falls_back",
    ),
)
ported_cases("test_peer_membership", globals(), keep=("from nydus_snapshotter_tpu import fleet",))
ported_cases("test_peer_topology", globals())
# The reference controller that both arms of TestFleetPeersRoute run
# counts on the reference's registry.
_other_package_still = other_package_still(exempt=("ntpu_fleet_",))


def _peer(side: str):
    return importlib.import_module(f"{ROOTS[side]}.daemon.peer")


def _mods(side: str):
    root = ROOTS[side]
    return (
        _peer(side),
        importlib.import_module(f"{root}.daemon.blobcache"),
        importlib.import_module(f"{root}.daemon.fetch_sched"),
        importlib.import_module(f"{root}.remote.mirror"),
    )


@pytest.fixture(params=SIDES)
def pkg(request):
    return request.param


def _short_dir() -> str:
    return tempfile.mkdtemp(prefix="p", dir="/tmp")


# -------------------------------------------------- mini storm (TestMiniStorm)

CHUNK = 64 << 10
PEER_TIMEOUT_S = 10.0
POD_BUDGET_BYTES = 8 << 20


class StormRegistry:
    """Shared origin with one serialized uplink: every ranged GET pays a
    fixed latency plus its queued pipe time."""

    def __init__(self, blob: bytes, latency_s: float, mibps: float):
        self.blob = blob
        self.latency_s = latency_s
        self.byte_s = 1.0 / (mibps * (1 << 20))
        self.egress = 0
        self.calls = 0
        self._lock = threading.Lock()
        self._pipe_free_at = 0.0

    def fetch(self, off: int, size: int) -> bytes:
        if off + size > len(self.blob):
            raise OSError(f"range [{off}, {off + size}) past blob end")
        now = time.perf_counter()
        with self._lock:
            self.egress += size
            self.calls += 1
            start = max(now, self._pipe_free_at)
            self._pipe_free_at = start + size * self.byte_s
            free_at = self._pipe_free_at
        time.sleep(max(0.0, free_at - now) + self.latency_s)
        return self.blob[off : off + size]


class _Pod:
    """One node: a ``CachedBlob`` behind a waterfall fetcher, its own
    admission gate and a pull-through chunk server."""

    def __init__(self, side, idx, workdir, blob_id, blob_len, registry, addrs, health):
        peer, blobcache, fs, _ = _mods(side)
        self.addr = addrs[idx]
        self.gate = fs.AdmissionGate(
            budget=fs.MemoryBudget(POD_BUDGET_BYTES), max_concurrent=8, demand_reserve=1, name=f"pod{idx}"
        )
        self.router = peer.PeerRouter(addrs, self_address=self.addr, region_bytes=CHUNK, health_registry=health)
        fetch_range = peer.PeerAwareFetcher(
            blob_id, registry.fetch, self.router, timeout_s=PEER_TIMEOUT_S, gate=self.gate
        ).read_range
        self.cb = blobcache.CachedBlob(
            os.path.join(workdir, f"pod{idx}"), blob_id, fetch_range, blob_size=blob_len,
            config=fs.FetchConfig(fetch_workers=2, merge_gap=0, readahead=0), gate=self.gate, tenant=f"pod{idx}",
        )
        export = peer.PeerExport()
        export.register(blob_id, self.cb)
        self.server = peer.PeerChunkServer(export, gate=self.gate, pull_through=True, router=self.router)
        self.server.run(self.addr)

    def stop_server(self) -> None:
        if self.server is not None:
            self.server.stop()
            self.server = None

    def close(self) -> None:
        self.stop_server()
        self.cb.close()


def _run_storm(side, workdir, blob, blob_id, pods, registry, kill_at_frac=None):
    """Every pod cold-reads the whole chunk plan at once; pod 0 stops every
    server at ``kill_at_frac`` of its plan. Returns (origin egress bytes,
    per-pod sha256)."""
    health = _mods(side)[3].HostHealthRegistry()
    sockdir = _short_dir()
    addrs = [os.path.join(sockdir, f"p{i}.sock") for i in range(pods)]
    nodes = [_Pod(side, i, workdir, blob_id, len(blob), registry, addrs, health) for i in range(pods)]
    plan = [(off, min(CHUNK, len(blob) - off)) for off in range(0, len(blob), CHUNK)]
    kill_idx = int(len(plan) * kill_at_frac) if kill_at_frac is not None else None
    digests: list = [None] * pods
    errors: list = []

    def run_pod(i):
        h = hashlib.sha256()
        try:
            for n, (off, size) in enumerate(plan):
                if i == 0 and kill_idx is not None and n == kill_idx:
                    for node in nodes:
                        node.stop_server()
                h.update(nodes[i].cb.read_at(off, size))
            digests[i] = h.hexdigest()
        except BaseException as e:  # noqa: BLE001
            errors.append(f"pod{i}: {e!r}")

    threads = [threading.Thread(target=run_pod, args=(i,)) for i in range(pods)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for node in nodes:
        node.close()
    shutil.rmtree(sockdir, ignore_errors=True)
    assert not errors, f"storm pod failures: {errors[:4]}"
    return registry.egress, digests


class TestMiniStorm:
    def test_four_pod_storm_identity_and_bounded_egress(self, pkg, tmp_path):
        blob = random.Random(5).randbytes(512 << 10)
        registry = StormRegistry(blob, latency_s=0.001, mibps=64.0)
        egress, digests = _run_storm(pkg, str(tmp_path), blob, "ee" * 32, 4, registry)
        oracle = hashlib.sha256(blob).hexdigest()
        assert all(d == oracle for d in digests)
        assert egress <= 1.5 * len(blob), (egress, len(blob))

    def test_four_pod_storm_peer_kill_falls_back(self, pkg, tmp_path):
        blob = random.Random(6).randbytes(256 << 10)
        registry = StormRegistry(blob, latency_s=0.001, mibps=64.0)
        _, digests = _run_storm(pkg, str(tmp_path), blob, "ee" * 32, 4, registry, kill_at_frac=0.25)
        oracle = hashlib.sha256(blob).hexdigest()
        assert all(d == oracle for d in digests)


# -------------------------------------------------------------- cross-package

BLOB = np.random.default_rng(0xB10B).integers(0, 256, 1 << 20, dtype=np.uint8).tobytes()
BLOB_ID = "9e" * 32


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(params=[("ref", "port"), ("port", "ref")], ids=["ref-server", "port-server"])
def served(request, tmp_path):
    """(server side, client side, addresses): a warm ``CachedBlob`` of the
    server's package exported on UDS and on TCP."""
    server_side, client_side = request.param
    peer, blobcache, fs, _ = _mods(server_side)
    cb = blobcache.CachedBlob(
        str(tmp_path / "srv"), BLOB_ID, lambda o, s: BLOB[o : o + s], blob_size=len(BLOB),
        config=fs.FetchConfig(fetch_workers=2, merge_gap=0, readahead=0),
    )
    cb.read_at(0, 256 << 10)
    export = peer.PeerExport()
    export.register(BLOB_ID, cb)
    art = tmp_path / "art.bin"
    art.write_bytes(BLOB[:4096])
    export.register_artifact("zdict", "k1", str(art))
    servers, addrs = [], []
    sockdir = _short_dir()
    for addr in (os.path.join(sockdir, "s.sock"), f"127.0.0.1:{_free_port()}"):
        srv = peer.PeerChunkServer(export, pull_through=False)
        srv.run(addr)
        servers.append(srv)
        addrs.append(addr)
    yield server_side, client_side, addrs, servers
    for srv in servers:
        srv.stop()
    cb.close()
    shutil.rmtree(sockdir, ignore_errors=True)


def test_client_reads_other_package_server(served):
    """Covered extents come back equal, uncovered ones and unknown blobs
    are misses, bad ranges are errors (not misses), artifacts are equal,
    on UDS and TCP."""
    _server_side, client_side, addrs, _ = served
    peer = _peer(client_side)
    rng = np.random.default_rng(3)
    for addr in addrs:
        client = peer.PeerClient(addr, timeout_s=5.0)
        for _ in range(8):
            off = int(rng.integers(0, (256 << 10) - 8192))
            size = int(rng.integers(1, 8192))
            assert client.read_range(BLOB_ID, off, size) == BLOB[off : off + size]
        with pytest.raises(peer.PeerMiss):
            client.read_range(BLOB_ID, 512 << 10, 4096)
        with pytest.raises(peer.PeerMiss):
            client.read_range("00" * 32, 0, 4096)
        with pytest.raises(peer.PeerError) as e:
            client.read_range(BLOB_ID, 0, 0)
        assert not isinstance(e.value, peer.PeerMiss)
        assert client.fetch_artifact("zdict", "k1") == BLOB[:4096]
        with pytest.raises(peer.PeerMiss):
            client.fetch_artifact("zdict", "nope")
        assert client.stat()["blobs"] == {BLOB_ID: {"covered_bytes": 256 << 10}}


def test_wire_headers_equal(served):
    """The server's raw response (status, CRC32 header, outcome, body) is
    the same wire whichever package serves it."""
    server_side, _client_side, addrs, servers = served
    status, headers, body = servers[0].handle("GET", f"/api/v1/peer/blob/{BLOB_ID}?offset=100&size=5000", {})
    assert status == 200 and body == BLOB[100:5100]
    assert headers["x-ntpu-peer-crc32"] == f"{zlib.crc32(body) & 0xFFFFFFFF:08x}"
    assert headers["x-ntpu-peer-outcome"] == "hit"
    other = _peer("port" if server_side == "ref" else "ref")
    export = other.PeerExport()
    twin = other.PeerChunkServer(export, pull_through=False)
    for path in (f"/api/v1/peer/blob/{'00' * 32}?offset=0&size=10", "/api/v1/peer/blob/x?offset=-1&size=1", "/nope",
                 "/api/v1/peer/artifact/zdict"):
        assert servers[0].handle("GET", path, {})[0] == twin.handle("GET", path, {})[0]
    twin.stop()


@pytest.mark.parametrize("server_side,client_side", [("ref", "port"), ("port", "ref")])
def test_corrupt_payload_fails_other_package_crc(tmp_path, monkeypatch, server_side, client_side):
    peer, blobcache, fs, _ = _mods(server_side)
    cb = blobcache.CachedBlob(str(tmp_path / "c"), BLOB_ID, lambda o, s: BLOB[o : o + s], blob_size=len(BLOB),
                              config=fs.FetchConfig(fetch_workers=1, merge_gap=0, readahead=0))
    cb.read_at(0, 65536)
    export = peer.PeerExport()
    export.register(BLOB_ID, cb)
    monkeypatch.setattr(peer, "_crc32", lambda data: 0xDEADBEEF)
    sockdir = _short_dir()
    srv = peer.PeerChunkServer(export, pull_through=False)
    srv.run(os.path.join(sockdir, "c.sock"))
    try:
        client = _peer(client_side).PeerClient(os.path.join(sockdir, "c.sock"), timeout_s=5.0)
        with pytest.raises(_peer(client_side).PeerError, match="CRC32"):
            client.read_range(BLOB_ID, 0, 4096)
    finally:
        srv.stop()
        cb.close()
        shutil.rmtree(sockdir, ignore_errors=True)


def test_rendezvous_ranking_equal():
    rng = np.random.default_rng(11)
    addrs = [f"/tmp/n{i}.sock" for i in range(9)]
    locs = {a: f"r{i % 3}:z{i % 2}:reg0" for i, a in enumerate(addrs)}
    routers = {}
    for side in SIDES:
        peer, _, _, mirror = _mods(side)
        routers[side] = peer.PeerRouter(addrs, self_address=addrs[0], region_bytes=64 << 10,
                                        health_registry=mirror.HostHealthRegistry(), locality=locs[addrs[0]],
                                        localities=locs)
    for _ in range(200):
        blob_id = rng.integers(0, 256, 32, dtype=np.uint8).tobytes().hex()
        off = int(rng.integers(0, 1 << 30))
        ref, port = routers["ref"], routers["port"]
        assert ref.ranked(blob_id, off) == port.ranked(blob_id, off)
        assert ref.routes(blob_id, off) == port.routes(blob_id, off)
        assert ref.is_shield(blob_id, off) == port.is_shield(blob_id, off)
    assert _peer("ref").parse_locality("r1:z2:reg3") == _peer("port").parse_locality("r1:z2:reg3")
    assert _peer("ref").parse_locality("bad") == _peer("port").parse_locality("bad")


def test_port_membership_through_reference_controller(tmp_path):
    """The reference's fleet controller, served over UDS by its system
    controller, lists two peer members; the port's ``PeerMembership``
    pointed at it sees the same live set, localities and epoch as the
    reference's."""
    from nydus_snapshotter_tpu import fleet as jfleet
    from nydus_snapshotter_tpu.system.system import SystemController

    plane = jfleet.FleetPlane(cfg=jfleet.FleetRuntimeConfig(enable=True, scrape_interval_secs=60), slo_objectives=[])
    sockdir = _short_dir()
    csock = os.path.join(sockdir, "sys.sock")
    controller = SystemController(fs=None, managers=[], sock_path=csock, fleet=plane)
    controller.run()
    try:
        for i in range(2):
            plane.registry.register(jfleet.Member(
                name=f"p{i}", component="peer", address=f"/tmp/peer{i}.sock", pid=100 + i,
                extra={"locality": f"r{i}:z0:reg0"}))
        views = {}
        for side in SIDES:
            m = _peer(side).PeerMembership(seed=["/tmp/seed.sock"], controller=csock, refresh_secs=0.0,
                                            health_registry=_mods(side)[3].HostHealthRegistry())
            views[side] = (m.addresses(), m.localities(), m.epoch)
        assert views["port"] == views["ref"]
        assert views["port"][0] == ["/tmp/peer0.sock", "/tmp/peer1.sock"]
    finally:
        controller.stop()
        shutil.rmtree(sockdir, ignore_errors=True)
