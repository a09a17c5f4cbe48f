"""The port's dict-shard HA plane against the JAX package's.

Each of the reference suite's cases (tests/test_dict_ha.py) runs in both
packages (``pkg``): replication identity, the byte budget, chaos at
``ha.replicate``, the loud resync, the 503 role gate, placement
properties and promotion, the ``ha.*`` failpoints, role re-push, the
down report, the fleet placement routes, mid-merge failover, the lagging
replica's repair, the ``|`` scheme, config resolution, rendezvous ranks
and planned demotion. The port's services run with ``device="cpu"``, so a
probe RPC on a primary or a replica is one ``lookup_u32`` through kernel
K3's plain version. Then the cross-package checks: equal placement maps on
the same member and liveness sequences, a reference primary tailed by a
port replica and the reverse, a replica tail that crosses an index
rebuild, a ``service+ha://`` batch resolved through the port's fleet
plane and system controller with the port's placement controller attached
(a primary killed mid-batch, its replica promoted), byte-identical to the
reference's batch, and the port's runner as a child process on the CPU.

Bootstraps come from the reference's ``BatchConverter`` (test side only).
Every wait has a deadline; every service, tailer and child is stopped.
"""

import functools
import io
import json
import logging
import os
import signal
import subprocess
import sys
import tarfile
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from nydus_snapshotter_tpu import failpoint as jfp
from nydus_snapshotter_tpu import fleet as jfleet
from nydus_snapshotter_tpu.converter.batch import BatchConverter as JBatchConverter
from nydus_snapshotter_tpu.converter.types import PackOption as JPackOption
from nydus_snapshotter_tpu.ha import placement as jplacement
from nydus_snapshotter_tpu.ha import replicate as jreplicate
from nydus_snapshotter_tpu.ha import resolve_ha_config as j_resolve_ha_config
from nydus_snapshotter_tpu.metrics.slo import SloEngine
from nydus_snapshotter_tpu.parallel import dict_service as jds
from nydus_snapshotter_tpu.utils import udshttp as judshttp
from nydus_snapshotter_tpu_torch import failpoint as tfp
from nydus_snapshotter_tpu_torch import fleet as tfleet
from nydus_snapshotter_tpu_torch.converter.batch import BatchConverter
from nydus_snapshotter_tpu_torch.converter.types import PackOption
from nydus_snapshotter_tpu_torch.ha import placement as tplacement
from nydus_snapshotter_tpu_torch.ha import replicate as treplicate
from nydus_snapshotter_tpu_torch.ha import resolve_ha_config as t_resolve_ha_config
from nydus_snapshotter_tpu_torch.parallel import dict_service as tds
from nydus_snapshotter_tpu_torch.system import SystemController
from nydus_snapshotter_tpu_torch.utils import udshttp as tudshttp

REPO = Path(__file__).resolve().parent.parent

PKG = {
    "port": SimpleNamespace(
        fp=tfp, ds=tds, udshttp=tudshttp,
        DictService=functools.partial(tds.DictService, device="cpu"),
        ServiceDict=functools.partial(tds.ServiceDict, device="cpu"),
        HaAgent=treplicate.HaAgent, ReplicaTailer=treplicate.ReplicaTailer,
        PlacementController=tplacement.PlacementController, rank=tplacement._rank,
        resolve_ha_config=t_resolve_ha_config,
    ),
    "ref": SimpleNamespace(
        fp=jfp, ds=jds, udshttp=judshttp,
        DictService=jds.DictService, ServiceDict=jds.ServiceDict,
        HaAgent=jreplicate.HaAgent, ReplicaTailer=jreplicate.ReplicaTailer,
        PlacementController=jplacement.PlacementController, rank=jplacement._rank,
        resolve_ha_config=j_resolve_ha_config,
    ),
}
BOTH = pytest.mark.parametrize("pkg", ["port", "ref"])

RNG = np.random.default_rng(23)
POOL = [
    RNG.integers(0, 256, int(RNG.integers(4_000, 40_000)), dtype=np.uint8).tobytes()
    for _ in range(16)
]
OPT = dict(chunk_size=0x10000, chunking="cdc")


def mk_image(seed: int, layers: int = 2, files: int = 5) -> list[bytes]:
    r = np.random.default_rng(seed)
    out = []
    for _li in range(layers):
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w", format=tarfile.GNU_FORMAT) as tf:
            for fi in range(files):
                data = POOL[int(r.integers(0, len(POOL)))]
                ti = tarfile.TarInfo(f"d/f{seed}_{fi}")
                ti.size = len(data)
                tf.addfile(ti, io.BytesIO(data))
        out.append(buf.getvalue())
    return out


@functools.lru_cache(maxsize=None)
def bootstrap_of(seed: int) -> bytes:
    return JBatchConverter(JPackOption(**OPT)).convert_image(f"img{seed}", mk_image(seed)).bootstrap


@pytest.fixture(autouse=True)
def _clean_failpoints():
    for p in PKG.values():
        p.fp.clear()
    yield
    for p in PKG.values():
        p.fp.clear()


def wait_until(pred, timeout=10.0, step=0.02, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(step)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.fixture()
def stack(tmp_path):
    """Factory of running services (``run(kind, name)``) and agents; all
    stopped at teardown, tailers first."""
    started, agents = [], []

    def run(kind: str, name: str, role=None):
        svc = PKG[kind].DictService()
        if role is not None:
            agents.append(PKG[kind].HaAgent(svc, role=role))
        svc.run(str(tmp_path / f"{name}.sock"))
        started.append(svc)
        return svc

    yield run
    for a in agents:
        if a.tailer is not None:
            a.tailer.stop()
    for svc in started:
        svc.stop()


@pytest.fixture()
def pair(stack, pkg):
    """Primary + replica of one package, replication running."""
    prim = stack(pkg, "p", role="primary")
    repl = stack(pkg, "r", role="unassigned")
    repl.ha.configure("replica", upstream=prim.sock_path)
    return prim, repl, repl.ha


def records(svc, ns="default") -> bytes:
    """The namespace's record tables, read under its lock (a tail is
    applied under it, blobs and chunks before batches)."""
    sd = svc.dict_for(ns)
    with sd._mu:
        return sd.records.bootstrap.to_bytes()


def n_chunks(svc, ns="default") -> int:
    return len(svc.dict_for(ns).records.bootstrap.chunks)


def replica_caught_up(prim, repl, ns="default"):
    return n_chunks(prim, ns) > 0 and records(prim, ns) == records(repl, ns)


def _members(n, addr="mem"):
    return [
        jfleet.Member(name=f"dict-{i}", component="dict", address=f"/tmp/{addr}{i}.sock",
                      pid=1000 + i)
        for i in range(n)
    ]


def _live(members):
    return {m.name: {"up": True, "stale": False} for m in members}


def _oracle(boots) -> bytes:
    oracle = jds.ServiceDict("default")
    for b in boots:
        oracle.merge_bootstrap_bytes(b)
    return oracle.records.bootstrap.to_bytes()


# ---------------------------------------------------------------------------
# Replication
# ---------------------------------------------------------------------------


class TestReplication:
    @BOTH
    def test_journal_tail_replay_identity(self, pair, pkg):
        prim, repl, _agent = pair
        cli = PKG[pkg].ds.DictClient(prim.sock_path)
        for seed in (1, 2, 3):
            cli.merge(bootstrap_of(seed), "default")
        wait_until(lambda: replica_caught_up(prim, repl), what="replica catch-up")
        assert records(prim) == records(repl)
        p_sd, r_sd = prim.dict_for("default"), repl.dict_for("default")
        digs = b"".join(c.digest for c in p_sd.records.bootstrap.chunks)
        assert np.array_equal(p_sd.probe(digs), r_sd.probe(digs))
        miss = b"".join(bytes(RNG.integers(0, 256, 32, dtype=np.uint8)) for _ in range(4))
        assert (r_sd.probe(miss) == -1).all()
        cli.close()

    @BOTH
    def test_byte_budget_bounds_in_flight_payload(self, stack, pkg):
        prim = stack(pkg, "p")
        repl = PKG[pkg].DictService()
        cli = PKG[pkg].ds.DictClient(prim.sock_path)
        for seed in (4, 5, 6):
            cli.merge(bootstrap_of(seed), "default")
        budget = 256  # 4 chunk rows a pull
        tailer = PKG[pkg].ReplicaTailer(repl, prim.sock_path, budget_bytes=budget, poll_s=0.01)
        try:
            assert tailer.poll_once() == n_chunks(prim)
            assert tailer.pulls >= 2
            assert tailer.max_pull_bytes <= budget + 4096
            assert replica_caught_up(prim, repl)
            assert records(prim) == records(repl)
        finally:
            tailer.stop()
            cli.close()

    @BOTH
    def test_replication_chaos_tailer_survives(self, pair, pkg):
        prim, repl, agent = pair
        PKG[pkg].fp.inject("ha.replicate", "error(OSError)*3")
        cli = PKG[pkg].ds.DictClient(prim.sock_path)
        cli.merge(bootstrap_of(7), "default")
        # a round already past the site when the fault was armed may catch
        # up first: wait for the three faults, then for convergence
        wait_until(lambda: PKG[pkg].fp.counts().get("ha.replicate", 0) >= 3, what="the faults")
        cli.merge(bootstrap_of(17), "default")
        wait_until(lambda: replica_caught_up(prim, repl), what="post-chaos catch-up")
        assert agent.tailer.errors >= 3
        cli.close()

    @BOTH
    def test_regressed_primary_resyncs_loudly(self, stack, pkg, caplog):
        prim = stack(pkg, "p")
        repl = PKG[pkg].DictService()
        cli = PKG[pkg].ds.DictClient(prim.sock_path)
        cli.merge(bootstrap_of(8), "default")
        cli.merge(bootstrap_of(9), "default")
        tailer = PKG[pkg].ReplicaTailer(repl, prim.sock_path, poll_s=0.01)
        try:
            tailer.poll_once()
            assert replica_caught_up(prim, repl)
            prim.reset_namespace("default")  # a restart with a younger table
            cli.merge(bootstrap_of(8), "default")
            with caplog.at_level(logging.ERROR):
                tailer.poll_once()  # detects the regression, resyncs
                tailer.poll_once()  # re-pulls the snapshot
            assert any("resyncing from a full snapshot" in r.message for r in caplog.records)
            assert tailer.status()["namespaces"]["default"]["resyncs"] == 1
            assert records(prim) == records(repl)
        finally:
            tailer.stop()
            cli.close()

    @BOTH
    def test_replica_rejects_writes_with_503(self, pair, pkg):
        _prim, repl, _agent = pair
        cli = PKG[pkg].ds.DictClient(repl.sock_path)
        with pytest.raises(PKG[pkg].ds.DictServiceError, match="503"):
            cli.merge(bootstrap_of(10), "default")
        assert cli.stats("default")["chunks"] == 0
        cli.close()


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------


class TestPlacement:
    @BOTH
    def test_initial_assignment_distinct_slots(self, pkg):
        members = _members(6)
        pc = PKG[pkg].PlacementController(lambda: members, lambda: _live(members),
                                          shards=2, replicas=2)
        assert pc.tick() is True
        m = pc.map()
        assert m["epoch"] == 1
        seen = set()
        for a in m["assignments"]:
            slots = [a["primary"]["name"]] + [r["name"] for r in a["replicas"]]
            assert len(a["replicas"]) == 2
            for s in slots:
                assert s not in seen
                seen.add(s)

    @BOTH
    def test_sticky_primary_and_minimal_churn_on_join_leave(self, pkg):
        members = _members(6)
        live = _live(members)
        pc = PKG[pkg].PlacementController(lambda: list(members), lambda: dict(live),
                                          shards=2, replicas=1)
        pc.tick()
        before = pc.map()["assignments"]
        primaries = [a["primary"]["name"] for a in before]
        members.append(jfleet.Member(name="dict-9", component="dict",
                                     address="/tmp/mem9.sock", pid=1009))
        live["dict-9"] = {"up": True, "stale": False}
        pc.tick()
        after = pc.map()["assignments"]
        assert [a["primary"]["name"] for a in after] == primaries
        churn = sum(
            1 for b, a in zip(before, after)
            for rb, ra in zip(b["replicas"], a["replicas"]) if rb["name"] != ra["name"]
        )
        assert churn <= len(after)
        assigned = {a["primary"]["name"] for a in after} | {
            r["name"] for a in after for r in a["replicas"]
        }
        spare = next(m for m in members if m.name not in assigned)
        live[spare.name] = {"up": False, "stale": True}
        epoch_before = pc.map()["epoch"]
        pc.tick()
        assert pc.map()["epoch"] == epoch_before
        assert pc.map()["assignments"] == after

    @BOTH
    def test_promotes_most_caught_up_replica(self, stack, pkg):
        prim = stack(pkg, "p", role="primary")
        replicas = [stack(pkg, f"r{i}", role="unassigned") for i in range(2)]
        replicas[0].ha.configure("replica", upstream=prim.sock_path)
        replicas[1].ha.configure("replica", upstream=prim.sock_path)
        replicas[1].ha.tailer.stop()  # r1 stays empty
        cli = PKG[pkg].ds.DictClient(prim.sock_path)
        cli.merge(bootstrap_of(11), "default")
        cli.close()
        wait_until(lambda: replica_caught_up(prim, replicas[0]), what="r0 catch-up")
        svcs = [prim] + replicas
        members = [
            jfleet.Member(name=n, component="dict", address=s.sock_path, pid=i + 1)
            for i, (n, s) in enumerate(zip(("dict-p", "dict-r0", "dict-r1"), svcs))
        ]
        live = _live(members)
        engine = SloEngine([])
        pc = PKG[pkg].PlacementController(lambda: members, lambda: dict(live), shards=1,
                                          replicas=2, engine=engine)
        pc.tick()
        seat = pc.map()["assignments"][0]["primary"]["name"]
        addr_of = {m.name: m.address for m in members}
        for svc in svcs:
            if svc.sock_path == addr_of[seat]:
                svc.stop()
        live[seat] = {"up": False, "stale": True}
        PKG[pkg].fp.inject("ha.place", "delay(0)*1")
        pc.tick()
        m = pc.map()
        promoted = m["assignments"][0]["primary"]["name"]
        assert promoted != seat
        assert m["promotions"] == 1
        events = engine.status()["events"]
        assert events and events[-1]["kind"] == "dict_ha_promotion"
        promoted_svc = next(s for s in svcs if s.sock_path == addr_of[promoted])
        assert promoted_svc.ha.is_primary()
        if seat == "dict-p":
            assert promoted == "dict-r0"

    @BOTH
    def test_ha_place_failpoint_fails_tick_loudly(self, pkg):
        members = _members(2)
        pc = PKG[pkg].PlacementController(lambda: members, lambda: _live(members),
                                          shards=1, replicas=1)
        PKG[pkg].fp.inject("ha.place", "error(OSError)")
        with pytest.raises(OSError):
            pc.tick()

    @BOTH
    def test_ha_promote_failpoint_fails_promotion_loudly(self, pkg):
        agent = PKG[pkg].HaAgent(PKG[pkg].DictService(), role="unassigned")
        PKG[pkg].fp.inject("ha.promote", "error(OSError)")
        with pytest.raises(OSError):
            agent.promote()

    @BOTH
    def test_restarted_member_gets_role_repushed(self, pkg):
        members = _members(2)
        pc = PKG[pkg].PlacementController(lambda: members, lambda: _live(members),
                                          shards=1, replicas=1)
        pushes = []
        pc._push_role = lambda name, addr, payload: pushes.append(name) or True
        pc.tick()
        first = list(pushes)
        assert set(first) == {"dict-0", "dict-1"}
        pc.tick()
        assert pushes == first
        members[0].pid += 1000
        pc.tick()
        assert pushes.count(members[0].name) == 2

    @BOTH
    def test_report_down_feeds_placement(self, pkg):
        members = _members(3)
        live = _live(members)
        pc = PKG[pkg].PlacementController(lambda: members, lambda: dict(live),
                                          shards=1, replicas=1)
        pc.tick()
        seat = pc.map()["assignments"][0]["primary"]["name"]
        pc.report_down(seat, source="test")
        names, _addr = pc._live_members()
        assert seat not in names

    @BOTH
    def test_fleet_placement_routes(self, pkg):
        """The port's fleet plane serves either package's controller."""
        plane = tfleet.FleetPlane(cfg=tfleet.FleetRuntimeConfig(enable=True), slo_objectives=[])
        members = _members(2)
        pc = PKG[pkg].PlacementController(lambda: members, lambda: _live(members),
                                          shards=1, replicas=1, engine=plane.slo)
        plane.attach_placement(pc)
        pc.tick()
        status, _ctype, payload = plane.handle("GET", "/api/v1/fleet/placement", {}, b"")
        assert status == 200
        doc = json.loads(payload)
        assert doc["epoch"] == 1 and len(doc["assignments"]) == 1
        status, _ctype, _payload = plane.handle(
            "POST", "/api/v1/fleet/placement/report", {}, b'{"name": "dict-0", "source": "test"}'
        )
        assert status == 200
        names, _ = pc._live_members()
        assert "dict-0" not in names


# ---------------------------------------------------------------------------
# Client failover
# ---------------------------------------------------------------------------


class TestClientFailover:
    @BOTH
    def test_mid_merge_failover_byte_identity(self, pair, pkg):
        prim, repl, agent = pair
        ds = PKG[pkg].ds
        boots = [bootstrap_of(s) for s in (20, 21, 22, 23)]
        scd = ds.ServiceChunkDict([ds.DictClient(prim.sock_path)], failover=[[repl.sock_path]])
        for b in boots[:2]:
            scd.add_bootstrap_bytes(b)
        wait_until(lambda: replica_caught_up(prim, repl), what="catch-up")
        prim.stop()
        agent.promote()
        for b in boots[2:]:
            scd.add_bootstrap_bytes(b)
        assert records(repl) == _oracle(boots)
        assert len(scd.bootstrap.chunks) == n_chunks(repl)
        scd.close()

    @BOTH
    def test_failover_repairs_lagging_replica(self, stack, pkg):
        prim = stack(pkg, "p")
        repl = stack(pkg, "r", role="unassigned")
        ds = PKG[pkg].ds
        boots = [bootstrap_of(s) for s in (30, 31, 32)]
        scd = ds.ServiceChunkDict([ds.DictClient(prim.sock_path)], failover=[[repl.sock_path]])
        scd.add_bootstrap_bytes(boots[0])  # no replication ran: maximally behind
        scd.add_bootstrap_bytes(boots[1])
        prim.stop()
        repl.ha.promote()
        scd.add_bootstrap_bytes(boots[2])
        assert records(repl) == _oracle(boots)
        scd.close()

    @BOTH
    def test_open_chunk_dict_failover_scheme(self, stack, pkg):
        svc = stack(pkg, "s")
        scd = PKG[pkg].ds.open_chunk_dict(f"service://{svc.sock_path}|/tmp/replica.sock#ns1")
        assert scd.namespace == "ns1"
        assert scd._shards[0].alternates == ["/tmp/replica.sock"]
        assert scd.shard_addrs == [svc.sock_path]  # the stable route key
        scd.close()

    @BOTH
    def test_ha_config_resolution(self, monkeypatch, pkg):
        monkeypatch.setenv("NTPU_DICT_HA_SHARDS", "3")
        monkeypatch.setenv("NTPU_DICT_HA_REPLICAS", "2")
        monkeypatch.setenv("NTPU_DICT_HA_BUDGET_KIB", "128")
        monkeypatch.setenv("NTPU_DICT_HA_POLL_MS", "25")
        cfg = PKG[pkg].resolve_ha_config()
        assert (cfg.shards, cfg.replicas) == (3, 2)
        assert cfg.budget_bytes == 128 << 10
        assert abs(cfg.poll_s - 0.025) < 1e-9
        assert cfg.enabled

    @BOTH
    def test_rank_is_deterministic_and_shard_dependent(self, pkg):
        rank = PKG[pkg].rank
        names = [f"m{i}" for i in range(8)]
        assert rank(0, names) == rank(0, list(reversed(names)))
        assert rank(0, names) != rank(1, names)


# ---------------------------------------------------------------------------
# Planned demotion
# ---------------------------------------------------------------------------


def _cluster(stack, pkg, n=2):
    svcs = [stack(pkg, f"m{i}", role="unassigned") for i in range(n)]
    members = [
        jfleet.Member(name=f"dict-{i}", component="dict", address=svcs[i].sock_path, pid=i + 1)
        for i in range(n)
    ]
    engine = SloEngine([])
    pc = PKG[pkg].PlacementController(lambda: members, lambda: _live(members), shards=1,
                                      replicas=n - 1, engine=engine)
    pc.tick()
    return svcs, pc, engine, {m.name: m.address for m in members}, {s.sock_path: s for s in svcs}


class TestPlannedDemotion:
    @BOTH
    def test_demotion_byte_identity_zero_client_errors(self, stack, pkg):
        svcs, pc, engine, addr_of, svc_of = _cluster(stack, pkg)
        ds = PKG[pkg].ds
        seat = pc.map()["assignments"][0]["primary"]["name"]
        repl_name = pc.map()["assignments"][0]["replicas"][0]["name"]
        prim, repl = svc_of[addr_of[seat]], svc_of[addr_of[repl_name]]
        boots = [bootstrap_of(s) for s in (40, 41, 42, 43)]
        scd = ds.ServiceChunkDict([ds.DictClient(prim.sock_path)], failover=[[repl.sock_path]])
        for b in boots[:2]:
            scd.add_bootstrap_bytes(b)
        wait_until(lambda: replica_caught_up(prim, repl), what="catch-up")
        errors = []

        def writer():
            try:
                for b in boots[2:]:
                    scd.add_bootstrap_bytes(b)
            except BaseException as e:  # noqa: BLE001 - the assertion below
                errors.append(repr(e))

        t = threading.Thread(target=writer)
        t.start()
        event = pc.demote(0, timeout_s=10.0)
        t.join(timeout=30.0)
        assert not t.is_alive(), "writer wedged through the drain"
        assert errors == []
        assert event["kind"] == "planned_demotion"
        assert (event["from"], event["to"]) == (seat, repl_name)
        assert records(repl) == _oracle(boots)
        m = pc.map()
        assert m["assignments"][0]["primary"]["name"] == repl_name
        assert m["promotions"] == 1
        assert seat in [r["name"] for r in m["assignments"][0]["replicas"]]
        assert engine.status()["events"][-1]["kind"] == "dict_ha_planned_demotion"
        scd.close()

    @BOTH
    def test_demotion_aborts_and_restores_when_no_replica_catches_up(self, stack, pkg):
        svcs, pc, _engine, addr_of, svc_of = _cluster(stack, pkg)
        seat = pc.map()["assignments"][0]["primary"]["name"]
        prim = svc_of[addr_of[seat]]
        for s in svcs:
            if s.ha.tailer is not None:
                s.ha.tailer.stop()
        cli = PKG[pkg].ds.DictClient(prim.sock_path)
        cli.merge(bootstrap_of(50), "default")
        with pytest.raises(RuntimeError, match="aborted"):
            pc.demote(0, timeout_s=0.3, poll_s=0.05)
        assert prim.ha.is_primary()
        cli.merge(bootstrap_of(51), "default")
        assert pc.map()["promotions"] == 0
        cli.close()

    @BOTH
    def test_demote_validates_shard_and_topology(self, stack, pkg):
        _svcs, pc, _engine, _addr, _svc = _cluster(stack, pkg)
        with pytest.raises(ValueError, match="out of range"):
            pc.demote(7)
        members = _members(1)
        lone = PKG[pkg].PlacementController(lambda: members, lambda: _live(members),
                                            shards=1, replicas=0)
        lone.tick()
        with pytest.raises(ValueError, match="no replica"):
            lone.demote(0)

    @BOTH
    def test_draining_role_semantics(self, stack, pkg):
        svc = stack(pkg, "d", role="primary")
        agent = svc.ha
        cli = PKG[pkg].ds.DictClient(svc.sock_path)
        cli.merge(bootstrap_of(60), "default")
        st = agent.demote()
        assert st["role"] == "draining"
        with pytest.raises(PKG[pkg].ds.DictServiceError, match="503"):
            cli.merge(bootstrap_of(61), "default")
        assert st["replication"]["namespaces"]["default"]["chunks"] > 0
        with pytest.raises(ValueError, match="draining"):
            agent.demote()
        agent.promote()
        cli.merge(bootstrap_of(61), "default")
        cli.close()

    @BOTH
    def test_demote_http_routes(self, stack, pkg):
        svc = stack(pkg, "r", role="replica")
        status, _body = PKG[pkg].udshttp.request(svc.sock_path, "/api/v1/ha/demote",
                                                 method="POST", body=b"{}")
        assert status == 409
        plane = tfleet.FleetPlane(cfg=tfleet.FleetRuntimeConfig(enable=True), slo_objectives=[])
        status, _ctype, _body = plane.handle("POST", "/api/v1/fleet/placement/demote", {},
                                             b'{"shard": 0}')
        assert status == 404
        members = _members(2)
        pc = PKG[pkg].PlacementController(lambda: members, lambda: _live(members),
                                          shards=1, replicas=1)
        plane.attach_placement(pc)
        status, _ctype, body = plane.handle("POST", "/api/v1/fleet/placement/demote", {},
                                            b'{"shard": 9}')
        assert status == 400
        assert "out of range" in json.loads(body)["message"]

    @BOTH
    def test_scale_replicas_bounds(self, pkg):
        members = _members(4)
        pc = PKG[pkg].PlacementController(lambda: members, lambda: _live(members),
                                          shards=1, replicas=1)
        assert pc.scale_replicas(+1) == 2
        assert pc.scale_replicas(+100, max_replicas=3) == 3
        assert pc.scale_replicas(-100) == 0
        pc.scale_replicas(+1)
        pc.tick()
        assert len(pc.map()["assignments"][0]["replicas"]) == 1


# ---------------------------------------------------------------------------
# Across the packages
# ---------------------------------------------------------------------------


def test_placement_maps_equal_reference():
    """Both controllers, fed the same member and liveness sequence (joins,
    a death, a report, a rejoin under a fresh pid, a scale-up), publish the
    same maps and push the same roles."""
    members = _members(7)
    live = _live(members)
    ctls = {
        k: PKG[k].PlacementController(lambda: list(members), lambda: dict(live),
                                      shards=3, replicas=1, clock=lambda: 100.0)
        for k in PKG
    }
    pushes = {k: [] for k in PKG}
    for k, pc in ctls.items():
        pc._push_role = lambda name, addr, payload, k=k: pushes[k].append((name, payload)) or True
        pc._ha_status = lambda address: {"replication": {"namespaces": {"default": {"chunks": len(address)}}}}
        pc._promote_member = lambda name, address: True

    def step():
        got = [pc.tick() for pc in ctls.values()]
        maps = [pc.map() for pc in ctls.values()]
        assert got[0] == got[1]
        assert maps[0] == maps[1]

    step()
    members.append(jfleet.Member(name="dict-x", component="dict", address="/tmp/x.sock", pid=7))
    live["dict-x"] = {"up": True, "stale": False}
    step()
    seat = ctls["port"].map()["assignments"][1]["primary"]["name"]
    live[seat] = {"up": False, "stale": True}
    step()
    for pc in ctls.values():
        pc.report_down("dict-3", source="test")
    step()
    live[seat] = {"up": True, "stale": False}
    members[0].pid += 1
    for pc in ctls.values():
        pc.scale_replicas(+1)
    step()
    assert pushes["port"] == pushes["ref"]
    names = [m.name for m in members]
    for s in range(5):
        assert tplacement._rank(s, names) == jplacement._rank(s, names)


@pytest.mark.parametrize("primary, replica", [("ref", "port"), ("port", "ref")],
                         ids=["ref-primary-port-replica", "port-primary-ref-replica"])
def test_cross_package_replication(stack, primary, replica):
    """A replica of one package tails a primary of the other: the record
    tables and probe answers are identical, and after the primary dies a
    client of the replica's package fails over onto it byte-identically."""
    prim = stack(primary, "p", role="primary")
    repl = stack(replica, "r", role="unassigned")
    repl.ha.configure("replica", upstream=prim.sock_path)
    boots = [bootstrap_of(s) for s in (70, 71, 72)]
    ds = PKG[replica].ds
    scd = ds.ServiceChunkDict([ds.DictClient(prim.sock_path)], failover=[[repl.sock_path]])
    for b in boots[:2]:
        scd.add_bootstrap_bytes(b)
    wait_until(lambda: replica_caught_up(prim, repl), what="cross-package catch-up")
    assert records(prim) == records(repl)
    digs = b"".join(c.digest for c in prim.dict_for("default").records.bootstrap.chunks)
    assert np.array_equal(prim.dict_for("default").probe(digs), repl.dict_for("default").probe(digs))
    status = PKG[primary].udshttp.get_json(repl.sock_path, "/api/v1/ha/status")
    assert status["role"] == "replica" and status["upstream"] == prim.sock_path
    prim.stop()
    repl.ha.promote()
    scd.add_bootstrap_bytes(boots[2])
    assert records(repl) == _oracle(boots)
    scd.close()


def test_replica_tail_across_rebuild_is_position_identical():
    """A tail applied in small pulls into a replica index with no headroom
    crosses several rebuilds; the record tables stay position-identical to
    the primary's and every digest probes to its primary position, in both
    packages' replicas."""
    boots = [bootstrap_of(80)] + [synthetic_bootstrap(700, seed) for seed in (81, 82, 83)]
    prim = jds.ServiceDict("default")
    for b in boots:
        prim.merge_bootstrap_bytes(b)
    want = prim.records.bootstrap.to_bytes()
    total = len(prim.records.bootstrap.chunks)
    cfg = tds.DictRuntimeConfig(load_factor=0.5, headroom=1.0, service="", namespace="default",
                                backend="auto")
    port = tds.ServiceDict("default", cfg, device="cpu")
    jcfg = jds.DictRuntimeConfig(0.5, 1.0, "", "default", "auto")
    ref = jds.ServiceDict("default", jcfg)
    for sd in (port, ref):
        cur = [0, 0, 0, 0]
        while cur[0] < total:
            payload = prim.entries_delta(*cur, limit=97)
            meta, ca, ba, ta, ea = _parse_delta(payload)
            sd.apply_replica_tail(meta, ca, ba, ta, ea, base=tuple(cur))
            for i, arr in enumerate((ca, ba, ta, ea)):
                cur[i] += len(arr)
        assert sd.records.bootstrap.to_bytes() == want
    assert port.index.rebuild_epoch > 0
    digs = b"".join(c.digest for c in prim.records.bootstrap.chunks)
    assert np.array_equal(port.probe(digs), np.arange(total))
    assert np.array_equal(port.probe(digs), ref.probe(digs))
    with pytest.raises(tds.DictServiceError, match="gap"):
        port.apply_replica_tail(meta, ca, ba, ta, ea, base=(0, 0, 0, 0))


def synthetic_bootstrap(n: int, seed: int) -> bytes:
    """A dict-image bootstrap of ``n`` chunk records with random digests in
    one blob (the reference's record classes)."""
    from nydus_snapshotter_tpu.models.bootstrap import BlobRecord, Bootstrap, ChunkRecord

    r = np.random.default_rng(seed)
    digs = r.integers(0, 256, (n, 32), dtype=np.uint8)
    chunks = [
        ChunkRecord(digest=d.tobytes(), blob_index=0, flags=0, uncompressed_offset=i << 16,
                    compressed_offset=i << 15, uncompressed_size=1 << 16, compressed_size=1 << 15)
        for i, d in enumerate(digs)
    ]
    blob = BlobRecord(blob_id=f"{seed:064x}", compressed_size=n << 15, uncompressed_size=n << 16,
                      chunk_count=n)
    return Bootstrap(chunk_size=1 << 16, inodes=[], chunks=chunks, blobs=[blob]).to_bytes()


def _parse_delta(payload: bytes):
    hdr = np.frombuffer(payload, dtype=np.uint64, count=8)
    off = hdr.nbytes
    out = []
    for n, dt in zip(hdr[:4], (tds._CHUNK_DT, tds._BLOB_DT, tds._BATCH_DT, tds._CIPHER_DT)):
        arr = np.frombuffer(payload, dtype=dt, count=int(n), offset=off)
        off += arr.nbytes
        out.append(arr)
    meta = {"epoch": int(hdr[4]), "rebuild_epoch": int(hdr[5]), "chunk_size": int(hdr[6]),
            "total_chunks": int(hdr[7])}
    return (meta, *out)


def test_service_ha_batch_through_reference_controller(stack, tmp_path):
    """``service+ha://`` resolved through the port's fleet plane and system
    controller (the reference's until they were ported; the name stays),
    with the port's placement controller attached over two port members.
    The primary is killed after the first image; a down report and a tick
    promote the replica, and the batch's blobs and bootstraps equal the
    reference's private-dict batch."""
    plane = tfleet.FleetPlane(cfg=tfleet.FleetRuntimeConfig(enable=True), slo_objectives=[])
    pc = tplacement.PlacementController(plane.registry.members, plane.federator.liveness,
                                        shards=1, replicas=1, engine=plane.slo)
    plane.attach_placement(pc)
    csock = str(tmp_path / "system.sock")
    controller = SystemController(fs=None, managers=[], sock_path=csock, fleet=plane)
    controller.run()
    try:
        svcs = [stack("port", f"m{i}", role="unassigned") for i in range(2)]
        for i, s in enumerate(svcs):
            plane.registry.register(tfleet.Member(name=f"dict-{i}", component="dict",
                                                  address=s.sock_path, pid=i + 1))
        pc.tick()
        seat = pc.map()["assignments"][0]
        prim = next(s for s in svcs if s.sock_path == seat["primary"]["address"])
        repl = next(s for s in svcs if s is not prim)
        images = [(f"img{s}", mk_image(s)) for s in (90, 91, 92)]
        bc = BatchConverter(PackOption(backend="hybrid", **OPT), dict_service=f"service+ha://{csock}",
                            device="cpu")
        try:
            assert bc.dict.shard_addrs == ["dict-shard-0"]
            got = [bc.convert_image(*images[0])]
            wait_until(lambda: replica_caught_up(prim, repl), what="replica catch-up")
            prim.stop()
            pc.report_down(seat["primary"]["name"], source="test")
            assert pc.tick() is True
            assert pc.map()["assignments"][0]["primary"]["address"] == repl.sock_path
            assert repl.ha.is_primary()
            got += [bc.convert_image(*img) for img in images[1:]]
        finally:
            bc.dict.close()
        want = JBatchConverter(JPackOption(backend="hybrid", **OPT)).convert_many(images)
        for g, w in zip(got, want):
            assert g.bootstrap == w.bootstrap, g.name
            assert g.blob_digests == w.blob_digests, g.name
            assert g.layer_blobs == w.layer_blobs, g.name
    finally:
        controller.stop()


def test_runner_child_on_cpu(tmp_path):
    """``python -m nydus_snapshotter_tpu_torch.ha.runner --device cpu``: a
    primary that serves merges and probes, reports its role, and stops on
    SIGTERM; ``--device cuda`` without CUDA exits with an error."""
    sock = str(tmp_path / "runner.sock")
    env = {k: v for k, v in os.environ.items() if not k.startswith("NTPU_FLEET")}
    cmd = [sys.executable, "-m", "nydus_snapshotter_tpu_torch.ha.runner", "--listen", sock,
           "--role", "primary"]
    proc = subprocess.Popen(cmd + ["--device", "cpu"], cwd=REPO, env=env,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        def answering():
            try:
                return tudshttp.get_json(sock, "/api/v1/ha/status", timeout=1.0)["role"] == "primary"
            except OSError:
                return False

        wait_until(answering, timeout=60.0, step=0.1, what="the runner's socket")
        cli = tds.DictClient(sock)
        boot = bootstrap_of(95)
        assert cli.merge(boot, "default")["added"] > 0
        digs = [c.digest for c in __import__(
            "nydus_snapshotter_tpu_torch.models.bootstrap", fromlist=["Bootstrap"]
        ).Bootstrap.from_bytes(boot).chunks]
        assert (cli.probe(digs, "default") >= 0).all()
        cli.close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stderr.close()
    if not __import__("torch").cuda.is_available():
        bad = subprocess.run(cmd + ["--device", "cuda"], cwd=REPO, env=env, capture_output=True,
                             timeout=60)
        assert bad.returncode != 0 and b"CUDA is not available" in bad.stderr


def test_fleet_member_half_matches_reference(monkeypatch):
    """The port's member half resolves the reference's config and registers
    over the same route as the reference's."""
    monkeypatch.setenv("NTPU_FLEET_CONTROLLER", "/run/ctl.sock")
    monkeypatch.setenv("NTPU_FLEET_MEMBER", "dict-a")
    monkeypatch.setenv("NTPU_FLEET_STALE_AFTER_SECS", "3")
    assert vars(tfleet.resolve_fleet_config()) == vars(jfleet.resolve_fleet_config())
    assert tfleet.MEMBERS_PATH == jfleet.MEMBERS_PATH
    m = tfleet.Member(name="a", component="dict", address="/x.sock", pid=1, extra={"k": 1})
    j = jfleet.Member(name="a", component="dict", address="/x.sock", pid=1, extra={"k": 1})
    assert m.to_dict() == j.to_dict()
    # the controller is the member itself: no registration
    assert tfleet.register_self("dict", "/run/ctl.sock") is False


def test_rebuilt_primary_keeps_replica_cursor(stack):
    """A primary whose index rebuilt (a journal compacted past the replica's
    cursor, wire 409) is tailed in many pulls: the port's replica
    re-baselines on the primary's epoch and never resyncs, its tables equal
    the primary's after every round. The reference's re-baselines on its
    own index epoch (one per pull) and resyncs from zero on the next round:
    a fault of the reference that the port does not carry (ROADMAP Queue C)."""
    resyncs = {}
    for kind in ("port", "ref"):
        prim = stack(kind, f"{kind}-p")
        cli = PKG[kind].ds.DictClient(prim.sock_path)
        cli.merge(synthetic_bootstrap(3000, 91), "default")
        assert cli.stats("default")["rebuild_epoch"] > 0
        tailer = PKG[kind].ReplicaTailer(PKG[kind].DictService(), prim.sock_path,
                                         budget_bytes=64 * 500, poll_s=0.01)
        try:
            for _ in range(3):
                tailer.poll_once()
                assert records(tailer.service) == records(prim)
            cli.merge(synthetic_bootstrap(900, 92), "default")  # a second rebuild
            for _ in range(2):
                tailer.poll_once()
            assert records(tailer.service) == records(prim)
            resyncs[kind] = tailer.status()["namespaces"]["default"]["resyncs"]
        finally:
            tailer.stop()
            cli.close()
    assert resyncs["port"] == 0
    assert resyncs["ref"] >= 1
