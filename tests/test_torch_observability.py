"""The port's metrics exporter, system controller, prefetch map and pprof
listener against the JAX package's.

Every case of tests/test_observability.py runs in both packages (``pkg``,
through ``ported_cases``: the reference's own bodies): the registry
primitives, the ``/proc`` samplers, the collectors, ``MetricsServer`` on
``/v1/metrics``, ``SystemController`` on its unix socket, the backend
secret filter, ``Pm`` and ``pprof``.

Cross-package case, on numpy-seeded daemons: a ``SystemController`` of
each package, over fake managers holding the same daemons, instances and
backend configs, answers one seeded request sequence on its socket
(``/api/v1/daemons``, ``/api/v1/daemons/records``, every daemon's
backend, the prefetch route with good and bad bodies, and
``/api/v1/daemons/upgrade`` with a present and a missing binary) with
equal statuses and bodies; the process's resident size, which moves
between two reads, is only checked to be positive. Both upgrades walk the
daemons in the same order. Over a real ``daemon.Daemon`` the port's
``/api/v1/daemons`` answers where the reference's fails (its fault, fixed
in the port).
"""

from __future__ import annotations

import importlib
import json
import os

import numpy as np
import pytest

from tests.test_torch_fetch_sched import ROOTS, SIDES, ported_cases
from tests.test_torch_snapshotter import short_tmp_path

tmp_path = short_tmp_path("ob")
ported_cases("test_observability", globals())


def _mod(side: str, name: str):
    return importlib.import_module(f"{ROOTS[side]}.{name}")


class _States:
    def __init__(self, api_socket: str, config_path: str):
        self.api_socket = api_socket
        self.supervisor_path = ""
        self.config_path = config_path
        self.fs_driver = "fusedev"


class _Instances:
    def __init__(self, rafs):
        self._rafs = rafs

    def list(self):
        return list(self._rafs)


class _Daemon:
    def __init__(self, side, daemon_id, rafs, config_path):
        self.side = side
        self.id = daemon_id
        self.states = _States(f"/run/{daemon_id}/api.sock", config_path)
        self.instances = _Instances(rafs)

    def pid(self):
        return os.getpid()

    def state(self):
        return _mod(self.side, "daemon.types").DaemonState.RUNNING

    def ref_count(self):
        return len(self.instances.list())

    def client(self):
        raise ConnectionError("no daemon in this test")


class _Manager:
    def __init__(self, daemons, db_rows):
        self._daemons = daemons
        self.upgraded = []
        self.db = type("Db", (), {"walk_daemons": staticmethod(lambda: iter(db_rows))})()

    def list_daemons(self):
        return self._daemons

    def get_by_daemon_id(self, daemon_id):
        return next((d for d in self._daemons if d.id == daemon_id), None)

    def do_daemon_upgrade(self, d):
        self.upgraded.append((d.id, getattr(d.states, "nydusd_path", "")))


def _managers(side: str, root, seed: int):
    rng = np.random.default_rng(seed)
    rafs_cls = _mod(side, "rafs").Rafs
    mgrs = []
    for m in range(int(rng.integers(1, 3))):
        daemons = []
        for i in range(int(rng.integers(1, 4))):
            did = f"d{m}{i}-{int(rng.integers(0, 1 << 30)):x}"
            rafs = [rafs_cls(snapshot_id=f"{int(rng.integers(1, 999))}", image_id=f"reg.example.com/i{j}:v",
                             fs_driver="fusedev", snapshot_dir=f"/snapshots/{j}") for j in range(int(rng.integers(0, 3)))]
            cfg_path = ""
            if rng.integers(0, 2):
                cfg_path = str(root / f"{did}.json")
                _mod(side, "config.daemonconfig").DaemonRuntimeConfig.from_dict(
                    {"device": {"backend": {"type": "registry", "config": {
                        "auth": "c2VjcmV0", "scheme": "https", "host": f"reg{int(rng.integers(0, 9))}.example.com",
                        "repo": "library/x"}}}}, "fusedev").dump(cfg_path)
            daemons.append(_Daemon(side, did, rafs, cfg_path))
        rows = [{"id": d.id, "pid": 0} for d in daemons]
        mgrs.append(_Manager(daemons, rows))
    return mgrs


def _requests(mgrs, binary: str, rng) -> list[tuple[str, str, bytes]]:
    ids = [d.id for m in mgrs for d in m.list_daemons()]
    good = json.dumps([{"image": f"reg.example.com/i{k}:v", "prefetch": f"/bin;/usr/lib/{int(rng.integers(0, 99))}"}
                       for k in range(3)]).encode()
    reqs = [("GET", "/api/v1/daemons", b""), ("GET", "/api/v1/daemons/records", b"")]
    reqs += [("GET", f"/api/v1/daemons/{i}/backend", b"") for i in ids + ["nope"]]
    reqs += [("PUT", "/api/v1/prefetch", good), ("PUT", "/api/v1/prefetch", b"{not json"),
             ("PUT", "/api/v1/daemons/upgrade", json.dumps({"nydusd_path": binary + ".missing"}).encode()),
             ("PUT", "/api/v1/daemons/upgrade", json.dumps({"nydusd_path": binary}).encode()),
             ("GET", "/api/v1/nowhere", b""), ("PUT", "/api/v1/nowhere", b"{}")]
    return reqs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_system_controller_routes_answer_equally(tmp_path, seed):
    from tests.test_observability import _uds_request

    binary = tmp_path / "nydusd"
    binary.write_bytes(b"#!/bin/sh\n")
    got = {}
    for side in SIDES:
        root = tmp_path / side
        root.mkdir()
        mgrs = _managers(side, root, seed)
        pm = _mod(side, "prefetch").Pm
        pm.reset()
        sock = str(root / "system.sock")
        sc = _mod(side, "system").SystemController(managers=mgrs, sock_path=sock)
        sc.run()
        replies = []
        try:
            for method, path, body in _requests(mgrs, str(binary), np.random.default_rng(seed)):
                status, out = _uds_request(sock, method, path, body)
                doc = json.loads(out) if out else None
                if path == "/api/v1/daemons":
                    for d in doc:
                        assert d.pop("memory_rss_kb") > 0
                        d["api_socket"] = d["api_socket"].replace(str(root), "<root>")
                replies.append((method, path, status, doc))
            prefetch = {f"reg.example.com/i{k}:v": pm.get_prefetch_info(f"reg.example.com/i{k}:v") for k in range(3)}
        finally:
            sc.stop()
            pm.reset()
        got[side] = (replies, prefetch, [m.upgraded for m in mgrs])
    assert got["port"] == got["ref"]
    replies, prefetch, upgraded = got["port"]
    assert all(prefetch.values()) and sum(len(u) for u in upgraded) == len(replies[0][3])
    assert b"c2VjcmV0" not in json.dumps(replies).encode()


def test_daemons_route_answers_for_a_real_daemon(tmp_path):
    """``/api/v1/daemons`` over a manager holding a real ``daemon.Daemon``
    (whose ``pid`` is a property, not the tests' fake method): the port's
    controller lists it with its pid and resident size; the reference's
    calls ``d.pid()`` and answers 500 for every real daemon (ROADMAP.md
    Queue C, C4)."""
    from tests.test_observability import _uds_request

    got = {}
    for side in SIDES:
        daemon_mod = _mod(side, "daemon.daemon")
        d = daemon_mod.Daemon(daemon_mod.ConfigState(daemon_id=f"real-{side}", process_id=os.getpid(),
                                                     api_socket=str(tmp_path / f"{side}-api.sock")))
        sock = str(tmp_path / f"{side}.sock")
        sc = _mod(side, "system").SystemController(managers=[_Manager([d], [])], sock_path=sock)
        sc.run()
        try:
            got[side] = _uds_request(sock, "GET", "/api/v1/daemons")
        finally:
            sc.stop()
    status, body = got["ref"]
    assert status == 500 and b"not callable" in body
    status, body = got["port"]
    (row,) = json.loads(body)
    assert status == 200 and row["id"] == "real-port" and row["pid"] == os.getpid()
    assert row["memory_rss_kb"] > 0 and row["instances"] == {}
