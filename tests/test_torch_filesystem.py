"""The port's filesystem facade, daemon manager and daemon store against
the JAX package's: mounts on shared and dedicated daemons, recovery,
restart and failover, the restart budget and liveness monitor, the
failpoint sites of the control plane, and the SQLite and bbolt stores.

Every case of tests/test_filesystem.py, tests/test_daemon_lifecycle.py and
tests/test_failpoint_chaos.py runs in both packages (``pkg``, through
``ported_cases``; the port's ``pack_layer`` and ``FusedDeviceEngine`` on
the host, ``device="cpu"``), and so do the ``store.boltdb`` cases of
tests/test_fuzz_parsers.py and the ``store`` cases of
tests/test_reference_fixtures.py (which skip in both packages where the
reference tree's bbolt fixtures are absent). Each daemon a port case
spawns is checked to run the port's server.
``TestRegistry::test_known_sites_catalog_is_wired`` wants every cataloged
site fired somewhere in the package: the port fires them all since its
scenario runner (``scenario.phase``, ``soak.wave``, ``soak.evolve``);
tests/test_torch_planes.py::test_catalog_equal_and_ported_sites_wired
holds the port's fired sites to exactly the catalog, and
``test_each_control_plane_site_fires_in_both_packages`` there fires each
site this file's modules carry.

Cross-package cases: the daemon and instance records one package's
``Manager`` saves in ``nydus.db`` read back equal in the other's
``Database`` and recover equal; a seeded bbolt file in the reference
snapshotter's layouts (``v1/daemons`` + ``v1/instances``, and the legacy
top-level ``daemons``) loads and imports equal in both packages, and a
hypothesis case mutates its bytes: both packages raise the same error or
return equal records.
"""

from __future__ import annotations

import importlib
import json
import queue
import struct

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from tests.test_torch_fetch_sched import ROOTS, SIDES, other_package_still, ported_cases
from tests.test_torch_snapshotter import short_tmp_path, spawns_own_server

tmp_path = short_tmp_path("fs")
ported_cases(
    "test_filesystem",
    globals(),
    subs=(
        ('pack_layer(out.getvalue(), PackOption(chunk_size=0x1000, backend="numpy"))',
         'pack_layer(out.getvalue(), PackOption(chunk_size=0x1000, backend="numpy"), device="cpu")'),
    ),
)
ported_cases(
    "test_daemon_lifecycle",
    globals(),
    host=("pack_layer",),
)
ported_cases(
    "test_failpoint_chaos",
    globals(),
    subs=(
        ("fused_convert.FusedDeviceEngine(chunk_size=0x10000)",
         'fused_convert.FusedDeviceEngine(chunk_size=0x10000, device="cpu")'),
    ),
)
ported_cases(
    "test_fuzz_parsers",
    globals(),
    only=(
        "TestBoltReaderFuzz::test_mutated_fixture_never_crashes",
        "TestBoltReaderFuzz::test_page_cycle_rejected",
        "TestBoltReaderFuzz::test_wide_page_cycle_bounded",
    ),
)
ported_cases(
    "test_reference_fixtures",
    globals(),
    only=("test_real_bolt_compat_daemons_load", "test_real_bolt_imports_into_sqlite",
          "test_real_stargz_nydus_db_buckets"),
)
_other_package_still = other_package_still()
_spawns_own_server = spawns_own_server()


def _mod(side: str, name: str):
    return importlib.import_module(f"{ROOTS[side]}.{name}")


# ------------------------------------------------------------------ nydus.db


def _saved_by_manager(side: str, root: str, seed: int) -> None:
    """Seeded daemons and RAFS instances saved through one package's
    ``Manager``, as ``Filesystem.mount`` saves them."""
    C = _mod(side, "constants")
    cfg = _mod(side, "config.config").SnapshotterConfig(root=root)
    cfg.validate()
    db = _mod(side, "store.database").Database(cfg.database_path)
    mgr = _mod(side, "manager.manager").Manager(cfg, db, fs_driver=C.FS_DRIVER_FUSEDEV)
    rafs_cls = _mod(side, "rafs.rafs").Rafs
    rng = np.random.default_rng(seed)
    ids = []
    for i in range(int(rng.integers(2, 5))):
        mode = [C.DAEMON_MODE_SHARED, C.DAEMON_MODE_DEDICATED][int(rng.integers(0, 2))]
        daemon = mgr.new_daemon(f"d{seed}x{i}", daemon_mode=mode)
        daemon.states.process_id = int(rng.integers(1 << 20, 1 << 22))
        mgr.add_daemon(daemon)
        ids.append(daemon.id)
    for j in range(int(rng.integers(3, 8))):
        sid = str(int(rng.integers(1, 10_000)) * 10 + j)
        rafs = rafs_cls(
            snapshot_id=sid,
            image_id=f"registry.example.com/app{int(rng.integers(0, 9))}:v{j}",
            daemon_id=ids[int(rng.integers(0, len(ids)))],
            fs_driver=C.FS_DRIVER_FUSEDEV,
            snapshot_dir=f"{root}/snapshots/{sid}",
            mountpoint=f"{root}/mnt/{sid}",
            annotations={f"k{a}": f"v{int(rng.integers(0, 99))}" for a in range(int(rng.integers(0, 3)))},
        )
        rafs.seq = db.next_instance_seq()
        db.save_instance(rafs.snapshot_id, rafs.to_dict(), rafs.seq)
    if rng.integers(0, 2):
        mgr.remove_daemon(ids[0])
    mgr.stop()
    db.close()


def _read_back(side: str, root: str) -> dict:
    C = _mod(side, "constants")
    cfg = _mod(side, "config.config").SnapshotterConfig(root=root)
    db = _mod(side, "store.database").Database(cfg.database_path)
    daemons = list(db.walk_daemons())
    instances = list(db.walk_instances())
    rafs_cls = _mod(side, "rafs.rafs").Rafs
    state_cls = _mod(side, "daemon.daemon").ConfigState
    out = {
        "daemons": daemons,
        "instances": instances,
        "one": [db.get_daemon(d["daemon_id"]) for d in daemons],
        "states": [state_cls.from_dict(d).to_dict() for d in daemons],
        "rafs": [rafs_cls.from_dict(rec).to_dict() for rec, _seq in instances],
        "next_seq": db.next_instance_seq(),
    }
    mgr = _mod(side, "manager.manager").Manager(cfg, db, fs_driver=C.FS_DRIVER_FUSEDEV)
    live, dead = mgr.recover()
    out["recovered"] = (sorted(d.id for d in live), sorted(d.id for d in dead))
    mgr.stop()
    db.close()
    return out


@pytest.mark.parametrize("writer", SIDES)
@pytest.mark.parametrize("seed", [2, 9])
def test_nydus_db_records_read_back_equal(tmp_path, writer, seed):
    """The records one package's ``Manager`` saves are read back equal by
    both packages' ``Database``, and both managers recover the same
    (dead) daemons from them."""
    root = str(tmp_path / "r")
    _saved_by_manager(writer, root, seed)
    import shutil

    shutil.copytree(root, str(tmp_path / "q"))
    got = {side: _read_back(side, str(tmp_path / ("r" if side == "ref" else "q"))) for side in SIDES}
    for key in ("instances", "rafs", "next_seq", "recovered"):
        assert got["ref"][key] == got["port"][key], key
    # the daemons' records name their own root; the copy sits at an equal-length path
    swap = lambda recs: json.loads(json.dumps(recs).replace(f"{tmp_path}/q", f"{tmp_path}/r"))
    for key in ("daemons", "one", "states"):
        assert got["ref"][key] == swap(got["port"][key]), key
    assert got["ref"]["daemons"] and got["ref"]["instances"]
    assert not got["ref"]["recovered"][0] and got["ref"]["recovered"][1]


# --------------------------------------------------------------------- bbolt

_PAGE = 4096
MAGIC, VERSION = 0xED0CDAED, 2


def _fnv1a(data: bytes) -> int:
    h = 0xCBF29CE484222325
    for b in data:
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def _leaf(pid: int, elems: list[tuple[int, bytes, bytes]]) -> bytes:
    """A leaf page body: header, element table, then keys and values."""
    head = struct.pack("<QHHI", pid, 0x02, len(elems), 0)
    table, data = b"", b""
    base = 16 + 16 * len(elems)
    for i, (flags, k, v) in enumerate(elems):
        off = 16 + 16 * i
        table += struct.pack("<IIII", flags, base + len(data) - off, len(k), len(v))
        data += k + v
    return head + table + data


def _bucket_value(root: int, inline: bytes = b"") -> bytes:
    return struct.pack("<QQ", root, 0) + inline


def _meta(pid: int, root: int, txid: int, npages: int) -> bytes:
    body = struct.pack("<IIII QQ Q Q Q", MAGIC, VERSION, _PAGE, 0, root, 0, 2, npages, txid)
    return struct.pack("<QHHI", pid, 0x04, 0, 0) + body + struct.pack("<Q", _fnv1a(body))


def _bolt_file(seed: int, legacy: bool) -> tuple[bytes, list[dict], list[dict]]:
    """A bbolt file in the reference snapshotter's layout, with seeded JSON
    daemon and instance records. ``v1`` holds ``daemons`` as an inline
    bucket and ``instances`` under a branch page over two leaves; the
    legacy layout is a top-level ``daemons`` bucket."""
    rng = np.random.default_rng(seed)
    daemons = [
        {"ID": f"d{seed}{i:03d}", "ConfigDir": f"/var/lib/nydus/config/d{i}", "DaemonMode":
         ["shared", "dedicated"][int(rng.integers(0, 2))], "Pid": int(rng.integers(1, 1 << 22)),
         "SnapshotDir": f"/var/lib/nydus/snapshots/{int(rng.integers(1, 999))}"}
        for i in range(int(rng.integers(1, 6)))
    ]
    instances = [
        {"SnapshotID": str(int(rng.integers(1, 1 << 16))), "Seq": int(rng.integers(1, 1 << 30)),
         "DaemonID": daemons[int(rng.integers(0, len(daemons)))]["ID"], "ImageID": f"img{i}",
         "Annotations": {"k": "v" * int(rng.integers(0, 40))}}
        for i in range(int(rng.integers(2, 9)))
    ]
    recs = lambda rs, key: sorted(((0, r[key].encode(), json.dumps(r).encode()) for r in rs))
    pages = [b"", b"", struct.pack("<QHHI", 2, 0x10, 0, 0)]
    if legacy:
        pages.append(_leaf(3, [(1, b"daemons", _bucket_value(4))]))
        pages.append(_leaf(4, recs(daemons, "ID")))
    else:
        pages.append(_leaf(3, [(1, b"v1", _bucket_value(4))]))
        inline = _leaf(0, recs(daemons, "ID"))
        inst = recs(instances, "SnapshotID")
        half = len(inst) // 2
        pages.append(_leaf(4, [(1, b"daemons", _bucket_value(0, inline)), (1, b"instances", _bucket_value(5))]))
        branch = struct.pack("<QHHI", 5, 0x01, 2, 0)
        branch += struct.pack("<IIQ", 32, len(inst[0][1]), 6) + struct.pack("<IIQ", 16 + len(inst[0][1]),
                                                                             len(inst[half][1]), 7)
        pages.append(branch + inst[0][1] + inst[half][1])
        pages.append(_leaf(6, inst[:half]))
        pages.append(_leaf(7, inst[half:]))
    pages[0] = _meta(0, 3, 1, len(pages))
    pages[1] = _meta(1, 3, 2, len(pages))
    for p in pages:
        assert len(p) <= _PAGE
    buf = b"".join(p.ljust(_PAGE, b"\0") for p in pages)
    return buf, daemons, instances


def _load(side: str, path: str):
    try:
        return "ok", _mod(side, "store.database").load_legacy_bolt(path)
    except Exception as e:  # noqa: BLE001 — the class and message are the answer
        return type(e).__name__, str(e)


@pytest.mark.parametrize("legacy", [False, True])
@pytest.mark.parametrize("seed", [1, 4, 7])
def test_bolt_file_loads_and_imports_equal(tmp_path, seed, legacy):
    """A seeded bbolt file loads to its records in both packages, and both
    packages' ``Database.import_legacy_bolt`` store equal records."""
    buf, daemons, instances = _bolt_file(seed, legacy)
    path = str(tmp_path / "nydus.db")
    with open(path, "wb") as f:
        f.write(buf)
    want = (sorted(daemons, key=lambda r: r["ID"]),
            [] if legacy else sorted(instances, key=lambda r: r["SnapshotID"]))
    imported = {}
    for side in SIDES:
        assert _load(side, path) == ("ok", want)
        db = _mod(side, "store.database").Database(str(tmp_path / f"{side}.sqlite"))
        counts = db.import_legacy_bolt(path)
        assert db.import_legacy_bolt(path) == (counts[0], 0)  # idempotent
        imported[side] = (counts, list(db.walk_daemons()), list(db.walk_instances()))
        db.close()
    assert imported["ref"] == imported["port"]
    assert imported["ref"][0] == (len(daemons), 0 if legacy else len(instances))
    seqs = [rec["Seq"] for rec, _seq in imported["ref"][2]]
    assert seqs == sorted(seqs)  # the reference's replay order, not key order


_MUTATIONS = st.lists(st.tuples(st.integers(0, 8 * _PAGE - 1), st.integers(0, 255)), min_size=1, max_size=12)


@settings(max_examples=120, deadline=None, suppress_health_check=[HealthCheck.too_slow,
                                                                  HealthCheck.function_scoped_fixture])
@given(seed=st.integers(0, 3), legacy=st.booleans(), edits=_MUTATIONS, structural=st.booleans())
def test_mutated_bolt_file_same_answer_in_both_packages(tmp_path, seed, legacy, edits, structural):
    """Mutated bytes of a seeded bbolt file: both packages raise the same
    error class with the same message, or return equal records."""
    buf, _d, _i = _bolt_file(seed, legacy)
    b = bytearray(buf)
    for pos, value in edits:
        if structural:  # page headers and element tables
            pos = (pos // _PAGE) * _PAGE + pos % 160
        b[pos % len(b)] = value
    path = str(tmp_path / "m.db")
    with open(path, "wb") as f:
        f.write(bytes(b))
    assert _load("ref", path) == _load("port", path)


# ------------------------------------------------------------ liveness monitor


def _watched_socket(tmp_path, monitor):
    """A listening daemon socket, ``monitor`` subscribed to it, and the
    daemon's end of that connection."""
    import socket

    path = str(tmp_path / "d.sock")
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(path)
    srv.listen(1)
    monitor.subscribe("d", path)
    conn, _ = srv.accept()
    return srv, conn, path


@pytest.mark.parametrize("side", SIDES)
def test_monitor_emits_one_death_event_on_close(tmp_path, side):
    """Both packages' liveness monitors emit one death event when the
    daemon's end of the watched connection closes, and drop the watch."""
    import time

    mon = _mod(side, "manager.monitor").LivenessMonitor()
    mon.run()
    srv, conn, path = _watched_socket(tmp_path, mon)
    try:
        conn.close()  # the daemon's end goes away
        event = mon.events.get(timeout=5)
        assert (event.daemon_id, event.path) == ("d", path)
        time.sleep(0.3)
        assert mon.events.empty() and "d" not in mon._by_id
    finally:
        mon.stop()
        srv.close()


def test_port_monitor_sees_a_close_reported_only_as_readable(tmp_path, monkeypatch):
    """The port's monitor watches level-triggered for EPOLLIN | EPOLLRDHUP
    as well as EPOLLHUP | EPOLLERR, and a readable socket counts as a death
    only at end of stream. Under a kernel that reports the daemon's close
    only as EPOLLIN, and only to a watch that asks for it (the reference's
    edge-triggered EPOLLHUP | EPOLLERR watch then waits forever), the port
    still emits the death event; bytes the daemon sends unasked are
    dropped and emit none."""
    import select

    monitor_mod = _mod("port", "manager.monitor")
    real_epoll = select.epoll
    masks = {}

    class ReadableOnly:
        def __init__(self):
            self._ep = real_epoll()

        def register(self, fd, mask):
            masks[fd] = mask
            self._ep.register(fd, mask)

        def poll(self, timeout=-1):
            return [(fd, select.EPOLLIN) for fd, ev in self._ep.poll(timeout)
                    if ev & select.EPOLLIN and masks[fd] & select.EPOLLIN]

        def __getattr__(self, name):
            return getattr(self._ep, name)

    monkeypatch.setattr(monitor_mod.select, "epoll", ReadableOnly)
    mon = monitor_mod.LivenessMonitor()
    mon.run()
    srv, conn, path = _watched_socket(tmp_path, mon)
    try:
        want = select.EPOLLIN | select.EPOLLRDHUP | select.EPOLLHUP | select.EPOLLERR
        assert list(masks.values()) == [want]  # level-triggered: no EPOLLET
        conn.sendall(b"unasked")
        with pytest.raises(queue.Empty):
            mon.events.get(timeout=0.5)
        assert "d" in mon._by_id
        conn.close()
        event = mon.events.get(timeout=5)
        assert (event.daemon_id, event.path) == ("d", path)
        with pytest.raises(queue.Empty):
            mon.events.get(timeout=0.3)
    finally:
        mon.stop()
        srv.close()
