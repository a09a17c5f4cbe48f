"""The port's daemon server, client, command line, host-side model, RAFS
records and supervisor against the JAX package's, in one process.

Both packages' ``DaemonServer`` run in this process under
``NTPU_DISABLE_FUSE=1`` (API-only serving, as the reference's
``start_fuse`` does without FUSE), each on its own socket, over the same
numpy-seeded two-layer image. Held equal across packages:

- every ``/api/v1/fs?op=stat|list|read`` answer, the errors of bad paths,
  ops and routes, ``/api/v1/daemon`` before and after ``start``, the fs
  metrics after one read sequence, the inflight list, each client against
  each server;
- ``snapshot_state()`` of one package restored by the other's
  ``restore_state``, directly and through either package's
  ``Supervisor`` (``send_states_to_supervisor`` / ``takeover_from_supervisor``),
  with reads equal after;
- ``DaemonCommand.build()`` except the server module it names;
- the host-side ``Daemon`` model driving either server (state machine,
  ref-counted RAFS attach, version);
- ``Rafs``/``RafsCache`` records and the packages' exports.
"""

from __future__ import annotations

import importlib
import io
import json
import os
import shutil
import tarfile
import tempfile
import threading
from types import SimpleNamespace

import numpy as np
import pytest

from tests.test_torch_fetch_sched import ROOTS, SIDES

MODULES = {
    "server": "daemon.server",
    "client": "daemon.client",
    "command": "daemon.command",
    "daemon": "daemon.daemon",
    "types": "daemon.types",
    "dpkg": "daemon",
    "rafs": "rafs",
    "supervisor": "supervisor",
    "fusedev": "fusedev",
    "errdefs": "utils.errdefs",
    "layout": "models.layout",
}
PKG = {
    side: SimpleNamespace(side=side, **{k: importlib.import_module(f"{ROOTS[side]}.{m}") for k, m in MODULES.items()})
    for side in SIDES
}
REF, PORT = PKG["ref"], PKG["port"]
PAIRS = [("ref", "port"), ("port", "ref")]


def _short_dir() -> str:
    return tempfile.mkdtemp(prefix="nd", dir="/tmp")


def _tree(seed: int, n: int) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n):
        size = int(rng.choice([0, 1, 100, 5000, 70_000, 200_000]))
        out[f"dir{i % 4}/sub{i % 2}/file{seed}_{i}"] = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
    return out


def _tar(files: dict, links: bool) -> bytes:
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w", format=tarfile.GNU_FORMAT) as tf:
        dirs = sorted({"/".join(p.split("/")[:k]) for p in files for k in (1, 2)})
        for d in dirs:
            ti = tarfile.TarInfo(d)
            ti.type = tarfile.DIRTYPE
            ti.mode = 0o755
            tf.addfile(ti)
        for path, data in files.items():
            ti = tarfile.TarInfo(path)
            ti.size = len(data)
            ti.mode = 0o640
            ti.uid, ti.gid, ti.mtime = 7, 8, 1_700_000_000
            tf.addfile(ti, io.BytesIO(data))
        if links:
            first = next(iter(files))
            ti = tarfile.TarInfo("dir0/sym")
            ti.type = tarfile.SYMTYPE
            ti.linkname = "../" + first
            tf.addfile(ti)
            ti = tarfile.TarInfo("dir1/hard")
            ti.type = tarfile.LNKTYPE
            ti.linkname = first
            tf.addfile(ti)
    return buf.getvalue()


@pytest.fixture(scope="module")
def image(tmp_path_factory):
    """Two layers merged (the upper overrides one file), packed by the
    reference (the port's packs are held byte-identical elsewhere), with a
    prefetch table."""
    from nydus_snapshotter_tpu.converter.convert import Merge, blob_data_from_layer_blob, pack_layer
    from nydus_snapshotter_tpu.converter.types import MergeOption, PackOption

    lower, upper = _tree(1, 12), _tree(2, 6)
    override = list(lower)[-1]
    upper[override] = b"upper wins\n"
    opt = PackOption(chunk_size=0x1000, backend="numpy", compressor="lz4_block", prefetch_patterns="/dir0\n")
    d = tmp_path_factory.mktemp("daemon-image")
    blobs = []
    for files, links in ((lower, True), (upper, False)):
        blob, res = pack_layer(_tar(files, links), opt)
        (d / res.blob_id).write_bytes(blob_data_from_layer_blob(blob))
        blobs.append(blob)
    boot = d / "image.boot"
    boot.write_bytes(Merge(blobs, MergeOption(prefetch_patterns="/dir0\n")).bootstrap)
    tree = {"/" + p: v for p, v in {**lower, **upper}.items()}
    tree["/dir1/hard"] = lower[next(iter(lower))]
    cfg = json.dumps({"device": {"backend": {"type": "localfs", "config": {"blob_dir": str(d)}}}})
    return SimpleNamespace(tree=tree, boot=str(boot), blob_dir=str(d), cfg=cfg, override="/" + override)


class _Running:
    """One package's DaemonServer serving on a socket in a thread."""

    def __init__(self, side: str, d: str, name: str = "twin", supervisor: str = "", upgrade: bool = False):
        self.side = side
        self.sock = os.path.join(d, f"{side}-{name}.sock")
        self.server = PKG[side].server.DaemonServer(
            name, self.sock, supervisor=supervisor, workdir=d, upgrade=upgrade
        )
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        self.client = PKG[side].client.NydusdClient(self.sock)
        self.client.wait_until_socket_exists(10)

    def stop(self) -> None:
        self.server.shutdown()
        self.thread.join(timeout=10)
        self.server._httpd.server_close()


@pytest.fixture()
def env(monkeypatch):
    monkeypatch.setenv("NTPU_DISABLE_FUSE", "1")
    d = _short_dir()
    running: list[_Running] = []

    def start(side, **kw):
        r = _Running(side, d, **kw)
        running.append(r)
        return r

    yield SimpleNamespace(dir=d, start=start)
    for r in running:
        r.stop()
    shutil.rmtree(d, ignore_errors=True)


def _outcome(fn):
    """A call's answer, or its error as (class name, message): each
    package raises its own errdefs classes."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the error is the answer
        return ("err", type(e).__name__, str(e))


def _answers(client, image, mp: str, seed: int) -> list:
    rng = np.random.default_rng(seed)
    paths = sorted(image.tree)
    out = [_outcome(lambda: client.stat_file(mp, p)) for p in paths + ["/dir0/sym", "/dir1/hard", "/nope"]]
    for d in ("/", "/dir0", "/dir1/sub1", "/dir3", "/nope"):
        out.append(_outcome(lambda d=d: client.list_dir(mp, d)))
    for _ in range(40):
        p = paths[int(rng.integers(0, len(paths)))]
        n = len(image.tree[p])
        off = int(rng.integers(0, n + 2))
        size = int(rng.choice([-1, 1, 4096, int(rng.integers(1, 100_000))]))
        out.append(_outcome(lambda p=p, off=off, size=size: client.read_file(mp, p, off, size)))
    out.append(_outcome(lambda: client.read_file(mp, "/dir0", 0, 10)))
    out.append(_outcome(lambda: client.read_file("/not-mounted", paths[0])))
    out.append(_outcome(lambda: client._request("GET", f"/api/v1/fs?mountpoint={mp}&op=chmod&path=/")))
    out.append(_outcome(lambda: client._request("GET", "/api/v1/nowhere")))
    out.append(_outcome(lambda: client.inflight_metrics()))
    return out


def test_api_answers_equal_each_client_each_server(env, image):
    servers = {side: env.start(side) for side in SIDES}
    for r in servers.values():
        info0 = r.client.get_daemon_info()
        r.client.mount("/m", image.boot, image.cfg)
        r.client.start()
        info1 = r.client.get_daemon_info()
        assert (info0["state"], info1["state"]) == ("READY", "RUNNING")
    assert _outcome(lambda: servers["ref"].client.get_daemon_info()) == _outcome(
        lambda: servers["port"].client.get_daemon_info())
    got = {}
    for server_side, r in servers.items():
        for client_side in SIDES:
            client = PKG[client_side].client.NydusdClient(r.sock)
            got[(server_side, client_side)] = _answers(client, image, "/m", seed=3)
    ref = got[("ref", "ref")]
    for key, answers in got.items():
        assert len(answers) == len(ref)
        for i, (a, b) in enumerate(zip(answers, ref)):
            assert a == b, (key, i)
    # the same two read passes leave the same fs metrics on both servers
    metrics = {side: r.client.fs_metrics("/m") for side, r in servers.items()}
    assert metrics["port"] == metrics["ref"] and metrics["port"]["data_read"] > 0
    # the reads are the tree's bytes, the override and the hardlink resolved
    client = servers["port"].client
    for p, data in image.tree.items():
        assert client.read_file("/m", p) == data, p
    assert client.read_file("/m", image.override) == b"upper wins\n"
    for side, r in servers.items():
        cache = r.client.cache_metrics()
        assert set(cache) >= {"prefetch_data_amount", "soci", "trace_exemplars"}, side
        with pytest.raises(PKG[side].errdefs.AlreadyExists):
            r.client.mount("/m", image.boot, image.cfg)
        with pytest.raises(PKG[side].errdefs.NotFound):
            r.client.umount("/never")
        r.client.umount("/m")
        assert r.server.instances == {}


def test_prefetch_amount_equal(env, image):
    """The mount's prefetch table warms the same bytes in both packages,
    with no client read."""
    amounts = {}
    for side in SIDES:
        r = env.start(side)
        r.client.mount("/p", image.boot, image.cfg)
        inst = r.server.instances["/p"]
        for _ in range(200):
            if inst._replayer is None and inst.prefetched_bytes:
                break
            threading.Event().wait(0.02)
        amounts[side] = r.client.cache_metrics()["prefetch_data_amount"]
        assert r.client.fs_metrics("/p")["data_read"] == 0
    assert amounts["port"] == amounts["ref"] > 0


def _reads(client, mp: str, image) -> dict:
    return {p: client.read_file(mp, p) for p in sorted(image.tree)}


@pytest.mark.parametrize("src,dst", PAIRS, ids=["ref-to-port", "port-to-ref"])
def test_snapshot_state_restored_across_packages(env, image, src, dst):
    a = env.start(src, name="a")
    for mp in ("/s1", "/s2"):
        a.client.mount(mp, image.boot, image.cfg)
    before = _reads(a.client, "/s1", image)
    state, fds = a.server.snapshot_state()
    assert fds == []  # API-only instances hold no session fd
    b = env.start(dst, name="b", upgrade=True)
    assert b.client.get_daemon_info()["state"] == "INIT"
    b.server.restore_state(state, fds)
    assert b.client.get_daemon_info()["state"] == "READY"
    assert sorted(b.server.instances) == ["/s1", "/s2"]
    for mp in ("/s1", "/s2"):
        assert (b.server.instances[mp].prefetched_bytes
                == a.server.instances[mp].prefetched_bytes)
        assert _reads(b.client, mp, image) == before
    # the state each package writes for the same mounts is the same JSON
    state_b, _ = b.server.snapshot_state()
    assert json.loads(state_b)["instances"] == json.loads(state)["instances"]


@pytest.mark.parametrize("sup_side", SIDES)
@pytest.mark.parametrize("src,dst", PAIRS, ids=["ref-to-port", "port-to-ref"])
def test_supervisor_handoff_across_packages(env, image, src, dst, sup_side):
    sup = PKG[sup_side].supervisor.Supervisor("handoff", os.path.join(env.dir, f"{sup_side}-sup.sock"))
    sup.start()
    try:
        a = env.start(src, name="a", supervisor=sup.sock_path)
        a.client.mount("/h", image.boot, image.cfg)
        assert sup.wait_for_state(10)
        a.client.send_fd()  # explicit handoff: the state pushed again
        assert json.loads(sup.fetch_state())["instances"][0]["mountpoint"] == "/h"
        b = env.start(dst, name="b", supervisor=sup.sock_path, upgrade=True)
        b.client.takeover()
        b.client.start()
        assert b.client.get_daemon_info()["state"] == "RUNNING"
        assert _reads(b.client, "/h", image) == _reads(a.client, "/h", image)
    finally:
        sup.stop()


def test_daemon_command_differs_only_in_module():
    rng = np.random.default_rng(4)
    for _ in range(20):
        kw = {
            "id": f"d{int(rng.integers(0, 99))}",
            "apisock": str(rng.choice(["", "/run/a.sock"])),
            "supervisor": str(rng.choice(["", "/run/s.sock"])),
            "workdir": str(rng.choice(["", "/var/w"])),
            "log_file": str(rng.choice(["", "/var/log/d.log"])),
            "upgrade": bool(rng.integers(0, 2)),
        }
        ref = REF.command.DaemonCommand(**kw).build()
        port = PORT.command.DaemonCommand(**kw).build()
        assert ref[2] == "nydus_snapshotter_tpu.daemon.server"
        assert port[2] == "nydus_snapshotter_tpu_torch.daemon.server"
        assert port[:2] + port[3:] == ref[:2] + ref[3:]


@pytest.mark.parametrize("model_side", SIDES)
@pytest.mark.parametrize("server_side", SIDES)
def test_daemon_model_drives_either_server(env, image, model_side, server_side):
    r = env.start(server_side, name="model")
    p = PKG[model_side]
    states = p.daemon.ConfigState(daemon_id="model", api_socket=r.sock, workdir=env.dir,
                                  process_id=os.getpid())
    d = p.daemon.Daemon(states)
    d.wait_until_state(p.types.DaemonState.READY, timeout=5)
    d.start()
    d.wait_until_state(p.types.DaemonState.RUNNING, timeout=5)
    assert d.get_daemon_version() == "0.1.0"
    rafs = [p.rafs.Rafs(snapshot_id=str(i), daemon_id="model", seq=i) for i in (3, 1, 2)]
    for rec in rafs:
        d.shared_mount(rec, image.boot, image.cfg)
    assert d.ref_count() == 3 and sorted(r.server.instances) == ["/1", "/2", "/3"]
    assert d.client().read_file("/2", image.override) == b"upper wins\n"
    for rec in rafs[:2]:
        d.shared_umount(rec)
    assert d.ref_count() == 1 and sorted(r.server.instances) == ["/2"]
    assert d.instances.head().snapshot_id == "2"


def test_rafs_records_equal(tmp_path):
    rng = np.random.default_rng(6)
    for i in range(10):
        kw = dict(snapshot_id=str(i), image_id=f"img{int(rng.integers(0, 9))}", daemon_id="d",
                  fs_driver=str(rng.choice(["fusedev", "fscache"])), snapshot_dir=str(tmp_path / str(i)),
                  mountpoint="", annotations={"k": str(i)}, seq=int(rng.integers(0, 100)))
        ref, port = REF.rafs.Rafs(**kw), PORT.rafs.Rafs(**kw)
        assert port.to_dict() == ref.to_dict()
        assert PORT.rafs.Rafs.from_dict(ref.to_dict()).to_dict() == ref.to_dict()
        assert (port.bootstrap_file(), port.fscache_work_dir(), port.relative_mountpoint()) == (
            ref.bootstrap_file(), ref.fscache_work_dir(), ref.relative_mountpoint())
        if i % 2:  # the legacy bootstrap path, as the reference falls back to it
            fs = tmp_path / str(i) / "fs"
            fs.mkdir(parents=True)
            (fs / PORT.layout.LEGACY_BOOTSTRAP_FILE).write_bytes(b"")
            assert port.bootstrap_file() == ref.bootstrap_file() == str(fs / REF.layout.LEGACY_BOOTSTRAP_FILE)
    caches = {side: PKG[side].rafs.RafsCache() for side in SIDES}
    for side, cache in caches.items():
        for i in (5, 2, 9):
            cache.add(PKG[side].rafs.Rafs(snapshot_id=str(i), daemon_id=f"d{i % 2}", seq=i))
        cache.remove("9")
    ref, port = caches["ref"], caches["port"]
    assert [r.to_dict() for r in port.list()] == [r.to_dict() for r in ref.list()]
    assert [r.snapshot_id for r in port.by_daemon("d1")] == [r.snapshot_id for r in ref.by_daemon("d1")]
    assert port.head().to_dict() == ref.head().to_dict() and len(port) == len(ref) == 2
    assert isinstance(PORT.rafs.rafs_global_cache, PORT.rafs.RafsCache)


@pytest.mark.parametrize("mod", ["dpkg", "rafs", "supervisor", "fusedev"])
def test_package_exports_equal(mod):
    names = {side: sorted(n for n in vars(PKG[side].__dict__[mod]) if not n.startswith("_")) for side in SIDES}
    want = {"dpkg": {"Daemon", "NydusdClient", "ClientError", "DaemonState", "MountRequest"},
            "rafs": {"Rafs", "RafsCache", "rafs_global_cache"},
            "supervisor": {"Supervisor", "SupervisorSet"},
            "fusedev": {"FuseSession", "FuseError", "fuse_available"}}[mod]
    assert want <= set(names["port"])
    assert [n for n in names["port"] if n in want or n[0].isupper()] == [
        n for n in names["ref"] if n in want or n[0].isupper()]


@pytest.mark.parametrize("client_side", SIDES)
@pytest.mark.parametrize("side", SIDES)
def test_main_starts_the_peer_server_and_exits_on_sigterm(image, side, client_side):
    """``python -m <package>.daemon.server`` with ``NTPU_PEER_ENABLE`` and
    ``NTPU_PEER_LISTEN``: the chunk server answers the other package's
    ``PeerClient``; ``/metrics`` renders the same metric families; SIGTERM
    (handed to a helper thread) ends the process with rc 0 within 5 s and
    removes its socket."""
    import signal
    import subprocess
    import sys
    import time

    d = _short_dir()
    api, peer_sock = os.path.join(d, "api.sock"), os.path.join(d, "peer.sock")
    env = dict(os.environ, NTPU_DISABLE_FUSE="1", NTPU_PEER_ENABLE="1", NTPU_PEER_LISTEN=peer_sock)
    env.pop("NTPU_FLEET_CONTROLLER", None)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen([sys.executable, "-m", f"{ROOTS[side]}.daemon.server", "--id", "main",
                             "--apisock", api, "--workdir", d], env=env, cwd=repo)
    try:
        client = PKG[side].client.NydusdClient(api)
        client.wait_until_socket_exists(30)
        client.mount("/m", image.boot, image.cfg)
        assert client.read_file("/m", image.override) == b"upper wins\n"
        peer = importlib.import_module(f"{ROOTS[client_side]}.daemon.peer")
        deadline = time.time() + 10
        while not os.path.exists(peer_sock) and time.time() < deadline:
            time.sleep(0.02)
        with pytest.raises(peer.PeerMiss):  # serves, holds nothing of this blob
            peer.PeerClient(peer_sock, timeout_s=5.0).read_range("ab" * 32, 0, 10)
        from nydus_snapshotter_tpu.utils import udshttp

        status, body = udshttp.request(api, "/metrics")
        families = sorted(line.split()[2] for line in body.decode().splitlines() if line.startswith("# TYPE"))
        assert status == 200 and "ntpu_trace_spans_total" in families
        t0 = time.time()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=5) == 0 and time.time() - t0 < 5
        assert not os.path.exists(api)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        shutil.rmtree(d, ignore_errors=True)
