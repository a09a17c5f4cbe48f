"""The port's snapshotter core and its snapshots.v1 gRPC service against
the JAX package's: the metastore, mount synthesis, label routing, the
control-plane workers and the containerd wire transcript.

Every case of tests/test_snapshotter.py and tests/test_grpc_service.py
runs in both packages (``pkg``, through ``ported_cases``; the twins of
tests/test_snapshot_concurrency.py and tests/test_containerd_transcript.py
are in tests/test_torch_snapshot_concurrency.py, since their fixtures
share names with these). tests/test_grpc_service.py imports ``FakeFs``
from tests/test_snapshotter.py, and its port twin imports it from that
file's port twin, whose fake raises the port's errdefs. Left out until
``cmd/snapshotter.py`` is ported:
``TestCliEntry::test_cli_builds_and_serves`` (it builds the stack through
``cmd.snapshotter.build_stack``).

``tmp_path`` is a short directory in the temp directory (or /tmp where
that is too long) in this file and in every
port file that builds a ``SnapshotterConfig``: both packages refuse a root
longer than ``MAX_ROOT_PATH_LEN`` (70) bytes, and pytest's own tmp paths
under xdist (``.../pytest-N/popen-gwK/<test name>``) pass it. A case here
holds that both packages still refuse a long root.

Cross-package cases feed both packages the same numpy-seeded inputs: a
snapshots database written by one package's ``Snapshotter`` opens in the
other's with equal ``walk``, ``stat``, ``usage`` and ``mounts`` for every
key; and one seeded containerd transcript runs over the gRPC wire with
each package's client on each package's service, with equal replies (the
roots taken out) and equal status codes.

This file also holds the helpers the other snapshotter-stack port files
share: ``short_tmp_path`` and ``spawns_own_server``, an autouse fixture
that checks every daemon a ``pkg`` case spawns runs its own package's
server (``/proc/<pid>/cmdline``).
"""

from __future__ import annotations

import importlib
import os
import shutil
import tempfile
import time
from pathlib import Path

import grpc
import numpy as np
import pytest

from nydus_snapshotter_tpu_torch.constants import MAX_ROOT_PATH_LEN
from tests.test_torch_fetch_sched import ROOTS, SIDES, other_package_still, port_twin, ported_cases


# Room a case needs under ``tmp_path`` for the root it builds there: the
# longest is ``/sn-port``.
ROOT_SUFFIX_MAX = 16


def short_tmp_base(prefix: str) -> str:
    """The directory a ``short_tmp_path`` lives in: the temp directory when
    ``<it>/<prefix>XXXXXXXX`` and a case's root under it stay within
    ``MAX_ROOT_PATH_LEN``, else ``/tmp``."""
    base = tempfile.gettempdir()
    if len(base) + 1 + len(prefix) + 8 + ROOT_SUFFIX_MAX > MAX_ROOT_PATH_LEN:
        return "/tmp"
    return base


def short_tmp_path(prefix: str = "sn"):
    """A ``tmp_path`` fixture: a fresh directory ``<base>/<prefix>XXXXXXXX``
    on ``short_tmp_base``, removed after the case."""

    @pytest.fixture(name="tmp_path")
    def _short_tmp_path():
        d = tempfile.mkdtemp(prefix=prefix, dir=short_tmp_base(prefix))
        yield Path(d)
        shutil.rmtree(d, ignore_errors=True)

    return _short_tmp_path


def cmdline(pid: int) -> list[str]:
    """A process's argv. Right after ``Popen`` returns, the kernel may not
    have set up the new image's arguments yet: an empty read is tried
    again for up to 5 s."""
    deadline = time.monotonic() + 5.0
    while True:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            argv = [a.decode() for a in f.read().split(b"\0") if a]
        if argv or time.monotonic() > deadline:
            return argv
        time.sleep(0.005)


def spawns_own_server():
    """An autouse fixture: in a ``pkg`` case, every ``Daemon.spawn`` of
    that package starts ``python -m <package>.daemon.server``. It yields
    the pids spawned."""

    @pytest.fixture(autouse=True)
    def _spawns_own_server(request, monkeypatch):
        callspec = getattr(request.node, "callspec", None)
        side = callspec.params.get("pkg") if callspec is not None else None
        if side not in SIDES:
            yield []
            return
        daemon_cls = importlib.import_module(f"{ROOTS[side]}.daemon.daemon").Daemon
        spawn = daemon_cls.spawn
        pids = []

        def checked(self, *args, **kw):
            pid = spawn(self, *args, **kw)
            argv = cmdline(pid)
            assert argv[1:3] == ["-m", f"{ROOTS[side]}.daemon.server"], argv
            pids.append(pid)
            return pid

        monkeypatch.setattr(daemon_cls, "spawn", checked)
        yield pids

    return _spawns_own_server


tmp_path = short_tmp_path()
SNAPSHOTTER = port_twin("test_snapshotter")
ported_cases("test_snapshotter", globals())
ported_cases(
    "test_grpc_service",
    globals(),
    twins=("test_snapshotter",),
    leave_out=("TestCliEntry::test_cli_builds_and_serves",),
)
_other_package_still = other_package_still()
_spawns_own_server = spawns_own_server()


def _mod(side: str, name: str):
    return importlib.import_module(f"{ROOTS[side]}.{name}")


def _fake_fs(side: str):
    mod = importlib.import_module("tests.test_snapshotter") if side == "ref" else SNAPSHOTTER
    return mod.FakeFs()


# ---------------------------------------------------------------- root length


@pytest.mark.parametrize("side", SIDES)
def test_both_packages_refuse_a_long_root(side):
    """The 70-byte root check stays in both packages: a root one byte over
    ``MAX_ROOT_PATH_LEN`` is refused, one at it is taken."""
    config = _mod(side, "config.config")
    limit = _mod(side, "constants").MAX_ROOT_PATH_LEN
    assert limit == 70
    base = "/tmp/"
    at = base + "r" * (limit - len(base))
    config.SnapshotterConfig(root=at).validate()
    with pytest.raises(config.ConfigError, match="longer than 70 bytes"):
        config.SnapshotterConfig(root=at + "r").validate()


def test_short_tmp_path_fits_the_root_check(tmp_path, request):
    """This file's ``tmp_path`` lies in the temp directory where that is
    short enough, and leaves room under the limit for the roots the
    reference's cases build, whatever the case's name and the xdist
    worker."""
    base = short_tmp_base("sn")
    assert base in (tempfile.gettempdir(), "/tmp")
    assert str(tmp_path).startswith(os.path.join(base, "sn"))
    assert len(str(tmp_path)) + ROOT_SUFFIX_MAX <= MAX_ROOT_PATH_LEN
    assert request.node.name not in str(tmp_path)


# ------------------------------------------------------------ metastore files


def _seeded_tree(sn, root: str, seed: int) -> list[str]:
    """Prepare, commit and view a seeded chain of plain snapshots, with
    labels and a few seeded files in each active snapshot. Returns the
    keys, in creation order."""
    rng = np.random.default_rng(seed)
    keys, committed = [], []
    for i in range(int(rng.integers(6, 10))):
        parent = committed[int(rng.integers(0, len(committed)))] if committed and rng.integers(0, 3) else ""
        labels = {f"example.com/k{j}": f"v{int(rng.integers(0, 1000))}" for j in range(int(rng.integers(0, 3)))}
        key = f"extract-{i} sha256:{seed:02x}{i:02x}"
        sn.prepare(key, parent, labels)
        upper = sn.upper_path(sn.ms.get_snapshot(key).id)
        for j in range(int(rng.integers(0, 4))):
            with open(os.path.join(upper, f"f{j}"), "wb") as f:
                f.write(rng.integers(0, 256, int(rng.integers(0, 9000)), dtype=np.uint8).tobytes())
        if rng.integers(0, 4):
            name = f"sha256:layer{seed:02x}{i:02x}"
            sn.commit(name, key, {"containerd.io/snapshot.ref": name})
            committed.append(name)
            keys.append(name)
        else:
            keys.append(key)
    if committed:
        sn.view(f"view-{seed}", committed[-1])
        keys.append(f"view-{seed}")
        sn.prepare(f"ctr-{seed}", committed[0])
        keys.append(f"ctr-{seed}")
    return keys


def _answers(sn, keys: list[str]) -> dict:
    walked = []
    sn.walk(lambda key, info: walked.append((key, info)))
    out = {"walk": sorted((k, repr(i)) for k, i in walked)}
    for key in keys:
        out[key] = (repr(sn.stat(key)), repr(sn.usage(key)), repr(sn.mounts(key)))
    return out


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
@pytest.mark.parametrize("seed", [3, 11])
def test_metastore_file_moves_between_packages(tmp_path, writer, reader, seed):
    """A node moves from one package to the other: the snapshots database
    one package's ``Snapshotter`` wrote opens in the other's, with equal
    answers for every key; then the reader commits on top of it and the
    writer reads that back."""
    root = str(tmp_path / "r")
    sn = _mod(writer, "snapshot.snapshotter").Snapshotter(root=root, fs=_fake_fs(writer))
    keys = _seeded_tree(sn, root, seed)
    sn.close()  # the usage workers' writes land by close
    sn = _mod(writer, "snapshot.snapshotter").Snapshotter(root=root, fs=_fake_fs(writer))
    before = _answers(sn, keys)
    sn.close()
    sn2 = _mod(reader, "snapshot.snapshotter").Snapshotter(root=root, fs=_fake_fs(reader))
    assert _answers(sn2, keys) == before
    sn2.commit("sha256:moved", f"ctr-{seed}")
    sn2.remove(f"view-{seed}")
    sn2.close()
    rest = [k for k in keys if k not in (f"ctr-{seed}", f"view-{seed}")] + ["sha256:moved"]
    after = {}
    for side in (writer, reader):
        sn3 = _mod(side, "snapshot.snapshotter").Snapshotter(root=root, fs=_fake_fs(side))
        after[side] = _answers(sn3, rest)
        sn3.close()
    assert after[writer] == after[reader]
    assert any("name='sha256:moved'" in info for _sid, info in after[writer]["walk"])


# ------------------------------------------------------------------ gRPC wire


def _transcript(client, seed: int) -> list:
    """One seeded containerd transcript: Prepare with the CRI labels,
    Commit, Stat, Walk with filters, Usage, Mounts, Update with a field
    mask, View, Remove and Cleanup, with the calls containerd makes that
    fail. Each step gives its reply or its status code."""
    pb = _mod("ref", "api.snapshots_pb2")
    rng = np.random.default_rng(seed)
    out = []

    def call(name, fn, *args):
        try:
            reply = fn(*args)
        except grpc.RpcError as e:
            out.append((name, args, "code", e.code()))
            return None
        out.append((name, args, "ok", _plain(reply)))
        return reply

    layers = [f"sha256:c{seed}{i}" for i in range(3)]
    parent = ""
    for i, chain in enumerate(layers):
        call("stat-miss", client.stat, chain)
        labels = {
            "containerd.io/snapshot/cri.image-ref": f"registry.example.com/app{seed}:latest",
            "containerd.io/snapshot/cri.layer-digest": f"sha256:l{seed}{i}",
            "containerd.io/snapshot/cri.image-layers": ",".join(f"sha256:l{seed}{j}" for j in range(3)),
            "containerd.io/snapshot.ref": chain,
            f"example.com/x{int(rng.integers(0, 9))}": str(int(rng.integers(0, 1 << 30))),
        }
        key = f"extract-{int(rng.integers(0, 1 << 20))} {chain}"
        call("prepare", client.prepare, key, parent, labels)
        call("prepare-again", client.prepare, key, parent, labels)
        call("commit", client.commit, chain, key, {"containerd.io/snapshot.ref": chain})
        call("commit-gone", client.commit, chain, key)
        parent = chain
    call("prepare-bad-parent", client.prepare, "ctr-x", "sha256:nope")
    call("prepare-ctr", client.prepare, "default/1/ctr", layers[-1])
    call("mounts", client.mounts, "default/1/ctr")
    call("mounts-miss", client.mounts, "nope")
    call("usage", client.usage, "default/1/ctr")
    call("usage-committed", client.usage, layers[0])
    call("view", client.view, "view-1", layers[1])
    info = pb.Info(name=layers[1], labels={"example.com/set": "1", "example.com/drop": "2"})
    call("update-mask", client.update, info, "labels.example.com/set")
    call("update-all-labels", client.update, pb.Info(name=layers[2], labels={"a": "b"}), "labels")
    call("update-bad-path", client.update, pb.Info(name=layers[2]), "kind")
    call("update-miss", client.update, pb.Info(name="nope"), "labels")
    call("stat", client.stat, layers[1])
    for filters in ([], ["kind==committed"], ['labels."containerd.io/snapshot.ref"'],
                    [f"parent=={layers[0]}"], ["name~=ctr", "kind==view"], ["bad filter =="]):
        call(f"walk {filters}", lambda f: _walk(client, f), filters)
    call("remove-parent", client.remove, layers[0])
    call("remove-ctr", client.remove, "default/1/ctr")
    call("remove-view", client.remove, "view-1")
    for chain in reversed(layers):
        call("remove", client.remove, chain)
    call("remove-miss", client.remove, layers[0])
    call("cleanup", client.cleanup)
    call("walk-empty", lambda f: _walk(client, f), [])
    return out


def _walk(client, filters):
    pb = _mod("ref", "api.snapshots_pb2")
    got = []
    for batch in client._call("List", pb.ListSnapshotsRequest(filters=filters)):
        got.extend(batch.info)
    return sorted(got, key=lambda i: i.name)


def _plain(reply):
    """A reply without its timestamps, as comparable data."""
    if reply is None:
        return None
    if isinstance(reply, list):
        return [_plain(r) for r in reply]
    if hasattr(reply, "DESCRIPTOR"):
        reply = type(reply).FromString(reply.SerializeToString())
        for stamp in ("created_at", "updated_at"):
            if stamp in reply.DESCRIPTOR.fields_by_name:
                reply.ClearField(stamp)
        return reply.SerializeToString(deterministic=True)
    return reply


def _run_wire(base: Path, client_side: str, service_side: str, seed: int):
    root = str(base / "root")
    # usage scans inline (NTPU_SNAPSHOT_USAGE_WORKERS=0): a committed
    # snapshot's usage is then in place when Commit returns, in every run
    sn = _mod(service_side, "snapshot.snapshotter").Snapshotter(
        root=root, fs=_fake_fs(service_side), usage_workers=0)
    sock = str(base / "g.sock")
    server = _mod(service_side, "api.service").serve(sn, sock)
    client = _mod(client_side, "api.client").SnapshotsClient(sock, timeout=10.0)
    try:
        steps = _transcript(client, seed)
    finally:
        client.close()
        server.stop(grace=None)
        sn.close()
    # Take the root out: both runs' roots have equal length, so the
    # serialized replies line up byte for byte once it is replaced.
    return [(n, a, kind, r.replace(root.encode(), b"<root>") if isinstance(r, bytes) else
             [x.replace(root.encode(), b"<root>") for x in r] if isinstance(r, list) else r)
            for n, a, kind, r in steps]


@pytest.mark.parametrize("seed", [5, 17])
def test_grpc_wire_equal_across_packages(tmp_path, seed):
    """The reference's client on the port's service and the port's client
    on the reference's service give the replies and the status codes that
    each package gives on its own, for the whole transcript."""
    runs = {}
    for i, (client_side, service_side) in enumerate(
        [("ref", "ref"), ("ref", "port"), ("port", "ref"), ("port", "port")]
    ):
        base = tmp_path / f"w{i}"
        base.mkdir()
        runs[(client_side, service_side)] = _run_wire(base, client_side, service_side, seed)
    want = runs[("ref", "ref")]
    codes = [s[3] for s in want if s[2] == "code"]
    assert grpc.StatusCode.NOT_FOUND in codes and grpc.StatusCode.ALREADY_EXISTS in codes
    assert grpc.StatusCode.FAILED_PRECONDITION in codes or grpc.StatusCode.INVALID_ARGUMENT in codes
    for pair, got in runs.items():
        assert len(got) == len(want), pair
        for g, w in zip(got, want):
            assert g == w, (pair, g[0])
