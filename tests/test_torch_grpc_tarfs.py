"""The port's snapshotter stack over tarfs layers, against the JAX
package's.

Every case of tests/test_grpc_tarfs.py (a tarfs image pulled through the
gRPC service, merged, exported with dm-verity and mounted over loop
devices, where this process is root with /dev/loop-control, under the
reference's own skip condition) and tests/test_concurrency_stress.py (a
SIGKILL storm on the daemon manager, the supervisor hammer, concurrent
tarfs layer prepares under the per-image limiter, blob-cache reads during
close) runs in both packages (``pkg``, through ``ported_cases``). Their
port twins import ``make_tar``, ``publish_image`` and ``snap_labels`` from
the port twin of tests/test_tarfs.py and ``_build_image`` from that of
tests/test_daemon_lifecycle.py; every daemon a port case spawns is checked
to run the port's server.

The cross-package case pulls one seeded three-layer tarfs image (a plain
layer, a second one with a directory tree, a third with a whiteout and an
opaque directory) from an in-process registry through each package's
stack, with the tarfs index built by the engine ``cmd/snapshotter.py``
gives ``tarfs.Manager`` (``ChunkDigestEngine(mode="fixed")``; the port's
on ``device="cpu"``): every layer takes the tarfs route (its committed
snapshot carries ``NYDUS_TARFS_LAYER``, the port's engine indexes it
once), and the layer and merged bootstraps are equal byte for byte.
"""

from __future__ import annotations

import functools
import importlib

import grpc
import numpy as np
import pytest

from tests.test_torch_fetch_sched import ROOTS, SIDES, other_package_still, port_twin, ported_cases
from tests.test_torch_snapshotter import short_tmp_path, spawns_own_server

tmp_path = short_tmp_path("gt")
port_twin("test_daemon_lifecycle", host=("pack_layer",))
TARFS = port_twin("test_tarfs")
GRPC_TARFS = port_twin("test_grpc_tarfs", twins=("test_tarfs",))
ported_cases("test_grpc_tarfs", globals(), twins=("test_tarfs",))
ported_cases("test_concurrency_stress", globals(), twins=("test_daemon_lifecycle", "test_tarfs"))
_other_package_still = other_package_still()
_spawns_own_server = spawns_own_server()


def _seeded_layers(seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    blob = lambda lo, hi: rng.integers(0, 256, int(rng.integers(lo, hi)), dtype=np.uint8).tobytes()
    l1 = {f"usr/lib/f{i}.so": blob(0, 12_000) for i in range(6)}
    l1["etc/hosts"] = b"127.0.0.1 localhost\n"
    l2 = {"opt/": b"", "opt/app/": b"", **{f"opt/app/m{i}.py": blob(10, 9000) for i in range(8)},
          "usr/lib/f0.so": blob(1, 5000)}
    l3 = {"usr/lib/.wh.f1.so": b"", "opt/app/.wh..wh..opq": b"", "opt/app/main.py": blob(100, 3000),
          "etc/motd": b"hi\n"}
    return [l1, l2, l3]


def _route(side: str, base, registry, mdigest: str, layer_digests: list[str]):
    """Pull the image through one package's stack (containerd's Prepare
    per layer, then the container's Prepare); return the committed
    snapshots' labels, the layer bootstraps, the merged bootstrap and the
    number of index builds its engine ran."""
    C = importlib.import_module(f"{ROOTS[side]}.constants")
    grpc_tarfs = importlib.import_module("tests.test_grpc_tarfs") if side == "ref" else GRPC_TARFS
    engine = importlib.import_module(f"{ROOTS[side]}.ops.chunker").ChunkDigestEngine(
        chunk_size=0x10000, mode="fixed", **({"device": "cpu"} if side == "port" else {}))
    builds = []
    digest_many = engine.digest_many
    engine.digest_many = lambda datas: builds.append(len(datas)) or digest_many(datas)
    mgr_cls = grpc_tarfs.TarfsManager
    grpc_tarfs.TarfsManager = functools.partial(mgr_cls, engine=engine)
    try:
        cfg, db, mgr, fs, sn, server, client = grpc_tarfs._mk_tarfs_stack(base, mount_on_host=False)
    finally:
        grpc_tarfs.TarfsManager = mgr_cls
    ref = f"{registry.host}/library/app:latest"
    try:
        parent, chains = "", []
        for i, ld in enumerate(layer_digests):
            chain = f"sha256:route-{i}"
            labels = {C.CRI_IMAGE_REF: ref, C.CRI_MANIFEST_DIGEST: mdigest, C.CRI_LAYER_DIGEST: ld,
                      C.TARGET_SNAPSHOT_REF: chain}
            with pytest.raises(grpc.RpcError) as exc_info:
                client.prepare(f"extract-{i}", parent, labels=labels)
            assert exc_info.value.code() == grpc.StatusCode.ALREADY_EXISTS
            chains.append(chain)
            parent = chain
        client.prepare("ctr", parent, labels={C.CRI_IMAGE_REF: ref})
        mounts = client.mounts("ctr")
        tm = fs.tarfs_mgr
        sids = [sn.ms.get_snapshot(c).id for c in chains]
        out = {
            "labels": [dict(client.stat(c).labels) for c in chains],
            "layers": [open(tm.layer_meta_file_path(sn.upper_path(s)), "rb").read() for s in sids],
            "merged": open(tm.image_meta_file_path(sn.upper_path(sids[-1])), "rb").read(),
            "mounts": [(m.type, [o.replace(cfg.root, "<root>") for o in m.options]) for m in mounts],
            "builds": list(builds),
            "tarfs_label": C.NYDUS_TARFS_LAYER,
        }
        client.remove("ctr")
        for c in reversed(chains):
            client.remove(c)
        client.cleanup()
        return out
    finally:
        client.close()
        server.stop(grace=None)
        fs.teardown()
        sn.close()
        mgr.stop()


@pytest.mark.parametrize("seed", [21])
def test_tarfs_route_bootstraps_equal(tmp_path, seed):
    from tests.test_remote import FakeRegistry

    layers = _seeded_layers(seed)
    registry = FakeRegistry(require_auth=False)
    # one publication for both stacks: gzip stamps its time into each blob
    mdigest, layer_digests = TARFS.publish_image(registry, layers, tarfs_hint="true")
    got = {}
    try:
        for i, side in enumerate(SIDES):
            plain = importlib.import_module(f"{ROOTS[side]}.remote.remote").Remote
            init = plain.__init__

            def patched(self, keychain=None, insecure=False, _init=init):
                _init(self, keychain=keychain, insecure=insecure)
                self.with_plain_http = True

            plain.__init__ = patched
            try:
                base = tmp_path / f"s{i}"
                base.mkdir()
                got[side] = _route(side, base, registry, mdigest, layer_digests)
            finally:
                plain.__init__ = init
    finally:
        registry.close()
    ref, port = got["ref"], got["port"]
    for labels in ref["labels"] + port["labels"]:
        assert ref["tarfs_label"] in labels  # every layer took the tarfs route
    assert len(port["builds"]) == len(layers)  # one index build per layer
    assert len(ref["builds"]) == len(layers)
    assert port["layers"] == ref["layers"]
    assert port["merged"] == ref["merged"]
    assert port["labels"] == ref["labels"]
    assert port["mounts"] == ref["mounts"]
