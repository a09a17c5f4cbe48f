"""The port's tarfs package against the JAX package's: the tar-tarfs
bootstrap builder, the dm-verity trees and the manager.

``TestTarfsBootstrap``, ``TestVerity``, ``test_export_flags_modes`` and
``TestManager`` of tests/test_tarfs.py run in both packages (``pkg``);
every bootstrap and tree is also held byte for byte against the
reference's. The builder's device route digests the indexed regions
through ``ChunkDigestEngine.digest_many`` (kernel K2, or K4 for BLAKE3,
on the card; their plain versions on ``device="cpu"``), against the
reference's engine and hashlib. The manager cases pull from an in-process
fake registry over plain HTTP (each package's ``Remote`` switched to it,
as the reference's tests do) with the loop and mount backends replaced by
recorders; the cross-package cases hold the port's manager, on the host
route and on a CPU engine, to the reference's files byte for byte, share
one engine between concurrent index builds, and fail a layer whose engine
raises.
"""

from __future__ import annotations

import gzip
import hashlib
import io
import json
import logging
import os
import tarfile
import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from nydus_snapshotter_tpu import constants as jC
from nydus_snapshotter_tpu import tarfs as jtarfs
from nydus_snapshotter_tpu.models import bootstrap as jbootstrap
from nydus_snapshotter_tpu.ops.chunker import ChunkDigestEngine as JEngine
from nydus_snapshotter_tpu.tarfs import bootstrap as jtb
from nydus_snapshotter_tpu.tarfs import verity as jverity
from nydus_snapshotter_tpu.remote import remote as jremote
from nydus_snapshotter_tpu.utils import errdefs as jerrdefs
from nydus_snapshotter_tpu.utils import losetup as jlosetup
from nydus_snapshotter_tpu.utils import mount as jmount
from nydus_snapshotter_tpu_torch import constants as tC
from nydus_snapshotter_tpu_torch import tarfs as ttarfs
from nydus_snapshotter_tpu_torch.models import bootstrap as tbootstrap
from nydus_snapshotter_tpu_torch.ops.chunker import ChunkDigestEngine as TEngine
from nydus_snapshotter_tpu_torch.tarfs import bootstrap as ttb
from nydus_snapshotter_tpu_torch.remote import remote as tremote
from nydus_snapshotter_tpu_torch.tarfs import verity as tverity
from nydus_snapshotter_tpu_torch.utils import blake3 as pyb3
from nydus_snapshotter_tpu_torch.utils import errdefs as terrdefs
from nydus_snapshotter_tpu_torch.utils import losetup as tlosetup
from nydus_snapshotter_tpu_torch.utils import mount as tmount
from tests.test_remote import FakeRegistry
from tests.test_tarfs import FakeMounter, _Snap, publish_image, snap_labels

PKG = {
    "ref": SimpleNamespace(build=jtb.tarfs_bootstrap_from_tar, verity=jverity, models=jbootstrap,
                           tarfs=jtarfs, C=jC, errdefs=jerrdefs, losetup=jlosetup, mount=jmount,
                           remote=jremote, side="ref"),
    "port": SimpleNamespace(build=ttarfs.tarfs_bootstrap_from_tar, verity=tverity, models=tbootstrap,
                            tarfs=ttarfs, C=tC, errdefs=terrdefs, losetup=tlosetup, mount=tmount,
                            remote=tremote, side="port"),
}


@pytest.fixture(params=["ref", "port"])
def pkg(request):
    return PKG[request.param]


def make_tar(files: dict[str, bytes]) -> bytes:
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:", format=tarfile.GNU_FORMAT) as tf:
        for name, data in files.items():
            if name.endswith("/"):
                info = tarfile.TarInfo(name.rstrip("/"))
                info.type = tarfile.DIRTYPE
                info.mode = 0o755
                tf.addfile(info)
            else:
                info = tarfile.TarInfo(name)
                info.size = len(data)
                info.mode = 0o644
                tf.addfile(info, io.BytesIO(data))
    return buf.getvalue()


def both(raw: bytes, blob_id: str, **kw) -> bytes:
    """The bootstrap of ``raw`` from both builders, held equal."""
    got = {side: p.build(io.BytesIO(raw), blob_id, **kw).to_bytes() for side, p in PKG.items()}
    assert got["port"] == got["ref"]
    return got["port"]


class TestTarfsBootstrap:
    def test_chunks_point_into_tar(self, pkg):
        files = {"etc/": b"", "etc/hosts": b"127.0.0.1 localhost\n", "big": b"Z" * 5000}
        raw = make_tar(files)
        bs = pkg.build(io.BytesIO(raw), "ab" * 32)
        hosts = {i.path: i for i in bs.inodes}["/etc/hosts"]
        assert hosts.chunk_count == 1
        chunk = bs.chunks[hosts.chunk_index]
        # the chunk's offset indexes the file data inside the tar itself
        off = chunk.uncompressed_offset
        assert raw[off:off + chunk.uncompressed_size] == files["etc/hosts"]
        assert chunk.digest == hashlib.sha256(files["etc/hosts"]).digest()
        both(raw, "ab" * 32)

    def test_large_file_split_by_chunk_size(self, pkg):
        data = bytes(range(256)) * 64  # 16 KiB
        raw = make_tar({"blob": data})
        bs = pkg.build(io.BytesIO(raw), "cd" * 32, chunk_size=4096)
        blob_inode = next(i for i in bs.inodes if i.path == "/blob")
        assert blob_inode.chunk_count == 4 and blob_inode.size == len(data)
        got = b"".join(
            raw[c.uncompressed_offset:c.uncompressed_offset + c.uncompressed_size]
            for c in bs.chunks[blob_inode.chunk_index:blob_inode.chunk_index + 4]
        )
        assert got == data
        both(raw, "cd" * 32, chunk_size=4096)

    def test_whiteout_normalization(self, pkg):
        raw = make_tar({"dir/": b"", "dir/.wh.gone": b"", "dir/.wh..wh..opq": b""})
        by_path = {i.path: i for i in pkg.build(io.BytesIO(raw), "ef" * 32).inodes}
        assert by_path["/dir/gone"].flags & pkg.models.INODE_FLAG_WHITEOUT
        assert by_path["/dir"].flags & pkg.models.INODE_FLAG_OPAQUE
        both(raw, "ef" * 32)

    def test_duplicate_member_last_wins_without_stale_chunks(self, pkg):
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w:", format=tarfile.GNU_FORMAT) as tf:
            info = tarfile.TarInfo("foo")
            info.size = 5120
            tf.addfile(info, io.BytesIO(b"A" * 5120))
            info2 = tarfile.TarInfo("foo")
            info2.size = 0
            tf.addfile(info2)
        foo = next(i for i in pkg.build(io.BytesIO(buf.getvalue()), "aa" * 32).inodes if i.path == "/foo")
        assert foo.chunk_count == 0 and foo.size == 0
        both(buf.getvalue(), "aa" * 32)

    def test_serialized_roundtrip(self, pkg):
        raw = make_tar({"a/b/c": b"deep"})
        bs = pkg.build(io.BytesIO(raw), "12" * 32)
        again = pkg.models.Bootstrap.from_bytes(bs.to_bytes())
        assert {i.path for i in again.inodes} == {i.path for i in bs.inodes}
        assert again.blobs[0].uncompressed_size == len(raw)
        both(raw, "12" * 32, fs_version="v5")


RNG = np.random.default_rng(0x7A5F)
ENGINE_TAR = make_tar({
    "usr/": b"",
    "usr/lib/libx.so": RNG.integers(0, 256, 70_000, dtype=np.uint8).tobytes(),
    "usr/share/doc": b"text " * 900,
    "usr/empty": b"",
    "usr/one": b"1",
    "etc/conf": RNG.integers(0, 256, 4096, dtype=np.uint8).tobytes(),
})


@pytest.mark.parametrize("backend", ["fused", "jax", "hybrid", "numpy"])
def test_engine_digests_equal_reference_engine_and_hashlib(backend):
    """``engine=``: the port's engine on the CPU (``jax``/``fused`` run K2's
    plain version there) gives the reference engine's bootstrap, whose
    digests are hashlib's."""
    chunk = 0x1000
    want = jtb.tarfs_bootstrap_from_tar(
        io.BytesIO(ENGINE_TAR), "e" * 64, chunk_size=chunk,
        engine=JEngine(chunk_size=chunk, backend=backend if backend != "hybrid" else "numpy"))
    got = ttb.tarfs_bootstrap_from_tar(
        io.BytesIO(ENGINE_TAR), "e" * 64, chunk_size=chunk,
        engine=TEngine(chunk_size=chunk, backend=backend, device="cpu"))
    assert got.to_bytes() == want.to_bytes()
    assert got.to_bytes() == ttb.tarfs_bootstrap_from_tar(io.BytesIO(ENGINE_TAR), "e" * 64,
                                                          chunk_size=chunk).to_bytes()
    for c in got.chunks:
        region = ENGINE_TAR[c.uncompressed_offset:c.uncompressed_offset + c.uncompressed_size]
        assert c.digest == hashlib.sha256(region).digest()


@pytest.mark.parametrize("backend", ["fused", "hybrid"])
def test_blake3_engine_digests_regions(backend):
    """A BLAKE3 engine digests the regions with BLAKE3 (K4's plain version
    on ``device="cpu"`` for the device lanes), as the reference's does."""
    chunk = 0x2000
    eng = TEngine(chunk_size=chunk, backend=backend, digester="blake3", device="cpu")
    got = ttb.tarfs_bootstrap_from_tar(io.BytesIO(ENGINE_TAR), "f" * 64, chunk_size=chunk, engine=eng)
    want = jtb.tarfs_bootstrap_from_tar(
        io.BytesIO(ENGINE_TAR), "f" * 64, chunk_size=chunk,
        engine=JEngine(chunk_size=chunk, backend="numpy", digester="blake3"))
    assert got.to_bytes() == want.to_bytes()
    for c in got.chunks:
        region = ENGINE_TAR[c.uncompressed_offset:c.uncompressed_offset + c.uncompressed_size]
        assert c.digest == pyb3.blake3(region)


class TestVerity:
    def test_tree_roundtrip(self, pkg):
        data = os.urandom(512 * 300)
        tree, info = pkg.verity.build_tree(data)
        assert info.data_blocks == 300
        assert pkg.verity.verify(data, info, tree)

    def test_tamper_detected(self, pkg):
        data = bytearray(os.urandom(512 * 64))
        tree, info = pkg.verity.build_tree(bytes(data))
        data[100] ^= 0xFF
        assert not pkg.verity.verify(bytes(data), info, tree)

    def test_multi_level_tree(self, pkg):
        data = b"\xAA" * (512 * 200)  # level0: 200 digests -> 2 hash blocks; level1: 1 block
        tree, info = pkg.verity.build_tree(data)
        assert len(tree) == 3 * pkg.verity.HASH_BLOCK_SIZE
        assert pkg.verity.verify(data, info, tree)

    def test_unaligned_rejected(self, pkg):
        with pytest.raises(ValueError):
            pkg.verity.build_tree(b"x" * 777)

    def test_block_info_label_roundtrip(self, pkg):
        info = pkg.verity.VerityInfo(123, 4096, "ab" * 32)
        assert pkg.verity.parse_block_info_label(info.block_info_label()) == info


@pytest.mark.parametrize("blocks", [1, 127, 128, 129, 200, 16_385])
def test_verity_trees_equal_reference(blocks):
    """Trees, roots and labels byte for byte, across level boundaries
    (128 digests per hash block: a third level past 16 384 blocks)."""
    data = np.random.default_rng(blocks).integers(0, 256, 512 * blocks, dtype=np.uint8).tobytes()
    t_tree, t_info = tverity.build_tree(data)
    j_tree, j_info = jverity.build_tree(data)
    assert t_tree == j_tree
    assert t_info.block_info_label() == j_info.block_info_label()
    assert tverity.verify(data, t_info, t_tree)


def test_package_exports_only_what_is_ported():
    """The whole tarfs package is ported: the reference's exports, with
    the same constants."""
    from nydus_snapshotter_tpu import tarfs as jtarfs

    assert sorted(ttarfs.__all__) == sorted(jtarfs.__all__)
    for name in ttarfs.__all__:
        if name.isupper():
            assert getattr(ttarfs, name) == getattr(jtarfs, name), name
    assert ttarfs.DEFAULT_CHUNK_SIZE == jtb.DEFAULT_CHUNK_SIZE


def test_append_tree_equals_reference():
    """``append_tree``: the hash area appended after an image's data, and
    its ``VerityInfo``, as the reference's."""
    data = np.random.default_rng(3).integers(0, 256, 512 * 333, dtype=np.uint8).tobytes()
    out = {}
    for side, p in PKG.items():
        f = io.BytesIO(data)
        f.seek(0, 2)
        info = p.verity.append_tree(f, len(data))
        out[side] = (f.getvalue(), info.block_info_label())
    assert out["port"] == out["ref"]
    info = tverity.parse_block_info_label(out["port"][1])
    assert tverity.verify(data, info, out["port"][0][info.hash_offset:])


def test_export_flags_modes(pkg):
    ExportFlags = pkg.tarfs.ExportFlags
    assert ExportFlags.from_mode("image_block_with_verity") == ExportFlags(True, True, True)
    assert ExportFlags.from_mode("layer_verity_only") == ExportFlags(False, False, True)
    with pytest.raises(pkg.errdefs.InvalidArgument):
        ExportFlags.from_mode("bogus")


# ---------------------------------------------------------------------------
# the manager against the fake registry
# ---------------------------------------------------------------------------


class FakeLoopBackend:
    """Records loop attaches; ``losetup`` is the package's own module."""

    def __init__(self, losetup):
        self.losetup = losetup
        self.attached: dict[int, str] = {}
        self._next = 0

    def attach(self, blob_path, offset=0, ro=True):
        dev = self.losetup.LoopDevice(self._next)
        self.attached[self._next] = blob_path
        self._next += 1
        return dev

    def detach(self, dev):
        self.attached.pop(dev.index, None)


def _fake_os(p, monkeypatch):
    loop, mounter = FakeLoopBackend(p.losetup), FakeMounter()
    monkeypatch.setattr(p.losetup, "backend", loop)
    monkeypatch.setattr(p.mount, "backend", mounter)
    return loop, mounter


@pytest.fixture()
def fake_os(pkg, monkeypatch):
    return _fake_os(pkg, monkeypatch)


@pytest.fixture(autouse=True)
def plain_http(monkeypatch):
    """Both packages' ``Remote`` speak plain HTTP to the fake registry, as
    tests/test_tarfs.py switches the reference's."""
    for p in PKG.values():
        orig = p.remote.Remote.__init__

        def patched(self, keychain=None, insecure=False, _orig=orig):
            _orig(self, keychain=keychain, insecure=insecure)
            self.with_plain_http = True

        monkeypatch.setattr(p.remote.Remote, "__init__", patched)


@pytest.fixture()
def registry():
    reg = FakeRegistry(require_auth=False)
    yield reg
    reg.close()


class TestManager:
    def _mgr(self, pkg, tmp_path, **kw):
        return pkg.tarfs.Manager(cache_dir_path=str(tmp_path / "cache"), **kw)

    def _boot(self, pkg, path):
        with open(path, "rb") as f:
            return pkg.models.Bootstrap.from_bytes(f.read())

    def test_prepare_and_ready(self, pkg, registry, tmp_path):
        mdigest, layer_digests = publish_image(registry, [{"etc/a": b"data-a"}])
        mgr = self._mgr(pkg, tmp_path)
        upper = tmp_path / "snap" / "1" / "fs"
        upper.mkdir(parents=True)
        mgr.prepare_layer(snap_labels(registry, mdigest, layer_digests[0]), "1", str(upper))
        mgr.wait_layer_ready("1")
        blob_id = layer_digests[0].split(":")[1]
        assert os.path.exists(mgr.layer_tar_file_path(blob_id))
        assert os.path.exists(mgr.layer_meta_file_path(str(upper)))
        bs = self._boot(pkg, mgr.layer_meta_file_path(str(upper)))
        assert "/etc/a" in {i.path for i in bs.inodes}

    def test_diff_id_mismatch_fails(self, pkg, registry, tmp_path):
        # publish layer whose diffID in config is wrong
        tar = make_tar({"f": b"x"})
        blob = gzip.compress(tar)
        digest = registry.add_blob(blob)
        config = {"rootfs": {"type": "layers", "diff_ids": ["sha256:" + "0" * 64]}}
        cfg_body = json.dumps(config).encode()
        cfg_digest = registry.add_blob(cfg_body)
        manifest = {"schemaVersion": 2,
                    "config": {"digest": cfg_digest, "size": len(cfg_body)},
                    "layers": [{"digest": digest, "size": len(blob)}]}
        mdigest = registry.add_blob(json.dumps(manifest).encode())
        mgr = self._mgr(pkg, tmp_path)
        upper = tmp_path / "s" / "fs"
        upper.mkdir(parents=True)
        mgr.prepare_layer(snap_labels(registry, mdigest, digest), "1", str(upper))
        with pytest.raises(pkg.errdefs.Unavailable):
            mgr.wait_layer_ready("1")

    def test_duplicate_prepare_rejected(self, pkg, registry, tmp_path):
        mdigest, layer_digests = publish_image(registry, [{"a": b"1"}])
        mgr = self._mgr(pkg, tmp_path)
        upper = tmp_path / "s" / "fs"
        upper.mkdir(parents=True)
        labels = snap_labels(registry, mdigest, layer_digests[0])
        mgr.prepare_layer(labels, "1", str(upper))
        with pytest.raises(pkg.errdefs.AlreadyExists):
            mgr.prepare_layer(labels, "1", str(upper))
        mgr.wait_layer_ready("1")

    def test_tarfs_hint_annotation(self, pkg, registry, tmp_path):
        mdigest, _ = publish_image(registry, [{"a": b"1"}], tarfs_hint="true")
        mgr = self._mgr(pkg, tmp_path, check_tarfs_hint=True)
        ref = f"{registry.host}/library/app:latest"
        assert mgr.check_tarfs_hint_annotation(ref, mdigest) is True
        # cached second call
        assert mgr.check_tarfs_hint_annotation(ref, mdigest) is True
        # hint disabled -> always true
        mgr2 = self._mgr(pkg, tmp_path / "m2")
        assert mgr2.check_tarfs_hint_annotation(ref, "sha256:" + "1" * 64) is True

    def _prepare_two_layers(self, pkg, registry, tmp_path):
        mdigest, layer_digests = publish_image(
            registry,
            [{"etc/lower": b"lower"}, {"etc/upper": b"upper"}],
        )
        mgr = self._mgr(pkg, tmp_path)
        uppers = {}
        # snapshot ids: layer 0 -> "2" (bottom), layer 1 -> "1"
        for sid, ld in zip(["2", "1"], layer_digests):
            upper = tmp_path / "snap" / sid / "fs"
            upper.mkdir(parents=True)
            uppers[sid] = str(upper)
            mgr.prepare_layer(snap_labels(registry, mdigest, ld), sid, str(upper))
            mgr.wait_layer_ready(sid)
        return mgr, uppers, layer_digests

    def test_merge_layers(self, pkg, registry, tmp_path):
        mgr, uppers, _ = self._prepare_two_layers(pkg, registry, tmp_path)
        snap = _Snap("0", ["1", "2"])
        mgr.merge_layers(snap, lambda sid: uppers[sid])
        bs = self._boot(pkg, mgr.image_meta_file_path(uppers["1"]))
        paths = {i.path for i in bs.inodes}
        assert "/etc/lower" in paths and "/etc/upper" in paths
        assert len(bs.blobs) == 2

    def test_export_block_data_with_verity(self, pkg, registry, tmp_path):
        C, verity = pkg.C, pkg.verity
        mgr, uppers, layer_digests = self._prepare_two_layers(pkg, registry, tmp_path)
        mgr.export_flags = pkg.tarfs.ExportFlags.from_mode("image_block_with_verity")
        snap = _Snap("0", ["1", "2"])
        mgr.merge_layers(snap, lambda sid: uppers[sid])
        blob_id = layer_digests[1].split(":")[1]
        labels = {C.NYDUS_TARFS_LAYER: blob_id}
        fields = mgr.export_block_data(snap, False, labels, lambda sid: uppers[sid])
        assert fields == ["labels." + C.NYDUS_IMAGE_BLOCK_INFO]
        info = verity.parse_block_info_label(labels[C.NYDUS_IMAGE_BLOCK_INFO])
        disk = mgr.image_disk_file_path(blob_id)
        assert os.path.exists(disk)
        # verify the tree embedded in the exported image
        with open(disk, "rb") as f:
            img = f.read()
        data = img[: info.data_blocks * verity.DATA_BLOCK_SIZE]
        tree = img[info.hash_offset :]
        assert verity.verify(data, info, tree)

    def test_export_reuses_verity_info_for_existing_disk(self, pkg, registry, tmp_path):
        C = pkg.C
        mgr, uppers, layer_digests = self._prepare_two_layers(pkg, registry, tmp_path)
        mgr.export_flags = pkg.tarfs.ExportFlags.from_mode("image_block_with_verity")
        snap = _Snap("0", ["1", "2"])
        mgr.merge_layers(snap, lambda sid: uppers[sid])
        blob_id = layer_digests[1].split(":")[1]
        first = {C.NYDUS_TARFS_LAYER: blob_id}
        mgr.export_block_data(snap, False, first, lambda sid: uppers[sid])
        # second snapshot of the same image: disk exists, info must be reused
        second = {C.NYDUS_TARFS_LAYER: blob_id}
        mgr.export_block_data(snap, False, second, lambda sid: uppers[sid])
        assert second[C.NYDUS_IMAGE_BLOCK_INFO] == first[C.NYDUS_IMAGE_BLOCK_INFO]
        assert second[C.NYDUS_IMAGE_BLOCK_INFO] != ""

    def test_remount_is_idempotent_and_sets_mountpoint(self, pkg, registry, tmp_path, fake_os):
        mgr, uppers, _ = self._prepare_two_layers(pkg, registry, tmp_path)
        mgr.mount_on_host = True

        class R:
            snapshot_dir = str(tmp_path / "snap" / "1")
            mountpoint = ""
            annotations = {}

        snap = _Snap("0", ["1", "2"])
        mgr.merge_layers(snap, lambda sid: uppers[sid])
        mgr.mount_tar_erofs("1", snap, {}, R)
        first = R.mountpoint
        R.mountpoint = ""
        mgr.mount_tar_erofs("1", snap, {}, R)  # replay
        assert R.mountpoint == first != ""

    def test_export_disabled_is_noop(self, pkg, registry, tmp_path):
        mgr = self._mgr(pkg, tmp_path)
        assert mgr.export_block_data(_Snap("0", ["1"]), False, {}, lambda s: "") == []

    def test_mount_without_host_mount_uses_upper(self, pkg, registry, tmp_path, fake_os):
        C = pkg.C
        mgr, uppers, _ = self._prepare_two_layers(pkg, registry, tmp_path)

        class R:
            snapshot_dir = str(tmp_path / "snap" / "1")
            mountpoint = ""
            annotations = {}

        snap = _Snap("0", ["1", "2"])
        mgr.merge_layers(snap, lambda sid: uppers[sid])
        mgr.mount_tar_erofs("1", snap, {C.NYDUS_TARFS_LAYER: "xyz"}, R)
        assert R.mountpoint == uppers["1"]
        assert R.annotations[C.NYDUS_TARFS_LAYER] == "xyz"

    def test_mount_on_host_loops_and_mounts(self, pkg, registry, tmp_path, fake_os):
        loop, mounter = fake_os
        mgr, uppers, _ = self._prepare_two_layers(pkg, registry, tmp_path)
        mgr.mount_on_host = True

        class R:
            snapshot_dir = str(tmp_path / "snap" / "1")
            mountpoint = ""
            annotations = {}

        snap = _Snap("0", ["1", "2"])
        mgr.merge_layers(snap, lambda sid: uppers[sid])
        mgr.mount_tar_erofs("1", snap, {}, R)
        mnt = os.path.join(str(tmp_path / "snap" / "1"), "mnt")
        assert R.mountpoint == mnt
        src, fstype, opts = mounter.mounts[mnt]
        assert fstype == "erofs"
        assert opts.count("device=") == 2  # both layer tars attached
        assert len(loop.attached) == 3  # 2 data + 1 meta
        # umount + detach
        mgr.umount_tar_erofs("1")
        assert mnt not in mounter.mounts
        mgr.detach_layer("1")
        mgr.detach_layer("2")
        assert len(loop.attached) == 0

    def test_concurrent_limiter_per_ref(self, pkg, tmp_path):
        mgr = self._mgr(pkg, tmp_path, max_concurrent_process=2)
        l1 = mgr.get_concurrent_limiter("ref-a")
        assert l1 is mgr.get_concurrent_limiter("ref-a")
        assert l1 is not mgr.get_concurrent_limiter("ref-b")
        assert self._mgr(pkg, tmp_path / "x", max_concurrent_process=0).get_concurrent_limiter("r") is None


# ---------------------------------------------------------------------------
# the manager across packages
# ---------------------------------------------------------------------------

MGR_RNG = np.random.default_rng(0x7A5E)
MGR_LAYERS = [
    {"etc/": b"", "etc/hosts": b"127.0.0.1 localhost\n", "usr/": b"", "usr/lib/": b"",
     "usr/lib/libz.so": MGR_RNG.integers(0, 256, 3000, dtype=np.uint8).tobytes(),
     "usr/share/doc": b"text " * 700, "opt/": b"", "opt/app/": b"", "opt/app/old": b"old"},
    {"usr/": b"", "usr/bin/": b"", "usr/bin/tool": MGR_RNG.integers(0, 256, 2500, dtype=np.uint8).tobytes(),
     "etc/": b"", "etc/.wh.hosts": b""},
    {"opt/": b"", "opt/app/": b"", "opt/app/.wh..wh..opq": b"", "opt/app/new": b"new " * 300,
     "usr/": b"", "usr/lib/": b"", "usr/lib/libz.so": b"patched"},
]


def _pull_image(p, registry, root, monkeypatch, engine=None, concurrent=True):
    """Pull MGR_LAYERS through package ``p``'s manager (all layers prepared
    at once), merge, export the whole image with its verity tree and mount
    it with recorders. -> every file the manager wrote, the labels, the
    recorded attaches and mounts."""
    loop, mounter = _fake_os(p, monkeypatch)
    mdigest, layer_digests = registry.image
    mgr = p.tarfs.Manager(cache_dir_path=str(root / "cache"), validate_diff_id=True,
                          export_mode="image_block_with_verity", engine=engine)
    sids = [str(len(layer_digests) - i) for i in range(len(layer_digests))]  # bottom layer: highest id
    uppers = {}
    for sid, ld in zip(sids, layer_digests):
        upper = root / "snap" / sid / "fs"
        upper.mkdir(parents=True)
        uppers[sid] = str(upper)
        mgr.prepare_layer(snap_labels(registry, mdigest, ld), sid, str(upper))
        if not concurrent:
            mgr.wait_layer_ready(sid)
    for sid in sids:
        mgr.wait_layer_ready(sid)
    snap = _Snap("0", sids[::-1])  # top first
    mgr.merge_layers(snap, lambda sid: uppers[sid])
    top_blob = layer_digests[-1].split(":")[1]
    labels = {p.C.NYDUS_TARFS_LAYER: top_blob}
    fields = mgr.export_block_data(snap, False, labels, lambda sid: uppers[sid])
    disk = mgr.image_disk_file_path(top_blob)
    mgr.mount_on_host = True

    class R:
        snapshot_dir = str(root / "snap" / sids[-1])
        mountpoint = ""
        annotations = {}

    mgr.mount_tar_erofs(sids[-1], snap, labels, R)
    mounts = {os.path.relpath(k, root): (v[1], v[2].count("device=")) for k, v in mounter.mounts.items()}
    attached = sorted(os.path.relpath(v, root) for v in loop.attached.values())
    mgr.umount_tar_erofs(sids[-1])
    for sid in sids:
        mgr.detach_layer(sid)
    image_boot = mgr.image_meta_file_path(uppers[sids[-1]])
    return {
        "layer_boots": [Path(mgr.layer_meta_file_path(uppers[s])).read_bytes() for s in sids],
        "image_boot": Path(image_boot).read_bytes(),
        "disk": Path(disk).read_bytes(),
        "verity_json": Path(disk + ".verity.json").read_text(),
        "labels": labels, "fields": fields, "mounts": mounts, "attached": attached,
        "left_attached": len(loop.attached), "left_mounted": len(mounter.mounts),
        "meta_erofs": Path(image_boot + ".erofs").read_bytes(),
    }


@pytest.fixture()
def image_registry(registry):
    registry.image = publish_image(registry, MGR_LAYERS)
    return registry


@pytest.mark.parametrize("engine", [None, "jax", "hybrid"])
def test_manager_files_equal_reference(image_registry, tmp_path, monkeypatch, engine):
    """The port's manager on the CPU writes the reference's ``layer.boot``
    files, merged ``image.boot``, EROFS meta image and verity-exported
    disk byte for byte, with the same labels, attaches and mounts: on the
    host route (no engine) and with a ``ChunkDigestEngine`` (``jax``: K2's
    plain version on ``device="cpu"``; ``hybrid``: the native host arm)."""
    want = _pull_image(PKG["ref"], image_registry, tmp_path / "ref", monkeypatch)
    eng = None if engine is None else TEngine(chunk_size=0x1000, backend=engine, device="cpu")
    got = _pull_image(PKG["port"], image_registry, tmp_path / "port", monkeypatch, engine=eng)
    assert got == want
    info = tverity.parse_block_info_label(got["labels"][tC.NYDUS_IMAGE_BLOCK_INFO])
    disk = got["disk"]
    assert tverity.verify(disk[: info.data_blocks * tverity.DATA_BLOCK_SIZE], info, disk[info.hash_offset:])
    assert got["left_attached"] == 0 and got["left_mounted"] == 0


def test_manager_serial_equals_concurrent(image_registry, tmp_path, monkeypatch):
    """One CPU engine shared by the concurrent prepares gives the files of
    one prepare at a time."""
    eng = TEngine(chunk_size=0x1000, device="cpu")
    a = _pull_image(PKG["port"], image_registry, tmp_path / "a", monkeypatch, engine=eng)
    b = _pull_image(PKG["port"], image_registry, tmp_path / "b", monkeypatch, engine=eng,
                    concurrent=False)
    assert a == b


def test_concurrent_digest_many_equals_serial():
    """Four threads on one engine's ``digest_many`` at once (as four
    concurrent index builds share the manager's engine) get the digests of
    the calls made one at a time, which are hashlib's."""
    rng = np.random.default_rng(0xD16)
    batches = [[rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
                for n in rng.integers(0, 1200, 24)] for _ in range(4)]
    eng = TEngine(chunk_size=0x1000, device="cpu")
    serial = [eng.digest_many(b) for b in batches]
    assert serial == [[hashlib.sha256(c).digest() for c in b] for b in batches]
    for _round in range(2):
        out: list = [None] * 4
        start = threading.Barrier(4)

        def work(i):
            start.wait()
            out[i] = eng.digest_many(batches[i])

        threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert out == serial


class _RaisingEngine:
    def __init__(self):
        self.calls = 0

    def digest_many(self, datas):
        self.calls += 1
        raise RuntimeError("engine failed")


def test_engine_that_raises_fails_the_layer(image_registry, tmp_path, monkeypatch):
    """An engine that raises fails its layer (FAILED, no ``layer.boot``);
    the build never falls back to hashlib."""
    monkeypatch.setattr(ttb, "hashlib", None)  # any host digest would raise AttributeError
    eng = _RaisingEngine()
    mdigest, layer_digests = image_registry.image
    mgr = ttarfs.Manager(cache_dir_path=str(tmp_path / "cache"), engine=eng)
    upper = tmp_path / "s" / "fs"
    upper.mkdir(parents=True)
    mgr.prepare_layer(snap_labels(image_registry, mdigest, layer_digests[0]), "1", str(upper))
    with pytest.raises(terrdefs.Unavailable, match="state 3 instead of ready"):
        mgr.wait_layer_ready("1")
    assert mgr._get_status("1").status == ttarfs.TARFS_STATUS_FAILED
    assert eng.calls == 1
    assert not os.path.exists(mgr.layer_meta_file_path(str(upper)))


def test_diff_id_mismatch_logs_the_reference_message(registry, tmp_path, caplog):
    """A wrong diff ID in the config fails the layer in both packages with
    the same logged message."""
    tar = make_tar({"f": b"x"})
    blob = gzip.compress(tar, mtime=0)
    digest = registry.add_blob(blob)
    cfg_body = json.dumps({"rootfs": {"type": "layers", "diff_ids": ["sha256:" + "0" * 64]}}).encode()
    cfg_digest = registry.add_blob(cfg_body)
    mdigest = registry.add_blob(json.dumps({
        "schemaVersion": 2, "config": {"digest": cfg_digest, "size": len(cfg_body)},
        "layers": [{"digest": digest, "size": len(blob)}]}).encode())
    msgs = {}
    for side, p in PKG.items():
        caplog.clear()
        mgr = p.tarfs.Manager(cache_dir_path=str(tmp_path / side / "cache"))
        upper = tmp_path / side / "fs"
        upper.mkdir(parents=True)
        with caplog.at_level(logging.ERROR):
            mgr.prepare_layer(snap_labels(registry, mdigest, digest), "9", str(upper))
            with pytest.raises(p.errdefs.Unavailable):
                mgr.wait_layer_ready("9")
        assert mgr._get_status("9").status == p.tarfs.TARFS_STATUS_FAILED
        msgs[side] = [r.getMessage() for r in caplog.records if r.name.endswith("tarfs.tarfs")]
    want = ("prepare tarfs layer for snapshot 9: layer diffID mismatch: sha256:"
            f"{hashlib.sha256(tar).hexdigest()} != sha256:{'0' * 64}")
    assert msgs["port"] == msgs["ref"] == [want]
